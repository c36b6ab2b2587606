"""The kernel families the CUDA ops take since the 20-coefficient form:
the port's plain density, IAD, std momentum, VE grad-h (with xmass) and
VE momentum ops with the wendland-c6 kernel (a degree-19 fit, 20
coefficients) and with sinc at sinc_index 5 (14 coefficients), against
the JAX package's Pallas ops in interpret mode, on the jittered Sedov
side 12 (fold path) and, for wendland-c6, side 24 at cell_target 16
(per-run shifts); and
the CLI's ``--kernel`` / ``--sincIndex`` constants against the JAX CLI's.

Tolerances are tests/test_torch_ops.py's and test_torch_ve_ops.py's
(the JAX package's own Pallas-vs-XLA ones): nc exact; rho, xm and kx
rtol 1e-5; IAD rtol 1e-4 / atol 1e-5 max|c11|; gradh rtol 5e-4 / atol
1e-5; std a and du rtol 1e-4 / atol 5e-6 max|.|, min dt rel 1e-5; VE a
and du rtol 2e-4 / atol 1e-5 max|.|, min dt rel 1e-4. Every op of the
port gets the JAX package's inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp
from sphexa_tpu.sph.hydro_std import compute_eos_std as jax_eos
from sphexa_tpu.sph.hydro_ve import compute_eos_ve as jax_eos_ve
from sphexa_tpu.sph.kernels import kernel_norm_3d as jax_kernel_norm

from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import jitter_sedov
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_ve import compute_eos_ve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.tensor(np.array(a))


#: kernel form -> (kernel_choice, sinc_index, polynomial coefficients)
KINDS = {"wendland-c6": ("wendland-c6", 6.0, 20), "sinc-5": ("sinc", 5.0, 14)}
GEOMETRY = {"fold": (12, {}), "shift": (24, {"cell_target": 16})}


@pytest.fixture(scope="module", params=[("wendland-c6", "fold"), ("wendland-c6", "shift"),
                                        ("sinc-5", "fold")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """Both packages' sorted jittered Sedov states with the kernel, and the
    JAX package's ops on them in interpret mode, each on the previous
    op's outputs."""
    kind, geom = request.param
    choice, n, ncoef = KINDS[kind]
    side, kw = GEOMETRY[geom]
    js0, jb, jc = jax_init_sedov(side)
    jc = dataclasses.replace(jc, kernel_choice=choice, sinc_index=n,
                             kernel_norm=jax_kernel_norm(n, choice))
    fields = jitter_sedov({f.name: np.array(getattr(js0, f.name))
                           for f in dataclasses.fields(js0)}, side, seed=side)
    js = dataclasses.replace(js0, **{k: jnp.asarray(v) for k, v in fields.items()})
    jcfg = jax_config(js, jb, jc, backend="pallas", **kw)
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(b) for b in jb.boundaries]}
    ts, tb, tc = state_from_numpy(fields, box, dataclasses.asdict(jc), device="cpu")
    assert (tc.kernel_choice, tc.sinc_index) == (choice, n)
    assert len(pe.op_consts(tc)["coeffs"]) == len(pe.op_consts(tc)["dcoeffs"]) == ncoef
    tcfg = make_propagator_config(ts, tb, tc, **kw)
    assert pe.engine_fold(tb, tcfg.nbr) == (geom == "fold")
    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    ranges = pe.group_cell_ranges(tss.x, tss.y, tss.z, tss.h, tkeys, tb, tcfg.nbr)

    s, nbr, ref = jss, jcfg.nbr, {}
    ref["dens"] = jax.jit(lambda x, y, z, h, m, k: pp.pallas_density(
        x, y, z, h, m, k, jb, jc, nbr, interpret=True))(s.x, s.y, s.z, s.h, s.m, jkeys)
    rho = ref["dens"][0]
    ref["iad"] = jax.jit(lambda x, y, z, h, v, k: pp.pallas_iad(
        x, y, z, h, v, k, jb, jc, nbr, interpret=True))(
            s.x, s.y, s.z, s.h, s.m / rho, jkeys)[0]
    p, cs = jax_eos(s.temp, rho, jc)
    ref["mom_std"] = jax.jit(lambda *a: pp.pallas_momentum_energy_std(
        *a, jkeys, jb, jc, nbr, interpret=True))(
            s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, rho, p, cs, *ref["iad"])
    xm, nc, _ = jax.jit(lambda x, y, z, h, m, k: pp.pallas_xmass(
        x, y, z, h, m, k, jb, jc, nbr, interpret=True))(s.x, s.y, s.z, s.h, s.m, jkeys)
    (kx, gradh), _ = jax.jit(lambda x, y, z, h, m, xm_, k: pp.pallas_ve_def_gradh(
        x, y, z, h, m, xm_, k, jb, jc, nbr, interpret=True))(
            s.x, s.y, s.z, s.h, s.m, xm, jkeys)
    prho, c_ve, _, _ = jax_eos_ve(s.temp, s.m, kx, xm, gradh, jc)
    ref.update(xm=xm, nc=nc, kx=kx, gradh=gradh, prho=prho, c=c_ve)
    ref["mom_ve"] = jax.jit(lambda *a, k, n_: pp.pallas_momentum_energy_ve(
        *a, k, jb, jc, nbr, nc=n_, interpret=True))(
            s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, prho, c_ve, kx, xm, s.alpha,
            *ref["iad"], k=jkeys, n_=nc)
    return dict(ref=ref, s=tss, keys=tkeys, box=tb, const=tc, nbr=tcfg.nbr, ranges=ranges)


def _port(c):
    return c["s"], (c["keys"], c["box"], c["const"], c["nbr"]), {"ranges": c["ranges"]}


def test_density(case):
    s, a, kw = _port(case)
    rho_j, nc_j, occ_j = case["ref"]["dens"]
    rho, nc, occ = pe.pallas_density(s.x, s.y, s.z, s.h, s.m, *a, **kw)
    assert int(occ) == int(occ_j)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(nc_j))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=1e-5)


def test_iad(case):
    s, a, kw = _port(case)
    want = case["ref"]["iad"]
    cs, _ = pe.pallas_iad(s.x, s.y, s.z, s.h, s.m / T(case["ref"]["dens"][0]), *a, **kw)
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    for k, (x, y) in enumerate(zip(cs, want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"c{k}")


def test_momentum_energy_std(case):
    s, a, kw = _port(case)
    r = case["ref"]
    rho = T(r["dens"][0])
    p, cs = compute_eos_std(s.temp, rho, case["const"])
    out = pe.pallas_momentum_energy_std(s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, rho, p,
                                        cs, *map(T, r["iad"]), *a, **kw)
    want = r["mom_std"]
    for name, x, y in zip(("ax", "ay", "az", "du"), out[:4], want[:4]):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4,
                                   atol=5e-6 * (np.max(np.abs(y)) + 1e-12), err_msg=name)
    assert float(out[4]) == pytest.approx(float(want[4]), rel=1e-5)


def test_xmass_gradh(case):
    s, a, kw = _port(case)
    r = case["ref"]
    xm, nc, _ = pe.pallas_xmass(s.x, s.y, s.z, s.h, s.m, *a, **kw)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(r["nc"]))
    np.testing.assert_allclose(xm.numpy(), np.asarray(r["xm"]), rtol=1e-5)
    (kx, gradh), _ = pe.pallas_ve_def_gradh(s.x, s.y, s.z, s.h, s.m, T(r["xm"]), *a, **kw)
    np.testing.assert_allclose(kx.numpy(), np.asarray(r["kx"]), rtol=1e-5)
    np.testing.assert_allclose(gradh.numpy(), np.asarray(r["gradh"]), rtol=5e-4, atol=1e-5)
    assert float(np.ptp(np.asarray(r["gradh"]))) > 0


def test_momentum_energy_ve(case):
    s, a, kw = _port(case)
    r = case["ref"]
    prho, c, _, _ = compute_eos_ve(s.temp, s.m, T(r["kx"]), T(r["xm"]), T(r["gradh"]),
                                   case["const"])
    np.testing.assert_allclose(prho.numpy(), np.asarray(r["prho"]), rtol=1e-6)
    out = pe.pallas_momentum_energy_ve(
        s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, T(r["prho"]), T(r["c"]), T(r["kx"]),
        T(r["xm"]), s.alpha, *map(T, r["iad"]), *a, nc=T(r["nc"]), **kw)
    want = r["mom_ve"]
    for name, x, y in zip(("ax", "ay", "az", "du"), out[:4], want[:4]):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=2e-4,
                                   atol=1e-5 * (float(np.max(np.abs(y))) + 1e-12), err_msg=name)
    assert float(out[4]) == pytest.approx(float(want[4]), rel=1e-4)


class _Stop(Exception):
    pass


def _cli_constants(main_module, sim_module, argv, monkeypatch):
    """The SimConstants a CLI hands to its Simulation, which
    ``sim_module.Simulation`` names when the CLI runs (the run stops there)."""
    got = {}

    def capture(state, box, const, *args, **kwargs):
        got["const"] = const
        raise _Stop

    monkeypatch.setattr(sim_module, "Simulation", capture)
    with pytest.raises(_Stop):
        main_module.main(argv)
    return got["const"]


@pytest.mark.parametrize("flags", [["--kernel", "wendland-c6"], ["--sincIndex", "5"],
                                   ["--kernel", "sinc-n1-n2", "--sincIndex", "4"]])
def test_cli_kernel_constants_match_jax(flags, monkeypatch, tmp_path):
    import sphexa_tpu.simulation as jax_sim

    argv = ["--init", "sedov", "-n", "6", "-s", "1", "-o", str(tmp_path), *flags]
    port = _cli_constants(app, app, argv + ["--device", "cpu"], monkeypatch)
    ref = _cli_constants(jax_app, jax_sim, argv, monkeypatch)
    for k in ("kernel_choice", "sinc_index", "kernel_norm"):
        assert getattr(port, k) == getattr(ref, k), k


def test_cli_unknown_kernel(capsys, tmp_path):
    assert app.main(["--init", "sedov", "-n", "6", "-s", "1", "--kernel", "cubic",
                     "-o", str(tmp_path), "--device", "cpu"]) == 2
    assert "unknown --kernel 'cubic'" in capsys.readouterr().err
    assert jax_app.main(["--init", "sedov", "-n", "6", "-s", "1", "--kernel", "cubic",
                         "-o", str(tmp_path)]) == 2


def test_cuda_op_form_of_every_fit():
    """The EngineArgs form: 14 or 20 coefficients, nothing else."""
    from sphexa_torch.sph.kernels import kernel_dterh_coeffs, kernel_poly_coeffs

    for choice, n, ncoef in KINDS.values():
        arr = pe._coeff_array(kernel_poly_coeffs(n, choice))
        assert len(arr) == max(pe.KERNEL_NCOEFS) and ncoef in pe.KERNEL_NCOEFS
        assert list(arr)[ncoef:] == [0.0] * (len(arr) - ncoef)
        assert len(kernel_dterh_coeffs(n, choice)) == ncoef
    with pytest.raises(ValueError, match="14 or 20"):
        pe._coeff_array(tuple(range(16)))
