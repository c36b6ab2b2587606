"""The port's three pair ops (plain PyTorch versions, as the wrappers run
them on CPU tensors) against the JAX package's Pallas ops in interpret
mode, on the fold case (Sedov side 12) and the shift case (side 24,
cell_target=16). Positions, h and velocities are jittered from a seed so
that every term of the pair math (IAD off-diagonals, the viscosity) is
non-zero. Tolerances are the JAX package's own for its Pallas-vs-XLA
check (tests/test_pallas_interpret.py): nc exact, rho rtol 1e-5, IAD
rtol 1e-4 / atol 1e-5 max|c11|, accelerations and du rtol 1e-4 / atol
5e-6 max|.|, min dt rel 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp
from sphexa_tpu.sph.hydro_std import compute_eos_std as jax_eos

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import jitter_sedov
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = {"fold": (12, {}), "shift": (24, {"cell_target": 16})}


def _jitter(js, side, seed):
    """The port's seeded lattice perturbation, applied to the JAX state's
    fields so that both packages get the same numpy inputs."""
    out = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    return jitter_sedov(out, side, seed)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    side, kw = CASES[request.param]
    js0, jb, jc = jax_init_sedov(side)
    fields = _jitter(js0, side, seed=side)
    js = dataclasses.replace(js0, **{k: jnp.asarray(v) for k, v in fields.items()})
    jcfg = jax_config(js, jb, jc, backend="pallas", **kw)
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(b) for b in jb.boundaries]}
    ts, tb, tc = state_from_numpy(fields, box, dataclasses.asdict(jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, **kw)
    # every field the port reads equals the JAX package's
    assert dataclasses.asdict(tcfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    assert pe.engine_fold(tb, tcfg.nbr) == (request.param == "fold")
    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    ranges = pe.group_cell_ranges(tss.x, tss.y, tss.z, tss.h, tkeys, tb, tcfg.nbr)
    # the JAX reference's density and IAD, computed once per case
    s, nbr = jss, jcfg.nbr
    dens = jax.jit(lambda x, y, z, h, m, k: pp.pallas_density(
        x, y, z, h, m, k, jb, jc, nbr, interpret=True))(s.x, s.y, s.z, s.h, s.m, jkeys)
    iad = jax.jit(lambda x, y, z, h, v, k: pp.pallas_iad(
        x, y, z, h, v, k, jb, jc, nbr, interpret=True))(
            s.x, s.y, s.z, s.h, s.m / dens[0], jkeys)[0]
    return dict(jss=jss, jkeys=jkeys, jb=jb, jc=jc, jnbr=nbr, jdens=dens, jiad=iad,
                tss=tss, tkeys=tkeys, tb=tb, tc=tc, tnbr=tcfg.nbr, ranges=ranges)


def test_density(case):
    c = case
    rho_j, nc_j, occ_j = c["jdens"]
    s = c["tss"]
    rho_t, nc_t, occ_t = pe.pallas_density(s.x, s.y, s.z, s.h, s.m, c["tkeys"], c["tb"],
                                           c["tc"], c["tnbr"], ranges=c["ranges"])
    assert int(occ_t) == int(occ_j)
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_j))
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-5)


def test_iad(case):
    c = case
    rho, cs_j = c["jdens"][0], c["jiad"]
    t = c["tss"]
    vol = t.m / torch.tensor(np.array(rho))
    cs_t, _ = pe.pallas_iad(t.x, t.y, t.z, t.h, vol, c["tkeys"], c["tb"], c["tc"],
                            c["tnbr"], ranges=c["ranges"])
    scale = float(np.max(np.abs(np.asarray(cs_j[0]))))
    for k, (a, b) in enumerate(zip(cs_t, cs_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=f"c{k}")


def test_momentum_energy(case):
    c = case
    rho, iad = c["jdens"][0], c["jiad"]
    s = c["jss"]
    p, cs = jax_eos(s.temp, rho, c["jc"])
    g = jax.jit(lambda *a: pp.pallas_momentum_energy_std(
        *a, c["jkeys"], c["jb"], c["jc"], c["jnbr"], interpret=True))
    out_j = g(s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, rho, p, cs, *iad)

    t = c["tss"]
    T = lambda a: torch.tensor(np.array(a))  # noqa: E731
    trho = T(rho)
    tp, tcs = compute_eos_std(t.temp, trho, c["tc"])
    out_t = pe.pallas_momentum_energy_std(
        t.x, t.y, t.z, t.vx, t.vy, t.vz, t.h, t.m, trho, tp, tcs,
        *[T(a) for a in iad], c["tkeys"], c["tb"], c["tc"], c["tnbr"],
        ranges=c["ranges"])
    for name, a, b in zip(("ax", "ay", "az", "du"), out_t[:4], out_j[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=5e-6 * (np.max(np.abs(b)) + 1e-12), err_msg=name)
    assert float(out_t[4]) == pytest.approx(float(out_j[4]), rel=1e-5)
    assert int(out_t[5]) == int(out_j[5])


def test_wrappers_count_only_kernel_launches(case):
    """CPU tensors take the plain version: no kernel launch is counted."""
    c = case
    s = c["tss"]
    pe.reset_launches()
    pe.pallas_density(s.x, s.y, s.z, s.h, s.m, c["tkeys"], c["tb"], c["tc"],
                      c["tnbr"], ranges=c["ranges"])
    assert set(pe.LAUNCHES.values()) == {0}
