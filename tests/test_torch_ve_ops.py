"""The port's VE pair ops (plain PyTorch versions, as the wrappers run them
on CPU tensors) against the JAX package's Pallas ops in interpret mode.

Streaming: jittered Sedov side 12 (the min-image fold path) and side 24
with cell_target=16 (per-run shifts). List mode: jittered Sedov side 30
and Noh 16 (open box), both packages on their own lists of the same
frozen state (equal bit for bit, tests/test_torch_pair_lists.py). Both
forms of divv/curlv (with and without gradv) and of the momentum op
(with and without av_clean) run. Every op of the port gets the JAX
package's inputs, so that errors do not compound along the chain.

Tolerances are the JAX package's own. Streaming
(tests/test_pallas_interpret.py, its VE pipeline): nc exact; xm and kx
rtol 1e-5; gradh rtol 5e-4 / atol 1e-5; divv, curlv and gradv rtol 1e-4
/ atol 1e-5 x max|divv| (a scale, not the lattice's absolute 5e-4: the
inputs are jittered); alpha rtol 1e-4 / atol 1e-6; a and du rtol 2e-4 /
atol 1e-5 x max|.|; min dt rel 1e-4. List mode (tests/test_pair_lists.py,
its VE list test): xm rtol 2e-6, kx rtol 2e-5, gradh rtol 2e-4 / atol
2e-6, the rest as streaming."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp
from sphexa_tpu.sph.hydro_ve import compute_eos_ve as jax_eos_ve

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import jitter_sedov
from sphexa_torch.propagator import _sort_by_keys, rebuild_pair_lists
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
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


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _jitter(js, side):
    """The port's seeded lattice perturbation of a JAX Sedov state: both
    packages get the same numpy inputs."""
    out = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    return dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in
                                      jitter_sedov(out, side, seed=side).items()})


def _jax_chain(s, keys, box, const, nbr, lists=None):
    """The JAX package's VE ops in interpret mode, each on the previous
    op's outputs; both divv/curlv forms and both momentum forms."""
    out = {}
    xm, nc, occ = jax.jit(lambda x, y, z, h, m, k, li: pp.pallas_xmass(
        x, y, z, h, m, k, box, const, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, s.m, keys, lists)
    out.update(xm=xm, nc=nc, occ=occ)
    (kx, gradh), _ = jax.jit(lambda x, y, z, h, m, xm_, k, li: pp.pallas_ve_def_gradh(
        x, y, z, h, m, xm_, k, box, const, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, s.m, xm, keys, lists)
    out.update(kx=kx, gradh=gradh)
    prho, c, rho, p = jax_eos_ve(s.temp, s.m, kx, xm, gradh, const)
    out.update(prho=prho, c=c)
    cs, _ = jax.jit(lambda x, y, z, h, v, k, li: pp.pallas_iad(
        x, y, z, h, v, k, box, const, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, xm / kx, keys, lists)
    out["cs"] = cs
    vel = (s.vx, s.vy, s.vz)
    for gradv in (False, True):
        out[f"dv{int(gradv)}"] = jax.jit(lambda *a, k, li: pp.pallas_iad_divv_curlv(
            *a, k, box, const, nbr, with_gradv=gradv, interpret=True, lists=li)[0])(
                s.x, s.y, s.z, *vel, s.h, kx, xm, *cs, k=keys, li=lists)
    divv = out["dv0"][0]
    out["alpha"] = jax.jit(lambda *a, k, dt, li: pp.pallas_av_switches(
        *a, k, box, dt, const, nbr, interpret=True, lists=li)[0])(
            s.x, s.y, s.z, *vel, s.h, c, kx, xm, divv, s.alpha, *cs, k=keys,
            dt=s.min_dt, li=lists)
    for av_clean in (False, True):
        gv = tuple(out["dv1"][2:]) if av_clean else None
        out[f"mom{int(av_clean)}"] = jax.jit(lambda *a, k, n, g, li: pp.pallas_momentum_energy_ve(
            *a, k, box, const, nbr, nc=n, gradv=g, interpret=True, lists=li))(
                s.x, s.y, s.z, *vel, s.h, s.m, prho, c, kx, xm, out["alpha"], *cs,
                k=keys, n=nc, g=gv, li=lists)
    return out


CASES = {"fold": (12, {}), "shift": (24, {"cell_target": 16})}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Streaming: both packages' sorted states and configs, the port's
    candidate runs, and the JAX package's VE chain."""
    side, kw = CASES[request.param]
    js0, jb, jc = jax_init_sedov(side)
    js = _jitter(js0, side)
    jcfg = jax_config(js, jb, jc, backend="pallas", **kw)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, **kw)
    assert pe.engine_fold(tb, tcfg.nbr) == (request.param == "fold")
    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    ranges = pe.group_cell_ranges(tss.x, tss.y, tss.z, tss.h, tkeys, tb, tcfg.nbr)
    ref = _jax_chain(jss, jkeys, jb, jc, jcfg.nbr)
    return dict(ref=ref, s=tss, keys=tkeys, box=tb, const=tc, nbr=tcfg.nbr,
                kw={"ranges": ranges}, lists=False)


LIST_CASES = {"sedov": (jax_init_sedov, 30), "noh": (jax_init_noh, 16)}


@pytest.fixture(scope="module", params=list(LIST_CASES))
def list_case(request):
    """List mode: both packages' frozen states and lists from the same
    state, and the JAX package's list-mode VE chain."""
    init, side = LIST_CASES[request.param]
    js, jb, jc = init(side)
    if request.param == "sedov":
        js = _jitter(js, side)
    jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True)
    jss, jbb, jl, _ = jax_rebuild(js, jb, jcfg)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, use_lists=True)
    assert tcfg.list_slot_cap == jcfg.list_slot_cap > 0
    tss, tbb, tl = rebuild_pair_lists(ts, tb, tcfg)
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    ref = _jax_chain(jss, None, jbb, jc, jcfg.nbr, lists=jl)
    return dict(ref=ref, s=tss, keys=None, box=tbb, const=tc, nbr=tcfg.nbr,
                kw={"lists": tl}, lists=True)


def _check_xmass_gradh(c):
    r, s = c["ref"], c["s"]
    xm, nc, occ = pe.pallas_xmass(s.x, s.y, s.z, s.h, s.m, c["keys"], c["box"], c["const"],
                                  c["nbr"], **c["kw"])
    np.testing.assert_array_equal(nc.numpy(), np.asarray(r["nc"]))
    assert int(occ) == int(r["occ"])
    np.testing.assert_allclose(xm.numpy(), np.asarray(r["xm"]), rtol=2e-6 if c["lists"] else 1e-5)
    (kx, gradh), _ = pe.pallas_ve_def_gradh(s.x, s.y, s.z, s.h, s.m, T(r["xm"]), c["keys"],
                                            c["box"], c["const"], c["nbr"], **c["kw"])
    np.testing.assert_allclose(kx.numpy(), np.asarray(r["kx"]), rtol=2e-5 if c["lists"] else 1e-5)
    rtol, atol = (2e-4, 2e-6) if c["lists"] else (5e-4, 1e-5)
    np.testing.assert_allclose(gradh.numpy(), np.asarray(r["gradh"]), rtol=rtol, atol=atol)
    assert float(np.ptp(np.asarray(r["gradh"]))) > 0


def _check_divv_curlv(c, gradv):
    r, s = c["ref"], c["s"]
    out, _ = pe.pallas_iad_divv_curlv(
        s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, T(r["kx"]), T(r["xm"]), *map(T, r["cs"]),
        c["keys"], c["box"], c["const"], c["nbr"], with_gradv=gradv, **c["kw"])
    want = r[f"dv{int(gradv)}"]
    assert len(out) == len(want) == (8 if gradv else 2)
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    assert scale > 0
    for k, (a, b) in enumerate(zip(out, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"output {k}")


def _check_av_switches(c):
    r, s = c["ref"], c["s"]
    alpha, _ = pe.pallas_av_switches(
        s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, T(r["c"]), T(r["kx"]), T(r["xm"]),
        T(r["dv0"][0]), s.alpha, *map(T, r["cs"]), c["keys"], c["box"], s.min_dt,
        c["const"], c["nbr"], **c["kw"])
    want = np.asarray(r["alpha"])
    np.testing.assert_allclose(alpha.numpy(), want, rtol=1e-4, atol=1e-6)
    # the switch moved: some particles rose to alphaloc, others decayed
    assert np.any(want > float(c["const"].alphamin)) and np.any(want != want[0])


def _check_momentum_energy(c, av_clean):
    r, s = c["ref"], c["s"]
    gradv = tuple(map(T, r["dv1"][2:])) if av_clean else None
    out = pe.pallas_momentum_energy_ve(
        s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, T(r["prho"]), T(r["c"]), T(r["kx"]),
        T(r["xm"]), T(r["alpha"]), *map(T, r["cs"]), c["keys"], c["box"], c["const"],
        c["nbr"], nc=T(r["nc"]), gradv=gradv, **c["kw"])
    want = r[f"mom{int(av_clean)}"]
    for name, a, b in zip(("ax", "ay", "az", "du"), out[:4], want[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4,
                                   atol=1e-5 * (float(np.max(np.abs(b))) + 1e-12), err_msg=name)
    assert float(out[4]) == pytest.approx(float(want[4]), rel=1e-4)
    assert int(out[5]) == int(want[5])


def test_xmass_gradh(case):
    _check_xmass_gradh(case)


@pytest.mark.parametrize("gradv", [False, True], ids=["divv", "gradv"])
def test_divv_curlv(case, gradv):
    _check_divv_curlv(case, gradv)


def test_av_switches(case):
    _check_av_switches(case)


@pytest.mark.parametrize("av_clean", [False, True], ids=["plain", "avclean"])
def test_momentum_energy_ve(case, av_clean):
    _check_momentum_energy(case, av_clean)


def test_xmass_gradh_lists(list_case):
    _check_xmass_gradh(list_case)


@pytest.mark.parametrize("gradv", [False, True], ids=["divv", "gradv"])
def test_divv_curlv_lists(list_case, gradv):
    _check_divv_curlv(list_case, gradv)


def test_av_switches_lists(list_case):
    _check_av_switches(list_case)


@pytest.mark.parametrize("av_clean", [False, True], ids=["plain", "avclean"])
def test_momentum_energy_ve_lists(list_case, av_clean):
    _check_momentum_energy(list_case, av_clean)


def test_dterh_fit_and_eos():
    """The analytic grad-h polynomial and the VE EOS equal the JAX
    package's; the wrappers count no launch on CPU tensors."""
    from sphexa_tpu.sph import kernels as jk

    from sphexa_torch.sph import kernels as tk
    from sphexa_torch.sph.particles import SimConstants

    assert tk.kernel_dterh_coeffs(6.0, "sinc") == jk.kernel_dterh_coeffs(6.0, "sinc")
    u = np.linspace(0.0, 4.5, 4001).astype(np.float32)
    dc = jk.kernel_dterh_coeffs(6.0, "sinc")
    np.testing.assert_allclose(tk.dterh_poly_eval(T(u), dc).numpy(),
                               np.asarray(jk.dterh_poly_eval(jnp.asarray(u), dc)),
                               rtol=1e-6, atol=1e-6)
    assert float(tk.dterh_poly_eval(torch.zeros(1), dc)) == pytest.approx(-3.0, abs=1e-5)
    rng = np.random.default_rng(4)
    f = lambda lo, hi: rng.uniform(lo, hi, 3000).astype(np.float32)  # noqa: E731
    temp, m, kx, xm, gradh = f(1e-9, 1e-5), f(1e-6, 2e-6), f(0.5, 2.0), f(1e-6, 2e-6), f(0.8, 1.2)
    from sphexa_tpu.sph.particles import SimConstants as JConst

    ct, cj = SimConstants().normalized(), JConst().normalized()
    assert ct.ramp == cj.ramp
    for a, b in zip(compute_eos_ve(*map(T, (temp, m, kx, xm, gradh)), ct),
                    jax_eos_ve(*map(jnp.asarray, (temp, m, kx, xm, gradh)), cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6)


def test_eta_crit_matches_jax():
    """The av_clean momentum op's eta_crit = cbrt(32 pi/3/(nc+1)) equals
    the JAX package's (pallas_pairs.py, ``jnp.cbrt`` of a float32
    quotient) bit for bit over the neighbour counts a run sees."""
    nc = np.arange(0, 2000, dtype=np.int32)
    ones = [torch.ones(len(nc))] * 19
    i_f, _ = pe.momentum_ve_fields(*ones, nc=torch.from_numpy(nc),
                                   gradv=[torch.zeros(len(nc))] * 6)
    want = jnp.cbrt(32.0 * np.pi / 3.0 / (jnp.asarray(nc).astype(jnp.float32) + 1.0))
    np.testing.assert_array_equal(i_f[23].numpy(), np.asarray(want))
