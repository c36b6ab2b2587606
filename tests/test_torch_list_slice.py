"""The port's list-mode slice against the JAX package's, on the CPU (the
port's plain versions, the JAX package's Pallas kernels in interpret
mode): the three pair ops with ``lists=``, stale lists after a drift
below half the skin, three list-mode steps, and the list-mode
``Simulation`` with its rebuilds. Cases: Sedov 24^3 with cell_target=16
(periodic, per-run shifts) and Noh 16 (open box; its inflow makes the
viscosity and energy terms non-zero).

Tolerances are the JAX package's own for list mode against streaming
(tests/test_pair_lists.py): nc exact, rho rtol 2e-6, IAD rtol 2e-5 /
atol 1e-6 x max|c|, accelerations rtol 1e-4 / atol 1e-5 x max|a|, du
rtol 1e-4 / atol 1e-6 x max|du|, min dt rtol 1e-5; the summation order
differs between the packages as it does between the JAX engines. Whole
steps carry the accelerations' tolerance through the integrator (rtol
1e-4, atol 5e-6 x max|.|, as tests/test_torch_slice.py; for temp_lo, the
low word of temp's two-sum carry, max|temp|)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.propagator import step_hydro_std as jax_step
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp
from sphexa_tpu.sph.hydro_std import compute_eos_std as jax_eos

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_noh
from sphexa_torch.propagator import _sort_by_keys, _step_hydro_std, rebuild_pair_lists
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.pair_lists import lists_valid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = {"noh": (jax_init_noh, 16, {}), "sedov": (jax_init_sedov, 24, {"cell_target": 16})}


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def T(a):
    return torch.tensor(np.array(a))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' configs, frozen sorted states and lists from the same
    initial state, and the JAX package's list-mode ops on them."""
    init, side, kw = CASES[request.param]
    js, jb, jc = init(side)
    jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True, **kw)
    jss, jbb, jl, _ = jax_rebuild(js, jb, jcfg)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, use_lists=True, **kw)
    tss, tbb, tl = rebuild_pair_lists(ts, tb, tcfg)
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))

    s, nbr = jss, jcfg.nbr
    dens = jax.jit(lambda x, y, z, h, m, lists: pp.pallas_density(
        x, y, z, h, m, None, jbb, jc, nbr, interpret=True, lists=lists))(
            s.x, s.y, s.z, s.h, s.m, jl)
    rho = dens[0]
    iad = jax.jit(lambda x, y, z, h, v, lists: pp.pallas_iad(
        x, y, z, h, v, None, jbb, jc, nbr, interpret=True, lists=lists))(
            s.x, s.y, s.z, s.h, s.m / rho, jl)[0]
    p, c = jax_eos(s.temp, rho, jc)
    mom = jax.jit(lambda *a, lists: pp.pallas_momentum_energy_std(
        *a, None, jbb, jc, nbr, interpret=True, lists=lists))(
            s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, rho, p, c, *iad, lists=jl)
    return dict(jss=jss, jbb=jbb, jc=jc, jcfg=jcfg, jl=jl, jdens=dens, jiad=iad,
                jp=p, jcs=c, jmom=mom, tss=tss, tbb=tbb, tc=tc, tcfg=tcfg, tl=tl)


def test_density_lists(case):
    c = case
    s = c["tss"]
    rho, nc, occ = pe.pallas_density(s.x, s.y, s.z, s.h, s.m, None, c["tbb"], c["tc"],
                                     c["tcfg"].nbr, lists=c["tl"])
    rho_j, nc_j, occ_j = c["jdens"]
    np.testing.assert_array_equal(nc.numpy(), np.asarray(nc_j))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=2e-6)
    assert int(occ) == int(occ_j)


def test_iad_lists(case):
    c = case
    s = c["tss"]
    vol = s.m / T(c["jdens"][0])
    cs, _ = pe.pallas_iad(s.x, s.y, s.z, s.h, vol, None, c["tbb"], c["tc"],
                          c["tcfg"].nbr, lists=c["tl"])
    csc = max(float(np.abs(np.asarray(b)).max()) for b in c["jiad"])
    for k, (a, b) in enumerate(zip(cs, c["jiad"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6 * csc,
                                   err_msg=f"c{k}")


def test_momentum_energy_lists(case):
    """The list walk (plain version) against the JAX package's list-walk
    engine, on the JAX package's density and IAD."""
    c = case
    s = c["tss"]
    out = pe.pallas_momentum_energy_std(
        s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, s.m, T(c["jdens"][0]), T(c["jp"]),
        T(c["jcs"]), *[T(a) for a in c["jiad"]], None, c["tbb"], c["tc"],
        c["tcfg"].nbr, lists=c["tl"])
    ax_j, ay_j, az_j, du_j, dt_j, occ_j = c["jmom"]
    scale = float(np.max(np.abs(np.asarray(ax_j))))
    assert scale > 0
    for nm, a, b in zip(("ax", "ay", "az"), out[:3], (ax_j, ay_j, az_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=nm)
    du_s = float(np.max(np.abs(np.asarray(du_j))))
    np.testing.assert_allclose(out[3].numpy(), np.asarray(du_j), rtol=1e-4, atol=1e-6 * du_s)
    assert float(out[4]) == pytest.approx(float(dt_j), rel=1e-5)
    assert int(out[5]) == int(occ_j)


def test_stale_lists_cover_drift(case):
    """The Verlet contract: after a drift below half the skin the stale
    lists give the density of a fresh streaming pass (new sort, new runs)
    on the moved positions."""
    c = case
    s, box, cfg, lists = c["tss"], c["tbb"], c["tcfg"], c["tl"]
    skin = float(lists.skin)
    rng = np.random.RandomState(3)
    amp = 0.45 * skin / np.sqrt(3.0)
    moved = dataclasses.replace(s, **{
        f: getattr(s, f) + torch.from_numpy(rng.uniform(-amp, amp, s.n).astype(np.float32))
        for f in ("x", "y", "z")})
    assert bool(lists_valid(moved.x, moved.y, moved.z, moved.h, lists))
    rho1, nc1, _ = pe.pallas_density(moved.x, moved.y, moved.z, moved.h, moved.m, None,
                                     box, c["tc"], cfg.nbr, lists=lists)
    fresh, keys, order = _sort_by_keys(moved, box, cfg.curve)
    rho0, nc0, _ = pe.pallas_density(fresh.x, fresh.y, fresh.z, fresh.h, fresh.m, keys,
                                     box, c["tc"], cfg.nbr)
    inv = torch.argsort(order)
    np.testing.assert_array_equal(nc1.numpy(), nc0[inv].numpy())
    np.testing.assert_allclose(rho1.numpy(), rho0[inv].numpy(), rtol=2e-5)


def test_three_list_steps_match_jax(case):
    """Three steady list-mode steps of each package from the same input
    state and the same lists (equal bit for bit, test_torch_pair_lists.py)."""
    c = case
    js, jb, jcfg, jl = c["jss"], c["jbb"], c["jcfg"], c["jl"]
    tcfg, tl = c["tcfg"], c["tl"]
    for it in range(3):
        ts, tb, _ = state_from_numpy(*_flat(js, jb, c["jc"]), device="cpu")
        jn, jb, jd = jax_step(js, jb, jcfg, lists=jl)
        tn, _, td = _step_hydro_std(ts, tb, tcfg, lists=tl)
        for k in ("nc_max", "occupancy", "list_ok", "dt_limiter"):
            assert float(td[k]) == float(jd[k]), (it, k)
        # an exact integer sum over n, divided in float32: the JAX package's
        # mean may round its division differently (1 ulp)
        assert float(td["nc_mean"]) == pytest.approx(float(jd["nc_mean"]), rel=1e-6)
        assert float(td["list_slack"]) == pytest.approx(float(jd["list_slack"]), rel=1e-6)
        assert float(td["dt"]) == pytest.approx(float(jd["dt"]), rel=1e-6)
        out, _, _ = state_to_numpy(tn, tb, c["tc"])
        for f in dataclasses.fields(jn):
            a, b = out[f.name], np.asarray(getattr(jn, f.name))
            if f.name == "h":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
                continue
            # temp_lo is the rounding residue of the two-sum temp update:
            # its scale is temp's
            ref = np.asarray(jn.temp) if f.name == "temp_lo" else b
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                       err_msg=f"step {it} {f.name}")
        js = jn


def test_simulation_list_mode_matches_jax():
    """Noh 14, four steps: the port's list-mode Simulation against the JAX
    package's (pallas, use_lists, check_every=1), per-particle fields
    compared order-insensitively (each freezes its own order between
    rebuilds), as the JAX package's list-vs-streaming test does."""
    js, jb, jc = jax_init_noh(14)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas", use_lists=True,
                         check_every=1)
    for _ in range(4):
        jsim.step()
    jsim.flush()
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu")
    diags = [sim.step() for _ in range(4)]
    assert sim.lists is not None and jsim._lists is not None
    assert sim.cfg.list_slot_cap == jsim._cfg.list_slot_cap > 0
    assert all(d["use_lists"] == 1.0 and "list_slack" in d for d in diags)
    s0, s1 = jsim.state, sim.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("temp", 1e-4), ("vx", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)


def test_simulation_rebuilds_on_expiry():
    """A skin of 0.05 x 2 h cannot survive 12 Noh steps: the Simulation
    rebuilds (proactively or by discarding a step) and keeps stepping."""
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu", list_skin_rel=0.05)
    diags = [sim.step() for _ in range(12)]
    assert sim.lists is not None
    assert sim.rebuilds >= 2, sim.rebuilds
    assert all("list_slack" in d for d in diags)
    assert np.isfinite(float(sim.state.ttot)) and float(sim.state.ttot) > 0
    for f in ("x", "vx", "h", "temp"):
        assert bool(torch.isfinite(getattr(sim.state, f)).all()), f


def test_use_lists_false_streams():
    """``use_lists=False`` runs the streaming step: no lists, no list
    diagnostics, and the config of the streaming sizing."""
    state, box, const = init_noh(14, device="cpu")
    sim = Simulation(state, box, const, device="cpu", use_lists=False)
    d = sim.step()
    assert sim.lists is None and sim.rebuilds == 0 and sim.cfg.list_slot_cap == 0
    assert d["use_lists"] == 0.0 and "list_slack" not in d
    assert sim.cfg.nbr == make_propagator_config(state, box, const).nbr


def test_stale_lists_discard_and_replay():
    """A step whose input the lists no longer cover (one particle moved by
    a whole skin) is discarded, the lists are rebuilt without a re-size,
    and the step is replayed on them."""
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu")
    sim.step()
    cfg, builds, replays = sim.cfg, sim.rebuilds, sim.replays
    x = sim.state.x.clone()
    x[0] += sim.lists.skin
    sim.state = dataclasses.replace(sim.state, x=x)
    d = sim.step()
    assert sim.replays == replays + 1 and sim.rebuilds > builds
    assert sim.reconfigures == 0 and sim.cfg == cfg
    assert d["list_ok"] == 1.0 and d["list_slack"] > 0.0


def test_slot_overflow_grows_margin_and_resizes():
    """A list build that overflows its slot budget grows the slot margin
    1.5x, re-sizes the config and builds again."""
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu")
    good = sim.cfg
    sim._cfg = dataclasses.replace(good, list_slot_cap=2)
    d = sim.step()
    assert sim.rebuilds == 2 and sim.reconfigures == 1
    assert sim.cfg.list_slot_cap >= good.list_slot_cap
    assert sim.lists is not None and int(sim.lists.overflow) == 0
    assert d["use_lists"] == 1.0
