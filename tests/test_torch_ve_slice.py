"""The port's VE step against the JAX package's, on the CPU (the port's
plain versions, the JAX package's Pallas kernels in interpret mode):
three steps of ``_step_hydro_ve`` from the same state (and the same
lists) as ``sphexa_tpu.propagator.step_hydro_ve``, in list mode on Noh 16
and streaming on Sedov 12 (the fold path); one av_clean step; and the
list-mode ``Simulation(prop="ve")`` on Noh 14 against the JAX package's.

Tolerances: whole steps carry the VE ops' tolerance (rtol 2e-4 / atol
1e-5 x max|a|, tests/test_pallas_interpret.py) through the integrator:
per-particle fields rtol 2e-4 / atol 5e-6 x max|.| (for temp_lo, the low
word of temp's two-sum carry, max|temp|), h rtol 1e-6, dt and the mean
neighbour count rel 1e-6, integer diagnostics exact. The Simulations
compare sorted fields (each freezes its own order between rebuilds), as
tests/test_torch_list_slice.py does: x 2e-6, temp, vx and alpha 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.propagator import step_hydro_ve as jax_step
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_noh
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import _step_hydro_ve, rebuild_pair_lists
from sphexa_torch.simulation import Simulation, make_propagator_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _compare_step(it, td, jd, tn, jn, tb, const, list_mode):
    keys = ("nc_max", "occupancy", "dt_limiter") + (("list_ok",) if list_mode else ())
    for k in keys:
        assert float(td[k]) == float(jd[k]), (it, k)
    assert float(td["nc_mean"]) == pytest.approx(float(jd["nc_mean"]), rel=1e-6)
    assert float(td["dt"]) == pytest.approx(float(jd["dt"]), rel=1e-6)
    if list_mode:
        assert float(td["list_slack"]) == pytest.approx(float(jd["list_slack"]), rel=1e-6)
    out, _, _ = state_to_numpy(tn, tb, const)
    for f in dataclasses.fields(jn):
        a, b = out[f.name], np.asarray(getattr(jn, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
            continue
        ref = np.asarray(jn.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f"step {it} {f.name}")


def _run_steps(js, jb, jc, jcfg, tcfg, steps, jl=None, tl=None):
    """``steps`` steps of each package, each from the JAX package's input
    state; returns the last pair of states."""
    for it in range(steps):
        ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        jn, jb, jd = jax_step(js, jb, jcfg, lists=jl)
        tn, tb, td = _step_hydro_ve(ts, tb, tcfg, lists=tl)
        _compare_step(it, td, jd, tn, jn, tb, tc, tl is not None)
        js = jn
    return tn, jn


@pytest.fixture(scope="module")
def noh_lists():
    """Both packages' list-mode configs, frozen states and lists of Noh 16
    (equal bit for bit, tests/test_torch_pair_lists.py)."""
    js, jb, jc = jax_init_noh(16)
    out = {}
    for av_clean in (False, True):
        jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True, av_clean=av_clean)
        ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        tcfg = dataclasses.replace(make_propagator_config(ts, tb, tc, use_lists=True),
                                   av_clean=av_clean)
        assert tcfg.list_slot_cap == jcfg.list_slot_cap > 0
        out[av_clean] = (jcfg, tcfg)
    jcfg, tcfg = out[False]
    jss, jbb, jl, _ = jax_rebuild(js, jb, jcfg)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tss, _, tl = rebuild_pair_lists(ts, tb, tcfg)
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    return dict(jss=jss, jbb=jbb, jc=jc, jl=jl, tl=tl, cfgs=out)


def test_three_list_steps_match_jax(noh_lists):
    """Three steady list-mode VE steps of each package from the same input
    state and the same lists."""
    c = noh_lists
    jcfg, tcfg = c["cfgs"][False]
    tn, jn = _run_steps(c["jss"], c["jbb"], c["jc"], jcfg, tcfg, 3, c["jl"], c["tl"])
    # the AV switches moved alpha off its initial value
    assert np.any(np.asarray(jn.alpha) != np.asarray(c["jss"].alpha))


def test_av_clean_step_matches_jax(noh_lists):
    """One list-mode step with av_clean (divv/curlv with gradv, the
    velocity-gradient correction in the momentum op)."""
    c = noh_lists
    jcfg, tcfg = c["cfgs"][True]
    assert tcfg.av_clean and jcfg.av_clean
    _run_steps(c["jss"], c["jbb"], c["jc"], jcfg, tcfg, 1, c["jl"], c["tl"])


def test_three_streaming_steps_match_jax():
    """Three streaming VE steps on Sedov 12, whose grid is in fold mode."""
    js, jb, jc = jax_init_sedov(12)
    jcfg = jax_config(js, jb, jc, backend="pallas")
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc)
    _run_steps(js, jb, jc, jcfg, tcfg, 3)


def test_simulation_ve_list_mode_matches_jax():
    """Noh 14, four steps: the port's list-mode Simulation(prop="ve")
    against the JAX package's (pallas, use_lists, check_every=1), the
    fields compared order-insensitively."""
    js, jb, jc = jax_init_noh(14)
    jsim = JaxSimulation(js, jb, jc, prop="ve", backend="pallas", use_lists=True,
                         check_every=1)
    for _ in range(4):
        jsim.step()
    jsim.flush()
    sim = Simulation(*init_noh(14, device="cpu"), prop="ve", device="cpu",
                     obs_spec=ObservableSpec())
    diags = [sim.step() for _ in range(4)]
    assert sim.lists is not None and jsim._lists is not None
    assert sim.cfg.list_slot_cap == jsim._cfg.list_slot_cap > 0
    assert all(d["use_lists"] == 1.0 and "list_slack" in d for d in diags)
    s0, s1 = jsim.state, sim.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("temp", 1e-4), ("vx", 1e-4), ("alpha", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)
    assert sim.energy_drift is not None and abs(sim.energy_drift) < 1e-3
