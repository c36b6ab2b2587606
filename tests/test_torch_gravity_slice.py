"""The port's std and VE steps with self-gravity against the JAX
package's, on the CPU (the port's plain versions, the JAX package's
Pallas kernels in interpret mode): three steps of each propagator on
Evrard 16 from the same input state and on the same tree (the JAX
package's, through ``convert.tree_from_numpy``); two steps of
``Simulation(prop="ve")`` on Evrard 14 against the JAX package's; a
periodic box with gravity refused.

Tolerances: tests/test_torch_ve_slice.py's for the fields (rtol 2e-4 /
atol 5e-6 x max|.|, h rtol 1e-6), egrav and dt rel 1e-4 (the
acceleration condition reads the gravity solve's max |a|), the mean
neighbour count rel 1e-6, the integer diagnostics (neighbour and
interaction-list high waters, the dt limiter) exact."""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.propagator import step_hydro_std as jax_step_std
from sphexa_tpu.propagator import step_hydro_ve as jax_step_ve
from sphexa_tpu.simulation import Simulation as JaxSimulation

from sphexa_torch.convert import state_from_numpy, state_to_numpy, tree_from_numpy
from sphexa_torch.gravity.traversal import GravityConfig
from sphexa_torch.init import init_evrard, init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import _step_hydro_std, _step_hydro_ve
from sphexa_torch.simulation import Simulation, make_propagator_config

INT_DIAGS = ("nc_max", "occupancy", "dt_limiter", "m2p_max", "p2p_max", "leaf_occ", "c_max")


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


@pytest.fixture(scope="module")
def evrard16():
    """Evrard 16: the JAX Simulation's configuration (pallas backend, so
    the engine near field) and gravity tree, and the port's configuration
    carrying the same caps on the same tree."""
    js, jb, jc = jax_init_evrard(16)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas", check_every=1)
    jcfg, jtree = jsim._cfg, jsim._gtree
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    meta = jcfg.grav_meta
    tree, tmeta = tree_from_numpy(
        {f.name: np.asarray(getattr(jtree, f.name)) for f in dataclasses.fields(jtree)},
        {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
         "level_ranges": meta.level_ranges}, device="cpu")
    gcfg = GravityConfig(**{f.name: getattr(jcfg.gravity, f.name)
                            for f in dataclasses.fields(GravityConfig)})
    tcfg = dataclasses.replace(make_propagator_config(ts, tb, tc), gravity=gcfg,
                               grav_meta=tmeta)
    for k in ("level", "cap", "window", "group", "run_cap", "gap"):
        assert getattr(tcfg.nbr, k) == getattr(jcfg.nbr, k), k
    return dict(js=js, jb=jb, jc=jc, jcfg=jcfg, jtree=jtree, tcfg=tcfg, tree=tree)


def _compare_step(it, td, jd, tn, jn, tb, const):
    for k in INT_DIAGS:
        assert float(td[k]) == float(jd[k]), (it, k)
    assert float(td["nc_mean"]) == pytest.approx(float(jd["nc_mean"]), rel=1e-6)
    for k in ("dt", "egrav"):
        assert float(td[k]) == pytest.approx(float(jd[k]), rel=1e-4), (it, k)
    out, _, _ = state_to_numpy(tn, tb, const)
    for f in dataclasses.fields(jn):
        a, b = out[f.name], np.asarray(getattr(jn, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
            continue
        ref = np.asarray(jn.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f"step {it} {f.name}")


@pytest.mark.parametrize("prop", ["std", "ve"])
def test_three_gravity_steps_match_jax(evrard16, prop):
    """Three steps of each package from the JAX package's input state:
    hydro plus the Barnes-Hut accelerations, the acceleration dt and egrav."""
    c = evrard16
    jstep, tstep = ((jax_step_std, _step_hydro_std) if prop == "std"
                    else (jax_step_ve, _step_hydro_ve))
    js, jb = c["js"], c["jb"]
    for it in range(3):
        ts, tb, tc = state_from_numpy(*_flat(js, jb, c["jc"]), device="cpu")
        jn, jb, jd = jstep(js, jb, c["jcfg"], c["jtree"])
        tn, tb, td = tstep(ts, tb, c["tcfg"], c["tree"])
        _compare_step(it, td, jd, tn, jn, tb, tc)
        js = jn
    assert float(td["egrav"]) < 0.0


def test_simulation_ve_gravity_matches_jax():
    """Evrard 14, two steps: the port's Simulation(prop="ve") against the
    JAX package's (pallas, check_every=1), the fields compared
    order-insensitively, and the same caps, energies and dt."""
    js, jb, jc = jax_init_evrard(14)
    jsim = JaxSimulation(js, jb, jc, prop="ve", backend="pallas", check_every=1)
    jd = [jsim.step() for _ in range(2)]
    sim = Simulation(*init_evrard(14, device="cpu"), prop="ve", device="cpu",
                     obs_spec=ObservableSpec())
    td = [sim.step() for _ in range(2)]
    assert sim.gravity_on and sim.lists is None
    for k in ("m2p_cap", "p2p_cap", "leaf_cap", "target_block", "super_factor"):
        assert getattr(sim.cfg.gravity, k) == getattr(jsim._cfg.gravity, k), k
    for a, b in zip(td, jd):
        for k in ("m2p_max", "p2p_max", "leaf_occ", "nc_max"):
            assert a[k] == float(b[k]), k
        for k in ("dt", "egrav"):
            assert a[k] == pytest.approx(float(b[k]), rel=1e-4), k
    s0, s1 = jsim.state, sim.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("temp", 1e-4), ("vx", 1e-4), ("alpha", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)
    assert sim.energy_drift is not None and abs(sim.energy_drift) < 1e-2


def test_periodic_box_with_gravity_raises():
    """Self-gravity in a box periodic in some dimensions only is refused
    (the JAX package's message); a fully periodic one runs Ewald."""
    fields, box, const = state_to_numpy(*init_sedov(8, device="cpu"))
    mixed = {**box, "boundaries": [1, 0, 0]}
    with pytest.raises(NotImplementedError, match="not mixed ones"):
        Simulation(*state_from_numpy(fields, mixed, {**const, "g": 1.0}, device="cpu"),
                   device="cpu")
    sim = Simulation(*state_from_numpy(fields, box, {**const, "g": 1.0}, device="cpu"),
                     device="cpu")
    assert sim.ewald_on
