"""The slice end to end: three std-SPH steps of the JAX package
(step_hydro_std, backend="pallas", Pallas in interpret mode) against the
port's streaming Simulation(device="cpu", use_lists=False; the list mode
is tests/test_torch_list_slice.py), every step from the same input state
handed over through sphexa_torch.convert. Per step: SFC keys and sort
order bitwise, diagnostics, then every field.

Field tolerance: the accelerations' (rtol 1e-4, atol 5e-6 x max|.|, the
JAX package's Pallas-vs-XLA criterion) carried through the integrator;
h, nc and occupancy depend only on exact neighbour counts and must match
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import step_hydro_std as jax_step
from sphexa_tpu.sfc.box import make_global_box as jax_global_box
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.sfc.box import make_global_box
from sphexa_torch.simulation import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = {"fold": (12, {}), "shift": (24, {"cell_target": 16})}


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case):
    side, kw = CASES[case]
    js, jb, jc = jax_init_sedov(side)
    jcfg = jax_config(js, jb, jc, backend="pallas", **kw)
    sim = Simulation(*state_from_numpy(*_flat(js, jb, jc), device="cpu"),
                     device="cpu", use_lists=False, **kw)
    # every field the port reads equals the JAX package's
    assert dataclasses.asdict(sim.cfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(sim.cfg.nbr)}

    for it in range(3):
        # the same input state on both sides
        sim.state, sim.box, _ = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        gbox = jax_global_box(js.x, js.y, js.z, jb)
        keys_j = np.asarray(jax_keys(js.x, js.y, js.z, gbox, curve="hilbert"))
        order_j = np.asarray(jnp.argsort(jnp.asarray(keys_j)))
        tbox = make_global_box(sim.state.x, sim.state.y, sim.state.z, sim.box)
        _, skeys_t, order_t = _sort_by_keys(sim.state, tbox, "hilbert")
        np.testing.assert_array_equal(order_t.numpy(), order_j)
        np.testing.assert_array_equal(skeys_t.numpy(), keys_j[order_j].astype(np.int64))

        jn, jb, jd = jax_step(js, jb, jcfg)
        d = sim.step()
        assert sim.reconfigures == 0 and sim.replays == 0
        for k in ("nc_mean", "nc_max", "occupancy", "dt_limiter"):
            assert d[k] == float(jd[k]), k
        for k in ("dt", "h_max"):
            assert d[k] == pytest.approx(float(jd[k]), rel=1e-6), k
        assert d["rho_max"] == pytest.approx(float(jd["rho_max"]), rel=1e-5)

        out, _, _ = state_to_numpy(sim.state, sim.box, sim.const)
        for f in dataclasses.fields(jn):
            a, b = out[f.name], np.asarray(getattr(jn, f.name))
            if f.name == "h":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
                continue
            np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=5e-6 * float(np.max(np.abs(b))),
                err_msg=f"step {it} {f.name}")
        js = jn
    jax.block_until_ready(js.x)
