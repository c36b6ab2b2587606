"""The port's block time steps (sph/blockdt.py, the *_blockdt steps, the
driver's bdt slot) against the JAX package's, on the CPU: the scheme's
functions on seeded inputs, the due-row compaction against the JAX
package's K13 path in interpret mode, two cycles (16 substeps) of std and
VE Sedov 8 at dt_bins 4 against ``step_hydro_{std,ve}_blockdt`` (backend
"pallas", Pallas in interpret mode), each substep from the same input
state and carry, the port's dt_bins=1 step against its own global
streaming step bit for bit, the updates-saved factor, the telemetry, a
rollback of the bdt slot and the knobs' validation.

Tolerances: the bins, due masks, folded keys, populations and the
compaction exactly (bins only where log2(dt_i / dt_min) lies more than
1e-5 from an integer: XLA's and PyTorch's float32 log2 may round apart
there); each substep's fields as tests/test_torch_slice.py's (rtol 1e-4,
atol 5e-6 x max|.|; h rtol 1e-6), but temp_lo, the compensated energy
sum's residual below one ulp of temp, within float32 eps x max|temp| (as
tests/test_torch_inits.py), dt rel 1e-6, the integer block
diagnostics (active count, populations, substep, resort, inversions)
exactly. The JAX package's own dt_bins=1 pin fails on jax 0.9.0 (XLA's
FMA contraction), so the port's pin is against itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import step_hydro_std_blockdt as jax_std_blockdt
from sphexa_tpu.propagator import step_hydro_ve_blockdt as jax_ve_blockdt
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import blockdt as jbdt

from sphexa_torch.app import main as app
from sphexa_torch.convert import (
    blockdt_from_numpy, blockdt_to_numpy, state_from_numpy, state_to_numpy,
)
from sphexa_torch.init import init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import _step_hydro_std_blockdt, _step_hydro_ve_blockdt
from sphexa_torch.simulation import Simulation
from sphexa_torch.sph import blockdt as bdt
from sphexa_torch.telemetry import MemorySink, Telemetry
from sphexa_torch.telemetry.registry import validate_event


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


def _jax_bst(bst) -> dict:
    return {f.name: np.array(getattr(bst, f.name)) for f in dataclasses.fields(bst)}


def test_due_schedule_and_populations_match_jax():
    rng = np.random.default_rng(3)
    for nbins in (1, 2, 4, 6):
        bins = rng.integers(0, nbins, 4000).astype(np.int32)
        for s in range(bdt.cycle_length(nbins)):
            got = bdt.due_mask(torch.tensor(bins), torch.tensor(s, dtype=torch.int32))
            want = jbdt.due_mask(jnp.asarray(bins), jnp.int32(s))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bdt.due_mask(torch.tensor(bins), torch.tensor(
            bdt.cycle_length(nbins) - 1, dtype=torch.int32)).all()
        got = bdt.bin_populations(torch.tensor(bins), nbins)
        want = np.asarray(jbdt.bin_populations(jnp.asarray(bins), nbins))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_assign_bins_matches_jax():
    rng = np.random.default_rng(5)
    dt_min = np.float32(1e-4)
    cand = (dt_min * np.exp2(rng.uniform(-1.0, 7.0, 20000))).astype(np.float32)
    cand[:4] = [np.inf, 1e2, 5e-5, dt_min]
    got = bdt.assign_bins(torch.tensor(cand), torch.tensor(dt_min), 5).numpy()
    want = np.asarray(jbdt.assign_bins(jnp.asarray(cand), jnp.float32(dt_min), 5))
    assert got.dtype == np.int32
    raw = cand.astype(np.float64) / np.float64(dt_min)
    with np.errstate(invalid="ignore"):
        log_r = np.log2(np.maximum(raw, 1.0))
        # clamped to ratio 1 (log2 exactly 0), or inf: exact in both
        clear = (np.abs(log_r - np.round(log_r)) > 1e-5) | (raw <= 1.0) | ~np.isfinite(raw)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert got[:4].tolist() == [4, 4, 0, 0] and clear.mean() > 0.99


def test_fold_bin_key_matches_jax():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 30, 5000).astype(np.uint32)
    keys[100:200] = keys[100]  # equal keys, grouped by bin
    bins = rng.integers(0, 9, 5000).astype(np.int32)
    got = bdt.fold_bin_key(torch.tensor(keys.astype(np.int64)), torch.tensor(bins)).numpy()
    want = np.asarray(jbdt.fold_bin_key(jnp.asarray(keys), jnp.asarray(bins)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the same stable order (jnp.argsort is stable)
    np.testing.assert_array_equal(
        torch.argsort(torch.tensor(got), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want))))
    assert bdt.FOLD_BITS == jbdt.FOLD_BITS == 2


@pytest.mark.parametrize("n,share", [(1000, 0.3), (9000, 0.05), (5000, 0.0), (777, 1.0)])
def test_compact_active_matches_jax_kernel(n, share):
    """The plain path (what the CPU runs) against the JAX package's K13
    path in interpret mode: the active rows first in row order, zeros
    after, and the count."""
    due = np.random.default_rng(n).uniform(size=n) < share
    idx, cnt = bdt.compact_active(torch.tensor(due))
    jidx, jcnt = jbdt.compact_active(jnp.asarray(due), use_kernel=True, interpret=True)
    assert int(cnt) == int(jcnt) == int(due.sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[:int(cnt)], np.flatnonzero(due))
    assert idx.dtype == torch.int32


#: prop -> (JAX step, port step)
STEPS = {"std": (jax_std_blockdt, _step_hydro_std_blockdt),
         "ve": (jax_ve_blockdt, _step_hydro_ve_blockdt)}

#: case -> (prop, Sedov 8 settings): the JAX package's two-scale case,
#: where every particle sits in the deepest bin (dt grows 1.1x a step from
#: minDt 1e-6, far under the Courant dt), and one from minDt 1e-3, where
#: the Courant dt sets dt_min and the hot core and the cold ambient take
#: different bins (the drift of the inactive rows and the rebase run)
CYCLE_CASES = {"std": ("std", None), "ve": ("ve", None),
               "std-courant": ("std", {"minDt": 1e-3, "minDt_m1": 1e-3})}


@pytest.mark.parametrize("case", list(CYCLE_CASES))
def test_two_cycles_match_jax(case):
    """16 substeps at dt_bins 4 (two cycles): every substep of the port
    from the JAX package's input state and carry. The bins are compared
    exactly everywhere: on these states no ratio's log2 comes within 1e-5
    of an integer."""
    prop, settings = CYCLE_CASES[case]
    jstep, tstep = STEPS[prop]
    js, jb, jc = jax_init_sedov(8, overrides=settings)
    jcfg = jax_config(js, jb, jc, backend="pallas", dt_bins=4)
    jbst = jbdt.make_blockdt_state(js, 4)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    sim = Simulation(ts, tb, tc, prop=prop, device="cpu", dt_bins=4)
    tcfg = sim.cfg
    assert dataclasses.asdict(tcfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    assert tcfg.dt_bins == 4 and tcfg.bin_sync_every == 1
    updates, pops = 0, set()
    for it in range(2 * bdt.cycle_length(4)):
        ts, tb, _ = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        tbst = blockdt_from_numpy(_jax_bst(jbst), device="cpu")
        jn, jb, jd, jbst = jstep(js, jb, jcfg, None, jbst)
        tn, tb, td, tbst = tstep(ts, tb, tcfg, None, tbst)
        for k in ("bdt_active", "bdt_substep", "bdt_resort", "bdt_drift", "nc_max",
                  "occupancy"):
            assert int(td[k]) == int(jd[k]), (it, k)
        np.testing.assert_array_equal(td["bdt_pop"].numpy(), np.asarray(jd["bdt_pop"]))
        pops.add(tuple(td["bdt_pop"].tolist()))
        assert float(td["dt"]) == pytest.approx(float(jd["dt"]), rel=1e-6)
        assert float(td["bdt_work"]) == pytest.approx(float(jd["bdt_work"]), rel=1e-6)
        updates += int(td["bdt_active"])
        got, want = blockdt_to_numpy(tbst), _jax_bst(jbst)
        for k in ("bins", "substep", "cycle"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"substep {it} {k}")
        np.testing.assert_allclose(got["dt_prev"], want["dt_prev"], rtol=1e-6)
        out, _, _ = state_to_numpy(tn, tb, tc)
        for f in dataclasses.fields(jn):
            a, b = out[f.name], np.asarray(getattr(jn, f.name))
            rtol = 1e-6 if f.name == "h" else 1e-4
            atol = 0.0 if f.name == "h" else 5e-6 * float(np.max(np.abs(b)))
            if f.name == "temp_lo":
                rtol, atol = 0.0, np.finfo(np.float32).eps * float(np.max(np.abs(jn.temp)))
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"substep {it} {f.name}")
        js = jn
    jax.block_until_ready(js.x)
    if settings is None:
        # the deepest bin steps once a cycle: at Sedov 8 every particle is there
        assert 2 * bdt.cycle_length(4) * js.x.shape[0] / updates >= 5.0
    else:
        assert any(sum(p[k] > 0 for k in range(4)) > 1 for p in pops), pops


@pytest.mark.parametrize("prop", ["std", "ve"])
def test_dt_bins_1_is_the_global_step(prop):
    """The port's dt_bins=1 step bit for bit its global streaming step
    (every particle due every substep, the plain sort, the scalars the
    global step feeds the integrator)."""
    state, box, const = init_sedov(8, device="cpu")
    ref = Simulation(state, box, const, prop=prop, device="cpu", use_lists=False,
                     obs_spec=ObservableSpec())
    blk = Simulation(state, box, const, prop=prop, device="cpu", dt_bins=1,
                     obs_spec=ObservableSpec())
    for _ in range(4):
        dr, db = ref.step(), blk.step()
        for k in ("dt", "nc_sum", "rho_max", "h_max", "obs_etot", "dt_limiter"):
            assert dr[k] == db[k], k
        assert db["bdt_active"] == state.n
    for f in ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz", "h", "temp",
              "temp_lo", "du", "du_m1", "alpha", "ttot", "min_dt", "min_dt_m1"):
        assert torch.equal(getattr(ref.state, f), getattr(blk.state, f)), f


def test_update_reduction_and_conservation():
    """Two cycles of std Sedov 8 at dt_bins 4 (the JAX package's
    TestTwoScaleProxy): at least 5x fewer particle updates than the
    global dt over the same substeps, the drift within 1e-5 on both."""
    state, box, const = init_sedov(8, device="cpu")
    spec = ObservableSpec()
    ref = Simulation(state, box, const, device="cpu", obs_spec=spec)
    blk = Simulation(state, box, const, device="cpu", dt_bins=4, obs_spec=spec)
    steps = 2 * bdt.cycle_length(4)
    for _ in range(steps):
        ref.step()
        blk.step()
    assert blk.lists is None and blk.bdt_updates_full == steps * state.n
    assert blk.bdt_updates > 0 and blk.bdt_updates_full / blk.bdt_updates >= 5.0
    assert blk.energy_drift is not None and blk.energy_drift <= 1e-5
    assert ref.energy_drift is not None and ref.energy_drift <= 1e-5


def test_dt_bins_event_and_resort_counters():
    sink = MemorySink()
    state, box, const = init_sedov(8, device="cpu")
    sim = Simulation(state, box, const, prop="ve", device="cpu", dt_bins=4,
                     bin_resort_drift=0.01, check_every=4, telemetry=Telemetry(sinks=[sink]))
    for _ in range(8):
        sim.step()
    sim.flush()
    evs = sink.of_kind("dt_bins")
    assert len(evs) == 2, "one dt_bins event a clean window"
    for e in evs:
        assert validate_event(e) == []
    last = evs[-1]
    assert len(last["pop"]) == 4 and sum(last["pop"]) == state.n
    assert 0 < last["updates"] <= last["updates_full"] == 4 * state.n
    assert sim.bdt_resorts + sim.bdt_keeps == 8
    assert sim.bdt_keeps >= 1, "a threshold of 0.01 keeps the order sometimes"


def test_rollback_restores_the_bdt_slot():
    """The cap forced to 8 before a window of 5 substeps: the flush rolls
    back to the window's first carry (the BlockDtState with it), re-sizes
    and replays to the synchronous run's state."""
    state, box, const = init_sedov(8, device="cpu")
    ref = Simulation(state, box, const, device="cpu", dt_bins=3)
    for _ in range(5):
        ref.step()
    sink = MemorySink()
    sim = Simulation(state, box, const, device="cpu", dt_bins=3, check_every=5,
                     telemetry=Telemetry(sinks=[sink]))
    prior = sim.bdt_state
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    for _ in range(5):
        sim.step()
    assert [e["reason"] for e in sink.of_kind("rollback")] == ["overflow"]
    assert int(prior.substep) == 0 and int(prior.cycle) == 0  # the pinned carry untouched
    got, want = blockdt_to_numpy(sim.bdt_state), blockdt_to_numpy(ref.bdt_state)
    for k in ("bins", "substep", "cycle"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["substep"]) == 5 % bdt.cycle_length(3) and int(got["cycle"]) == 1
    np.testing.assert_allclose(got["dt_prev"], want["dt_prev"], rtol=1e-6)
    np.testing.assert_allclose(sim.state.x.numpy(), ref.state.x.numpy(), rtol=1e-6)
    assert sim.bdt_updates == ref.bdt_updates


def test_rejects_propagators_and_knobs():
    state, box, const = init_sedov(6, device="cpu")
    for prop in ("nbody", "turb-ve", "std-cooling"):
        with pytest.raises(ValueError, match="dt_bins"):
            Simulation(state, box, const, prop=prop, device="cpu", dt_bins=2)
    for kw in ({"dt_bins": 0}, {"dt_bins": 2, "bin_sync_every": 0},
               {"dt_bins": 2, "bin_resort_drift": -0.1}):
        with pytest.raises(ValueError):
            Simulation(state, box, const, device="cpu", **kw)


def test_cli_dt_bins(tmp_path, capsys):
    assert app.main(["--init", "sedov", "-n", "8", "-s", "4", "--dt-bins", "3",
                     "--bin-resort-drift", "0.01", "-o", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "it     4" in out and "lists off" in out
    assert app.main(["--init", "sedov", "-n", "8", "-s", "1", "--dt-bins", "2", "--prop",
                     "nbody", "--G", "1", "-o", str(tmp_path), "--device", "cpu"]) == 2
    assert "dt_bins" in capsys.readouterr().err


def test_compact_active_past_the_kernels_index_bits():
    """Past 2**IDX_BITS rows, where the JAX package sorts the classes
    stably (its XLA path), the one-row form reads the mask itself and has
    no such limit: the due rows first in row order and the count agree;
    the port's slots past the count are zeros, the JAX package's the
    inactive rows (no caller reads past the count)."""
    n = (1 << jbdt.IDX_BITS) + 3
    due = np.zeros(n, dtype=bool)
    due[np.random.default_rng(11).integers(0, n, size=5000)] = True
    due[-1] = True
    idx, cnt = bdt.compact_active(torch.tensor(due))
    jidx, jcnt = jbdt.compact_active(jnp.asarray(due))
    k = int(due.sum())
    assert int(cnt) == int(jcnt) == k
    np.testing.assert_array_equal(idx.numpy()[:k], np.asarray(jidx)[:k])
    assert not idx.numpy()[k:].any()
