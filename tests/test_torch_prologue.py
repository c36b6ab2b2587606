"""The port's config sizing and candidate-run prologue against the JAX
package on the CPU: make_propagator_config gives the same NeighborConfig,
and group_cell_ranges the same runs (bitwise), on the min-image fold case
(Sedov side 12) and the per-run shift case (side 24, cell_target=16)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.neighbors.cell_list import NeighborConfig
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe


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
def test_config_and_ranges_match(case):
    side, kw = CASES[case]
    js, jb, jc = jax_init_sedov(side)
    jcfg = jax_config(js, jb, jc, backend="pallas", **kw)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, **kw)
    # every field the port reads equals the JAX package's
    assert dataclasses.asdict(tcfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    assert tcfg.curve == jcfg.curve
    assert pe.engine_fold(tb, tcfg.nbr) == pp.engine_fold(jb, jcfg.nbr) == (case == "fold")

    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, order = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    jr = jax.jit(lambda x, y, z, h, k: pp.group_cell_ranges(x, y, z, h, k, jb, jcfg.nbr))(
        jss.x, jss.y, jss.z, jss.h, jkeys)
    tr = pe.group_cell_ranges(tss.x, tss.y, tss.z, tss.h, tkeys, tb, tcfg.nbr)
    for name in ("starts", "lens", "shift_x", "shift_y", "shift_z", "ncells",
                 "occupancy", "boxl"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), err_msg=name)
    assert int(tr.occupancy) <= tcfg.nbr.cap


def test_min_cap_and_window_sentinel():
    """min_cap raises the cap as in the JAX package; a window too small
    for the groups' search extent reports the cap + 1 sentinel."""
    js, jb, jc = jax_init_sedov(12)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    for min_cap in (0, 300, 1000):
        jcfg = jax_config(js, jb, jc, backend="pallas", min_cap=min_cap, cell_target=16)
        tcfg = make_propagator_config(ts, tb, tc, min_cap=min_cap, cell_target=16)
        # every field the port reads equals the JAX package's
        assert dataclasses.asdict(tcfg.nbr) == {
            k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    small = dataclasses.replace(tcfg.nbr, window=1)
    tr = pe.group_cell_ranges(tss.x, tss.y, tss.z, tss.h, tkeys, tb, small)
    assert int(tr.occupancy) == small.cap + 1


def test_merge_runs_loop_matches_scan():
    """_merge_runs (Python loop over window columns) against the JAX
    lax.scan version on random tables with gaps, images and dead cells."""
    rng = np.random.default_rng(9)
    ng, w3 = 40, 27
    start = np.sort(rng.integers(0, 5000, (ng, w3)), axis=1).astype(np.int32)
    lens = rng.integers(0, 60, (ng, w3)).astype(np.int32)
    keep = rng.random((ng, w3)) < 0.6
    shifts = rng.integers(-1, 2, (ng, w3, 3)).astype(np.float32)
    for a in (start, lens, keep):
        a[:] = np.take_along_axis(a, rng.permuted(np.tile(np.arange(w3), (ng, 1)), axis=1), 1)
    js, jl, jsh, jn = pp._merge_runs(start, lens, keep, shifts, 300, 40)
    ts, tl, tsh, tn = pe._merge_runs(torch.tensor(start), torch.tensor(lens),
                                     torch.tensor(keep), torch.tensor(shifts), 300, 40)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for a, b in zip(tsh, jsh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_neighbor_config_requires_merged_runs():
    """The engine always merges runs: a config without a run cap is refused."""
    with pytest.raises(ValueError, match="run_cap"):
        NeighborConfig(level=3, cap=40, run_cap=0)
