"""The port's persistent neighbour lists (sphexa_torch/sph/pair_lists.py,
the list build in its plain version as CPU tensors run it) against the
JAX package's ``build_pair_lists`` (Pallas in interpret mode), on Sedov
24^3 with cell_target=16 (periodic, per-run shifts), Noh 16 (open box)
and a mixed box (Sedov 24^3 stretched 1.3x in z, periodic in x and open
in y and z, cell_target=16).
Both sides start from the same numpy state and go through their own
config sizing and ``rebuild_pair_lists`` (regrow, sort, skin, build).
The Sedov lattice is not jittered here: jittered, its list-inflated
window spans the whole periodic grid (fold mode), where both packages
leave lists off and stream (``test_config_fold_keeps_streaming``).

Everything here is exact: config fields, pruned runs, per-slot counts,
the marked lane set of every slot, the overflow sentinel and the
validity verdicts are equal; the remaining-skin fraction is held to
rtol 1e-6 (float32 reductions in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.sfc.box import BoundaryType as JaxBoundary
from sphexa_tpu.sfc.box import Box as JaxBox
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph.pair_lists import build_pair_lists as jax_build
from sphexa_tpu.sph.pair_lists import list_slack as jax_slack
from sphexa_tpu.sph.pair_lists import lists_valid as jax_valid

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import init_noh, jitter_sedov, stretch_box
from sphexa_torch.kernels import checks
from sphexa_torch.propagator import rebuild_pair_lists
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph import pair_lists as pl
from sphexa_torch.sph.pair_lists import build_pair_lists, list_slack, lists_valid


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


#: the mixed box: periodic x, open y and z
MIXED_BOUNDARIES = (JaxBoundary.periodic, JaxBoundary.open, JaxBoundary.open)


def jax_case(name):
    """The JAX package's state of a case and the make_propagator_config
    keywords both packages size it with."""
    if name == "noh":
        return jax_init_noh(16), {}
    js, jb, jc = jax_init_sedov(24)
    if name == "mixed":
        fields, b = stretch_box(_flat(js, jb, jc)[0], _flat(js, jb, jc)[1], 1.3,
                                MIXED_BOUNDARIES)
        js = dataclasses.replace(js, z=jnp.asarray(fields["z"]))
        jb = JaxBox.create(*np.stack([b["lo"], b["hi"]], axis=1).ravel().tolist(),
                           boundary=MIXED_BOUNDARIES)
    return (js, jb, jc), {"cell_target": 16}


def jax_marked_lanes(jl):
    """(NG, S_cap, 128) bool marked lanes of the JAX lists: the k < cnt
    selected source lanes sit at gidx[g, s, (fill + k) % 128]."""
    gidx, fill, cnt = (np.asarray(a) for a in (jl.gidx, jl.fill, jl.cnt))
    k = np.arange(128)
    lanes = np.take_along_axis(gidx, (fill[..., None] + k) % 128, axis=2)
    g, s, kk = np.nonzero(k < cnt[..., None])
    out = np.zeros(gidx.shape, bool)
    out[g, s, lanes[g, s, kk]] = True
    return out


@pytest.fixture(scope="module", params=["noh", "sedov", "mixed"])
def case(request):
    (js, jb, jc), kw = jax_case(request.param)
    jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True, **kw)
    jss, jbb, jl, _ = jax_rebuild(js, jb, jcfg)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, use_lists=True, **kw)
    tss, tbb, tl = rebuild_pair_lists(ts, tb, tcfg)
    return dict(name=request.param, jcfg=jcfg, jss=jss, jbb=jbb, jl=jl,
                tcfg=tcfg, tss=tss, tbb=tbb, tl=tl)


def test_config_matches(case):
    """make_propagator_config(use_lists=True): the list-inflated window and
    the slot budget from the sizing pass equal the JAX package's."""
    t, j = case["tcfg"], case["jcfg"]
    assert dataclasses.asdict(t.nbr) == {k: getattr(j.nbr, k) for k in dataclasses.asdict(t.nbr)}
    assert t.list_slot_cap == j.list_slot_cap > 0
    assert t.list_skin_rel == j.list_skin_rel
    assert not pe.engine_fold(case["tbb"], t.nbr)


def test_config_fold_keeps_streaming():
    """Jittered, Sedov 24^3 (cell_target=16) would need a window of the
    whole grid once the skin is added: both packages keep the un-inflated
    window and a slot budget of 0, so the steps stream."""
    js, jb, jc = jax_init_sedov(24)
    fields = jitter_sedov(_flat(js, jb, jc)[0], 24, seed=24)
    js = dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in fields.items()})
    jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True, cell_target=16)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, use_lists=True, cell_target=16)
    assert dataclasses.asdict(tcfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    assert tcfg.list_slot_cap == jcfg.list_slot_cap == 0


def test_sorted_state_and_skin(case):
    """The rebuild's frozen order and its float32 skin are the JAX one's."""
    np.testing.assert_array_equal(case["tss"].x.numpy(), np.asarray(case["jss"].x))
    np.testing.assert_array_equal(case["tss"].h.numpy(), np.asarray(case["jss"].h))
    assert case["tl"].skin.dtype == torch.float32
    assert float(case["tl"].skin) == float(case["jl"].skin)


def test_pruned_runs_bitwise(case):
    tr, jr = case["tl"].ranges, case["jl"].ranges
    for f in ("starts", "lens", "shift_x", "shift_y", "shift_z", "ncells"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                      err_msg=f)
    assert int(tr.occupancy) == int(jr.occupancy)


def test_counts_overflow_lanes_total(case):
    tl, jl = case["tl"], case["jl"]
    np.testing.assert_array_equal(tl.cnt.numpy(), np.asarray(jl.cnt))
    assert int(tl.overflow) == int(jl.overflow) == 0
    assert float(tl.lanes_total) == float(jl.lanes_total)


def test_marked_lanes_of_every_slot(case):
    """The port's 128-bit masks hold, slot for slot, the lanes the JAX
    package's compacted gather indices select; the counts are their
    popcounts."""
    tl = case["tl"]
    mine = pe.lane_mask(tl.bits).numpy()
    np.testing.assert_array_equal(mine, jax_marked_lanes(case["jl"]))
    np.testing.assert_array_equal(mine.sum(-1), tl.cnt.numpy())


def test_every_pruned_chunk_is_marked(case):
    """Pruning keeps only chunks with a marked lane, so the pruned runs'
    chunks are exactly the slots with cnt > 0, leading each row: the K1
    gate ``cnt > 0`` the JAX package's list-mode density and IAD apply is
    vacuous on them."""
    tl = case["tl"]
    _, _, nslots = pe.chunk_slots(tl.ranges, tl.slot_cap)
    s_idx = torch.arange(tl.slot_cap)[None, :]
    cnt = tl.cnt
    assert bool((cnt[s_idx < nslots[:, None]] > 0).all())
    assert bool((cnt[s_idx >= nslots[:, None]] == 0).all())
    assert int(nslots.max()) <= tl.slot_cap


def test_slot_cap_overflow_sentinel(case):
    """With a slot budget of 2 both packages raise the overflow sentinel."""
    ss, box, cfg, lists = case["tss"], case["tbb"], case["tcfg"], case["tl"]
    keys = compute_sfc_keys(ss.x, ss.y, ss.z, box, curve=cfg.curve)
    small = build_pair_lists(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr, lists.skin, 2)
    assert int(small.overflow) == 1
    js, jb = case["jss"], case["jbb"]
    jkeys = jax_keys(js.x, js.y, js.z, jb, curve="hilbert")
    jsmall = jax.jit(lambda x, y, z, h, k, s: jax_build(
        x, y, z, h, k, jb, case["jcfg"].nbr, s, 2, interpret=True))(
            js.x, js.y, js.z, js.h, jkeys, case["jl"].skin)
    assert int(jsmall.overflow) == 1
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("kind", ["fresh", "drift", "growth"])
def test_slack_and_validity(case, kind):
    """The Verlet-skin test on the cases of the JAX package's own
    (tests/test_pair_lists.py): fresh lists are valid, one particle moved
    by 0.6 skin is not, and h growth alone trips it too."""
    tl, jl = case["tl"], case["jl"]
    skin = float(jl.skin)
    x, y, z, h = (np.asarray(getattr(case["jss"], f)).copy() for f in "xyzh")
    if kind == "drift":
        x[0] = np.float32(x[0] + np.float32(0.6 * skin))
    elif kind == "growth":
        h[0] = np.float32(h[0] * np.float32(1.0 + skin))
        h = (h + np.float32(0.51 * skin)).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, y, z, h)]
    t = [torch.from_numpy(a) for a in (x, y, z, h)]
    assert bool(lists_valid(*t, tl)) == bool(jax_valid(*j, jl)) == (kind == "fresh")
    np.testing.assert_allclose(float(list_slack(*t, tl)), float(jax_slack(*j, jl)),
                               rtol=1e-6)


def test_init_noh_arrays_equal():
    js, jb, jc = jax_init_noh(16)
    ts, tb, tc = init_noh(16, device="cpu")
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tb.lo.numpy(), np.asarray(jb.lo))
    np.testing.assert_array_equal(tb.hi.numpy(), np.asarray(jb.hi))
    assert [int(b) for b in tb.boundaries] == [int(b) for b in jb.boundaries]
    assert dataclasses.asdict(tc) == {k: v for k, v in dataclasses.asdict(jc).items()
                                      if k in dataclasses.asdict(tc)}


@pytest.mark.parametrize("seed", [7, 11])
def test_synthetic_cull_exercises_merge_edges(seed):
    """The synthetic cells that the card's list-build check runs hold, in
    every group, each edge of the run merge (kept cells in start order:
    A, B, C, D, E, F, then an empty and a dropped cell, then G): a gap of
    exactly ``gap`` rows joins (A, B), one more row does not (C); a run of
    exactly ``run_cap`` rows joins (C, D), one more row does not (E); a new
    image shift starts a run (F) and the kept cell after a dropped one
    joins it (G). The columns are shuffled, and the prune drops chunks."""
    cull, x, y, z, h, skin, scap, cfg = checks.synthetic_cull(seed, "cpu")
    start, lens, keep, _ = (a.numpy() for a in cull)
    s, ln, sh, _ = (a for a in pe._merge_runs(*cull, cfg.run_cap, cfg.gap))
    s, ln, shx = s.numpy(), ln.numpy(), sh[0].numpy()
    w3 = start.shape[1]
    shuffled = 0
    for g in range(start.shape[0]):
        order = np.lexsort((np.arange(w3), np.where(keep[g], start[g], 2**30)))
        k = order[keep[g][order]]
        shuffled += int(not np.array_equal(k[:7], np.sort(k[:7])))
        cs, ce = start[g][k], start[g][k] + lens[g][k]
        assert cs[1] - ce[0] == cfg.gap and (s[g, 0], s[g, 0] + ln[g, 0]) == (cs[0], ce[1])
        assert cs[2] - ce[1] == cfg.gap + 1 and s[g, 1] == cs[2]
        assert ce[3] - cs[2] == cfg.run_cap and ln[g, 1] == cfg.run_cap
        assert (s[g, 2], ln[g, 2]) == (cs[4], 1) and ce[4] - cs[2] == cfg.run_cap + 1
        assert s[g, 3] == cs[5] and s[g, 3] + ln[g, 3] >= ce[6]
        assert tuple(shx[g, :4]) == (0.0, 0.0, 0.0, 1.0)
        between = (start[g] >= ce[5]) & (start[g] < cs[6]) | (start[g] == ce[5])
        assert (~keep[g][between]).sum() == 2 and (lens[g][between] == 0).any()
    assert shuffled > 0
    tables, bits, cnt, total = pl.build_lists_plain(cull, x, y, z, h, skin, scap, cfg)
    kept_slots = (cnt > 0).sum(dim=1)
    assert int(total.max()) == scap and bool((kept_slots < total).any())
    assert bool((kept_slots > 0).all())


def test_list_build_kernel_refuses_cpu_tensors():
    """On CPU tensors the list build's launcher raises: the wrapper
    (``build_lists``) runs the plain version there and never reaches it."""
    cull, x, y, z, h, skin, scap, cfg = checks.synthetic_cull(7, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pl.build_lists_launcher(cull, x, y, z, h, skin, scap, cfg)
    got = pl.build_lists(cull, x, y, z, h, skin, scap, cfg)
    want = pl.build_lists_plain(cull, x, y, z, h, skin, scap, cfg)
    for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.equal(a, b)
