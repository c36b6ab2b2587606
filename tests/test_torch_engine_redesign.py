"""List mode with every SPH op on the list walk, on the CPU: density,
IAD, grad-h and both forms of divv/curlv through the walk's plain version
(``engine_lists_plain``, what the wrappers run on CPU tensors with
``lists=``) against K1's plain version over the lists' pruned runs (how
list mode ran them before) and against the JAX package's list-mode Pallas
ops in interpret mode, on jittered Sedov 30 and Noh 16 (open box), both
packages on their own lists of the same frozen state. And the body-pass
counter (``pair_engine.body_pass_counts``) on a hand-built case.

Every pair within 2 h of a target is among the marked lanes while the
lists are valid, and both engines take a target's candidates in
ascending order, so the walk and the pruned runs pair the same
candidates in the same order. Tolerances are the JAX package's own: nc
exact, rho and xm rtol 1e-5 (tests/test_pallas_interpret.py:41-52); IAD
rtol 2e-5 / atol 1e-6 x max|c|, kx rtol 2e-5, gradh rtol 2e-4 / atol
2e-6, divv, curlv and gradv rtol 1e-4 / atol 1e-5 x max|divv| (its list
mode against streaming, tests/test_pair_lists.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import jitter_sedov
from sphexa_torch.propagator import rebuild_pair_lists
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


def T(a):
    return torch.tensor(np.array(a))


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _jitter(js, side):
    out = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    return dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in
                                      jitter_sedov(out, side, seed=side).items()})


CASES = {"sedov": (jax_init_sedov, 30), "noh": (jax_init_noh, 16)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' frozen states and lists from the same state, and the
    JAX package's list-mode density, grad-h, IAD and divv/curlv (each on
    the previous op's outputs)."""
    init, side = CASES[request.param]
    js, jb, jc = init(side)
    if request.param == "sedov":
        js = _jitter(js, side)
    jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True)
    s, jbb, jl, _ = jax_rebuild(js, jb, jcfg)
    ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, use_lists=True)
    assert tcfg.list_slot_cap == jcfg.list_slot_cap > 0
    tss, tbb, tl = rebuild_pair_lists(ts, tb, tcfg)
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(s.x))
    assert not pe.engine_fold(tbb, tcfg.nbr)

    nbr = jcfg.nbr
    ref = {}
    ref["rho"], ref["nc"], _ = jax.jit(lambda x, y, z, h, m, li: pp.pallas_density(
        x, y, z, h, m, None, jbb, jc, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, s.m, jl)
    xm = s.m / ref["rho"]
    ref["kx"], ref["gradh"] = jax.jit(lambda x, y, z, h, m, xm_, li: pp.pallas_ve_def_gradh(
        x, y, z, h, m, xm_, None, jbb, jc, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, s.m, xm, jl)[0]
    ref["cs"] = jax.jit(lambda x, y, z, h, v, li: pp.pallas_iad(
        x, y, z, h, v, None, jbb, jc, nbr, interpret=True, lists=li))(
            s.x, s.y, s.z, s.h, xm / ref["kx"], jl)[0]
    for gradv in (False, True):
        ref[f"dv{int(gradv)}"] = jax.jit(lambda *a, li: pp.pallas_iad_divv_curlv(
            *a, None, jbb, jc, nbr, with_gradv=gradv, interpret=True, lists=li)[0])(
                s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, ref["kx"], xm, *ref["cs"], li=jl)
    ref["xm"] = xm
    return dict(ref=ref, s=tss, box=tbb, const=tc, nbr=tcfg.nbr, lists=tl)


def _both(c, fn, *args, **kw):
    """An op through the walk's plain version (the wrapper on CPU tensors
    with ``lists``) and through K1's plain version over the pruned runs."""
    walk = fn(*args, None, c["box"], c["const"], c["nbr"], lists=c["lists"], **kw)
    pruned = fn(*args, None, c["box"], c["const"], c["nbr"], ranges=c["lists"].ranges, **kw)
    return walk, pruned


def test_density_on_the_walk(case):
    c, r = case, case["ref"]
    s = c["s"]
    (rho_w, nc_w, _), (rho_p, nc_p, _) = _both(c, pe.pallas_density, s.x, s.y, s.z, s.h, s.m)
    assert torch.equal(nc_w, nc_p)
    np.testing.assert_array_equal(nc_w.numpy(), np.asarray(r["nc"]))
    torch.testing.assert_close(rho_w, rho_p, rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(rho_w.numpy(), np.asarray(r["rho"]), rtol=1e-5)


def test_iad_on_the_walk(case):
    c, r = case, case["ref"]
    s = c["s"]
    vol = T(r["xm"]) / T(r["kx"])
    (cs_w, _), (cs_p, _) = _both(c, pe.pallas_iad, s.x, s.y, s.z, s.h, vol)
    csc = max(float(np.abs(np.asarray(b)).max()) for b in r["cs"])
    for k, (a, b, want) in enumerate(zip(cs_w, cs_p, r["cs"])):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6 * csc, msg=f"c{k}")
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6 * csc,
                                   err_msg=f"c{k}")


def test_gradh_on_the_walk(case):
    c, r = case, case["ref"]
    s = c["s"]
    ((kx_w, gh_w), _), ((kx_p, gh_p), _) = _both(c, pe.pallas_ve_def_gradh, s.x, s.y, s.z,
                                                  s.h, s.m, T(r["xm"]))
    torch.testing.assert_close(kx_w, kx_p, rtol=2e-5, atol=0.0)
    torch.testing.assert_close(gh_w, gh_p, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(kx_w.numpy(), np.asarray(r["kx"]), rtol=2e-5)
    np.testing.assert_allclose(gh_w.numpy(), np.asarray(r["gradh"]), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("gradv", [False, True], ids=["divv", "gradv"])
def test_divv_curlv_on_the_walk(case, gradv):
    c, r = case, case["ref"]
    s = c["s"]
    (out_w, _), (out_p, _) = _both(
        c, pe.pallas_iad_divv_curlv, s.x, s.y, s.z, s.vx, s.vy, s.vz, s.h, T(r["kx"]),
        T(r["xm"]), *map(T, r["cs"]), with_gradv=gradv)
    want = r[f"dv{int(gradv)}"]
    assert len(out_w) == len(want) == (8 if gradv else 2)
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    assert scale > 0
    for k, (a, b, w) in enumerate(zip(out_w, out_p, want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale, msg=f"output {k}")
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"output {k}")


def test_body_pass_counts_per_lane_windows_never_exceed_union(case):
    """On a real list state: the counter's pairs are the neighbour pairs
    (the density op's nc); per-lane windows never run more passes than
    the union rule (per window, the busiest lane's pairs are at most the
    candidates any lane accepts there), and a window never more than the
    smaller windows it is made of."""
    c, r = case, case["ref"]
    s = c["s"]
    i_f, j_f = pe.density_fields(s.x, s.y, s.z, s.h, s.m)
    got = pe.body_pass_counts(pe.DENSITY, i_f, j_f, c["nbr"].group, {}, (32, 128, 512),
                              lists=c["lists"])
    assert got["pairs"] == int(np.asarray(r["nc"]).astype(np.int64).sum())
    w = got["windows"]
    assert got["pairs"] <= w[512] <= w[128] <= w[32] <= got["union"]


def _line_case():
    """Two groups of 32 on parallel lines 0.5 apart (y = 0 and y = 0.5,
    x = 0..31, spacing 1), 2h = 0.6: target t of either line pairs with
    exactly one candidate, its partner across the gap. Each group's one run
    holds all 64 particles in index order."""
    x = torch.cat([torch.arange(32.0), torch.arange(32.0)])
    y = torch.cat([torch.zeros(32), torch.full((32,), 0.5)])
    z = torch.zeros(64)
    h = torch.full((64,), 0.3)
    m = torch.ones(64)
    i32 = torch.int32
    ranges = pe.GroupRanges(
        starts=torch.zeros(2, 1, dtype=i32), lens=torch.full((2, 1), 64, dtype=i32),
        shift_x=torch.zeros(2, 1), shift_y=torch.zeros(2, 1), shift_z=torch.zeros(2, 1),
        ncells=torch.ones(2, dtype=i32), occupancy=torch.tensor(64),
        boxl=torch.full((3,), 1e30))
    return pe.density_fields(x, y, z, h, m), ranges


def test_body_pass_counts_hand_built():
    """64 pairs; under the union rule each warp runs the body on the 32
    candidates its lanes accept, all 32 lanes each time (2 x 32 x 32
    passes, efficiency 1/32); with per-lane windows of 32 or more
    candidates a warp runs once per window that holds its pairs (2 x 32
    passes, efficiency 1)."""
    (i_f, j_f), ranges = _line_case()
    got = pe.body_pass_counts(pe.DENSITY, i_f, j_f, 32, {}, (32, 64, 128), ranges=ranges)
    assert got == {"pairs": 64, "union": 2048, "windows": {32: 64, 64: 64, 128: 64}}
    # the symmetric cutoff d^2 < 4 h_j^2 keeps the same pairs here
    sym = dataclasses.replace(pe.DENSITY, sym_j=3)
    j_sym = j_f[:3] + [1.0 / (i_f[3] * i_f[3])]
    assert pe.body_pass_counts(sym, i_f, j_sym, 32, {}, (32,), ranges=ranges) == {
        "pairs": 64, "union": 2048, "windows": {32: 64}}
    # the counts agree with the engine's own neighbour counts
    _, nc = pe.engine_plain(pe.DENSITY, ranges, i_f, j_f, False, 32, pe.op_consts(
        _sedov_const()))
    assert nc.tolist() == [1] * 64


def test_body_pass_counts_busy_lane():
    """One lane with every other particle of the run (h = 100) next to
    lanes with one pair each: with a window of 32 candidates, the busy
    lane's 31 pairs in the first window and 32 in the second set the
    warp's passes (32 x 31 + 32 x 32); the union rule runs the same 63
    candidates for all lanes."""
    (i_f, j_f), ranges = _line_case()
    h = i_f[3].clone()
    h[0] = 100.0
    i_f, j_f = pe.density_fields(i_f[0], i_f[1], i_f[2], h, j_f[3])
    got = pe.body_pass_counts(pe.DENSITY, i_f, j_f, 32, {}, (32, 64), ranges=ranges)
    # group 0: lane 0 pairs with 63 candidates, lanes 1-31 with one each;
    # group 1: 32 lanes with one each, plus none (h_j does not count)
    assert got["pairs"] == 63 + 31 + 32
    assert got["union"] == 32 * 63 + 32 * 32
    assert got["windows"] == {32: 32 * 31 + 32 * 32 + 32, 64: 32 * 63 + 32}


def test_body_pass_counts_rejects_partial_warps():
    (i_f, j_f), ranges = _line_case()
    with pytest.raises(ValueError):
        pe.body_pass_counts(pe.DENSITY, i_f, j_f, 48, {}, (32,), ranges=ranges)


def _sedov_const():
    from sphexa_torch.init import init_sedov

    return init_sedov(4, device="cpu")[2]


def _mask_case():
    """A small list state on the CPU (Noh 12), its box, constants and
    config, and its lists."""
    from sphexa_torch.init import init_noh

    st, box, const = init_noh(12, device="cpu")
    cfg = make_propagator_config(st, box, const, use_lists=True)
    st, box, lists = rebuild_pair_lists(st, box, cfg)
    return st, box, const, cfg, lists


def test_mask_word_offsets_sized_per_group():
    """The list walk's mask-word layout: one 32-candidate word per target
    for every 32 marked lanes of its group (rounded up), groups one after
    another; the buffer itself is the card's (the plain walk keeps no
    words)."""
    _, _, _, _, lists = _mask_case()
    per_group = (lists.cnt.to(torch.int64).sum(dim=1) + 31) // 32
    assert lists.word_off.dtype == torch.int32
    assert lists.word_off.tolist() == [0] + torch.cumsum(per_group, 0).tolist()
    assert torch.equal(pe.mask_word_offsets(lists.cnt), lists.word_off)
    assert lists.mask_words is None


def test_mask_modes_checked_and_plain_agrees():
    """The mask modes are named, and the op that counts neighbours (density)
    cannot read a kept mask; on the CPU every mode runs the plain walk (the
    same pairs in the same order), so the outputs agree bit for bit."""
    st, box, const, cfg, lists = _mask_case()
    x, y, z, h, m = st.x, st.y, st.z, st.h, st.m
    with pytest.raises(ValueError, match="mask must be"):
        pe.mask_mode(pe.IAD, "keep")
    with pytest.raises(ValueError, match="counts neighbours"):
        pe.pallas_density(x, y, z, h, m, None, box, const, cfg.nbr, lists=lists, mask="read")
    assert [pe.mask_mode(pe.IAD, k) for k in ("own", "write", "read")] == [0, 1, 2]
    rho, nc, _ = pe.pallas_density(x, y, z, h, m, None, box, const, cfg.nbr, lists=lists)
    rho_w, nc_w, _ = pe.pallas_density(x, y, z, h, m, None, box, const, cfg.nbr, lists=lists,
                                       mask="write")
    assert torch.equal(rho, rho_w) and torch.equal(nc, nc_w)
    cs, _ = pe.pallas_iad(x, y, z, h, m / rho, None, box, const, cfg.nbr, lists=lists)
    cs_r, _ = pe.pallas_iad(x, y, z, h, m / rho, None, box, const, cfg.nbr, lists=lists,
                            mask="read")
    assert all(torch.equal(a, b) for a, b in zip(cs, cs_r))
