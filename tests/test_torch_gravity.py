"""The port's gravity solver against the JAX package's, on the CPU (the
port's plain versions; the JAX package's Pallas kernels in interpret mode,
as its own tests run them).

Exact: SFC decode, the tree linkage, the leaf array from device keys, the
list compaction (K13's plain version), the MAC classification's lists and
counts in all three compactions when both packages start from the same
multipoles, and the sampled caps. Within a tolerance: the multipoles
(each package's float32 cumulative sums round differently: the root
within tests/test_gravity.py's bounds, mass rtol 1e-5, com atol 1e-4,
quadrupole atol 2e-3 x scale; every node within the 2e-4 relative error
that multipole.edge_segment_sum documents), the near field (K12's plain
version) and whole solves at the JAX package's p2p tolerance (rtol 1e-4,
atol 1e-6 x max|.|, tests/test_pallas_interpret.py), and the tree against
direct summation at tests/test_gravity.py's theta-0.5 bounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.gravity import pallas_compact as jax_compact
from sphexa_tpu.gravity.direct import direct_gravity as jax_direct
from sphexa_tpu.gravity.traversal import GravityConfig as JaxGravityConfig
from sphexa_tpu.gravity.traversal import _monotone_mac_geometry as jax_mac_geometry
from sphexa_tpu.gravity.traversal import _pallas_p2p as jax_pallas_p2p
from sphexa_tpu.gravity.traversal import compute_gravity as jax_compute_gravity
from sphexa_tpu.gravity.traversal import compute_multipoles as jax_multipoles
from sphexa_tpu.gravity.traversal import estimate_gravity_caps as jax_estimate
from sphexa_tpu.gravity.tree import linkage_from_leaves as jax_linkage
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init.plummer import sample_plummer
from sphexa_tpu.parallel.sizing import leaf_array_from_device_keys as jax_leaf_array
from sphexa_tpu.propagator import _sort_by_keys as jax_sort
from sphexa_tpu.sfc.box import Box as JaxBox
from sphexa_tpu.sfc.box import BoundaryType as JaxBoundary
from sphexa_tpu.sfc.box import make_global_box as jax_global_box
from sphexa_tpu.sfc.hilbert import hilbert_decode as jax_hilbert_decode
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.sfc.morton import morton_decode as jax_morton_decode

from sphexa_torch.convert import tree_from_numpy
from sphexa_torch.gravity import pallas_compact as pc
from sphexa_torch.gravity import traversal as tt
from sphexa_torch.gravity.direct import direct_gravity
from sphexa_torch.gravity.tree import linkage_from_leaves
from sphexa_torch.kernels.checks import IMAGE_SHIFT
from sphexa_torch.parallel.sizing import leaf_array_from_device_keys
from sphexa_torch.sfc.box import Box
from sphexa_torch.sfc.hilbert import hilbert_decode
from sphexa_torch.sfc.morton import morton_decode

MODES = {"sort": {}, "bitmask": {"compaction": "bitmask"},
         "bitmask_sf8": {"compaction": "bitmask", "super_factor": 8}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None and a.dtype.kind in "iu":
        dtype = torch.int64
    return torch.as_tensor(a.copy(), dtype=dtype)


def _tree_dict(tree, meta):
    arrays = {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return arrays, {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
                    "level_ranges": meta.level_ranges}


def _port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tt.GravityConfig)}
    return tt.GravityConfig(**{**{k: getattr(jcfg, k) for k in names}, **kw})


@pytest.fixture(scope="module")
def evrard():
    """Evrard 16 (2,163 particles), SFC-sorted, its tree from the JAX
    package's leaf array, the JAX multipoles and sampled caps, and the
    same arrays as port tensors."""
    state, box, _ = jax_init_evrard(16)
    box = jax_global_box(state.x, state.y, state.z, box)
    ss, keys, _ = jax_sort(state, box, "hilbert")
    gtree, meta = jax_linkage(jax_leaf_array(keys, bucket_size=64))
    jcfg = jax_estimate(ss.x, ss.y, ss.z, ss.m, keys, box, gtree, meta,
                        JaxGravityConfig(theta=0.5, G=1.0, use_pallas=True))
    mps = jax_multipoles(ss.x, ss.y, ss.z, ss.m, keys, gtree, meta)
    tree, tmeta = tree_from_numpy(*_tree_dict(gtree, meta), device="cpu")
    port = {
        "xyzmh": [_t(getattr(ss, f)) for f in ("x", "y", "z", "m", "h")],
        "keys": _t(keys), "box": Box(lo=_t(box.lo), hi=_t(box.hi)),
        "tree": tree, "meta": tmeta,
        "mps": tuple(_t(a) for a in mps),
    }
    return {"ss": ss, "keys": keys, "box": box, "gtree": gtree, "meta": meta,
            "jcfg": jcfg, "mps": mps, "port": port}


def _jax_lists(ev, cfg):
    """The JAX package's dense per-block classification (traversal.py
    one_block, the sort path's masks), vmapped over blocks as there."""
    ss, gtree, meta = ev["ss"], ev["gtree"], ev["meta"]
    node_mass, node_com = ev["mps"][0], ev["mps"][1]
    valid = node_mass > 0.0
    ccenter, chalf, mac2 = jax_mac_geometry(ev["box"], gtree, meta, node_com, valid,
                                            tt.THETA)
    self_parent = gtree.parent == jnp.arange(meta.num_nodes, dtype=gtree.parent.dtype)
    n, blk = ss.x.shape[0], cfg.target_block
    nb = -(-n // blk)
    idx = jnp.minimum(jnp.arange(nb * blk, dtype=jnp.int32), n - 1).reshape(nb, blk)

    def one_block(bi):
        tx, ty, tz = ss.x[bi], ss.y[bi], ss.z[bi]
        bc = jnp.stack([(jnp.max(a) + jnp.min(a)) * 0.5 for a in (tx, ty, tz)])
        bs = jnp.stack([(jnp.max(a) - jnp.min(a)) * 0.5 for a in (tx, ty, tz)])
        d = jnp.maximum(jnp.abs(bc[None, :] - ccenter) - bs[None, :] - chalf, 0.0)
        accept = valid & (jnp.sum(d * d, axis=1) >= mac2)
        anc = jnp.where(self_parent, False, accept[gtree.parent])
        return accept & ~anc, gtree.is_leaf & valid & ~accept

    m2p, p2p = (np.asarray(a) for a in jax.jit(jax.vmap(one_block))(idx))
    return m2p, p2p


# ---------------------------------------------------------------------------
# exact parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_decode_matches_jax(curve):
    keys = np.random.default_rng(3).integers(0, 1 << 30, size=20000)
    jdec = jax_hilbert_decode if curve == "hilbert" else jax_morton_decode
    tdec = hilbert_decode if curve == "hilbert" else morton_decode
    for a, b in zip(tdec(torch.as_tensor(keys)), jdec(jnp.asarray(keys, jnp.uint32))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def _plummer_keys(n=20000):
    x, y, z, _ = sample_plummer(n)
    r = float(np.max(np.abs(np.stack([x, y, z])))) * 1.001
    box = JaxBox.create(-r, r, boundary=JaxBoundary.open)
    return np.sort(np.asarray(jax_keys(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), box)))


@pytest.mark.parametrize("case", ["evrard16", "plummer"])
def test_leaf_array_from_device_keys_matches_jax(evrard, case):
    keys = np.asarray(evrard["keys"]) if case == "evrard16" else _plummer_keys()
    ref = jax_leaf_array(jnp.asarray(keys), bucket_size=64)
    out = leaf_array_from_device_keys(torch.as_tensor(keys.astype(np.int64)), bucket_size=64)
    np.testing.assert_array_equal(out, np.asarray(ref, dtype=np.uint64))


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_linkage_matches_jax(evrard, curve):
    leaves = jax_leaf_array(evrard["keys"], bucket_size=32)
    jtree, jmeta = jax_linkage(leaves, curve=curve)
    ttree, tmeta = linkage_from_leaves(leaves, curve=curve)
    assert (tmeta.num_leaves, tmeta.num_nodes, tmeta.level_ranges) == \
        (jmeta.num_leaves, jmeta.num_nodes, jmeta.level_ranges)
    for f in dataclasses.fields(jtree):
        a, b = getattr(ttree, f.name).numpy(), np.asarray(getattr(jtree, f.name))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f.name)


@pytest.mark.parametrize("B,C,cap0,cap1", [(4, 1000, 192, 64), (1, 90, 8, 8),
                                           (3, 513, 256, 48), (3, 3, 2, 2), (2, 5, 1, 4),
                                           (5, 1001, 200, 300), (2, 4500, 1100, 2000),
                                           (7, 2050, 1500, 5)])
def test_compact_plain_matches_jax_kernel(B, C, cap0, cap1):
    """K13's plain version against the JAX kernel in interpret mode, on
    test_pallas_interpret.py's random cases and on the widths the card
    kernel's tiles (1,024 candidates read as 16-byte words) cut: rows
    narrower than a word, widths off the multiples of 4, caps that cut
    inside a tile, a row longer than four tiles."""
    rng = np.random.default_rng(7)
    cls = rng.integers(0, 3, size=(B, C))
    vals = rng.integers(0, 1 << 20, size=(B, C))
    packed = (cls << pc.IDX_BITS) | vals
    ref = jax_compact.compact_class_lists(jnp.asarray(packed, jnp.int32), cap0, cap1,
                                          interpret=True)
    out = pc.compact_class_lists(torch.as_tensor(packed, dtype=torch.int32), cap0, cap1)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", list(MODES))
def test_classification_matches_jax(evrard, mode):
    """The M2P and P2P lists and counts of every block, fed the JAX
    multipoles: equal to the JAX package's dense classification in all
    three compactions (the JAX package pins bitmask == sort bitwise)."""
    p = evrard["port"]
    extra = dict(MODES[mode])
    if extra.get("super_factor"):
        extra["super_cap"] = p["meta"].num_nodes
    cfg = _port_cfg(evrard["jcfg"], **extra)
    x, y, z = p["xyzmh"][:3]
    lists = tt.classify(x, y, z, p["box"], p["tree"], p["meta"], cfg, p["mps"][0],
                        p["mps"][1])
    m2p, p2p = _jax_lists(evrard, cfg)
    for name, masks, cap in (("m2p", m2p, cfg.m2p_cap), ("p2p", p2p, cfg.p2p_cap)):
        np.testing.assert_array_equal(lists[f"{name}_n"].numpy(), masks.sum(axis=1))
        got = torch.where(lists[f"{name}_ok"], lists[name].long(), -1).numpy()
        for b, row in enumerate(masks):
            exp = np.flatnonzero(row)[:cap]
            np.testing.assert_array_equal(got[b, :len(exp)], exp, err_msg=f"{name} {b}")
            assert np.all(got[b, len(exp):] == -1)
    if mode == "bitmask_sf8":
        assert 0 < int(lists["c_max"]) <= p["meta"].num_nodes


@pytest.mark.parametrize("super_factor", [0, 8])
def test_estimate_caps_match_jax(evrard, super_factor):
    p = evrard["port"]
    jcfg = dataclasses.replace(evrard["jcfg"], super_factor=super_factor,
                               compaction="bitmask" if super_factor else "sort")
    ref = jax_estimate(evrard["ss"].x, evrard["ss"].y, evrard["ss"].z, evrard["ss"].m,
                       evrard["keys"], evrard["box"], evrard["gtree"], evrard["meta"],
                       jcfg)
    x, y, z, m, _ = p["xyzmh"]
    out = tt.estimate_gravity_caps(x, y, z, m, p["keys"], p["box"], p["tree"], p["meta"],
                                   _port_cfg(jcfg), multipoles=p["mps"])
    for k in ("m2p_cap", "p2p_cap", "leaf_cap", "super_cap"):
        assert getattr(out, k) == getattr(ref, k), k


# ---------------------------------------------------------------------------
# parts within a tolerance
# ---------------------------------------------------------------------------


def test_multipoles_match_jax(evrard):
    p = evrard["port"]
    x, y, z, m, _ = p["xyzmh"]
    nm, com, q, edges = tt.compute_multipoles(x, y, z, m, p["keys"], p["tree"], p["meta"])
    jm, jc, jq, je = (np.asarray(a) for a in evrard["mps"])
    np.testing.assert_array_equal(edges.numpy(), je)
    # the root, at tests/test_gravity.py's bounds
    assert float(nm[0]) == pytest.approx(float(jm[0]), rel=1e-5)
    np.testing.assert_allclose(com[0].numpy(), jc[0], atol=1e-4)
    qscale = max(1.0, float(np.abs(jq[0]).max()))
    np.testing.assert_allclose(q[0].numpy() / qscale, jq[0] / qscale, atol=2e-3)
    # every node, within the float32 cumulative sums' error
    np.testing.assert_allclose(nm.numpy(), jm, atol=2e-4 * float(jm[0]))
    np.testing.assert_allclose(com.numpy(), jc, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), jq, atol=2e-3 * float(np.abs(jq).max()))


@pytest.mark.parametrize("allow_self,shift",
                         [(False, None), (True, IMAGE_SHIFT), (False, IMAGE_SHIFT)],
                         ids=["open_box", "image_self", "image_noself"])
def test_near_field_plain_matches_jax_kernel(evrard, allow_self, shift):
    """K12's plain version against the JAX near field (_pallas_p2p in
    interpret mode) on the same leaf ranges: the open-box solve's call (no
    shift, no self pair) and an image's (the targets shifted), with the
    self pair kept, as Ewald's replicas call it, and dropped."""
    p = evrard["port"]
    cfg = _port_cfg(evrard["jcfg"])
    x, y, z, m, h = p["xyzmh"]
    lists = tt.classify(x, y, z, p["box"], p["tree"], p["meta"], cfg, p["mps"][0],
                        p["mps"][1])
    start, length = tt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], p["tree"],
                                        p["mps"][3], p["meta"].num_nodes)
    assert start.dtype == length.dtype == torch.int32
    assert start.shape == length.shape == (lists["p2p"].shape[0], cfg.p2p_cap)
    sh = np.asarray(shift or (0.0, 0.0, 0.0), np.float32)
    out = tt._pallas_p2p(x, y, z, m, h, torch.as_tensor(sh), allow_self, cfg, start, length)
    ss = evrard["ss"]
    ref = jax_pallas_p2p(ss.x, ss.y, ss.z, ss.m, ss.h, jnp.asarray(sh),
                         jnp.asarray(allow_self), evrard["jcfg"],
                         jnp.asarray(start.numpy()), jnp.asarray(length.numpy()))
    n = x.shape[0]
    for name, a, b in zip(("ax", "ay", "az", "phi"), out, ref):
        b = np.asarray(b)[:n]
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)


def test_near_field_self_pair_counts_only_when_allowed(evrard):
    """With a shift the self pair is a real pair: dropping it (allow_self
    False) moves every target's sums by its own term, which the plain
    version adds back exactly where allow_self is True."""
    p = evrard["port"]
    cfg = _port_cfg(evrard["jcfg"])
    x, y, z, m, h = p["xyzmh"]
    lists = tt.classify(x, y, z, p["box"], p["tree"], p["meta"], cfg, p["mps"][0],
                        p["mps"][1])
    start, length = tt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], p["tree"],
                                        p["mps"][3], p["meta"].num_nodes)
    sh = torch.tensor(IMAGE_SHIFT)
    keep = tt._pallas_p2p(x, y, z, m, h, sh, True, cfg, start, length)
    drop = tt._pallas_p2p(x, y, z, m, h, sh, False, cfg, start, length)
    # the target's own term: r = shift, d^2 = |shift|^2, softened at 2 h
    d2 = float((sh * sh).sum())
    w = m / torch.clamp_min(torch.maximum(torch.tensor(d2), (2 * h) ** 2), 1e-30) ** 1.5
    own = [-sh[0] * w, -sh[1] * w, -sh[2] * w, -w * d2]
    for name, a, b, o in zip(("ax", "ay", "az", "phi"), keep, drop, own):
        scale = float(a.abs().max())
        assert float((a - b).abs().min()) > 0.0, name
        np.testing.assert_allclose((a - b).numpy(), o.numpy(), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=name)


def test_compute_gravity_hands_leaf_ranges_to_the_near_field(evrard, monkeypatch):
    """compute_gravity passes the near field the (NB, p2p_cap) int32 leaf
    ranges themselves, unmerged (the card kernel reads them as they come),
    with no shift and no self pair."""
    p = evrard["port"]
    cfg = _port_cfg(evrard["jcfg"])
    seen = []
    real = tt._pallas_p2p

    def spy(x, y, z, m, h, shift, allow_self, cfg_, starts, lens):
        seen.append((shift.clone(), allow_self, starts, lens))
        return real(x, y, z, m, h, shift, allow_self, cfg_, starts, lens)

    monkeypatch.setattr(tt, "_pallas_p2p", spy)
    tt.compute_gravity(*p["xyzmh"], p["keys"], p["box"], p["tree"], p["meta"], cfg,
                       multipoles=p["mps"])
    (shift, allow_self, starts, lens), = seen
    nb = -(-p["xyzmh"][0].shape[0] // cfg.target_block)
    assert not allow_self and not bool(shift.any())
    assert starts.dtype == lens.dtype == torch.int32
    assert starts.shape == lens.shape == (nb, cfg.p2p_cap)
    lists = tt.classify(*p["xyzmh"][:3], p["box"], p["tree"], p["meta"], cfg, p["mps"][0],
                        p["mps"][1])
    ref = tt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], p["tree"], p["mps"][3],
                              p["meta"].num_nodes)
    assert torch.equal(starts, ref[0]) and torch.equal(lens, ref[1])


@pytest.mark.parametrize("blk,r", [(64, 2), (128, 4), (192, 2), (256, 4)])
def test_p2p_targets_per_thread(blk, r):
    """K12's targets a thread: P2P_TARGETS where blk / r threads make whole
    warps, 2 where they would not."""
    assert tt.P2P_TARGETS == 4
    assert tt.p2p_targets_per_thread(blk) == r


@pytest.mark.parametrize("blk", [0, 32, 48, 96, 512])
def test_p2p_targets_per_thread_refuses(blk):
    with pytest.raises(ValueError):
        tt.p2p_targets_per_thread(blk)


def test_p2p_block_order_heaviest_first():
    """Blocks by descending candidate count, ties in block order."""
    lens = torch.tensor([[3, 0, 0], [5, 4, 0], [1, 1, 0], [2, 2, 1], [9, 0, 0]],
                        dtype=torch.int32)
    order = tt.p2p_block_order(lens)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 4, 3, 0, 2]


def _evrard_leaf_ranges(evrard, **extra):
    p = evrard["port"]
    if extra.get("super_factor"):
        extra["super_cap"] = p["meta"].num_nodes
    cfg = _port_cfg(evrard["jcfg"], **extra)
    lists = tt.classify(*p["xyzmh"][:3], p["box"], p["tree"], p["meta"], cfg, p["mps"][0],
                        p["mps"][1], keep_packed=bool(extra))
    start, length = tt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], p["tree"],
                                        p["mps"][3], p["meta"].num_nodes)
    return cfg, lists, start, length


def test_chip_smoke_gravity_bounds_count_the_leaf_ranges(evrard):
    """chip_smoke's K12 bound counts the candidate pairs of the leaf ranges
    (the sum of their lengths x the block's targets), the same as the runs
    the plain version merges them into, and refuses runs that hold other
    candidates; K13's bound covers both compactions and each launch."""
    import chip_smoke

    cfg, lists, start, length = _evrard_leaf_ranges(evrard, compaction="bitmask",
                                                    super_factor=8)
    runs = tt.p2p_runs(start, length, cfg)
    n = evrard["port"]["xyzmh"][0].shape[0]
    out = chip_smoke.gravity_bounds(length, n, cfg.target_block, lists["packed"], runs=runs)
    cand = int(length.sum()) * cfg.target_block
    assert out["gravity_p2p"]["cand_pairs"] == cand > 0
    assert out["gravity_p2p"]["ops"] == cand * (chip_smoke.GRAV_MASK_OPS
                                                + chip_smoke.GRAV_BODY_OPS)
    k13 = out["compact_class_lists"]
    assert len(lists["packed"]) == len(k13["per_launch"]) == len(k13["shapes"]) == 2
    assert k13["bytes"] == sum(e["bytes"] for e in k13["per_launch"])
    assert k13["slots"] == sum(int(p.numel()) for p, _, _ in lists["packed"])
    short = runs._replace(lens=torch.where(runs.lens > 0, runs.lens - 1, 0))
    with pytest.raises(AssertionError):
        chip_smoke.gravity_bounds(length, n, cfg.target_block, lists["packed"], runs=short)


def test_chip_smoke_near_field_load(evrard):
    """chip_smoke's per-block near-field candidates: mean, median, 99th
    percentile, max and min of the leaf lengths' row sums."""
    import chip_smoke

    cfg, _, _, length = _evrard_leaf_ranges(evrard)
    out = chip_smoke.near_field_load(length, cfg.target_block)
    per = length.numpy().astype(np.int64).sum(axis=1)
    assert out["blocks"] == per.shape[0] and out["slots"] == cfg.p2p_cap
    assert out["cand_per_block_mean"] == pytest.approx(per.mean())
    assert out["cand_per_block_max"] == per.max() and out["cand_per_block_min"] == per.min()
    assert out["cand_per_block_p99"] == pytest.approx(np.quantile(per, 0.99))
    assert out["max_over_mean"] == pytest.approx(per.max() / per.mean())
    assert out["live_slots_mean"] == pytest.approx((length.numpy() > 0).sum(axis=1).mean())


@pytest.mark.parametrize("mode", list(MODES))
def test_compute_gravity_matches_jax(evrard, mode):
    """Whole solves against the JAX package's compute_gravity with the
    engine near field, from each package's own multipoles; the integer
    diagnostics from the same multipoles are equal."""
    p = evrard["port"]
    extra = dict(MODES[mode])
    if extra.get("super_factor"):
        extra["super_cap"] = p["meta"].num_nodes
    jcfg = dataclasses.replace(evrard["jcfg"], **extra)
    cfg = _port_cfg(jcfg)
    ss = evrard["ss"]
    jargs = (ss.x, ss.y, ss.z, ss.m, ss.h, evrard["keys"], evrard["box"], evrard["gtree"],
             evrard["meta"], jcfg)
    ref = jax_compute_gravity(*jargs)
    targs = (*p["xyzmh"], p["keys"], p["box"], p["tree"], p["meta"], cfg)
    out = tt.compute_gravity(*targs)
    for name, a, b in zip(("ax", "ay", "az"), out[:3], ref[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert float(out[3]) == pytest.approx(float(ref[3]), rel=1e-4)
    shared = tt.compute_gravity(*targs, multipoles=p["mps"])[4]
    for k in ("m2p_max", "p2p_max", "leaf_occ", "c_max", "compact_width",
              "mac_work_ratio"):
        assert float(shared[k]) == float(ref[4][k]), k


@pytest.mark.parametrize("n", [5000])
def test_tree_vs_direct(n):
    """Barnes-Hut against direct summation on a Plummer sphere, at
    tests/test_gravity.py's theta-0.5 bounds (rms relative error < 0.01,
    99th percentile < 0.05, egrav within 2e-3); the port's direct sum
    against the JAX package's."""
    x, y, z, m = sample_plummer(n)
    lim = float(np.max(np.abs([x, y, z]))) * 1.001
    jbox = JaxBox.create(-lim, lim)
    keys = np.asarray(jax_keys(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jbox))
    order = np.argsort(keys, kind="stable")
    x, y, z, m = (torch.as_tensor(np.asarray(a, np.float32)[order]) for a in (x, y, z, m))
    h = torch.full((n,), 0.02)
    tkeys = torch.as_tensor(keys[order].astype(np.int64))
    box = Box(lo=torch.full((3,), -lim), hi=torch.full((3,), lim))
    tree, meta = linkage_from_leaves(leaf_array_from_device_keys(tkeys, 64))
    cfg = tt.estimate_gravity_caps(x, y, z, m, tkeys, box, tree, meta,
                                   tt.GravityConfig())
    ax, ay, az, egrav, diag = tt.compute_gravity(x, y, z, m, h, tkeys, box, tree, meta, cfg)
    assert int(diag["m2p_max"]) <= cfg.m2p_cap and int(diag["p2p_max"]) <= cfg.p2p_cap
    dax, day, daz, degrav = direct_gravity(x, y, z, m, h)
    err = torch.sqrt((ax - dax) ** 2 + (ay - day) ** 2 + (az - daz) ** 2)
    rel = (err / torch.clamp_min(torch.sqrt(dax**2 + day**2 + daz**2), 1e-6)).numpy()
    assert np.sqrt(np.mean(rel**2)) < 0.01
    assert np.percentile(rel, 99) < 0.05
    assert float(egrav) == pytest.approx(float(degrav), rel=2e-3)
    ref = jax_direct(*(jnp.asarray(a.numpy()) for a in (x, y, z, m, h)))
    for a, b in zip((dax, day, daz), ref[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max())
    assert float(degrav) == pytest.approx(float(ref[3]), rel=1e-5)
