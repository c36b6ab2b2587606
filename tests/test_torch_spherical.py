"""The port's spherical multipoles against the JAX package's, on the CPU:
for orders P = 2..6 the regular and irregular harmonics, P2M, M2M and M2P
on the same seeded inputs; the autograd acceleration against finite
differences of the potential; the expansion's convergence and M2M's
invariance (tests/test_spherical.py's identities); the order-P upsweep
and a whole order-4 solve against the JAX compute_gravity; order 4 and 6
closer to direct summation than the cartesian quadrupole; and the sort
compaction with superblocks, whose lists equal the JAX package's.

Tolerances: the operators rtol 1e-5 (with a floor of 1e-6 max|.| where a
sum cancels to near zero), the finite-difference force rtol 1e-3
(tests/test_spherical.py:68-81), the solve at the JAX package's p2p
tolerance (rtol 1e-4, atol 1e-6 x max|.|) and egrav rel 1e-4, the
multipoles within the float32 cumulative sums' error
(tests/test_torch_gravity.py's 2e-4 relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.gravity import spherical as jsp
from sphexa_tpu.gravity.traversal import GravityConfig as JaxGravityConfig
from sphexa_tpu.gravity.traversal import compute_gravity as jax_compute_gravity
from sphexa_tpu.gravity.traversal import compute_multipoles as jax_multipoles
from sphexa_tpu.gravity.traversal import estimate_gravity_caps as jax_estimate
from sphexa_tpu.gravity.tree import linkage_from_leaves as jax_linkage
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.parallel.sizing import leaf_array_from_device_keys as jax_leaf_array
from sphexa_tpu.propagator import _sort_by_keys as jax_sort
from sphexa_tpu.sfc.box import make_global_box as jax_global_box

from sphexa_torch.convert import tree_from_numpy
from sphexa_torch.gravity import spherical as sp
from sphexa_torch.gravity import traversal as tt
from sphexa_torch.gravity.direct import direct_gravity
from sphexa_torch.init import init_evrard
from sphexa_torch.propagator import _force_stage_prologue
from sphexa_torch.sfc.box import Box
from sphexa_torch.simulation import Simulation

ORDERS = [2, 3, 4, 5, 6]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(a, b, rtol=1e-5, floor=1e-6, err_msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * float(np.abs(b).max()),
                               err_msg=err_msg)


def _cloud(n=64, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, spread, (n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos[:, 0], pos[:, 1], pos[:, 2], m


def _both(*arrays):
    return [torch.as_tensor(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("p", ORDERS)
def test_harmonics_match_jax(p):
    (tx, ty, tz), (jx, jy, jz) = _both(*_cloud(seed=p)[:3])
    for name in ("regular_harmonics", "irregular_harmonics"):
        out = getattr(sp, name)(tx, ty, tz, p)
        ref = getattr(jsp, name)(jx, jy, jz, p)
        assert len(out) == len(ref) == sp.ncoef(p) == jsp.ncoef(p)
        for k, (a, b) in enumerate(zip(out, ref)):
            assert a.dtype == torch.complex64
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("p", ORDERS)
def test_p2m_m2m_m2p_match_jax(p):
    """P2M over two leaves, M2M of both expansions, M2P of the two nodes
    (one masked) on eight far targets: values and the autograd forces."""
    rng = np.random.default_rng(10 + p)
    x, y, z, m = _cloud(seed=20 + p)
    edges = np.array([0, 20, 64])
    center = rng.normal(0, 0.1, (2, 3)).astype(np.float32)
    (tx, ty, tz, tm, tc), (jx, jy, jz, jm, jc) = _both(x, y, z, m, center)
    M = sp.p2m(tx, ty, tz, tm, tc, torch.as_tensor(edges), p)
    J = jsp.p2m(jx, jy, jz, jm, jc, jnp.asarray(edges, jnp.int32), p)
    _close(M, J, err_msg="p2m")
    d = rng.normal(0, 0.2, (2, 3)).astype(np.float32)
    _close(sp.m2m(M, torch.as_tensor(d), p), jsp.m2m(J, jnp.asarray(d), p), err_msg="m2m")
    targets = [rng.normal(2.0, 0.5, 8).astype(np.float32) for _ in range(3)]
    mask = np.array([True, False])
    (a0, a1, a2, am), (b0, b1, b2, bm) = _both(*targets, mask)
    out = sp.m2p(a0, a1, a2, tc, M, am, p)
    ref = jsp.m2p(b0, b1, b2, jc, J, bm, p)
    for name, a, b in zip(("ax", "ay", "az", "phi"), out, ref):
        assert not a.requires_grad
        _close(a, b, err_msg=f"m2p {name}")


def test_m2p_batched_over_blocks():
    """The port's M2P takes leading block dimensions (the solver's chunks):
    each block equals its own unbatched call."""
    p = 4
    x, y, z, m = _cloud(seed=3)
    (tx, ty, tz, tm), _ = _both(x, y, z, m)
    centers = torch.tensor([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05], [0.0, 0.3, 0.0]])
    M = sp.p2m(tx, ty, tz, tm, centers, torch.tensor([0, 20, 40, 64]), p)
    t = torch.tensor([[2.0, 2.5], [-1.5, 3.0]])
    mask = torch.tensor([[True, True, False], [True, False, True]])
    out = sp.m2p(t, t + 0.5, -t, centers.expand(2, 3, 3), M.expand(2, 3, sp.ncoef(p)), mask, p)
    for b in range(2):
        ref = sp.m2p(t[b], t[b] + 0.5, -t[b], centers, M, mask[b], p)
        for a, r in zip(out, ref):
            torch.testing.assert_close(a[b], r)


def test_m2p_autodiff_force_matches_fd():
    p = 4
    (tx, ty, tz, tm), _ = _both(*_cloud(seed=5))
    center = torch.zeros(1, 3)
    M = sp.p2m(tx, ty, tz, tm, center, torch.tensor([0, 64]), p)
    mask = torch.tensor([True])
    px, py, pz = torch.tensor([2.2]), torch.tensor([-1.1]), torch.tensor([1.4])
    ax, ay, az, _ = sp.m2p(px, py, pz, center, M, mask, p)
    eps = 1e-3
    for a, (dx, dy, dz) in ((ax, (eps, 0, 0)), (ay, (0, eps, 0)), (az, (0, 0, eps))):
        hi = sp.m2p(px + dx, py + dy, pz + dz, center, M, mask, p)[3]
        lo = sp.m2p(px - dx, py - dy, pz - dz, center, M, mask, p)[3]
        fd = -(float(hi[0]) - float(lo[0])) / (2 * eps)
        np.testing.assert_allclose(float(a[0]), fd, rtol=1e-3)


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_expansion_converges_to_direct(p):
    x, y, z, m = _cloud()
    (tx, ty, tz, tm), _ = _both(x, y, z, m)
    M = sp.p2m(tx, ty, tz, tm, torch.zeros(1, 3), torch.tensor([0, 64]), p)
    target = (2.0, 1.5, 1.8)
    phi = float(sp.potential(*(torch.tensor([v]) for v in target), M[0], p)[0])
    d = np.sqrt((target[0] - x) ** 2 + (target[1] - y) ** 2 + (target[2] - z) ** 2)
    exact = float(np.sum(m / d))
    assert abs(phi - exact) / abs(exact) < 0.45 ** (p - 1)


def test_m2m_preserves_far_potential():
    p = 4
    (tx, ty, tz, tm), _ = _both(*_cloud(seed=3))
    edges = torch.tensor([0, 64])
    c1, c2 = torch.zeros(1, 3), torch.tensor([[0.2, -0.1, 0.15]])
    direct = sp.p2m(tx, ty, tz, tm, c2, edges, p)
    moved = sp.m2m(sp.p2m(tx, ty, tz, tm, c1, edges, p), c1 - c2, p)
    t = [torch.tensor([3.0]) - c2[0, 0], torch.tensor([0.5]) - c2[0, 1],
         torch.tensor([-2.0]) - c2[0, 2]]
    np.testing.assert_allclose(float(sp.potential(*t, moved[0], p)[0]),
                               float(sp.potential(*t, direct[0], p)[0]), rtol=2e-5)


@pytest.fixture(scope="module")
def evrard():
    """Evrard 16, SFC-sorted, its tree from the JAX package's leaf array
    and the JAX caps (the engine near field), with the port's copies."""
    state, box, _ = jax_init_evrard(16)
    box = jax_global_box(state.x, state.y, state.z, box)
    ss, keys, _ = jax_sort(state, box, "hilbert")
    gtree, meta = jax_linkage(jax_leaf_array(keys, bucket_size=64))
    jcfg = jax_estimate(ss.x, ss.y, ss.z, ss.m, keys, box, gtree, meta,
                        JaxGravityConfig(theta=0.5, G=1.0, use_pallas=True))
    tree, tmeta = tree_from_numpy(
        {f.name: np.asarray(getattr(gtree, f.name)) for f in dataclasses.fields(gtree)},
        {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
         "level_ranges": meta.level_ranges}, device="cpu")
    xyzmh = [torch.as_tensor(np.asarray(getattr(ss, f)).copy()) for f in "xyzmh"]
    port = {"xyzmh": xyzmh, "keys": torch.as_tensor(np.asarray(keys).astype(np.int64)),
            "box": Box(lo=torch.as_tensor(np.asarray(box.lo).copy()),
                       hi=torch.as_tensor(np.asarray(box.hi).copy())),
            "tree": tree, "meta": tmeta}
    return {"ss": ss, "keys": keys, "box": box, "gtree": gtree, "meta": meta, "jcfg": jcfg,
            "port": port}


def _port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tt.GravityConfig)}
    return tt.GravityConfig(**{**{k: getattr(jcfg, k) for k in names}, **kw})


@pytest.mark.parametrize("p", [3, 6])
def test_spherical_multipoles_match_jax(evrard, p):
    """The order-P upsweep (P2M at the leaves, M2M level by level) against
    the JAX compute_multipoles(order=P): the root's coefficients, every
    node's within the cumulative sums' error; M_0^0 is the node mass."""
    pt = evrard["port"]
    x, y, z, m, _ = pt["xyzmh"]
    nm, com, q, edges = tt.compute_multipoles(x, y, z, m, pt["keys"], pt["tree"], pt["meta"],
                                              order=p)
    ss = evrard["ss"]
    jm, jc, jq, je = (np.asarray(a) for a in jax_multipoles(
        ss.x, ss.y, ss.z, ss.m, evrard["keys"], evrard["gtree"], evrard["meta"], order=p))
    np.testing.assert_array_equal(edges.numpy(), je)
    assert q.shape == jq.shape == (pt["meta"].num_nodes, sp.ncoef(p)) and q.is_complex()
    np.testing.assert_allclose(q[:, 0].real.numpy(), nm.numpy(), rtol=1e-5, atol=1e-9)
    _close(q[0], jq[0], rtol=1e-4, floor=1e-5, err_msg="root")
    np.testing.assert_allclose(q.numpy(), jq, atol=2e-4 * float(np.abs(jq).max()))


def test_order4_solve_matches_jax(evrard):
    """A whole order-4 solve against the JAX compute_gravity with the
    engine near field, each package from its own multipoles."""
    pt, ss = evrard["port"], evrard["ss"]
    jcfg = dataclasses.replace(evrard["jcfg"], multipole_order=4)
    ref = jax_compute_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, evrard["keys"], evrard["box"],
                              evrard["gtree"], evrard["meta"], jcfg)
    cfg = _port_cfg(jcfg)
    out = tt.compute_gravity(*pt["xyzmh"], pt["keys"], pt["box"], pt["tree"], pt["meta"], cfg)
    for name, a, b in zip(("ax", "ay", "az"), out[:3], ref[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert float(out[3]) == pytest.approx(float(ref[3]), rel=1e-4)
    for k in ("m2p_max", "p2p_max", "leaf_occ"):
        assert int(out[4][k]) == int(ref[4][k]), k


def test_higher_orders_beat_the_quadrupole():
    """tests/test_spherical.py's end-to-end knob: at theta 0.9 on Evrard
    12 (the N-body Simulation's tree and caps), order 4 comes closer to
    direct summation than the cartesian quadrupole, and order 6 closer
    than order 4."""
    sim = Simulation(*init_evrard(12, device="cpu"), prop="nbody", device="cpu")
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    dx, dy, dz, _ = direct_gravity(ss.x, ss.y, ss.z, ss.m, ss.h)
    aref = torch.sqrt(dx * dx + dy * dy + dz * dz)

    def err(order):
        cfg = dataclasses.replace(sim.cfg.gravity, G=1.0, theta=0.9, multipole_order=order)
        ax, ay, az, _, _ = tt.compute_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box,
                                              sim.gtree, sim.cfg.grav_meta, cfg)
        e = torch.sqrt((ax - dx) ** 2 + (ay - dy) ** 2 + (az - dz) ** 2)
        return float(torch.mean(e / (aref + 1e-12)))

    e_quad, e_p4, e_p6 = err(0), err(4), err(6)
    assert e_p4 < e_quad, (e_p4, e_quad)
    assert e_p6 < e_p4, (e_p6, e_p4)


def _jax_lists_super(ev, cfg):
    """The JAX sort compaction with superblocks, its per-block masks as
    traversal.py's one_super / one_block compute them (vmapped)."""
    ss, gtree, meta = ev["ss"], ev["gtree"], ev["meta"]
    from sphexa_tpu.gravity.traversal import _monotone_mac_geometry as jax_mac

    mps = jax_multipoles(ss.x, ss.y, ss.z, ss.m, ev["keys"], gtree, meta)
    valid = mps[0] > 0.0
    ccenter, chalf, mac2 = jax_mac(ev["box"], gtree, meta, mps[1], valid, cfg.theta)
    num_n = meta.num_nodes
    self_parent = gtree.parent == jnp.arange(num_n, dtype=gtree.parent.dtype)
    n, blk, sf = ss.x.shape[0], cfg.target_block, cfg.super_factor
    scap = min(cfg.super_cap, num_n)

    def bbox(bi):
        tx, ty, tz = ss.x[bi], ss.y[bi], ss.z[bi]
        bc = jnp.stack([(jnp.max(a) + jnp.min(a)) * 0.5 for a in (tx, ty, tz)])
        bs = jnp.stack([(jnp.max(a) - jnp.min(a)) * 0.5 for a in (tx, ty, tz)])
        return bc, bs

    def accept_of(bc, bs, gc, gs, m2):
        d = jnp.maximum(jnp.abs(bc[None, :] - gc) - bs[None, :] - gs, 0.0)
        return jnp.sum(d * d, axis=1) >= m2

    nsup = -(-n // (sf * blk))
    sidx = jnp.minimum(jnp.arange(nsup * sf * blk), n - 1).reshape(nsup, sf * blk)

    def one_super(si):
        bc, bs = bbox(si)
        accept = valid & accept_of(bc, bs, ccenter, chalf, mac2)
        cand = ~jnp.where(self_parent, False, accept[gtree.parent])
        ordc = jnp.argsort(~cand, stable=True)[:scap]
        cok = cand[ordc]
        cidx = jnp.where(cok, ordc, num_n).astype(jnp.int32)
        ppos = jnp.minimum(jnp.searchsorted(cidx, gtree.parent[jnp.minimum(cidx, num_n - 1)]),
                           scap - 1)
        return cidx, cok, ppos, jnp.sum(cand)

    scand, sok, spar, sn = jax.jit(jax.vmap(one_super))(sidx)
    nb = -(-n // blk)
    bidx = jnp.minimum(jnp.arange(nb * blk), n - 1).reshape(nb, blk)

    def one_block(bi, b):
        bc, bs = bbox(bi)
        sid = b // sf
        cidx = jnp.minimum(scand[sid], num_n - 1)
        cok, ppos = sok[sid], spar[sid]
        accept = cok & valid[cidx] & accept_of(bc, bs, ccenter[cidx], chalf[cidx], mac2[cidx])
        anc = accept[ppos] & (cidx[ppos] != cidx)
        m2p = accept & ~anc
        p2p = cok & gtree.is_leaf[cidx] & valid[cidx] & ~accept
        return cidx, m2p, p2p

    cidx, m2p, p2p = (np.asarray(a) for a in jax.jit(jax.vmap(one_block))(
        bidx, jnp.arange(nb)))
    return cidx, m2p, p2p, int(np.max(np.asarray(sn)))


@pytest.mark.parametrize("super_cap", [None, 96], ids=["full_cap", "cap_96"])
def test_sort_compaction_with_superblocks_matches_jax(evrard, super_cap):
    """The sort compaction with superblocks (compaction "sort",
    super_factor 8) from the JAX multipoles: every block's M2P and P2P
    lists (node order kept) and counts, and the superblock lists' high
    water, equal to the JAX package's; the whole solve equal to the dense
    sort's where the superblock lists hold every candidate."""
    pt = evrard["port"]
    ss = evrard["ss"]
    cap = pt["meta"].num_nodes if super_cap is None else super_cap
    cfg = _port_cfg(evrard["jcfg"], super_factor=8, super_cap=cap, compaction="sort")
    jm = [torch.as_tensor(np.asarray(a).copy()) for a in jax_multipoles(
        ss.x, ss.y, ss.z, ss.m, evrard["keys"], evrard["gtree"], evrard["meta"])]
    x, y, z = pt["xyzmh"][:3]
    lists = tt.classify(x, y, z, pt["box"], pt["tree"], pt["meta"], cfg, jm[0], jm[1])
    cidx, m2p, p2p, c_max = _jax_lists_super(evrard, cfg)
    assert int(lists["c_max"]) == c_max
    for name, masks, capn in (("m2p", m2p, cfg.m2p_cap), ("p2p", p2p, cfg.p2p_cap)):
        np.testing.assert_array_equal(lists[f"{name}_n"].numpy(), masks.sum(axis=1))
        got = torch.where(lists[f"{name}_ok"], lists[name].long(), -1).numpy()
        for b in range(masks.shape[0]):
            exp = cidx[b][masks[b]][:capn]
            np.testing.assert_array_equal(got[b, :len(exp)], exp, err_msg=f"{name} {b}")
            assert np.all(got[b, len(exp):] == -1)
    if super_cap is None:
        mps = tuple(jm)
        dense = tt.compute_gravity(*pt["xyzmh"], pt["keys"], pt["box"], pt["tree"], pt["meta"],
                                   _port_cfg(evrard["jcfg"]), multipoles=mps)
        two = tt.compute_gravity(*pt["xyzmh"], pt["keys"], pt["box"], pt["tree"], pt["meta"],
                                 cfg, multipoles=mps)
        for a, b in zip(two[:4], dense[:4]):
            torch.testing.assert_close(a, b)
        assert int(two[4]["c_max"]) == c_max and int(two[4]["compact_width"]) == cap
