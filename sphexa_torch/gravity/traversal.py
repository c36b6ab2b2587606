"""Traversal-free Barnes-Hut gravity (sphexa_tpu/gravity/traversal.py):
every target block evaluates a monotone vector MAC against the tree's
nodes at once and classifies each node; the M2P set (accepted, parent not
accepted) and the P2P set (leaves not accepted) are compacted into
fixed-cap lists.

Two compactions, as in the JAX package: "sort" (each block's packed
3-class key sorted over its candidates; below 500k particles) and
"bitmask" (the class of every candidate packed with its node index and
compacted by ``pallas_compact.compact_class_lists``, the K13 kernel). Both
can be two-level: a superblock of ``super_factor`` blocks keeps its open
set and accepted cut (the pre-pass: a stable argsort in the sort mode, a
compaction in the bitmask mode), and its blocks classify against that
list only.

The far field is plain PyTorch, chunked over blocks so that its
temporaries stay a few GB: the cartesian quadrupole (``multipole.m2p``)
or, with ``multipole_order`` P > 0, spherical multipoles of order P
(``spherical.m2p``, open boxes only). The near field pairs every target with
every particle of its block's near-field leaves (``_pallas_p2p``: on the
card the K12 kernel of csrc/gravity_p2p.cu, which reads the leaf ranges as
they come; its plain version merges them into runs and streams them
through the plain pair engine with no distance cutoff). Every shape
follows from the caps, so a solve reads nothing back to the host; the
diagnostics report the high-water marks that the caller checks against
the caps (an overflow re-sizes and replays the step). A solve may shift
its targets (the replica passes of Ewald gravity, ``gravity/ewald.py``):
the classification, M2P and the near field then see the targets at
``x + shift``, and the near field pairs a target with its own image only
with ``allow_self``.

Across ranks (``shard=``, parallel/mesh.py; the JAX package's shard_map
solve) each rank's targets are its slab of the sorted particles: the
multipoles come from ``compute_multipoles_sharded`` (each rank's partial
leaf sums over its slab, summed over the ranks in rank order, the
upsweep replicated; node arrays bit-identical on every rank), blocks
classify against the rank's essential set (the LET: the nodes whose
parent the slab's bbox does not accept, ``GravityConfig.let_cap``), and
the near field's leaf ranges, global rows, are localized into a j-buffer
[own slab | halo rows] served by the halo exchanges of
parallel/exchange.py (``edges`` is the cell table of the MAC-sized
sparse serve), which K12 reads in its jdata form (the gather backend's
``_p2p_xla`` the same j-buffer); runs outside the
served rows flip the p2p occupancy to the cap + 1 sentinel.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sphexa_torch.gravity import multipole as mp
from sphexa_torch.gravity import pallas_compact as pcmp
from sphexa_torch.gravity import spherical as sp
from sphexa_torch.gravity.tree import GravityTree, GravityTreeMeta, level_add_
from sphexa_torch.kernels import costs
from sphexa_torch.sfc.box import Box
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.util.phases import check_runs, named_phase

#: elements of one (blocks, targets or candidates, nodes) temporary per
#: chunk of the classification and the M2P evaluation
CHUNK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 25}

#: default opening angle of the MAC (the JAX package's)
THETA = 0.5
#: leaf capacity target of the tree build (the JAX package's bucket_size)
GRAV_BUCKET = 64
#: default margin of the sampled m2p cap (M2P cost is linear in it)
M2P_CAP_MARGIN = 1.3
#: the spherical M2P's autograd graph holds about 16 float32 words per
#: pair and coefficient at its peak (the cartesian form about 30 per
#: pair): its chunks hold ncoef / SPHERICAL_CHUNK_DIVISOR times fewer pairs
SPHERICAL_CHUNK_DIVISOR = 2


@dataclasses.dataclass(frozen=True)
class GravityConfig:
    """Static gravity-solver configuration (the JAX GravityConfig's fields
    that the port reads; the near field is ``compute_gravity``'s
    ``gather_p2p`` argument, the JAX package's use_pallas)."""

    theta: float = THETA  # opening angle of the MAC
    target_block: int = 64  # particles per MAC target group
    m2p_cap: int = 512  # max accepted multipoles per target block
    p2p_cap: int = 48  # max near-field leaves per target block
    leaf_cap: int = 128  # max particles per near-field leaf
    G: float = 1.0
    # blocks per superblock of the two-level classification (0 = one level)
    super_factor: int = 0
    super_cap: int = 1024  # max candidates of a superblock's list
    # "sort" (packed 3-class sort) or "bitmask" (the compaction kernel)
    compaction: str = "sort"
    # 0: the cartesian quadrupole; P >= 2: spherical multipoles keeping P
    # orders (gravity/spherical.py; open boxes only)
    multipole_order: int = 0
    # the sampled m2p cap's own margin (estimate_gravity_caps)
    m2p_cap_margin: float = M2P_CAP_MARGIN
    # the per-rank essential-set cap of the sharded solves (0: off): blocks
    # classify against the nodes the slab's bbox does not prune
    let_cap: int = 0


def gravity_tuning(n: int, use_pallas: bool = True) -> dict:
    """Scale-dependent solver shape, as the JAX package's gravity_tuning:
    coarser blocks from 500k particles, and there, with the engine near
    field (``use_pallas``), the two-level bitmask compaction (K13); the
    gather backend keeps the one-level sort compaction at every N."""
    big = n >= 500_000
    return {"target_block": 256 if big else 64,
            "super_factor": 8 if (big and use_pallas) else 0,
            "compaction": "bitmask" if (big and use_pallas) else "sort"}


def _slab_blocks(x, y, z, blk: int, mesh=None):
    """The target blocks of the rows: their (nb, blk) coordinates tx, ty,
    tz, (nb, 3) min and max, and ``lead``. One device: the rows [b blk,
    (b + 1) blk), the tail block padded with the last row, ``lead`` 0.
    ``mesh``: the rows are rank k's slab, the rows [kS, (k + 1) S) of the
    global sorted array, and its blocks are the global array's blocks
    that meet it, so that every rank classifies the one-device blocks:
    the first is led by ``lead`` = kS mod blk copies of row 0 (targets
    that the solve drops), and a block shared with other ranks takes the
    bbox of all its rows (each rank's first and last block extrema,
    all_gathered)."""
    n = x.shape[0]
    dev = x.device
    lead = 0 if mesh is None else (mesh.rank * n) % blk
    idx = _block_rows(n, blk, lead, device=dev)
    nb = idx.shape[0]
    tx, ty, tz = x[idx], y[idx], z[idx]
    bmin = torch.stack([tx.amin(1), ty.amin(1), tz.amin(1)], dim=1)
    bmax = torch.stack([tx.amax(1), ty.amax(1), tz.amax(1)], dim=1)
    if mesh is not None and mesh.size > 1:
        from sphexa_torch.parallel.mesh import all_gather

        g = all_gather(mesh, torch.cat([bmin[[0, -1]], bmax[[0, -1]]], dim=1))  # (P, 2, 6)
        r = torch.arange(mesh.size, device=dev)
        ids = torch.stack([r * n // blk, ((r + 1) * n - 1) // blk], dim=1)[..., None]
        inf = torch.tensor(float("inf"), dtype=x.dtype, device=dev)
        bmin, bmax = bmin.clone(), bmax.clone()
        for row, b in ((0, mesh.rank * n // blk), (nb - 1, ((mesh.rank + 1) * n - 1) // blk)):
            bmin[row] = torch.where(ids == b, g[..., :3], inf).amin(dim=(0, 1))
            bmax[row] = torch.where(ids == b, g[..., 3:], -inf).amax(dim=(0, 1))
    return tx, ty, tz, bmin, bmax, lead


def _lead_rows(fields, lead: int) -> tuple:
    """Each field led by ``lead`` copies of its row 0 (``_slab_blocks``)."""
    if lead == 0:
        return tuple(fields)
    return tuple(torch.cat([f[:1].expand(lead), f]) for f in fields)


def _block_rows(n: int, blk: int, lead: int = 0, device=None) -> torch.Tensor:
    """(nb, blk) particle rows of the target blocks, led by ``lead``
    copies of row 0; rows past the last particle repeat it (min(idx, n -
    1))."""
    nb = -(-(lead + n) // blk)
    idx = torch.arange(nb * blk, device=device) - lead
    return torch.clamp(idx, 0, n - 1).reshape(nb, blk)


def _global_block_bboxes(mesh, x, y, z, blk: int):
    """The block bboxes of the global sorted array from every rank's slab
    (rank k holds rows [k S, (k + 1) S)): each rank's per-block extrema
    of its own rows (+-inf elsewhere), all_gathered and reduced. The same
    (nb, 3) pair on every rank; O(N / blk) travels."""
    from sphexa_torch.parallel.mesh import all_gather

    S = x.shape[0]
    n = S * mesh.size
    nb = -(-n // blk)
    dev = x.device
    blocks = (mesh.rank * S + torch.arange(S, device=dev)) // blk
    pos = torch.stack([x, y, z], dim=1)
    lo = torch.full((nb, 3), float("inf"), dtype=x.dtype, device=dev)
    hi = torch.full((nb, 3), float("-inf"), dtype=x.dtype, device=dev)
    idx = blocks[:, None].expand(-1, 3)
    lo = lo.scatter_reduce(0, idx, pos, "amin")
    hi = hi.scatter_reduce(0, idx, pos, "amax")
    g = all_gather(mesh, torch.cat([lo, hi], dim=1))  # (P, nb, 6)
    return g[..., :3].amin(dim=0), g[..., 3:].amax(dim=0)


def estimate_gravity_caps(x, y, z, m, sorted_keys, box: Box, tree: GravityTree,
                          meta: GravityTreeMeta, cfg: GravityConfig,
                          sample_blocks: int = 256, margin: float = 1.5,
                          quantum: int = 32, multipoles=None, let_shards: int = 0,
                          mesh=None) -> GravityConfig:
    """Size the interaction-list caps from the current distribution: the
    MAC classification of a sample of target blocks (numpy generator
    seed 0, as the JAX package samples) in host numpy, padded maxima.
    Only O(tree) and O(N / target_block) arrays reach the host. The
    overflow diagnostics of ``compute_gravity`` stay the guard.
    ``multipoles``: a precomputed ``compute_multipoles`` result.
    ``let_shards`` P > 1: also the essential-set cap ``let_cap`` of P
    ranks (the most candidates any rank's slab keeps, its slab taken as
    the blocks [k nb / P, (k + 1) nb / P)). ``mesh``: the inputs are this
    rank's slab of the sorted particles; the blocks are the global
    array's (their bboxes gathered) and the multipoles the sharded
    upsweep's, so every rank sizes the same caps."""
    if multipoles is None:
        multipoles = (compute_multipoles(x, y, z, m, sorted_keys, tree, meta) if mesh is None
                      else compute_multipoles_sharded(mesh, x, y, z, m, sorted_keys, tree,
                                                      meta))
    node_mass, node_com, _, edges = multipoles
    blk = cfg.target_block
    if mesh is None:
        n = x.shape[0]
        bboxes = _slab_blocks(x, y, z, blk)[3:5]
    else:
        n = x.shape[0] * mesh.size
        bboxes = _global_block_bboxes(mesh, x, y, z, blk)
    nb = -(-n // blk)
    bmin, bmax = (a.cpu().numpy() for a in bboxes)
    nm, com, edges, parent, is_leaf, lengths, lo, center_frac, halfsize_frac = (
        a.cpu().numpy() for a in (node_mass, node_com, edges, tree.parent, tree.is_leaf,
                                  box.lengths, box.lo, tree.center_frac,
                                  tree.halfsize_frac))
    valid = nm > 0.0
    counts = np.diff(edges)

    lo = np.asarray(lo, dtype=np.float64)
    geo_center = lo[None, :] + np.asarray(center_frac) * lengths[None, :]
    geo_size = np.asarray(halfsize_frac)[:, None] * lengths[None, :]
    l_node = 2.0 * geo_size.max(axis=1)
    s_off = np.linalg.norm(com - geo_center, axis=1)
    # the monotone MAC radius and subtree com box of compute_gravity
    smax = np.where(valid, s_off, 0.0)
    BIG = 1e15
    com_lo = np.where(valid[:, None], com, BIG)
    com_hi = np.where(valid[:, None], com, -BIG)
    for s, e in reversed(meta.level_ranges[1:]):
        np.maximum.at(smax, parent[s:e], smax[s:e])
        np.minimum.at(com_lo, parent[s:e], com_lo[s:e])
        np.maximum.at(com_hi, parent[s:e], com_hi[s:e])
    ccenter = np.where(valid[:, None], 0.5 * (com_lo + com_hi), BIG)
    chalf = np.where(valid[:, None], np.maximum(0.5 * (com_hi - com_lo), 0.0), 0.0)
    mac2 = (l_node / cfg.theta + smax) ** 2
    self_parent = parent == np.arange(meta.num_nodes)

    rng = np.random.default_rng(0)
    blocks = (np.arange(nb) if nb <= sample_blocks else
              np.unique(np.concatenate([[0, nb - 1], rng.integers(0, nb, sample_blocks)])))

    def classify(b0, b1):
        pmin = bmin[b0:b1].min(axis=0)
        pmax = bmax[b0:b1].max(axis=0)
        bc, bs = (pmax + pmin) / 2, (pmax - pmin) / 2
        d = np.maximum(np.abs(bc[None, :] - ccenter) - bs[None, :] - chalf, 0.0)
        accept = valid & ~((d * d).sum(axis=1) < mac2)
        anc = np.where(self_parent, False, accept[parent])
        return accept, anc

    m2p_max, p2p_max = 1, 1
    for b in blocks:
        accept, anc = classify(b, b + 1)
        m2p_max = max(m2p_max, int((accept & ~anc).sum()))
        p2p_max = max(p2p_max, int((is_leaf & valid & ~accept).sum()))

    # superblock candidate-list high water: ~anc of the super's bbox
    c_cap_max = 1
    if cfg.super_factor > 0:
        nsb = -(-n // (cfg.super_factor * blk))
        supers = (np.arange(nsb) if nsb <= sample_blocks else
                  np.unique(np.concatenate([[0, nsb - 1],
                                            rng.integers(0, nsb, sample_blocks)])))
        for b in supers:
            _, anc = classify(b * cfg.super_factor, min((b + 1) * cfg.super_factor, nb))
            c_cap_max = max(c_cap_max, int((~anc).sum()))

    # per-rank essential-set high water (the LET cap): ~anc of the slab
    # bbox, each rank's blocks a contiguous block range
    let_max = 0
    if let_shards > 1:
        for k in range(let_shards):
            b0 = k * nb // let_shards
            b1 = max(b0 + 1, (k + 1) * nb // let_shards)
            _, anc = classify(b0, min(b1, nb))
            let_max = max(let_max, int((~anc).sum()))

    def pad(v, mg=margin):
        return int(np.ceil(v * mg / quantum) * quantum)

    leaf_cap = pad(int(counts.max()) if len(counts) else 1)
    # the m2p cap's own margin, scaled so that Simulation's overflow
    # margin growth still reaches any true high water
    m2p_margin = cfg.m2p_cap_margin * margin / 1.5
    return dataclasses.replace(
        cfg,
        m2p_cap=min(pad(m2p_max, m2p_margin), meta.num_nodes),
        p2p_cap=min(pad(p2p_max), meta.num_leaves),
        leaf_cap=leaf_cap,
        super_cap=(min(pad(c_cap_max), meta.num_nodes) if cfg.super_factor > 0
                   else cfg.super_cap),
        let_cap=min(pad(let_max), meta.num_nodes) if let_shards > 1 else cfg.let_cap)


@named_phase("gravity-upsweep")
def compute_multipoles(x, y, z, m, sorted_keys, tree: GravityTree, meta: GravityTreeMeta,
                       order: int = 0):
    """Masses, centres of mass and multipoles of every node
    (computeLeafMultipoles + upsweepMultipoles): leaf sums over the
    contiguous leaf rows, then a level-by-level upsweep, deepest first,
    each level's rows added into their parents (``level_add_``) with the
    M2M shift. Returns (node_mass (N,), node_com (N, 3), node_q, edges
    (L+1,) int64 leaf row boundaries): node_q the (N, 7) cartesian
    quadrupoles at ``order`` 0, else the (N, ncoef(order)) complex
    spherical coefficients."""
    n = x.shape[0]
    edges = torch.searchsorted(sorted_keys, tree.leaf_keys)
    return _multipoles_from_edges(x, y, z, m, edges, edges, n, tree, meta, order,
                                  mp.edge_segment_sum)


@named_phase("gravity-upsweep")
def compute_multipoles_sharded(mesh, x, y, z, m, local_keys, tree: GravityTree,
                               meta: GravityTreeMeta, order: int = 0):
    """``compute_multipoles`` across ranks (the JAX package's
    compute_multipoles_sharded, global_multipole.hpp's allreduce): the
    global leaf edges are the ranks' local edge positions summed (an
    integer all_reduce); each rank takes the partial leaf sums of its slab
    rows (the edges clipped to its slab) in float64, the (L, k) payloads
    are all_gathered and summed in rank order, then rounded to float32 as
    the one-device pass rounds its float64 segment sums, and the upsweep
    runs replicated. Every rank computes the same sums of the same values
    in the same order, so the node arrays are bit-identical on every
    rank. Only O(tree) arrays travel. Returns the same tuple, with the
    GLOBAL edges."""
    from sphexa_torch.parallel.mesh import all_gather, all_reduce_sum

    S = x.shape[0]
    edges = all_reduce_sum(mesh, torch.searchsorted(local_keys, tree.leaf_keys))
    e_clip = torch.clamp(edges - mesh.rank * S, 0, S)

    def rank_sums(w, e):
        part = mp.edge_segment_sum(w.to(torch.float64), e)  # (L, k) float64
        g = all_gather(mesh, part)
        acc = g[0]
        for r in range(1, mesh.size):
            acc = acc + g[r]
        return acc.to(w.dtype)

    return _multipoles_from_edges(x, y, z, m, edges, e_clip, S, tree, meta, order, rank_sums)


def _multipoles_from_edges(x, y, z, m, edges, e_local, n: int, tree: GravityTree,
                           meta: GravityTreeMeta, order: int, segment_sum):
    """The multipole pass over the rows ``x``..``m``, ``e_local`` the leaf
    edges in those rows and ``segment_sum(w, e_local)`` the leaves' (L, k)
    sums; ``edges`` is returned."""
    pleaf = _pleaf_from_edges(e_local, n)
    w = torch.stack([m, m * x, m * y, m * z], dim=1)
    leaf_w = segment_sum(w, e_local)  # (L, 4)
    node_mass, node_com = _upsweep_mass_com(leaf_w, tree, meta)
    leaf_com = node_com[tree.node_of_leaf]
    if order > 0:
        leaf_c = sp.p2m(x, y, z, m, leaf_com, e_local, order, pleaf=pleaf,
                        segment_sum=segment_sum)
        return node_mass, node_com, sp.upsweep(leaf_c, node_com, tree, meta, order), edges
    leaf_q = mp.p2m_leaf(x, y, z, m, pleaf, leaf_com, e_local, segment_sum=segment_sum)
    node_q = _upsweep_quadrupoles(leaf_q, node_mass, node_com, tree, meta)
    return node_mass, node_com, node_q, edges


def _pleaf_from_edges(edges: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) particle -> leaf map from the sorted leaf start rows: the
    cumulative count of starts (an empty leaf advances it twice)."""
    mark = torch.zeros(n + 1, dtype=torch.int64, device=edges.device)
    mark.index_add_(0, edges, torch.ones_like(edges))
    return torch.cumsum(mark, 0)[:n] - 1


def _upsweep_mass_com(leaf_w, tree: GravityTree, meta: GravityTreeMeta):
    node_w = torch.zeros(meta.num_nodes, 4, dtype=leaf_w.dtype, device=leaf_w.device)
    node_w[tree.node_of_leaf] = leaf_w
    lr = meta.level_ranges
    for lv in range(len(lr) - 1, 0, -1):
        s, e = lr[lv]
        # the level's rows are read before their parents are written
        level_add_(node_w, tree.parent[s:e], node_w[s:e].clone(), lr[lv - 1])
    node_mass = node_w[:, 0]
    node_com = node_w[:, 1:4] / torch.clamp_min(node_mass, 1e-30)[:, None]
    return node_mass, node_com


def _upsweep_quadrupoles(leaf_q, node_mass, node_com, tree: GravityTree,
                         meta: GravityTreeMeta):
    node_q = torch.zeros(meta.num_nodes, 7, dtype=leaf_q.dtype, device=leaf_q.device)
    node_q[tree.node_of_leaf] = leaf_q
    lr = meta.level_ranges
    for lv in range(len(lr) - 1, 0, -1):
        s, e = lr[lv]
        par = tree.parent[s:e]
        d = node_com[par] - node_com[s:e]
        level_add_(node_q, par, mp.m2m_shift(node_q[s:e], node_mass[s:e], d), lr[lv - 1])
    return node_q


def _monotone_mac_geometry(box: Box, tree: GravityTree, meta: GravityTreeMeta,
                           node_com, valid, theta: float):
    """Monotone vector-MAC geometry: the acceptance radius l / theta plus
    the subtree max of |com - geometric centre|, measured from a target
    bbox to the node's subtree-com box. Child boxes nest and the radius
    does not grow down the tree, so accept(parent) implies accept(child)
    and the first accepted ancestor is the parent. Returns (ccenter (N,
    3), chalf (N, 3), mac2 (N,)); the sums of squares are written out in
    the JAX package's order, so that no node flips at the boundary."""
    lengths = box.lengths
    geo_center = box.lo[None, :] + tree.center_frac * lengths[None, :]
    geo_size = tree.halfsize_frac[:, None] * lengths[None, :]
    l_node = 2.0 * geo_size.amax(dim=1)
    d = node_com - geo_center
    s_off = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    # an empty node's com is (0, 0, 0): its s_off must not grow any radius
    smax = torch.where(valid, s_off, 0.0)
    BIG = 1e15  # "infinitely far"; its square stays finite in float32
    com_lo = torch.where(valid[:, None], node_com, BIG)
    com_hi = torch.where(valid[:, None], node_com, -BIG)
    for s, e in reversed(meta.level_ranges[1:]):
        par = tree.parent[s:e]
        par3 = par[:, None].expand(-1, 3)
        smax.scatter_reduce_(0, par, smax[s:e].clone(), "amax")
        com_lo.scatter_reduce_(0, par3, com_lo[s:e].clone(), "amin")
        com_hi.scatter_reduce_(0, par3, com_hi[s:e].clone(), "amax")
    ccenter = torch.where(valid[:, None], 0.5 * (com_lo + com_hi), BIG)
    chalf = torch.where(valid[:, None], torch.clamp_min(0.5 * (com_hi - com_lo), 0.0), 0.0)
    a = l_node / theta + smax
    return ccenter, chalf, a * a


def _bbox(tx, ty, tz):
    """Centre and half size (..., 3) of each row's targets (..., blk)."""
    return _box_cs(torch.stack([a.amin(-1) for a in (tx, ty, tz)], dim=-1),
                   torch.stack([a.amax(-1) for a in (tx, ty, tz)], dim=-1))


def _box_cs(bmin, bmax):
    """Centre and half size (..., 3) of boxes given by their (..., 3) min
    and max."""
    return (bmax + bmin) * 0.5, (bmax - bmin) * 0.5


def _superblock_boxes(bmin, bmax, sf: int):
    """The superblocks of ``sf`` blocks: each one's centre and half size
    (num_super, 3), the bbox of its blocks' bboxes, and the blocks' own
    (num_super, sf, 3), the blocks past the last one copies of it."""
    num_super = -(-bmin.shape[0] // sf)
    pad = num_super * sf - bmin.shape[0]
    bmin = torch.cat([bmin, bmin[-1:].expand(pad, 3)]).reshape(num_super, sf, 3)
    bmax = torch.cat([bmax, bmax[-1:].expand(pad, 3)]).reshape(num_super, sf, 3)
    return _box_cs(bmin.amin(1), bmax.amax(1)) + _box_cs(bmin, bmax)


def _accept(bc, bs, gc, gs, m2):
    """Box-to-box distance against the monotone MAC radius, broadcast over
    the leading dimensions; (d0 d0 + d1 d1) + d2 d2 in the JAX order."""
    d = [torch.clamp_min(torch.abs(bc[..., k] - gc[..., k]) - bs[..., k] - gs[..., k], 0.0)
         for k in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] >= m2


class _Geo:
    """Per-candidate MAC arrays of one node list: its own subtree-com box
    and radius, its parent's, and the masks (parent may have accepted,
    leaf, valid, listed) with the node index."""

    FIELDS = ("cc", "ch", "m2", "pc", "ph", "pm2", "aok", "lfk", "vld", "ok", "idx")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    def gather(self, cidx, ok) -> "_Geo":
        """The arrays of the nodes ``cidx`` (a candidate list, past its
        count masked by ``ok``), gathered once per list."""
        ci = torch.clamp(cidx, max=self.idx.shape[0] - 1).to(torch.int64)
        return _Geo(cc=self.cc[ci], ch=self.ch[ci], m2=self.m2[ci], pc=self.pc[ci],
                    ph=self.ph[ci], pm2=self.pm2[ci], aok=self.aok[ci] & ok,
                    lfk=self.lfk[ci] & ok, vld=self.vld[ci] & ok, ok=ok,
                    idx=ci.to(torch.int32))

    def unsqueeze(self, dim: int) -> "_Geo":
        return _Geo(**{k: getattr(self, k).unsqueeze(dim) for k in self.FIELDS})


def _packed_cls(bc, bs, g: _Geo):
    """Each candidate's class (0 M2P, 1 P2P, 2 pruned) packed over its
    node index for the compaction; ``anc`` re-evaluates the MAC on the
    parent's own arrays (accept(parent), the first accepted ancestor)."""
    acc = g.vld & _accept(bc, bs, g.cc, g.ch, g.m2)
    anc = g.aok & _accept(bc, bs, g.pc, g.ph, g.pm2)
    cls = torch.where(acc & ~anc, 0, torch.where(g.lfk & ~acc, 1, 2)).to(torch.int32)
    return (cls << pcmp.IDX_BITS) | g.idx


def _packed_cand(bc, bs, g: _Geo):
    """Superblock pre-pass class: 0 where the parent is not accepted (the
    open set and the accepted cut, ancestor-closed), else 2."""
    anc = g.aok & _accept(bc, bs, g.pc, g.ph, g.pm2)
    cls = torch.where(g.ok & ~anc, 0, 2).to(torch.int32)
    return (cls << pcmp.IDX_BITS) | g.idx


def _chunks(total: int, per_item: int, dev: torch.device):
    """(start, stop) ranges of items whose per_item-element temporaries
    fit the chunk budget of the device."""
    step = max(1, CHUNK_ELEMS[dev.type] // max(per_item, 1))
    return [(a, min(a + step, total)) for a in range(0, total, step)]


def _classify_bitmask(bmin, bmax, tree, meta, cfg, geo: _Geo,
                      packed_out: Optional[list] = None, let_geo: Optional[_Geo] = None):
    """Both lists of every block (given by its (nb, 3) bbox min and max)
    through the compaction kernel; with ``super_factor`` > 0 the
    superblock pre-pass first (one compaction), then each block against
    its superblock's list (one compaction).
    ``let_geo``: the rank's essential set (gathered from ``geo``), which
    the blocks classify against at super_factor 0 and the superblocks
    at super_factor > 0. Returns (m2p list, m2p count, p2p list, p2p
    count, c_max); each compaction's (packed array, cap0, cap1) is
    appended to ``packed_out``."""
    keep = packed_out.append if packed_out is not None else (lambda _item: None)
    dev = bmin.device
    num_n = meta.num_nodes
    sf = cfg.super_factor
    nb = bmin.shape[0]
    bc, bs = _box_cs(bmin, bmax)
    pre = geo if let_geo is None else let_geo
    width = pre.idx.shape[0]
    if sf == 0:
        packed = torch.empty(nb, width, dtype=torch.int32, device=dev)
        for b0, b1 in _chunks(nb, width, dev):
            packed[b0:b1] = _packed_cls(bc[b0:b1, None], bs[b0:b1, None], pre)
        keep((packed, cfg.m2p_cap, cfg.p2p_cap))
        om, mn, op, pn = pcmp.compact_class_lists(packed, cfg.m2p_cap, cfg.p2p_cap)
        return om, mn, op, pn, None

    scap = min(cfg.super_cap, num_n)
    sbc, sbs, bbc, bbs = _superblock_boxes(bmin, bmax, sf)
    num_super = sbc.shape[0]
    spk = torch.empty(num_super, width, dtype=torch.int32, device=dev)
    for s0, s1 in _chunks(num_super, width, dev):
        spk[s0:s1] = _packed_cand(sbc[s0:s1, None], sbs[s0:s1, None], pre)
    keep((spk, scap, 128))
    scand, scand_n, _, _ = pcmp.compact_class_lists(spk, scap, 128)
    c_max = scand_n.max()

    # blocks of the last superblock past the last block copy it; only the
    # real blocks are classified
    packed = torch.empty(nb, scap, dtype=torch.int32, device=dev)
    lane = torch.arange(scap, device=dev)
    for s0, s1 in _chunks(num_super, sf * scap, dev):
        ok = lane[None, :] < torch.clamp(scand_n[s0:s1], max=scap)[:, None]
        g = geo.gather(scand[s0:s1], ok).unsqueeze(1)  # (S, 1, scap[, 3])
        rows = _packed_cls(bbc[s0:s1, :, None], bbs[s0:s1, :, None], g).reshape(-1, scap)
        b0 = s0 * sf
        b1 = min(s1 * sf, nb)
        if b1 > b0:
            packed[b0:b1] = rows[: b1 - b0]
    keep((packed, cfg.m2p_cap, cfg.p2p_cap))
    om, mn, op, pn = pcmp.compact_class_lists(packed, cfg.m2p_cap, cfg.p2p_cap)
    return om, mn, op, pn, c_max


def _sort_lists(m2p_mask, p2p_mask, cfg, num_n: int, cidx=None):
    """One 3-class sort of a chunk of blocks' candidates: the packed
    (class, candidate) keys sorted, M2P first, P2P after, the P2P slice
    starting at the M2P count (clamped into the array, as the JAX
    dynamic_slice clamps). ``cidx``: each candidate's node (a superblock's
    list), else the candidates are the nodes. Returns (m2p list, m2p ok,
    p2p list, p2p ok, m2p count, p2p count)."""
    dev = m2p_mask.device
    rows, width = m2p_mask.shape
    nbits = max(1, int(np.ceil(np.log2(max(width, 2)))))
    iota = torch.arange(width, device=dev)
    padn = max(cfg.m2p_cap, cfg.p2p_cap)
    m2p_n = m2p_mask.sum(dim=1)
    cls = torch.where(m2p_mask, 0, torch.where(p2p_mask, 1, 2))
    ks = torch.sort((cls << nbits) | iota, dim=1).values
    order_all = ks & ((1 << nbits) - 1)
    cls_sorted = ks >> nbits
    if cidx is not None:
        order_all = cidx.gather(1, order_all)
    # sentinel pad, so the fixed-cap slices stay in range
    order_all = torch.cat([order_all, torch.full((rows, padn), num_n - 1, device=dev,
                                                 dtype=order_all.dtype)], dim=1)
    cls_sorted = torch.cat([cls_sorted, torch.full((rows, padn), 2, device=dev,
                                                   dtype=cls_sorted.dtype)], dim=1)
    slot = torch.arange(cfg.p2p_cap, device=dev)
    p_at = torch.clamp(m2p_n, max=width + padn - cfg.p2p_cap)[:, None] + slot[None, :]
    return (torch.clamp(order_all[:, : cfg.m2p_cap], max=num_n - 1),
            cls_sorted[:, : cfg.m2p_cap] == 0, order_all.gather(1, p_at),
            cls_sorted.gather(1, p_at) == 1, m2p_n, p2p_mask.sum(dim=1))


def _sort_superblocks(bmin, bmax, tree, meta, cfg, ccenter, chalf, mac2, valid,
                      self_parent):
    """The sort mode's superblock pre-pass: each superblock of
    ``super_factor`` blocks (the bbox of their bboxes, given by their
    (nb, 3) min and max) against all nodes, its candidates the nodes
    whose parent it does not accept (the open set and the accepted cut,
    ancestor-closed), kept in node order by a stable argsort and cut at
    the cap. Returns (candidates (S, cap), with num_nodes on dead slots,
    live mask, each candidate's parent position in its list, unclipped
    counts)."""
    dev = bmin.device
    num_n = meta.num_nodes
    scap = min(cfg.super_cap, num_n)
    sbc, sbs = _superblock_boxes(bmin, bmax, cfg.super_factor)[:2]
    outs = [[] for _ in range(4)]
    for s0, s1 in _chunks(sbc.shape[0], num_n, dev):
        accept = valid & _accept(sbc[s0:s1, None], sbs[s0:s1, None], ccenter, chalf, mac2)
        cand = ~(accept[:, tree.parent] & ~self_parent)
        for o, v in zip(outs, _compact_candidates(cand, scap, tree, num_n)):
            o.append(v)
    return tuple(torch.cat(o) for o in outs)


def _compact_candidates(cand, cap: int, tree: GravityTree, num_n: int):
    """Fixed-cap candidate lists from (rows, N) bool node masks: a stable
    compaction in node order (the kept prefix stays ancestor-closed where
    ``cand`` is), num_nodes on the dead slots (the list stays ascending),
    each candidate's parent position in its list (clamped into it).
    Returns (candidates, live mask, parent positions, unclipped counts)."""
    ordc = torch.argsort((~cand).to(torch.uint8), dim=1, stable=True)[:, :cap]
    cok = cand.gather(1, ordc)
    cidx = torch.where(cok, ordc, num_n)
    ppos = torch.searchsorted(cidx, tree.parent[torch.clamp(cidx, max=num_n - 1)])
    return cidx, cok, torch.clamp(ppos, max=cap - 1), cand.sum(dim=1)


def _classify_sort(bc, bs, tree, meta, cfg, ccenter, chalf, mac2, valid, self_parent,
                   supers=None):
    """The 3-class sort compaction of every block: accept, the parent's
    accept as the first accepted ancestor, and one sort of the packed
    keys (``_sort_lists``). The candidates are all nodes, or with
    ``supers`` (``_sort_superblocks``) the list of the block's
    superblock, or at super_factor 0 one list every block shares (the
    rank's essential set), where the parent's accept is read at its
    position in the list. Returns (m2p list, m2p ok, p2p list, p2p ok, m2p count, p2p
    count)."""
    dev = bc.device
    num_n = meta.num_nodes
    nb = bc.shape[0]
    leafv = tree.is_leaf & valid
    outs = [[] for _ in range(6)]
    width = num_n if supers is None else supers[0].shape[1]
    for b0, b1 in _chunks(nb, width, dev):
        bcc, bss = bc[b0:b1, None], bs[b0:b1, None]
        if supers is None:
            accept = valid & _accept(bcc, bss, ccenter, chalf, mac2)
            anc = accept[:, tree.parent] & ~self_parent
            m2p_mask, p2p_mask, cidx = accept & ~anc, leafv & ~accept, None
        else:
            # one shared list (the LET) or the block's superblock's
            sid = (torch.zeros(b1 - b0, dtype=torch.int64, device=dev)
                   if supers[0].shape[0] == 1 and cfg.super_factor == 0
                   else torch.arange(b0, b1, device=dev) // cfg.super_factor)
            cidx = torch.clamp(supers[0][sid], max=num_n - 1)
            cok, ppos = supers[1][sid], supers[2][sid]
            accept = cok & valid[cidx] & _accept(bcc, bss, ccenter[cidx], chalf[cidx],
                                                 mac2[cidx])
            # the root is its own parent: an accepted root must not count
            # as its own accepted ancestor
            anc = accept.gather(1, ppos) & (cidx.gather(1, ppos) != cidx)
            m2p_mask, p2p_mask = accept & ~anc, cok & leafv[cidx] & ~accept
        for o, v in zip(outs, _sort_lists(m2p_mask, p2p_mask, cfg, num_n, cidx)):
            o.append(v)
    return tuple(torch.cat(o) for o in outs)


@named_phase("gravity-m2p")
def _m2p_eval(tx, ty, tz, order_m, m2p_ok, node_packed, order: int = 0):
    """Far field of every block: its M2P list's nodes (one row gather of
    the packed com, multipole and mass) on its targets, in chunks of
    blocks; the spherical expansion of ``order`` > 0 in smaller chunks (its
    autograd graph lives for one chunk). Returns (ax, ay, az, phi), each
    (nb, blk)."""
    dev = tx.device
    nb, blk = tx.shape
    cap = order_m.shape[1]
    num_n = node_packed.shape[0]
    per_block = blk * cap * (max(1, sp.ncoef(order) // SPHERICAL_CHUNK_DIVISOR)
                             if order > 0 else 1)
    outs = [torch.empty(nb, blk, device=dev) for _ in range(4)]
    for b0, b1 in _chunks(nb, per_block, dev):
        nd = node_packed[torch.clamp(order_m[b0:b1], max=num_n - 1).to(torch.int64)]
        if order > 0:
            nc = sp.ncoef(order)
            coeffs = torch.complex(nd[..., 4:4 + nc], nd[..., 4 + nc:])
            res = sp.m2p(tx[b0:b1], ty[b0:b1], tz[b0:b1], nd[..., 0:3], coeffs,
                         m2p_ok[b0:b1], order)
        else:
            res = mp.m2p(tx[b0:b1], ty[b0:b1], tz[b0:b1], nd[..., 0:3], nd[..., 3:10],
                         nd[..., 10], m2p_ok[b0:b1])
        for o, r in zip(outs, res):
            o[b0:b1] = r
    return outs


def _node_packed(node_mass, node_com, node_q, order: int):
    """The per-node payload M2P gathers in one row: com, quadrupole, mass
    and a pad (cartesian), or com, mass and the spherical coefficients'
    real then imaginary parts."""
    if order > 0:
        return torch.cat([node_com, node_mass[:, None], node_q.real, node_q.imag], dim=1)
    return torch.cat([node_com, node_q, node_mass[:, None], torch.zeros_like(node_mass)[:, None]],
                     dim=1)


@named_phase("gravity-p2p")
def _p2p_leaf_ranges(order_p, p2p_ok, tree: GravityTree, edges, num_n: int):
    """Sorted-array row ranges (start, length), (NB, p2p_cap) int32 each,
    of each block's near-field leaves; slots past the list are empty."""
    lidx = tree.leaf_of_node[torch.clamp(order_p, max=num_n - 1).to(torch.int64)]
    start = torch.where(p2p_ok, edges[lidx], 0)
    length = torch.where(p2p_ok, edges[lidx + 1] - edges[lidx], 0)
    return start.to(torch.int32), length.to(torch.int32)


def p2p_runs(starts, lens, cfg: GravityConfig) -> pe.GroupRanges:
    """The near-field leaf ranges merged into runs (the port's
    ``_merge_runs``, the JAX wrapper's call), for the plain version: with
    gap 0 only, since a bridged gap would stream particles whose mass
    already arrives by M2P (no distance cutoff masks them), and runs of at
    most max(leaf_cap, 1024) rows."""
    zero3 = torch.zeros(starts.shape + (3,), dtype=torch.float32, device=starts.device)
    rs, rl, sh, nruns = pe._merge_runs(starts, lens, lens > 0, zero3,
                                       max(cfg.leaf_cap, 1024), 0)
    i32 = torch.int32
    return pe.GroupRanges(
        starts=rs.to(i32).contiguous(), lens=rl.to(i32).contiguous(),
        shift_x=sh[0].contiguous(), shift_y=sh[1].contiguous(), shift_z=sh[2].contiguous(),
        ncells=nruns.to(i32).contiguous(),
        occupancy=torch.zeros((), dtype=torch.int64, device=starts.device),
        boxl=torch.full((3,), 1e30, dtype=torch.float32, device=starts.device))


def _gravity_pair(g, I, J, c):
    """The near-field body (traversal.py pair_body): the distance clamped
    to h_i + h_j; rx = x_i - x_j, so the acceleration is -sum r w."""
    h_ij = I[3] + J[4]
    r2_eff = torch.maximum(g.d2, h_ij * h_ij)
    inv_r = torch.rsqrt(torch.clamp_min(r2_eff, 1e-30))
    w = J[3] * inv_r * inv_r * inv_r
    return -(g.rx * w), -(g.ry * w), -(g.rz * w), -(w * g.d2)


#: the near field as an op of the plain pair engine: i-fields x+sx, y+sy,
#: z+sz, h; j-fields x, y, z, m, h; no distance cutoff
GRAVITY_P2P = pe.OpSpec("gravity_p2p", 4, 5, 4, _gravity_pair, ("sum",) * 4,
                        lambda I, accs, nc, c: tuple(accs), want_nc=False, cutoff=False)

#: the engine constants the gravity body leaves unread
_P2P_CONSTS = {"coeffs": [0.0] * 14, "dcoeffs": [0.0] * 14, "K": 0.0, "k_cour": 0.0,
               "alphamin": 0.0, "alphamax": 0.0, "decay_c": 0.0, "at_min": 0.0,
               "at_max": 0.0, "ramp": 0.0}


def p2p_fields(x, y, z, m, h, shift):
    """The near field's i-fields (targets shifted) and j-fields."""
    return [x + shift[0], y + shift[1], z + shift[2], h], [x, y, z, m, h]


#: targets each thread of the near-field kernel keeps in registers
#: (csrc/gravity_p2p.cu), 2 where a block has too few targets for a whole
#: number of warps of 4
P2P_TARGETS = 4


def p2p_targets_per_thread(blk: int) -> int:
    """K12's targets a thread for blocks of ``blk`` targets: P2P_TARGETS
    where blk / 4 threads are a whole number of warps, else 2 (the
    kernel's two forms, for the solver's blocks of 256 and 64)."""
    if blk % 64 or not 0 < blk <= 256:
        raise ValueError(f"the near-field kernel takes target blocks of a multiple of 64 "
                         f"up to 256 targets, got {blk}")
    return P2P_TARGETS if blk % (32 * P2P_TARGETS) == 0 else 2


def p2p_block_order(lens: torch.Tensor) -> torch.Tensor:
    """(NB,) int32 blocks by descending near-field candidate count (the sum
    of their leaf lengths), ties by block index: K12 starts the heaviest
    blocks first, so that the light ones fill the tail."""
    return torch.argsort(lens.sum(dim=1), descending=True, stable=True).to(torch.int32)


@named_phase("gravity-p2p")
def _pallas_p2p(x, y, z, m, h, shift, allow_self: bool, cfg: GravityConfig, starts, lens,
                jdata=None):
    """Near-field P2P of every target over its block's near-leaf ranges:
    ``starts``/``lens`` are (NB, W) int32 row ranges (``_p2p_leaf_ranges``
    gives W = p2p_cap; slots past a block's list have length 0), ``shift``
    ((3,)) is added to the targets, and the pair with a target's own row
    counts only with ``allow_self``. ``jdata``: the j-buffer (x, y, z, m,
    h) of its own length nj >= n that the ranges index (a rank's [own
    slab | halo rows], the own rows at offset 0, so that a target's row
    is its own candidate's row); None: the targets' own arrays. The K12
    kernel (csrc/gravity_p2p.cu) for CUDA tensors, the plain version for
    CPU tensors. Returns (ax, ay, az, phi), each (n,)."""
    dev = x.device
    # --debug-checks: the leaf ranges K12 reads stay inside its j-arrays
    check_runs("gravity_p2p", starts, lens, (x if jdata is None else jdata[0]).shape[0])
    # a cost tally charges K12's rule (kernels/costs.py), not either branch's ops
    with costs.charging():
        if dev.type == "cuda":
            launch, out = p2p_launcher(x, y, z, m, h, shift, allow_self, cfg, starts, lens,
                                       jdata=jdata)
            launch()
            pe.LAUNCHES["gravity_p2p"] += 1
        elif dev.type == "cpu":
            out = _pallas_p2p_plain(x, y, z, m, h, shift, allow_self, cfg, starts, lens,
                                    jdata=jdata)
        else:
            raise ValueError(f"unsupported device {dev}")
    costs.charge_p2p(lens, x.shape[0], cfg.target_block,
                     None if jdata is None else jdata[0].shape[0], outs=out)
    return out


def p2p_launcher(x, y, z, m, h, shift, allow_self: bool, cfg: GravityConfig, starts, lens,
                 jdata=None):
    """K12's arguments checked and built once (the blocks heaviest first,
    ``p2p_block_order``; ``p2p_targets_per_thread`` targets a thread):
    the target fields against n, the j-buffer's (``jdata``, else the
    targets' own arrays) against its own length nj >= n. Returns (launch,
    (ax, ay, az, phi)): each ``launch()`` runs the kernel on the current
    stream (no sync) into those outputs and raises on a launch error.
    ``_pallas_p2p`` launches it once; a timing loop may launch it again
    without the argument building."""
    from sphexa_torch.kernels.build import load_library

    dev, n, blk = x.device, x.shape[0], cfg.target_block
    nb = -(-n // blk)
    r = p2p_targets_per_thread(blk)
    for name, a in zip(("x", "y", "z", "m", "h"), (x, y, z, m, h)):
        pe.check_cuda_f32(name, a, n, dev)
    jd = (x, y, z, m, h) if jdata is None else tuple(jdata)
    nj = jd[0].shape[0]
    if len(jd) != 5 or nj < n:
        raise ValueError(f"jdata: need the five j-fields (x, y, z, m, h) of nj >= n = {n} "
                         f"rows, got {len(jd)} of {nj}")
    for name, a in zip(("xj", "yj", "zj", "mj", "hj"), jd):
        pe.check_cuda_f32(name, a, nj, dev)
    pe.check_table("shift", shift, torch.float32, (3,), dev)
    width = starts.shape[1] if starts.dim() == 2 else 0
    if width < 1:
        raise ValueError(f"starts: need (nb, W) ranges with W >= 1, got {tuple(starts.shape)}")
    pe.check_table("starts", starts, torch.int32, (nb, width), dev)
    pe.check_table("lens", lens, torch.int32, (nb, width), dev)
    order = p2p_block_order(lens)
    out = torch.empty(4, n, dtype=torch.float32, device=dev).unbind(0)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):
            err = lib.launch_gravity_p2p(
                x.data_ptr(), y.data_ptr(), z.data_ptr(), h.data_ptr(),
                *(a.data_ptr() for a in jd), nj, shift.data_ptr(), int(bool(allow_self)),
                starts.data_ptr(), lens.data_ptr(), order.data_ptr(), n, nb, width, blk, r,
                *(a.data_ptr() for a in out), stream)
        if err != 0:
            raise RuntimeError(f"launch_gravity_p2p failed: CUDA error {err} "
                               f"({lib.pair_engine_error_string(err).decode()})")

    return launch, out


def p2p_kernel_info(blk: int) -> dict:
    """Static facts of the K12 instantiation that blocks of ``blk`` targets
    run (``pair_engine.KERNEL_INFO_KEYS``; "window" is its staged tile).
    Needs a CUDA device; launches nothing."""
    import ctypes

    from sphexa_torch.kernels.build import load_library

    lib = load_library()
    out = (ctypes.c_int32 * len(pe.KERNEL_INFO_KEYS))()
    err = lib.gravity_p2p_info(blk, p2p_targets_per_thread(blk), out)
    if err != 0:
        raise RuntimeError(f"gravity_p2p kernel info failed: CUDA error {err} "
                           f"({lib.pair_engine_error_string(err).decode()})")
    return {**dict(zip(pe.KERNEL_INFO_KEYS, out)),
            "targets_per_thread": p2p_targets_per_thread(blk)}


def _pallas_p2p_plain(x, y, z, m, h, shift, allow_self: bool, cfg: GravityConfig, starts,
                      lens, jdata=None):
    """Plain PyTorch version of ``_pallas_p2p`` on any device: the leaf
    ranges merged into runs (``p2p_runs``) through ``engine_plain``, the
    j-fields ``jdata`` where given."""
    i_f, j_f = p2p_fields(x, y, z, m, h, shift)
    if jdata is not None:
        j_f = list(jdata)
    outs, _ = pe.engine_plain(GRAVITY_P2P, p2p_runs(starts, lens, cfg), i_f, j_f, False,
                              cfg.target_block, {**_P2P_CONSTS, "allow_self": allow_self})
    return tuple(outs)


@named_phase("gravity-p2p")
def _p2p_xla(tx, ty, tz, th, bi, start, length, x, y, z, m, h, allow_self: bool,
             cfg: GravityConfig):
    """The gather backend's near field (the JAX package's ``_p2p_xla``):
    each block's candidates are the rows of its near-field leaves, up to
    ``leaf_cap`` a leaf (``start``/``length`` (NB, p2p_cap), empty slots
    length 0), and every target pairs with every candidate but its own
    row (in a shifted pass, ``allow_self``, with that too) through
    ``multipole.p2p``. Targets ``tx``, ``ty``, ``tz`` (shifted), ``th``
    and their rows ``bi`` are (NB, blk). Plain PyTorch on either device,
    in chunks of blocks whose (blocks, blk, candidates) temporaries stay a
    few GB. Returns (ax, ay, az, phi), (NB, blk) each."""
    n, dev = x.shape[0], x.device
    nb, blk = tx.shape
    width = start.shape[1] * cfg.leaf_cap
    chunk = max(1, CHUNK_ELEMS[dev.type] // (blk * width))
    slots = torch.arange(cfg.leaf_cap, device=dev)
    outs = []
    for b0 in range(0, nb, chunk):
        sl = slice(b0, min(b0 + chunk, nb))
        cand = start[sl].to(torch.int64)[..., None] + slots  # (C, P, leaf_cap)
        ok = (cand < (start[sl] + length[sl])[..., None]).reshape(cand.shape[0], width)
        cand = cand.clamp(0, n - 1).reshape(ok.shape)
        pair_ok = ok[:, None, :] & ((cand[:, None, :] != bi[sl][..., None]) | bool(allow_self))
        outs.append(mp.p2p(tx[sl], ty[sl], tz[sl], th[sl], x[cand], y[cand], z[cand], m[cand],
                           h[cand], pair_ok))
    return tuple(torch.cat(parts) for parts in zip(*outs))


@named_phase("gravity-mac")
def classify(x, y, z, box: Box, tree: GravityTree, meta: GravityTreeMeta,
             cfg: GravityConfig, node_mass, node_com, keep_packed: bool = False,
             shift=None, let: bool = False, mesh=None):
    """The MAC classification of every target block from the given
    multipoles; ``shift`` ((3,)) moves the targets (a replica pass).
    ``mesh``: x, y, z are this rank's slab, and its blocks are the global
    array's (``_slab_blocks``: led by ``lead`` rows, a block shared with
    another rank classified by the bbox of all its rows). ``let`` (a
    rank's slab, ``cfg.let_cap`` > 0; the sort compaction at super_factor
    0, or the bitmask one): the blocks classify against the slab's
    essential set, the nodes whose parent the bbox of the slab's blocks
    does not accept (the open set and the accepted cut, ancestor-closed
    under the monotone MAC: any node outside it has an accepted ancestor
    in it for every block, whose bbox lies inside), compacted at the cap.
    Returns a dict: ``m2p`` (nb, m2p_cap) node indices with ``m2p_ok``,
    ``p2p`` (nb, p2p_cap) with ``p2p_ok``, the unclipped counts ``m2p_n``
    and ``p2p_n`` (nb,), ``c_max`` (the superblock lists' high water, or
    None), ``let_n`` (the essential set's size, or None), the (shifted)
    target coordinates ``tx``, ``ty``, ``tz`` (nb, blk) and ``lead``;
    with ``keep_packed`` (bitmask compaction) also ``packed``, the
    (packed array, cap0, cap1) of each compaction."""
    dev = x.device
    num_n = meta.num_nodes
    if cfg.compaction not in ("sort", "bitmask"):
        raise ValueError(f"unknown compaction mode {cfg.compaction!r}")
    if cfg.compaction == "bitmask" and num_n > (1 << pcmp.IDX_BITS):
        raise ValueError(f"bitmask compaction packs node indices in {pcmp.IDX_BITS} bits; "
                         f"{num_n} nodes needs compaction='sort'")
    if shift is not None:
        # x[i] + s, as the JAX package shifts each gathered target
        x, y, z = x + shift[0], y + shift[1], z + shift[2]
    valid = node_mass > 0.0
    ccenter, chalf, mac2 = _monotone_mac_geometry(box, tree, meta, node_com, valid, cfg.theta)
    self_parent = tree.parent == torch.arange(num_n, device=dev)
    tx, ty, tz, bmin, bmax, lead = _slab_blocks(x, y, z, cfg.target_block, mesh)
    bc, bs = _box_cs(bmin, bmax)
    out = {"tx": tx, "ty": ty, "tz": tz, "let_n": None, "lead": lead}
    bitmask = cfg.compaction == "bitmask"
    use_let = let and cfg.let_cap > 0 and (cfg.super_factor == 0 or bitmask)
    lists = None
    if use_let:
        # one classification of the blocks' bbox, shared by every block
        bc_s, bs_s = _box_cs(bmin.amin(0), bmax.amax(0))
        accept_s = valid & _accept(bc_s, bs_s, ccenter, chalf, mac2)
        cand_s = ~(accept_s[tree.parent] & ~self_parent)
        lists = _compact_candidates(cand_s[None], min(cfg.let_cap, num_n), tree, num_n)
        out["let_n"] = lists[3][0]
    if bitmask:
        par = tree.parent
        geo = _Geo(cc=ccenter, ch=chalf, m2=mac2, pc=ccenter[par], ph=chalf[par],
                   pm2=mac2[par], aok=~self_parent & valid[par], lfk=tree.is_leaf & valid,
                   vld=valid, ok=torch.ones(num_n, dtype=torch.bool, device=dev),
                   idx=torch.arange(num_n, dtype=torch.int32, device=dev))
        let_geo = None if lists is None else geo.gather(lists[0][0], lists[1][0])
        packed = [] if keep_packed else None
        om, mn, op, pn, c_max = _classify_bitmask(bmin, bmax, tree, meta, cfg, geo, packed,
                                                  let_geo=let_geo)
        if keep_packed:
            out["packed"] = packed
        out.update(m2p=om, m2p_ok=torch.arange(cfg.m2p_cap, device=dev)[None, :] < mn[:, None],
                   p2p=op, p2p_ok=torch.arange(cfg.p2p_cap, device=dev)[None, :] < pn[:, None],
                   m2p_n=mn, p2p_n=pn, c_max=c_max)
    else:
        supers = (_sort_superblocks(bmin, bmax, tree, meta, cfg, ccenter, chalf, mac2, valid,
                                    self_parent) if cfg.super_factor > 0 else lists)
        om, mok, op, pok, mn, pn = _classify_sort(bc, bs, tree, meta, cfg, ccenter, chalf,
                                                  mac2, valid, self_parent, supers)
        out.update(m2p=om, m2p_ok=mok, p2p=op, p2p_ok=pok, m2p_n=mn, p2p_n=pn,
                   c_max=None if cfg.super_factor == 0 else supers[3].max())
    return out


@named_phase("halo-exchange")
def _near_field_halo(shard, x, y, z, m, h, edges, start, length, lead: int = 0):
    """A rank's near field across ranks: the (NB, p2p_cap) global-row leaf
    ranges localized into its j-buffer [lead rows | own slab | halo rows]
    and the halo's (x, y, z, m, h) served. ``shard`` = (mesh, win): ``win``
    a tuple is the MAC-sized sparse serve's per-distance caps (the leaf
    ``edges`` its cell table), an int the windowed serve's per-peer window
    (the slab: whole slabs). ``lead``: the targets' lead rows
    (``_slab_blocks``), mirrored in the j-buffer (no range reads them) so
    that a target's row is its own candidate's row. Returns (starts, lens,
    j-buffer, escaped, metrics or None)."""
    from sphexa_torch.parallel import exchange as ex

    mesh, win = shard
    S = x.shape[0]
    zf = torch.zeros(start.shape, dtype=torch.float32, device=x.device)
    ranges = pe.GroupRanges(
        starts=start, lens=length, shift_x=zf, shift_y=zf, shift_z=zf,
        ncells=torch.zeros(start.shape[0], dtype=torch.int32, device=x.device),
        occupancy=torch.zeros((), dtype=torch.int64, device=x.device),
        boxl=torch.full((3,), 1e30, dtype=torch.float32, device=x.device))
    fields = (x, y, z, m, h)
    metrics = None
    if isinstance(win, tuple):
        lr, covered_all, escaped, covered = ex.localize_ranges_sparse(mesh, ranges, edges, S,
                                                                      win)
        ridx = ex.sparse_send_rows(mesh, covered_all, edges, S, win)
        halo = ex.serve_sparse(mesh, fields, ridx)
        metrics = ex.exchange_metrics_sparse(covered, edges, S, win, mesh.size, mesh.rank)
    else:
        lr, bounds, escaped = ex.localize_ranges(mesh, ranges, S, win)
        halo = ex.serve_windows(mesh, fields, bounds, S, win)
    return (lr.starts + lead, lr.lens, _lead_rows(ex.jbuf(fields, halo), lead), escaped,
            metrics)


def compute_gravity(x, y, z, m, h, sorted_keys, box: Box, tree: GravityTree,
                    meta: GravityTreeMeta, cfg: GravityConfig, multipoles=None,
                    timer: Optional[Callable[[str], None]] = None, shift=None,
                    allow_self: bool = False, with_phi: bool = False, shard=None,
                    gather_p2p: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """Gravitational acceleration of every (SFC-sorted) particle and the
    potential energy. Returns (ax, ay, az, egrav, diagnostics): egrav =
    0.5 G sum m phi (a 0-d tensor); with ``with_phi`` the (n,) potential
    phi in its place. The diagnostics (0-d tensors) are the high-water
    marks ``m2p_max``, ``p2p_max``, ``leaf_occ``, ``c_max`` (0 on the
    one-level paths) and ``let_max`` (the essential set's size, 0 off a
    mesh) that the caller holds against the caps, ``compact_width`` (the
    candidates each block's compaction scans) and ``mac_work_ratio``
    (interaction-list entries over MAC evaluations).

    ``shift``: a (3,) offset added to the targets (the replica passes of
    Ewald gravity: targets against the tree of the base box);
    ``allow_self``: a target pairs with its own image in the near field
    (true for a nonzero shift). ``multipoles``: a precomputed
    ``compute_multipoles`` result of the config's order; ``timer(phase)``:
    called after each phase ("multipoles", "mac", "m2p", "p2p_prologue",
    and on a mesh "serve", then "p2p").

    ``shard`` = (mesh, win): x .. h are this rank's slab and
    ``multipoles`` must come from ``compute_multipoles_sharded`` (global
    edges). The blocks classify against the rank's essential set (with
    ``cfg.let_cap`` > 0), and the near field's leaf ranges are localized
    into the j-buffer [own slab | halo rows] that the halo exchange
    serves (``win``: a tuple of P - 1 per-distance row caps selects the
    MAC-sized sparse serve, which adds ``halo_rows`` and ``halo_occ`` to
    the diagnostics; an int the windowed serve's window, the slab for
    whole slabs); K12 runs in its jdata form. Ranges that escape the
    served rows set ``p2p_max`` to the cap + 1 sentinel. egrav and the
    diagnostics are this rank's (the caller reduces them).

    ``gather_p2p``: the gather backend's near field (``_p2p_xla``, plain
    PyTorch on either device, no kernel; the JAX package's
    use_pallas=False), on a mesh over the same j-buffer; else K12
    (``_pallas_p2p``)."""
    mark = timer or (lambda _name: None)
    n = x.shape[0]
    dev = x.device
    num_n = meta.num_nodes
    order = cfg.multipole_order
    if shard is not None and multipoles is None:
        raise ValueError("a sharded solve needs the multipoles of compute_multipoles_sharded")
    if multipoles is None:
        multipoles = compute_multipoles(x, y, z, m, sorted_keys, tree, meta, order=order)
    node_mass, node_com, node_q, edges = multipoles
    mark("multipoles")

    lists = classify(x, y, z, box, tree, meta, cfg, node_mass, node_com, shift=shift,
                     let=shard is not None, mesh=None if shard is None else shard[0])
    lead = lists["lead"]
    mark("mac")
    ax, ay, az, phi = _m2p_eval(lists["tx"], lists["ty"], lists["tz"], lists["m2p"],
                                lists["m2p_ok"], _node_packed(node_mass, node_com, node_q,
                                                              order), order)
    mark("m2p")
    start, length = _p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], tree, edges, num_n)
    mark("p2p_prologue")
    if shift is None:
        # an open box: no replica shift (and no self pair unless asked)
        shift = torch.zeros(3, dtype=x.dtype, device=dev)
    jd, escaped, hmetrics = None, None, None
    if shard is not None:
        start, length, jd, escaped, hmetrics = _near_field_halo(shard, x, y, z, m, h, edges,
                                                                start, length, lead)
        mark("serve")
    if not gather_p2p:
        pax, pay, paz, pphi = _pallas_p2p(*_lead_rows((x, y, z, m, h), lead), shift, allow_self,
                                          cfg, start, length,
                                          **({} if jd is None else {"jdata": jd}))
    else:
        # the targets' rows, and on a mesh their rows in the j-buffer [lead
        # rows | own slab | halo rows]
        bi = _block_rows(n, cfg.target_block, lead, device=dev)
        pax, pay, paz, pphi = (a.reshape(-1) for a in _p2p_xla(
            lists["tx"], lists["ty"], lists["tz"], h[bi], bi + lead, start, length,
            *(jd if jd is not None else (x, y, z, m, h)), allow_self, cfg))
    mark("p2p")

    def total(far, near):
        return (far.reshape(-1)[lead:lead + n] + near[lead:lead + n]) * cfg.G

    ax, ay, az, phi = total(ax, pax), total(ay, pay), total(az, paz), total(phi, pphi)
    m2p_n, p2p_n = lists["m2p_n"], lists["p2p_n"]
    nb = m2p_n.shape[0]
    sf = cfg.super_factor
    scap = min(cfg.super_cap, num_n)
    let_n = lists["let_n"]
    ecap = min(cfg.let_cap, num_n) if let_n is not None else 0
    if sf > 0:
        # the superblocks classify against the essential set where there
        # is one (plus its one slab-bbox sweep), else against every node
        evals = -(-n // (sf * cfg.target_block)) * (ecap or num_n) + nb * scap
        if let_n is not None:
            evals += num_n
    elif let_n is not None:
        evals = num_n + nb * ecap
    else:
        evals = nb * num_n
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=dev)
    p2p_hw = p2p_n.max().to(i32)
    if escaped is not None:
        from sphexa_torch.parallel.exchange import fold_escape_sentinel

        p2p_hw = fold_escape_sentinel(p2p_hw, escaped, cfg.p2p_cap)
    diagnostics = {
        "m2p_max": m2p_n.max().to(i32),
        "p2p_max": p2p_hw,
        "leaf_occ": (edges[1:] - edges[:-1]).max().to(i32),
        "c_max": lists["c_max"].to(i32) if lists["c_max"] is not None else zero,
        "let_max": let_n.to(i32) if let_n is not None else zero,
        # a fill, not a copy from the host: a copy would sync the stream
        "compact_width": torch.full((), scap if sf > 0 else (ecap or num_n), dtype=i32,
                                    device=dev),
        # XLA folds the division by a constant into a product with its
        # float32 reciprocal; so does this, to give the JAX package's value
        "mac_work_ratio": ((m2p_n.sum() + p2p_n.sum()).to(torch.float32)
                           * float(np.float32(1.0) / np.float32(evals))),
    }
    if hmetrics is not None:
        diagnostics["halo_rows"] = hmetrics["halo_rows"]
        diagnostics["halo_occ"] = hmetrics["halo_occ"]
    if with_phi:
        return ax, ay, az, phi, diagnostics
    egrav = 0.5 * torch.sum(m * phi)
    return ax, ay, az, egrav, diagnostics
