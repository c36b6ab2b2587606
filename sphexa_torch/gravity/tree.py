"""Linked octree of the gravity solver (sphexa_tpu/gravity/tree.py): a
level-major node array with a parent index per node, built on the host
from a cornerstone leaf array at configuration time and kept on the
device. Node geometry is stored as box fractions, so an open box may grow
between reconfigurations without invalidating the structure."""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.sfc.hilbert import hilbert_decode
from sphexa_torch.sfc.morton import morton_decode
from sphexa_torch.tree.csarray import KEY_RANGE, compute_octree, node_levels


@dataclasses.dataclass
class GravityTree:
    """Device tensors of the linked octree (level-major node order). The
    index arrays are int64, the type torch's gathers and scatters take."""

    leaf_keys: torch.Tensor  # (L+1,) int64 cornerstone leaf boundaries
    parent: torch.Tensor  # (N,) int64 parent node (the root is its own)
    is_leaf: torch.Tensor  # (N,) bool
    leaf_of_node: torch.Tensor  # (N,) int64 leaf index, 0 for internal nodes
    node_of_leaf: torch.Tensor  # (L,) int64
    center_frac: torch.Tensor  # (N, 3) float32 box-relative geometric centre
    halfsize_frac: torch.Tensor  # (N,) float32 box-relative half edge

    def to(self, device) -> "GravityTree":
        return GravityTree(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class GravityTreeMeta:
    """Static structure metadata: sizes and each level's node range."""

    num_leaves: int
    num_nodes: int
    # (start, end) node-index range per level, root level first
    level_ranges: Tuple[Tuple[int, int], ...]


def build_gravity_tree(sorted_keys, bucket_size: int, curve: str = "hilbert", device=None
                       ) -> Tuple[GravityTree, GravityTreeMeta]:
    """The cornerstone leaf array of the sorted keys and its linkage
    (sphexa_tpu/gravity/tree.py ``build_gravity_tree``: computeOctree,
    csarray.hpp:456, then updateInternalTree). The host build:
    ``sorted_keys`` (numpy, or an int64 key tensor read to the host once)
    goes through ``tree.csarray.compute_octree``; the tree lands on
    ``device`` (``device.resolve_device``: the card unless the caller asks
    for the CPU). The Simulation builds its leaves on the device
    (``parallel/sizing.leaf_array_from_device_keys``), equal to these bit
    for bit."""
    leaf_tree, _counts = compute_octree(sorted_keys, bucket_size)
    return linkage_from_leaves(leaf_tree, curve, device=resolve_device(device))


def linkage_from_leaves(leaf_tree, curve: str = "hilbert", device="cpu"
                        ) -> Tuple[GravityTree, GravityTreeMeta]:
    """Internal linkage and geometry from a cornerstone leaf array
    (updateInternalTree, octree.hpp role), in host numpy as the JAX
    package builds it; the result is moved to ``device``."""
    leaf_tree = np.asarray(leaf_tree, dtype=np.uint64)
    leaf_levels = node_levels(leaf_tree)
    leaf_starts = leaf_tree[:-1]
    num_leaves = len(leaf_starts)
    max_level = int(leaf_levels.max()) if num_leaves > 1 else 0

    # node set per level: leaves at that level + ancestors of deeper leaves
    per_level = []
    for lvl in range(max_level + 1):
        span = KEY_RANGE >> np.uint64(3 * lvl)
        here = leaf_starts[leaf_levels == lvl]
        deeper = leaf_starts[leaf_levels > lvl]
        anc = np.unique((deeper // span) * span) if len(deeper) else deeper
        per_level.append(np.unique(np.concatenate([here, anc])))

    level_offsets = np.concatenate([[0], np.cumsum([len(p) for p in per_level])])
    num_nodes = int(level_offsets[-1])
    node_key = np.concatenate(per_level)
    node_level = np.concatenate(
        [np.full(len(p), lvl, dtype=np.int64) for lvl, p in enumerate(per_level)])

    # parent: truncate the key to the parent level's span, search that level
    parent = np.zeros(num_nodes, dtype=np.int64)
    for lvl in range(1, max_level + 1):
        s, e = level_offsets[lvl], level_offsets[lvl + 1]
        pspan = KEY_RANGE >> np.uint64(3 * (lvl - 1))
        pkeys = (node_key[s:e] // pspan) * pspan
        parent[s:e] = level_offsets[lvl - 1] + np.searchsorted(per_level[lvl - 1], pkeys)

    # a node is the leaf with the same start key iff the levels match
    leaf_pos = np.clip(np.searchsorted(leaf_starts, node_key), 0, num_leaves - 1)
    is_leaf = (leaf_starts[leaf_pos] == node_key) & (leaf_levels[leaf_pos] == node_level)
    leaf_of_node = np.where(is_leaf, leaf_pos, 0).astype(np.int64)
    node_of_leaf = np.zeros(num_leaves, dtype=np.int64)
    node_of_leaf[leaf_of_node[is_leaf]] = np.flatnonzero(is_leaf)

    # geometry: decode the range-start key at full depth, truncate to the level
    decode = hilbert_decode if curve == "hilbert" else morton_decode
    ix, iy, iz = decode(torch.as_tensor(node_key.astype(np.int64)))
    cells = np.stack([ix.numpy(), iy.numpy(), iz.numpy()], axis=1)
    octant = cells >> (KEY_BITS - node_level)[:, None]
    inv = 1.0 / (1 << node_level).astype(np.float64)
    center_frac = ((octant + 0.5) * inv[:, None]).astype(np.float32)
    halfsize_frac = (0.5 * inv).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    tree = GravityTree(
        leaf_keys=dev(leaf_tree.astype(np.int64)), parent=dev(parent),
        is_leaf=dev(is_leaf), leaf_of_node=dev(leaf_of_node),
        node_of_leaf=dev(node_of_leaf), center_frac=dev(center_frac),
        halfsize_frac=dev(halfsize_frac))
    meta = GravityTreeMeta(
        num_leaves=num_leaves, num_nodes=num_nodes,
        level_ranges=tuple((int(level_offsets[lv]), int(level_offsets[lv + 1]))
                           for lv in range(max_level + 1)))
    return tree, meta


def level_add_(dst: torch.Tensor, par: torch.Tensor, vals: torch.Tensor,
               parent_range: Tuple[int, int]) -> None:
    """``dst[par[i]] += vals[i]`` for one level of the tree: its parents
    lie in the level before it, rows ``parent_range``, and ``par`` does not
    decrease (a parent's children are contiguous in the level-major
    layout). Each parent's children are added one at a time in row order,
    as a sequential ``index_add_`` adds them on the CPU, but
    deterministically on any device and without a read of the card (its
    ``index_add_`` adds with atomics in no fixed order, and ranks must
    agree bit for bit)."""
    ps, pe = parent_range
    k = par.shape[0]
    if k == 0:
        return
    dev = par.device
    slot = torch.arange(k, device=dev) - torch.searchsorted(par, par)
    loc = par - ps
    dense = torch.zeros((pe - ps, 8) + tuple(vals.shape[1:]), dtype=vals.dtype, device=dev)
    dense[loc, slot] = vals  # an octree node has at most 8 children
    acc = torch.zeros_like(dense[:, 0])
    for j in range(8):
        acc = acc + dense[:, j]
    has = torch.zeros(pe - ps, dtype=torch.int64, device=dev)
    has.index_add_(0, loc, torch.ones_like(loc))
    has = (has > 0).reshape((-1,) + (1,) * (vals.dim() - 1))
    dst[ps:pe] = torch.where(has, dst[ps:pe] + acc, dst[ps:pe])
