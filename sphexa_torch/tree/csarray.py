"""Cornerstone leaf-array octree build (sphexa_tpu/tree/csarray.py; the
reference's cstone/tree/csarray.hpp computeNodeCounts :203,
calculateNodeOp :291, rebalanceTree :399, updateOctree :433,
computeOctree :456).

A tree is a sorted key array of ``numLeaves + 1`` boundaries from 0 to
2^30, every leaf spanning a power-of-8 key range aligned to its level;
counts per leaf are one ``searchsorted``, and one rebalance step is a
per-leaf op (8 split, 1 keep, 0 merged into the parent), its exclusive
scan and a scatter of the new boundaries. Host numpy on uint64, so that
2^30 is exact, as in the JAX module: the build runs at configuration time
and its output sizes device structures.

The functions also take the port's int64 key tensors (dtypes.KEY_DTYPE),
on any device: those are read to the host once (a host read of the card
for a CUDA tensor). The device build of the same tree is
``parallel/sizing.leaf_array_from_device_keys``, equal to
``compute_octree``'s leaves bit for bit.
"""

from typing import Tuple

import numpy as np
import torch

from sphexa_torch.dtypes import KEY_BITS

KEY_RANGE = np.uint64(1) << np.uint64(3 * KEY_BITS)


def _as_keys(a) -> np.ndarray:
    """Keys widened to uint64 on the host, so that 2^30 (one past the
    largest key) is exact. A tensor is read to the host once."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.uint64)


def make_root_tree() -> np.ndarray:
    """The minimal tree: a single root leaf covering the whole key space."""
    return np.array([0, KEY_RANGE], dtype=np.uint64)


def make_uniform_tree(level: int) -> np.ndarray:
    """Fully refined tree at ``level``: 8**level equal leaves."""
    n = 1 << (3 * level)
    return np.arange(n + 1, dtype=np.uint64) * (KEY_RANGE // np.uint64(n))


def node_levels(tree) -> np.ndarray:
    """Octree level of each leaf, from its key span (power-of-8 invariant)."""
    spans = np.diff(_as_keys(tree))
    return (3 * KEY_BITS - np.round(np.log2(spans.astype(np.float64))).astype(np.int64)) // 3


def compute_node_counts(tree, sorted_keys) -> np.ndarray:
    """Particle count per leaf: one searchsorted of every leaf boundary in
    the sorted keys (computeNodeCounts, csarray.hpp:203)."""
    edges = np.searchsorted(_as_keys(sorted_keys), _as_keys(tree), side="left")
    return np.diff(edges).astype(np.int64)


def _node_ops(tree, counts: np.ndarray, bucket_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(op per leaf, merged-first flags): 8 split, 1 keep, 0 merged into
    the parent (calculateNodeOp, csarray.hpp:291). A leaf splits when it
    holds more than ``bucket_size`` and is not at the deepest level; eight
    aligned siblings whose total fits the bucket merge, the first standing
    for the parent (op 1, flagged) and the other seven op 0."""
    tree = _as_keys(tree)
    spans = np.diff(tree)
    levels = node_levels(tree)
    n = len(counts)

    ops = np.ones(n, dtype=np.int64)
    ops[(counts > bucket_size) & (levels < KEY_BITS)] = 8
    merged_first = np.zeros(n, dtype=bool)
    if n < 8:
        return ops, merged_first
    starts = tree[:-1]
    parent_span = spans * np.uint64(8)
    is_first_sibling = (np.arange(n) + 8 <= n) & (starts % np.maximum(parent_span, 1) == 0)
    idx = np.flatnonzero(is_first_sibling)
    if not len(idx):
        return ops, merged_first
    # eight equal spans in a row from an aligned start: a true sibling group
    span_ok = np.ones(len(idx), dtype=bool)
    total = np.zeros(len(idx), dtype=np.int64)
    for j in range(8):
        span_ok &= spans[np.minimum(idx + j, n - 1)] == spans[idx]
        total += counts[np.minimum(idx + j, n - 1)]
    merge = span_ok & (total <= bucket_size) & (levels[idx] > 0)
    for j in range(1, 8):
        ops[idx[merge] + j] = 0
    ops[idx[merge]] = 1
    merged_first[idx[merge]] = True
    return ops, merged_first


def rebalance_tree(tree, counts: np.ndarray, bucket_size: int) -> Tuple[np.ndarray, bool]:
    """One rebalance step: (new tree, converged) (rebalanceTree,
    csarray.hpp:399)."""
    tree = _as_keys(tree)
    ops, merged_first = _node_ops(tree, counts, bucket_size)
    if bool(np.all(ops == 1) and not merged_first.any()):
        return tree, True

    offsets = np.concatenate([[0], np.cumsum(ops)])
    new_tree = np.zeros(offsets[-1] + 1, dtype=np.uint64)
    spans = np.diff(tree)
    keep = np.flatnonzero(ops == 1)
    new_tree[offsets[keep]] = tree[keep]
    split = np.flatnonzero(ops == 8)
    if len(split):
        child_span = spans[split] // np.uint64(8)
        for j in range(8):
            new_tree[offsets[split] + j] = tree[split] + np.uint64(j) * child_span
    new_tree[-1] = KEY_RANGE
    return new_tree, False


def update_octree(sorted_keys, tree, bucket_size: int) -> Tuple[np.ndarray, np.ndarray, bool]:
    """One iteration of counts and rebalance: (tree, counts, converged)
    (updateOctree, csarray.hpp:433)."""
    sorted_keys = _as_keys(sorted_keys)
    counts = compute_node_counts(tree, sorted_keys)
    new_tree, converged = rebalance_tree(tree, counts, bucket_size)
    if not converged:
        counts = compute_node_counts(new_tree, sorted_keys)
    return new_tree, counts, converged


def compute_octree(sorted_keys, bucket_size: int, max_iterations: int = 64
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A converged cornerstone tree of the sorted keys, built from the
    root: ``update_octree`` until no leaf splits or merges (computeOctree,
    csarray.hpp:456). Returns (tree, counts)."""
    sorted_keys = _as_keys(sorted_keys)
    tree = make_root_tree()
    counts = compute_node_counts(tree, sorted_keys)
    for _ in range(max_iterations):
        tree, counts, converged = update_octree(sorted_keys, tree, bucket_size)
        if converged:
            break
    return tree, counts
