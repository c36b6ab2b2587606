"""Continuum octree: the cornerstone build from an analytic density
(sphexa_tpu/tree/continuum.py; the reference's cstone/tree/continuum.hpp
computeContinuumCsarray). A leaf's expected count is the density's
integral over its volume, midpoint-sampled on a 2x2x2 subgrid, scaled to
``n_total``: a tree for initial conditions and tests without particles.

The leaves' start keys are decoded with the port's Hilbert or Morton
decode on ``device`` (``device.resolve_device``: the card unless the
caller asks for the CPU), and the cells come back to the host as int64,
the integers the JAX module's numpy shifts make; the rest is float64
numpy, as there.
"""

from typing import Callable, Tuple

import numpy as np
import torch

from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.sfc.hilbert import hilbert_decode
from sphexa_torch.sfc.morton import morton_decode
from sphexa_torch.tree.csarray import _as_keys, make_root_tree, node_levels, rebalance_tree


def _leaf_boxes(tree, box_lo, box_lengths, curve: str, device=None):
    """(lo (L, 3), edge (L, 3)) of the leaves in box coordinates, float64.
    The decode runs on ``device``; one host read of the (L, 3) cells."""
    dev = resolve_device(device)
    tree = _as_keys(tree)
    levels = node_levels(tree)
    decode = hilbert_decode if curve == "hilbert" else morton_decode
    starts = torch.as_tensor(tree[:-1].astype(np.int64), device=dev)
    cells = torch.stack(decode(starts), dim=1).cpu().numpy()
    # int64 cells shifted by int64 level shifts: the JAX module's numpy
    # uint32 cells promote to the same int64 integers
    octant = cells >> (KEY_BITS - levels)[:, None]
    inv = 1.0 / (1 << levels).astype(np.float64)
    lengths = np.asarray(box_lengths, np.float64)[None, :]
    lo = np.asarray(box_lo, np.float64)[None, :] + octant * (inv[:, None] * lengths)
    edge = inv[:, None] * lengths
    return lo, edge


def continuum_counts(tree, rho_fn: Callable, box_lo, box_lengths, n_total: int,
                     curve: str = "hilbert", device=None) -> np.ndarray:
    """Expected particle count per leaf: ``n_total`` x the leaf's share of
    the density's integral, midpoint-sampled on a 2x2x2 subgrid a leaf.
    ``rho_fn(x, y, z)`` takes and returns float64 numpy arrays."""
    lo, edge = _leaf_boxes(tree, box_lo, box_lengths, curve, device)
    vol = np.prod(edge, axis=1)
    acc = np.zeros(len(vol), np.float64)
    for ox in (0.25, 0.75):
        for oy in (0.25, 0.75):
            for oz in (0.25, 0.75):
                p = lo + edge * np.array([ox, oy, oz])
                acc += rho_fn(p[:, 0], p[:, 1], p[:, 2])
    mass = acc / 8.0 * vol
    total = mass.sum()
    if total <= 0.0:
        return np.zeros(len(vol), np.int64)
    return np.round(mass / total * n_total).astype(np.int64)


def compute_continuum_octree(rho_fn: Callable, box_lo, box_lengths, n_total: int,
                             bucket_size: int, curve: str = "hilbert",
                             max_iterations: int = 64, device=None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Converged cornerstone tree of an analytic density
    (computeContinuumCsarray, continuum.hpp): expected counts and
    rebalance from the root until stable. Returns (tree, counts)."""
    dev = resolve_device(device)
    tree = make_root_tree()
    counts = continuum_counts(tree, rho_fn, box_lo, box_lengths, n_total, curve, dev)
    for _ in range(max_iterations):
        tree, converged = rebalance_tree(tree, counts, bucket_size)
        counts = continuum_counts(tree, rho_fn, box_lo, box_lengths, n_total, curve, dev)
        if converged:
            break
    return tree, counts
