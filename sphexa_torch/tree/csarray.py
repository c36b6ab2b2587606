"""Cornerstone leaf-array helpers (sphexa_tpu/tree/csarray.py, the two the
gravity tree reads): a tree is a sorted key array of ``numLeaves + 1``
boundaries from 0 to 2^30, every leaf spanning a power-of-8 key range
aligned to its level. Host numpy, uint64 so that 2^30 is exact."""

import numpy as np

from sphexa_torch.dtypes import KEY_BITS

KEY_RANGE = np.uint64(1) << np.uint64(3 * KEY_BITS)


def node_levels(tree: np.ndarray) -> np.ndarray:
    """Octree level of each leaf, from its key span (power-of-8 invariant)."""
    spans = np.diff(np.asarray(tree, dtype=np.uint64))
    return (3 * KEY_BITS - np.round(np.log2(spans.astype(np.float64))).astype(np.int64)) // 3
