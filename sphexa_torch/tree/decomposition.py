"""SFC domain decomposition: equal-count key ranges per rank
(sphexa_tpu/tree/decomposition.py; the reference's
cstone/domain/domaindecomp.hpp uniformBins :49, makeSfcAssignment
:74-116). The sharded steps own equal row slabs of the sorted keys
(parallel/sort.py); this is the leaf-aligned assignment the reference
makes, for comparison and for tools."""

from typing import Tuple

import numpy as np
import torch

from sphexa_torch.parallel.sizing import leaf_array_from_device_keys


def uniform_bins(tree: np.ndarray, counts: np.ndarray, num_bins: int) -> np.ndarray:
    """``num_bins + 1`` split keys, each bin holding about the same count;
    bin r owns [keys[r], keys[r + 1]). Splits fall on leaf boundaries of
    ``tree`` (a leaf is never split across ranks)."""
    tree = np.asarray(tree, dtype=np.uint64)
    csum = np.concatenate([[0], np.cumsum(counts)])
    total = csum[-1]
    targets = (np.arange(1, num_bins) * total) // num_bins
    split_leaves = np.searchsorted(csum, targets, side="left")
    split_leaves = np.clip(split_leaves, 1, len(tree) - 1)
    # strictly increasing boundaries even for tiny trees
    split_leaves = np.maximum.accumulate(split_leaves)
    for i in range(1, len(split_leaves)):
        if split_leaves[i] <= split_leaves[i - 1]:
            split_leaves[i] = min(split_leaves[i - 1] + 1, len(tree) - 1)
    return np.concatenate([[tree[0]], tree[split_leaves], [tree[-1]]])


def make_sfc_assignment(sorted_keys: np.ndarray, num_ranks: int, bucket_size: int = 64
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(assignment keys, counts per rank): the leaf tree of the keys
    (``leaf_array_from_device_keys``, the converged compute_octree) cut
    into ``num_ranks`` contiguous key ranges of about equal count."""
    keys = np.asarray(sorted_keys, dtype=np.uint64)
    tree = leaf_array_from_device_keys(torch.as_tensor(keys.astype(np.int64)), bucket_size)
    counts = np.diff(np.searchsorted(keys, tree, side="left"))
    bins = uniform_bins(tree, counts, num_ranks)
    edges = np.searchsorted(keys, bins, side="left")
    return bins, np.diff(edges)
