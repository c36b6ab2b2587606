"""Gravity-tree build from device keys (sphexa_tpu/parallel/sizing.py,
``key_histogram``, ``drill_histogram`` and ``leaf_array_from_device_keys``):
a histogram pyramid plus drill-down rounds over the overfull cells, so
only O(8^level) counts reach the host, never the keys."""

import numpy as np
import torch

from sphexa_torch.dtypes import KEY_BITS


def key_histogram(keys: torch.Tensor, level: int) -> torch.Tensor:
    """Cell-occupancy histogram at ``level``: (8^level,) int64."""
    cid = keys >> (3 * (KEY_BITS - level))
    return torch.bincount(cid, minlength=1 << (3 * level))


def drill_histogram(keys: torch.Tensor, cell_ids_sorted: torch.Tensor, level: int,
                    sub: int, k_cap: int) -> torch.Tensor:
    """Counts of the 8^sub sub-cells of ``k_cap`` selected cells at
    ``level`` (keys outside them fall in a discard bin).
    ``cell_ids_sorted``: (k_cap,) sorted cell indices padded with 2^30.
    Returns (k_cap, 8^sub) int64."""
    nsub = 1 << (3 * sub)
    cid = keys >> (3 * (KEY_BITS - level))
    pos = torch.searchsorted(cell_ids_sorted, cid).clamp(0, k_cap - 1)
    hit = cell_ids_sorted[pos] == cid
    subid = (keys >> (3 * (KEY_BITS - level - sub))) & (nsub - 1)
    b = torch.where(hit, pos * nsub + subid, k_cap * nsub)
    return torch.bincount(b, minlength=k_cap * nsub + 1)[: k_cap * nsub].reshape(k_cap, nsub)


def leaf_array_from_device_keys(keys_dev: torch.Tensor, bucket_size: int,
                                base_level: int = 5, sub: int = 2,
                                k_cap: int = 4096) -> np.ndarray:
    """Cornerstone leaf array (sorted start keys + the 2^30 sentinel),
    uint64, built without shipping the keys to the host: a node splits
    while its count exceeds ``bucket_size`` (capped at the key resolution),
    which equals the converged rebalance of compute_octree. Counts come
    from one base-level histogram plus drill rounds over the overfull
    frontier. Each histogram is one host read."""
    base_level = min(base_level, KEY_BITS)
    hist = key_histogram(keys_dev, base_level).cpu().numpy()
    pyramid = {base_level: hist.astype(np.int64)}
    for lvl in range(base_level - 1, -1, -1):
        pyramid[lvl] = pyramid[lvl + 1].reshape(-1, 8).sum(axis=1)

    leaves: list = []  # (cell_index, level)
    overfull = []      # frontier beyond the pyramid, all at base_level
    stack = [(0, 0)]
    while stack:
        i, lv = stack.pop()
        c = int(pyramid[lv][i])
        if c <= bucket_size or lv >= KEY_BITS:
            leaves.append((i, lv))
        elif lv < base_level:
            stack.extend((i * 8 + k, lv + 1) for k in range(8))
        else:
            overfull.append(i)

    # drill rounds: refine every overfull cell ``sub`` levels at a time;
    # the depth-``sub`` counts are summed back up so that splitting still
    # happens one level at a time
    level = base_level
    pending = overfull
    while pending and level < KEY_BITS:
        step = min(sub, KEY_BITS - level)
        nsub = 1 << (3 * step)
        nxt = []
        for c0 in range(0, len(pending), k_cap):
            chunk = np.sort(np.asarray(pending[c0: c0 + k_cap], np.int64))
            ids = np.full(k_cap, 2**30, np.int64)
            ids[: len(chunk)] = chunk
            counts = drill_histogram(keys_dev, torch.as_tensor(ids, device=keys_dev.device),
                                     level, step, k_cap).cpu().numpy()
            for r, cell in enumerate(chunk):
                sums = [counts[r].reshape(1 << (3 * d), -1).sum(axis=1)
                        for d in range(step + 1)]
                stack = [(k, 1) for k in range(8)]  # the cell is known overfull
                while stack:
                    i, d = stack.pop()
                    c = int(sums[d][i])
                    lvl = level + d
                    if c <= bucket_size or lvl >= KEY_BITS:
                        leaves.append((int(cell) * (1 << (3 * d)) + i, lvl))
                    elif d < step:
                        stack.extend((i * 8 + k, d + 1) for k in range(8))
                    else:
                        nxt.append(int(cell) * nsub + i)
        pending = nxt
        level += step

    starts = np.sort(np.asarray(
        [np.uint64(i) << np.uint64(3 * (KEY_BITS - lv)) for i, lv in leaves], np.uint64))
    return np.concatenate([starts, [np.uint64(1) << np.uint64(3 * KEY_BITS)]])
