"""Key injection: force given SFC keys to be leaf boundaries
(sphexa_tpu/tree/inject.py; the reference's cstone/focus/inject.hpp
injectKeys). Each refinement splits the containing leaf into its eight
children, level by level, until the key is a boundary, so that every leaf
still spans an aligned power-of-8 key range. Host numpy on uint64."""

import numpy as np

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.tree.csarray import KEY_RANGE, _as_keys


def inject_keys(tree, keys) -> np.ndarray:
    """A valid cornerstone tree with every one of ``keys`` on a leaf
    boundary (injectKeys, inject.hpp:26-99). ``tree`` and ``keys`` may be
    numpy arrays or int64 key tensors (read to the host once)."""
    tree = _as_keys(tree)
    inject = np.unique(_as_keys(keys))
    inject = inject[(inject > 0) & (inject < KEY_RANGE)]
    boundaries = set(tree.tolist())

    for k in inject.tolist():
        if k in boundaries:
            continue
        # from the root octant that holds k down: add the seven inner
        # boundaries of the containing node's split at each level
        for level in range(1, KEY_BITS + 1):
            span = int(KEY_RANGE) >> (3 * level)
            if span == 0:
                break
            node_start = (k // (span * 8)) * (span * 8)
            for j in range(1, 8):
                boundaries.add(node_start + j * span)
            if k % span == 0:
                break

    return np.array(sorted(boundaries), dtype=np.uint64)
