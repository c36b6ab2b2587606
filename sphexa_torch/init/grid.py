"""Lattice coordinates (sphexa_tpu/init/grid.py)."""

import numpy as np


def regular_grid(r: float, side: int):
    """Regular cubic lattice centred on the origin spanning [-r, r)^3, with
    a half-step inset so it tiles periodically; float32 (x, y, z)."""
    step = 2.0 * r / side
    line = (-r + 0.5 * step + step * np.arange(side)).astype(np.float32)
    z, y, x = np.meshgrid(line, line, line, indexing="ij")
    return x.ravel(), y.ravel(), z.ravel()
