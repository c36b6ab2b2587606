"""Particle-lattice helpers for initial conditions (sphexa_tpu/init/
glass.py, the procedural parts): a lattice with seeded sub-spacing jitter,
which breaks the grid axes' alignment as a relaxed glass would, the
sphere cut and the rho ~ 1/r contraction. The glass-template tiling of
the JAX package is not ported."""

from typing import Tuple

import numpy as np


def jittered_lattice(lo, hi, counts, seed: int = 42, jitter: float = 0.2
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Jittered lattice of ``counts=(nx, ny, nz)`` points spanning the
    cuboid [lo, hi): cell centres moved by up to ``jitter`` spacings (numpy
    generator ``seed``) and wrapped into the cuboid; float64 (x, y, z)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    steps = (hi - lo) / np.asarray(counts, np.float64)
    lines = [lo[d] + steps[d] * (0.5 + np.arange(counts[d])) for d in range(3)]
    zz, yy, xx = np.meshgrid(lines[2], lines[1], lines[0], indexing="ij")
    n = int(np.prod(counts))
    out = []
    for d, grid in enumerate((xx, yy, zz)):
        delta = rng.uniform(-jitter, jitter, size=n) * steps[d]
        out.append(lo[d] + np.mod(grid.ravel() + delta - lo[d], hi[d] - lo[d]))
    return out[0], out[1], out[2]


def cut_sphere(r: float, x, y, z, center=None):
    """Keep only the particles inside radius r (grid.hpp cutSphere)."""
    if center is None:
        center = (0.0, 0.0, 0.0)
    keep = (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2 <= r * r
    return x[keep], y[keep], z[keep]


def contract_rho_profile(x, y, z):
    """Multiply coordinates by sqrt(r): uniform sphere -> rho ~ 1/r
    profile (evrard_init.hpp contractRhoProfile)."""
    c = np.sqrt(np.sqrt(x * x + y * y + z * z))
    return x * c, y * c, z * c
