"""Synthetic Plummer-sphere sample (sphexa_tpu/init/plummer.py): the
centrally concentrated mass distribution that stresses the Barnes-Hut MAC
classification (deep, strongly non-uniform trees). Not a reference init
case: a gravity benchmark and test initial condition, as in the JAX
package, and the N-body propagator's large input."""

from typing import Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.utils import build_state
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants


def sample_plummer(n: int, a: float = 1.0, rmax: float = 8.0, seed: int = 3):
    """(x, y, z, m) float32 arrays of an n-particle Plummer sphere with
    scale radius ``a``, radius-clipped at ``rmax`` (total mass 1); the
    same generator calls as the JAX package's, so the same arrays."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, n)
    r = a / np.sqrt(np.maximum(u ** (-2.0 / 3.0) - 1.0, 1e-12))
    r = np.minimum(r, rmax)
    cth = rng.uniform(-1.0, 1.0, n)
    sth = np.sqrt(1.0 - cth * cth)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    x = (r * sth * np.cos(phi)).astype(np.float32)
    y = (r * sth * np.sin(phi)).astype(np.float32)
    z = (r * cth).astype(np.float32)
    m = np.full(n, 1.0 / n, np.float32)
    return x, y, z, m


def plummer_state(n: int, h: float = 1e-3, min_dt: float = 1e-4, seed: int = 3,
                  device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """A cold Plummer sphere at rest for the N-body propagator, as the JAX
    package's gravity benchmark sets it up (bench.py ``_gravity_scale_line``):
    the sample of ``sample_plummer``, smoothing length ``h`` everywhere,
    an open cube 1.001 x the largest coordinate, G = 1."""
    dev = resolve_device(device)
    x, y, z, m = sample_plummer(n, seed=seed)
    ext = float(np.max(np.abs(np.stack([x, y, z])))) * 1.001
    box = Box.create(-ext, ext, boundary=BoundaryType.open, device=dev)
    const = SimConstants(g=1.0).normalized()
    state = build_state(x, y, z, 0.0, 0.0, 0.0, h, m, 0.0, min_dt, const.alphamin,
                        device=dev)
    return state, box, const
