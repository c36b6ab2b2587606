"""Global bounding box and periodic-boundary math (sphexa_tpu/sfc/box.py).

``lo``/``hi`` are (3,) float32 tensors on the particles' device; the
boundary types are static Python values that select code paths.
"""

import dataclasses
import enum
import functools
from typing import Tuple

import torch

from sphexa_torch.dtypes import COORD_DTYPE


class BoundaryType(enum.IntEnum):
    """Per-dimension boundary behaviour (cstone/sfc/box.hpp BoundaryType)."""

    open = 0
    periodic = 1
    fixed = 2


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned global box with per-dimension boundary types."""

    lo: torch.Tensor
    hi: torch.Tensor
    boundaries: Tuple[BoundaryType, BoundaryType, BoundaryType] = (
        BoundaryType.open, BoundaryType.open, BoundaryType.open,
    )

    @staticmethod
    def create(xmin, xmax, ymin=None, ymax=None, zmin=None, zmax=None,
               boundary=BoundaryType.open, device="cpu") -> "Box":
        """Cubic if only (xmin, xmax) are given, like cstone::Box."""
        if ymin is None:
            ymin, ymax, zmin, zmax = xmin, xmax, xmin, xmax
        if isinstance(boundary, BoundaryType):
            boundary = (boundary, boundary, boundary)
        lo = torch.tensor([xmin, ymin, zmin], dtype=COORD_DTYPE, device=device)
        hi = torch.tensor([xmax, ymax, zmax], dtype=COORD_DTYPE, device=device)
        return Box(lo=lo, hi=hi, boundaries=tuple(BoundaryType(b) for b in boundary))

    @property
    def lengths(self) -> torch.Tensor:
        return self.hi - self.lo

    @property
    def periodic_mask(self) -> torch.Tensor:
        """(3,) bool tensor: which dims wrap around."""
        return _dim_mask(tuple(b == BoundaryType.periodic for b in self.boundaries),
                         self.lo.device)

    def to(self, device) -> "Box":
        return Box(lo=self.lo.to(device), hi=self.hi.to(device),
                   boundaries=self.boundaries)


@functools.lru_cache(maxsize=None)
def _dim_mask(flags: Tuple[bool, bool, bool], device: torch.device) -> torch.Tensor:
    """(3,) bool tensor of per-dimension flags, made once per device and
    shared read-only: a host-to-device copy in every step would sync it."""
    return torch.tensor(flags, device=device)


def _floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod for floats: fmod, shifted into the divisor's sign (exact,
    the same steps as jax.numpy.remainder)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def apply_pbc_xyz(box: Box, rx, ry, rz):
    """Minimum-image fold of per-component separations (periodic dims);
    ``torch.round`` rounds half to even like ``jnp.round``."""
    L = box.lengths
    out = []
    for d, r in enumerate((rx, ry, rz)):
        if box.boundaries[d] == BoundaryType.periodic:
            r = r - L[d] * torch.round(r / L[d])
        out.append(r)
    return tuple(out)


def put_in_box(box: Box, xyz: torch.Tensor) -> torch.Tensor:
    """Fold absolute positions (..., 3) back into the box along periodic dims."""
    L = box.lengths
    folded = box.lo + _floor_mod(xyz - box.lo, L)
    return torch.where(box.periodic_mask, folded, xyz)


def make_global_box(x, y, z, prev: Box, mesh=None) -> Box:
    """Grow open dimensions to the particle extrema; periodic and fixed
    dimensions keep their limits (cstone makeGlobalBox). ``mesh``: the
    arrays are this rank's slab, and the extrema are reduced over the
    ranks (one all_gather, parallel/mesh.py)."""
    lo_fit = torch.stack([x.min(), y.min(), z.min()])
    hi_fit = torch.stack([x.max(), y.max(), z.max()])
    if mesh is not None:
        from sphexa_torch.parallel.mesh import reduce_scalars

        _, (hi_fit,), (lo_fit,) = reduce_scalars(mesh, maxes=[hi_fit], mins=[lo_fit])
    keep = _dim_mask(tuple(b != BoundaryType.open for b in prev.boundaries),
                     prev.lo.device)
    lo = torch.where(keep, prev.lo, torch.minimum(prev.lo, lo_fit))
    hi = torch.where(keep, prev.hi, torch.maximum(prev.hi, hi_fit))
    return Box(lo=lo, hi=hi, boundaries=prev.boundaries)
