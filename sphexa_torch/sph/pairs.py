"""Pair geometry of the gather backend's SPH j-reductions
(sphexa_tpu/sph/pairs.py).

Every gather op is a masked reduction over a static-shape neighbour list
(N, ngmax) from ``neighbors.cell_list.find_neighbors``: gather the
j-side fields, take minimum-image displacements and normalized kernel
distances, and sum or max over the valid slots.

The targets are the rows of the list, ``nidx.shape[0]`` of them. A field
an op reads on the j side may be longer: on a rank's slab (the gather
backend across ranks) it is the j-buffer [own slab | halo rows], whose
first rows are the targets' own, so the target's row reads its own value
from the same buffer and ``nidx`` holds j-buffer rows.
"""

from typing import NamedTuple

import torch

from sphexa_torch.sfc.box import Box, apply_pbc_xyz


class PairGeom(NamedTuple):
    idx: torch.Tensor  # (B,) i-particle rows (int64)
    nj: torch.Tensor  # (B, ngmax) j-particle rows (int64)
    mask: torch.Tensor  # (B, ngmax) valid-pair mask
    rx: torch.Tensor  # (B, ngmax) minimum-image displacement x_i - x_j
    ry: torch.Tensor
    rz: torch.Tensor
    dist: torch.Tensor  # (B, ngmax) |r_ij|, 1 where masked (a safe divisor)
    v1: torch.Tensor  # (B, ngmax) dist / h_i


def pair_geometry(idx, x, y, z, h, nidx, nmask, box: Box) -> PairGeom:
    """The pair geometry of one block of rows ``idx``."""
    nj = nidx[idx].long()
    mask = nmask[idx]
    rx, ry, rz = apply_pbc_xyz(box, x[idx][:, None] - x[nj], y[idx][:, None] - y[nj],
                               z[idx][:, None] - z[nj])
    d2 = rx * rx + ry * ry + rz * rz
    dist = torch.where(mask, torch.sqrt(torch.where(mask, d2, 1.0)), 1.0)
    return PairGeom(idx, nj, mask, rx, ry, rz, dist, dist / h[idx][:, None])


def iad_project(c11, c12, c13, c22, c23, c33, rx, ry, rz, w=None, sign=-1.0):
    """The pair displacement through the symmetric IAD tensor:
    tA_k = sign * (C r)_k * w. ``c*`` are i-side columns (B, 1) or j-side
    gathers (B, ngmax)."""
    t1 = c11 * rx + c12 * ry + c13 * rz
    t2 = c12 * rx + c22 * ry + c23 * rz
    t3 = c13 * rx + c23 * ry + c33 * rz
    if w is not None:
        t1, t2, t3 = t1 * w, t2 * w, t3 * w
    if sign != 1.0:
        t1, t2, t3 = sign * t1, sign * t2, sign * t3
    return t1, t2, t3


def msum(mask, terms):
    """Masked j-sum: invalid pairs zeroed, reduced over the neighbour axis."""
    return torch.sum(torch.where(mask, terms, 0.0), dim=-1)


def mmax(mask, terms, init=0.0):
    """Masked j-max with an explicit identity."""
    return torch.amax(torch.where(mask, terms, init), dim=-1)
