"""Spherical multipoles of a selectable order P (sphexa_tpu/gravity/spherical.py):
the accuracy knob the reference takes from its EXAFMM harmonics
(ryoanji/nbody/kernel.hpp P2M / M2M / M2P to any order).

The solid-harmonic recurrences are unrolled in Python for a static P and
run as batched complex arithmetic over (..., ncoef) coefficient tensors,
in the JAX package's operation order. P2M is a segment sum of regular
harmonics, M2P a masked coefficient contraction, and the acceleration the
gradient of the M2P potential: the JAX package takes it with ``jax.grad``,
the port with ``torch.autograd.grad`` of each call's summed potential, so
that a caller chunking its targets frees each chunk's graph. M2M is the
O(P^4) translation M'_n^m = sum_kl R_k^l(d) M_{n-k}^{m-l}.

Conventions (Dehnen / EXAFMM scaled solid harmonics):
  R_0^0 = 1,  R_m^m = (x+iy)/(2m) R_{m-1}^{m-1},
  R_n^m = ((2n-1) z R_{n-1}^m - r^2 R_{n-2}^m) / ((n+m)(n-m))
  S_0^0 = 1/r, S_m^m = (2m-1)(x+iy)/r^2 S_{m-1}^{m-1},
  S_n^m = ((2n-1) z S_{n-1}^m - ((n-1)^2 - m^2) S_{n-2}^m) / r^2
with R_n^{-m} = (-1)^m conj(R_n^m); only m >= 0 is stored, ncoef(P) =
P (P+1) / 2 complex coefficients. Order P keeps the terms n = 0..P-1: P
= 3 carries the cartesian quadrupole's information, P >= 4 beats it.
"""

import functools
from typing import Dict, List, Tuple

import torch

from sphexa_torch.gravity import multipole as mp
from sphexa_torch.gravity.tree import level_add_


def ncoef(p: int) -> int:
    return p * (p + 1) // 2


@functools.lru_cache(maxsize=None)
def _nm_index(p: int) -> Dict[Tuple[int, int], int]:
    """(n, m) -> flat index for 0 <= m <= n < p."""
    idx, k = {}, 0
    for n in range(p):
        for m in range(n + 1):
            idx[(n, m)] = k
            k += 1
    return idx


def _flat(table: Dict, p: int) -> List[torch.Tensor]:
    return [table[nm] for nm in _nm_index(p)]


def regular_harmonics(x, y, z, p: int) -> List[torch.Tensor]:
    """R_n^m(x) for 0 <= m <= n < p, each a complex tensor of x's shape."""
    xy = torch.complex(x, y)
    r2 = x * x + y * y + z * z
    R = {(0, 0): torch.ones_like(xy)}
    for m in range(1, p):
        R[(m, m)] = xy / (2.0 * m) * R[(m - 1, m - 1)]
    for m in range(0, p - 1):
        R[(m + 1, m)] = z * R[(m, m)]
    for m in range(0, p):
        for n in range(m + 2, p):
            R[(n, m)] = ((2.0 * n - 1.0) * z * R[(n - 1, m)] - r2 * R[(n - 2, m)]) \
                / float((n + m) * (n - m))
    return _flat(R, p)


def irregular_harmonics(x, y, z, p: int) -> List[torch.Tensor]:
    """S_n^m(x) for 0 <= m <= n < p; singular at the origin (callers
    evaluate them only outside the MAC radius)."""
    xy = torch.complex(x, y)
    r2 = x * x + y * y + z * z
    inv_r2 = 1.0 / r2
    S = {(0, 0): torch.sqrt(inv_r2).to(xy.dtype)}
    for m in range(1, p):
        S[(m, m)] = (2.0 * m - 1.0) * xy * inv_r2 * S[(m - 1, m - 1)]
    for m in range(0, p - 1):
        S[(m + 1, m)] = (2.0 * m + 1.0) * z * inv_r2 * S[(m, m)]
    for m in range(0, p):
        for n in range(m + 2, p):
            S[(n, m)] = ((2.0 * n - 1.0) * z * S[(n - 1, m)]
                         - float((n - 1) ** 2 - m * m) * S[(n - 2, m)]) * inv_r2
    return _flat(S, p)


def _segment_sum_complex(w: torch.Tensor, edges: torch.Tensor,
                         segment_sum=None) -> torch.Tensor:
    """``multipole.edge_segment_sum`` (or ``segment_sum``) of a complex
    (n, k) tensor, its real and imaginary parts summed side by side."""
    n, k = w.shape
    s = (segment_sum or mp.edge_segment_sum)(torch.view_as_real(w).reshape(n, 2 * k), edges)
    return torch.view_as_complex(s.reshape(-1, k, 2).contiguous())


def p2m(x, y, z, m_part, center, edges, p: int, pleaf=None, segment_sum=None) -> torch.Tensor:
    """Leaf multipoles M_n^m = sum_j m_j R_n^m(x_j - c) over the contiguous
    leaf row ranges ``edges`` (L+1,); ``pleaf`` the particle -> leaf map
    where the caller has it; ``segment_sum`` the leaves' sums (default
    ``multipole.edge_segment_sum``). Returns (L, ncoef(p)) complex."""
    nl = center.shape[0]
    if pleaf is None:
        rows = torch.arange(x.shape[0], dtype=edges.dtype, device=x.device)
        pleaf = torch.clamp(torch.searchsorted(edges, rows, right=True) - 1, 0, nl - 1)
    dx = x - center[pleaf, 0]
    dy = y - center[pleaf, 1]
    dz = z - center[pleaf, 2]
    R = regular_harmonics(dx, dy, dz, p)
    w = torch.stack([m_part * Rk for Rk in R], dim=1)  # (n, NC) complex
    return _segment_sum_complex(w, edges, segment_sum)


def _get(coeffs, idx, n: int, m: int):
    """M_n^m from the m >= 0 storage, negative m by the conjugation parity."""
    if m >= 0:
        return coeffs[..., idx[(n, m)]]
    c = torch.conj(coeffs[..., idx[(n, -m)]])
    return c if (-m) % 2 == 0 else -c


def m2m(coeffs, d, p: int) -> torch.Tensor:
    """Child expansions translated by ``d = c_child - c_parent``, batched
    over the leading dimensions: coeffs (..., NC) complex, d (..., 3)."""
    idx = _nm_index(p)
    R = regular_harmonics(d[..., 0], d[..., 1], d[..., 2], p)
    Rd = {}
    for (n, m), k in idx.items():
        Rd[(n, m)] = R[k]
        if m > 0:
            c = torch.conj(R[k])
            Rd[(n, -m)] = c if m % 2 == 0 else -c
    out = []
    for n in range(p):
        for m in range(n + 1):
            acc = 0.0
            for k in range(n + 1):
                for l in range(-k, k + 1):
                    if abs(m - l) > n - k:
                        continue
                    acc = acc + Rd[(k, l)] * _get(coeffs, idx, n - k, m - l)
            out.append(acc)
    return torch.stack(out, dim=-1).resolve_conj()


def potential(dx, dy, dz, coeffs, p: int) -> torch.Tensor:
    """phi at offsets from the expansion centre: sum_n [M_n^0 S_n^0 +
    2 sum_{m>0} Re(M_n^m conj(S_n^m))]; shapes broadcast, coeffs (...,
    NC) complex."""
    S = irregular_harmonics(dx, dy, dz, p)
    acc = 0.0
    for (n, m), k in _nm_index(p).items():
        term = torch.real(coeffs[..., k] * torch.conj(S[k]))
        acc = acc + (term if m == 0 else 2.0 * term)
    return acc


def m2p(tx, ty, tz, com, coeffs, mask, p: int):
    """Far-field acceleration and potential of accepted nodes on targets:
    targets (..., B), nodes com (..., K, 3), coeffs (..., K, NC), mask
    (..., K). The acceleration is the gradient of the summed expansion
    potential (each target's sum depends on its own position only, so the
    gradient of the total is every target's own), consistent with phi to
    rounding; its graph lives for this call only. Returns (ax, ay, az,
    phi), each (..., B), phi in the cartesian path's physical sign."""
    valid = mask[..., None, :]
    with torch.enable_grad():
        px, py, pz = (a.detach().requires_grad_(True) for a in (tx, ty, tz))
        # a masked slot may hold the target's own leaf (r -> 0, S
        # singular): its offsets are replaced before the harmonics, so
        # that neither the value nor the gradient meets the singularity
        dx = torch.where(valid, px[..., :, None] - com[..., None, :, 0], 1.0)
        dy = torch.where(valid, py[..., :, None] - com[..., None, :, 1], 1.0)
        dz = torch.where(valid, pz[..., :, None] - com[..., None, :, 2], 1.0)
        ph = potential(dx, dy, dz, coeffs[..., None, :, :], p)
        phi = torch.where(valid, ph, 0.0).sum(dim=-1)
        gx, gy, gz = torch.autograd.grad(phi.sum(), (px, py, pz))
    # the expansion is phi_exp = sum_j m_j / |x - x_j| (positive); the
    # physical potential is -phi_exp, so a = +grad(phi_exp)
    return gx, gy, gz, -phi.detach()


def upsweep(leaf_coeffs, node_com, tree, meta, p: int) -> torch.Tensor:
    """Level-by-level M2M to the root (upsweepMultipoles), deepest level
    first, each level's translated expansions added into their parents.
    Returns (num_nodes, ncoef(p)) complex."""
    node_c = torch.zeros(meta.num_nodes, ncoef(p), dtype=leaf_coeffs.dtype,
                         device=leaf_coeffs.device)
    node_c[tree.node_of_leaf] = leaf_coeffs
    acc = torch.view_as_real(node_c)
    lr = meta.level_ranges
    for lv in range(len(lr) - 1, 0, -1):
        s, e = lr[lv]
        par = tree.parent[s:e]
        d = node_com[s:e] - node_com[par]  # child - parent
        level_add_(acc, par, torch.view_as_real(m2m(node_c[s:e], d, p)), lr[lv - 1])
    return node_c
