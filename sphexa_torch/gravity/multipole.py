"""Cartesian quadrupole operators P2M / M2M / M2P / P2P
(sphexa_tpu/gravity/multipole.py, in its operation order).

A multipole is a (..., 7) tensor [qxx qxy qxz qyy qyz qzz trace] in the
trace-free Hernquist-1987 form; masses and centres of mass are carried
separately."""

import torch


def edge_segment_sum(w: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Sums of row-contiguous segments (the particles are SFC-sorted, so a
    leaf's rows are contiguous): a cumulative sum differenced at the
    segment edges. ``w`` (n, k), ``edges`` (L+1,) row boundaries; returns
    (L, k) in ``w``'s type.

    The prefix sums run in float64, along the contiguous dimension. In
    float32 (the JAX package's choice) a sum over 10^6 rows leaves errors
    of order 1e-4 in the centres of mass of small leaves, which move the
    forces by some 1e-5 of their scale between two devices that order the
    sum differently; in float64 both devices give the exact segment sums
    rounded to float32. (A scan along dim 0 of an (n, k) tensor runs k
    sequential scans on the card, hence the transpose.)"""
    c = torch.cumsum(w.to(torch.float64).t().contiguous(), dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    return (c[:, edges[1:]] - c[:, edges[:-1]]).t().to(w.dtype)


def p2m_leaf(x, y, z, m, pleaf, leaf_com, edges, segment_sum=None) -> torch.Tensor:
    """Trace-free quadrupole of every leaf about its centre of mass
    (cartesian_qpole.hpp:89): raw second moments by segment sums
    (``segment_sum``, default ``edge_segment_sum``), then the trace
    removal. Returns (L, 7)."""
    dx = x - leaf_com[pleaf, 0]
    dy = y - leaf_com[pleaf, 1]
    dz = z - leaf_com[pleaf, 2]
    raw = torch.stack([m * dx * dx, m * dx * dy, m * dx * dz,
                       m * dy * dy, m * dy * dz, m * dz * dz], dim=1)
    return _remove_trace((segment_sum or edge_segment_sum)(raw, edges))


def _remove_trace(q: torch.Tensor) -> torch.Tensor:
    """Raw second moments (..., 6) -> trace-free form (..., 7)."""
    trace = q[..., 0] + q[..., 3] + q[..., 5]
    return torch.stack(
        [3.0 * q[..., 0] - trace, 3.0 * q[..., 1], 3.0 * q[..., 2],
         3.0 * q[..., 3] - trace, 3.0 * q[..., 4], 3.0 * q[..., 5] - trace, trace],
        dim=-1)


def m2m_shift(q_child, m_child, d) -> torch.Tensor:
    """Child quadrupole shifted to the parent expansion centre
    (addQuadrupole, cartesian_qpole.hpp:210); ``d = com_parent -
    com_child``. The result is added into the parent."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2_3 = (dx * dx + dy * dy + dz * dz) * (1.0 / 3.0)
    ml = 3.0 * m_child
    return q_child + torch.stack(
        [ml * (dx * dx - r2_3), ml * dx * dy, ml * dx * dz,
         ml * (dy * dy - r2_3), ml * dy * dz, ml * (dz * dz - r2_3), ml * r2_3],
        dim=-1)


def m2p(tx, ty, tz, com, q, mass, mask):
    """Far-field contribution of nodes to targets (cartesian_qpole.hpp:177):
    monopole -M r / r^3 plus quadrupole Q.r / r^5 - 5/2 (r.Q.r) r / r^7.
    Batched: targets (..., B), nodes (..., K) with com (..., K, 3), q
    (..., K, 7), mass and mask (..., K); returns per-target sums (ax, ay,
    az, phi), each (..., B)."""
    rx = tx[..., :, None] - com[..., None, :, 0]  # (..., B, K)
    ry = ty[..., :, None] - com[..., None, :, 1]
    rz = tz[..., :, None] - com[..., None, :, 2]
    r2 = rx * rx + ry * ry + rz * rz
    valid = mask[..., None, :]
    inv_r = torch.where(valid, torch.rsqrt(torch.clamp_min(r2, 1e-30)), 0.0)
    inv_r2 = inv_r * inv_r
    inv_r5 = inv_r2 * inv_r2 * inv_r

    qn = [q[..., None, :, k] for k in range(6)]
    qxx, qxy, qxz, qyy, qyz, qzz = qn
    qrx = rx * qxx + ry * qxy + rz * qxz
    qry = rx * qxy + ry * qyy + rz * qyz
    qrz = rx * qxz + ry * qyz + rz * qzz
    rqr = rx * qrx + ry * qry + rz * qrz

    m_ = mass[..., None, :]
    quad_mono = (-2.5 * rqr * inv_r5 - m_ * inv_r) * inv_r2
    phi = -(m_ * inv_r + 0.5 * inv_r5 * rqr)
    ax = inv_r5 * qrx + quad_mono * rx
    ay = inv_r5 * qry + quad_mono * ry
    az = inv_r5 * qrz + quad_mono * rz
    return tuple(torch.where(valid, a, 0.0).sum(dim=-1) for a in (ax, ay, az, phi))


def p2p(tx, ty, tz, th, sx, sy, sz, sm, sh, mask):
    """Near-field particle-particle interaction with SPH-compatible
    softening (kernel.hpp:515): inside h_i + h_j the distance is clamped
    to it. Targets (..., B), sources (..., S) with the same leading dims
    (none, or a batch of blocks), ``mask`` (..., B, S); returns (ax, ay,
    az, phi), each (..., B)."""
    dx = sx[..., None, :] - tx[..., :, None]  # source minus target
    dy = sy[..., None, :] - ty[..., :, None]
    dz = sz[..., None, :] - tz[..., :, None]
    r2 = dx * dx + dy * dy + dz * dz
    h_ij = th[..., :, None] + sh[..., None, :]
    r2_eff = torch.maximum(r2, h_ij * h_ij)
    inv_r = torch.where(mask, torch.rsqrt(torch.clamp_min(r2_eff, 1e-30)), 0.0)
    inv_r3m = sm[..., None, :] * inv_r * inv_r * inv_r
    phi = -inv_r3m * r2
    return ((dx * inv_r3m).sum(dim=-1), (dy * inv_r3m).sum(dim=-1),
            (dz * inv_r3m).sum(dim=-1), phi.sum(dim=-1))
