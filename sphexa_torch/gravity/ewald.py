"""Ewald summation for self-gravity in periodic boxes
(sphexa_tpu/gravity/ewald.py, after the reference's computeGravityEwald,
ryoanji/nbody/traversal_ewald_cpu.hpp). The periodic force is

  near field : Barnes-Hut forces summed over the (2r+1)^3 box replicas
               (the tree of the base box, the targets shifted: one
               ``compute_gravity`` pass per shift, K12 pairing a target
               with its own image in every pass but the base one);
  real space : a per-particle correction from the ROOT multipole over
               the replicas within ``num_ewald_shells``, erfc-screened
               (erf-subtracted inside the region the near field covered);
  k space    : the smooth long-range rest as a Fourier sum with root
               multipole coefficients.

The corrections are plain PyTorch: (rows, shells) broadcasts, chunked
over rows so that a chunk's temporaries stay a few GB, and the k-space
sum as cos / sin products with the h-vector table. The box must be cubic
(traversal_ewald_cpu.hpp:366); the multipoles cartesian quadrupoles.
"""

import dataclasses
import functools
import math
from itertools import product
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sphexa_torch.gravity.traversal import (
    CHUNK_ELEMS, GravityConfig, compute_gravity, compute_multipoles, compute_multipoles_sharded,
)
from sphexa_torch.gravity.tree import GravityTree, GravityTreeMeta
from sphexa_torch.sfc.box import Box

#: the solver diagnostics an Ewald solve folds by max over its replica
#: passes (the high-water marks the driver holds against the caps)
EWALD_DIAG_KEYS = ("m2p_max", "p2p_max", "leaf_occ", "c_max", "let_max", "compact_width")


@dataclasses.dataclass(frozen=True)
class EwaldConfig:
    """Static Ewald parameters (ewaldInitParameters' recommended values)."""

    num_replica_shells: int = 1
    lcut: float = 2.6
    hcut: float = 2.8
    alpha_scale: float = 2.0
    small_r_factor: float = 3.0e-3  # Gasoline's value (traversal_ewald_cpu.hpp:147)

    @property
    def num_ewald_shells(self) -> int:
        return max(int(np.ceil(self.lcut)), self.num_replica_shells)


def _real_space_shells(cfg: EwaldConfig):
    """The shell table: integer offsets (S, 3) float32 and their
    in-near-field flags (S,)."""
    s = cfg.num_ewald_shells
    r = cfg.num_replica_shells
    shells, in_near = [], []
    for ix, iy, iz in product(range(-s, s + 1), repeat=3):
        shells.append((ix, iy, iz))
        in_near.append(abs(ix) <= r and abs(iy) <= r and abs(iz) <= r)
    return np.asarray(shells, np.float32), np.asarray(in_near)


def _k_space_hvecs(cfg: EwaldConfig):
    """The h-vector table (H, 3) float32: 0 < |h| <= hcut."""
    reps = int(np.ceil(cfg.hcut))
    hvecs = [(hx, hy, hz) for hx, hy, hz in product(range(-reps, reps + 1), repeat=3)
             if 0 < hx * hx + hy * hy + hz * hz <= cfg.hcut ** 2]
    return np.asarray(hvecs, np.float32)


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: EwaldConfig, device: torch.device):
    """The shell table, its near-field flags, the h-vectors and the
    replica shifts' shells as tensors on ``device``, copied there once
    (a copy from the host would stall the stream every solve)."""
    shells, in_near = _real_space_shells(cfg)
    return tuple(torch.as_tensor(a, device=device) for a in (
        shells, in_near, _k_space_hvecs(cfg), replica_shells(cfg)))


def replica_shells(cfg: EwaldConfig) -> np.ndarray:
    """The near field's (2r+1)^3 integer shifts (float32, base box in the
    middle), in the order the passes run and sum."""
    r = cfg.num_replica_shells
    return np.array(list(product(range(-r, r + 1), repeat=3)), np.float32)


def _eval_root_multipole(r, gamma, mass, q):
    """Potential and acceleration of the root expansion at offsets ``r``
    (..., 3) (ewaldEvalMultipoleComplete, traversal_ewald_cpu.hpp:89-111):
    ``gamma`` (..., 4) the first four gamma factors, root monopole
    ``mass`` and trace-free quadrupole ``q`` (7,). Returns (u (...), a
    (..., 3))."""
    qxx = (q[0] + q[6]) / 3.0
    qyy = (q[3] + q[6]) / 3.0
    qzz = (q[5] + q[6]) / 3.0
    qxy, qxz, qyz = q[1] / 3.0, q[2] / 3.0, q[4] / 3.0

    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    qr = torch.stack([rx * qxx + ry * qxy + rz * qxz,
                      rx * qxy + ry * qyy + rz * qyz,
                      rx * qxz + ry * qyz + rz * qzz], dim=-1)
    rqr = 0.5 * torch.sum(r * qr, dim=-1)
    qtr = 0.5 * q[6]

    g0, g1, g2, g3 = gamma[..., 0], gamma[..., 1], gamma[..., 2], gamma[..., 3]
    u = -g0 * mass + g1 * qtr - g2 * rqr
    a = g2[..., None] * qr - r * (g1 * mass - g2 * qtr + g3 * rqr)[..., None]
    return u, a


def _row_chunks(n: int, per_row: int, dev: torch.device):
    """(start, stop) row ranges whose (rows, per_row) temporaries hold
    half the traversal's chunk budget of elements each."""
    step = max(1, CHUNK_ELEMS[dev.type] // (2 * per_row))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _real_space_correction(dr, mass, q, L, cfg: EwaldConfig):
    """The real-space Ewald sum over the shells for particle offsets ``dr``
    (N, 3) from the root's centre of mass: the gamma recurrences of
    traversal_ewald_cpu.hpp:199-297 (erfc screening outside the near
    field, -erf inside it, a series near R = 0), in chunks of rows.
    Returns (u (N,), a (N, 3))."""
    dev = dr.device
    shells, in_near, _, _ = _device_tables(cfg, dev)
    in_near = in_near[None, :]
    alpha = cfg.alpha_scale / L
    alpha2 = alpha * alpha
    ka = 2.0 * alpha / math.sqrt(math.pi)
    lcut2 = cfg.lcut ** 2 * L * L
    small_r2 = cfg.small_r_factor * L * L
    k1 = math.pi / (alpha2 * L ** 3)
    n = dr.shape[0]
    u_out = torch.empty(n, dtype=dr.dtype, device=dev)
    a_out = torch.empty(n, 3, dtype=dr.dtype, device=dev)
    for r0, r1 in _row_chunks(n, shells.shape[0], dev):
        R = dr[r0:r1, None, :] + shells[None, :, :] * L  # (c, S, 3)
        r2 = torch.sum(R * R, dim=-1)
        # the shells within lcut, and every near-field shell
        active = (r2 <= lcut2) | in_near
        rmag = torch.sqrt(torch.clamp_min(r2, 1e-30))
        inv_r = 1.0 / rmag
        inv_r2 = inv_r * inv_r
        a_term = torch.exp(-r2 * alpha2) * ka * inv_r2
        fn = torch.where(in_near, -torch.special.erf(alpha * rmag),
                         torch.special.erfc(alpha * rmag))
        g0 = fn * inv_r
        g1 = g0 * inv_r2 + a_term
        alphan = 2 * alpha2
        g2 = 3 * g1 * inv_r2 + alphan * a_term
        alphan = alphan * 2 * alpha2
        g3 = 5 * g2 * inv_r2 + alphan * a_term
        # the series near the origin (cancellation-safe)
        r2a2 = r2 * alpha2
        c0 = ka
        cs = [c0 * (r2a2 / 3.0 - 1.0)]
        for num, den in ((5.0, 3.0), (7.0, 5.0), (9.0, 7.0)):
            c0 = c0 * 2 * alpha2
            cs.append(c0 * (r2a2 / num - 1.0 / den))
        small = r2 < small_r2
        gamma = torch.stack([torch.where(active, torch.where(small, c, g), 0.0)
                             for c, g in zip(cs, (g0, g1, g2, g3))], dim=-1)
        u, a = _eval_root_multipole(R, gamma, mass, q)
        # the background term k1 M (the mean density's compensation, :215)
        u_out[r0:r1] = torch.sum(u, dim=1) + k1 * mass
        a_out[r0:r1] = torch.sum(a, dim=1)
    return u_out, a_out


def _k_space_correction(dr, mass, q, L, cfg: EwaldConfig):
    """The Fourier-space Ewald sum (computeEwaldKSpace with the hsum
    coefficients) over the h-vector table, in chunks of rows. Returns (u
    (N,), a (N, 3))."""
    dev = dr.device
    hvecs = _device_tables(cfg, dev)[2]  # (H, 3)
    alpha = cfg.alpha_scale / L
    k4 = math.pi ** 2 / (alpha ** 2 * L ** 2)
    h2 = torch.sum(hvecs * hvecs, dim=1)
    g0 = torch.exp(-k4 * h2) / (math.pi * h2 * L)
    g1 = 2 * math.pi / L * g0
    g2 = -2 * math.pi / L * g1
    g3 = 2 * math.pi / L * g2
    zero = torch.zeros_like(g0)
    # cos coefficients take the even gammas, sin the odd ones (hsum, :176)
    hfac_cos, _ = _eval_root_multipole(hvecs, torch.stack([g0, zero, g2, zero], dim=-1),
                                       mass, q)
    hfac_sin, _ = _eval_root_multipole(hvecs, torch.stack([zero, g1, zero, g3], dim=-1),
                                       mass, q)
    hr_scaled = 2 * math.pi / L * hvecs  # (H, 3)
    n = dr.shape[0]
    u_out = torch.empty(n, dtype=dr.dtype, device=dev)
    a_out = torch.empty(n, 3, dtype=dr.dtype, device=dev)
    for r0, r1 in _row_chunks(n, hvecs.shape[0], dev):
        hdotx = dr[r0:r1] @ hr_scaled.T  # (c, H)
        c, s = torch.cos(hdotx), torch.sin(hdotx)
        u_out[r0:r1] = -(c @ hfac_cos + s @ hfac_sin)
        # acc = sum_h (hfac_cos s - hfac_sin c) hr_scaled (:316)
        a_out[r0:r1] = (s * hfac_cos[None, :] - c * hfac_sin[None, :]) @ hr_scaled
    return u_out, a_out


def compute_gravity_ewald(x, y, z, m, h, sorted_keys, box: Box, tree: GravityTree,
                          meta: GravityTreeMeta, cfg: GravityConfig, ecfg: EwaldConfig,
                          multipoles=None, timer: Optional[Callable[[str], None]] = None,
                          shard=None, gather_p2p: bool = False,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     Dict[str, torch.Tensor]]:
    """Periodic-box gravity: the replica near field plus the Ewald
    corrections; ``compute_gravity``'s return contract. One multipole
    upsweep serves every pass; each of the (2r+1)^3 passes is a
    ``compute_gravity`` with G = 1, the targets shifted by the replica's
    offset (float32 shells x L, as the JAX package builds them) and the
    self pair kept in every pass but the base one; the passes' accelerations
    and potentials are summed in the shift table's order, their
    diagnostics (``EWALD_DIAG_KEYS``) folded by max. ``timer(phase)``:
    ``compute_gravity``'s phases of every pass, then "real_space" and
    "k_space".

    ``shard`` = (mesh, win) (``compute_gravity``'s): x .. h are this rank's
    slab, the upsweep is ``compute_multipoles_sharded``, every pass runs
    its own serve of halo rows (the sparse serve's caps cover the union of
    the shifted slabs' needs, ``parallel.sizing.device_gravity_halo``),
    and the corrections are row-local (the root expansion is replicated).
    The diagnostics then also fold ``halo_rows`` and ``halo_occ`` (sparse)
    by max over the passes; egrav and the diagnostics are this rank's.
    ``gather_p2p``: every pass's near field the gather backend's
    (``compute_gravity``'s)."""
    if cfg.multipole_order > 0:
        raise NotImplementedError(
            "spherical multipoles are open-boundary only; the Ewald path keeps the "
            "cartesian quadrupole (traversal_ewald_cpu.hpp parity)")
    mark = timer or (lambda _name: None)
    dev = x.device
    n = x.shape[0]
    L = box.lengths[0]
    if multipoles is None:
        multipoles = (compute_multipoles(x, y, z, m, sorted_keys, tree, meta) if shard is None
                      else compute_multipoles_sharded(shard[0], x, y, z, m, sorted_keys, tree,
                                                      meta))
    node_mass, node_com, node_q, _ = multipoles
    mark("multipoles")

    shells = replica_shells(ecfg)
    shifts = _device_tables(ecfg, dev)[3] * L
    cfg1 = dataclasses.replace(cfg, G=1.0)
    ax, ay, az, phi = (torch.zeros(n, dtype=x.dtype, device=dev) for _ in range(4))
    diag = {k: torch.zeros((), dtype=torch.int32, device=dev) for k in EWALD_DIAG_KEYS}
    if shard is not None and isinstance(shard[1], tuple):
        # the sparse serve's exchange metrics, the worst pass's
        diag["halo_rows"] = torch.zeros((), dtype=torch.int64, device=dev)
        diag["halo_occ"] = torch.zeros((), dtype=torch.float32, device=dev)
    for shell, shift in zip(shells, shifts):
        dax, day, daz, dphi, d = compute_gravity(
            x, y, z, m, h, sorted_keys, box, tree, meta, cfg1, multipoles=multipoles,
            timer=timer, shift=shift, allow_self=bool(shell.any()), with_phi=True, shard=shard,
            gather_p2p=gather_p2p)
        ax, ay, az, phi = ax + dax, ay + day, az + daz, phi + dphi
        diag = {k: torch.maximum(diag[k], d[k].to(diag[k].dtype)) for k in diag}

    dr = torch.stack([x, y, z], dim=1) - node_com[0][None, :]
    u_r, a_r = _real_space_correction(dr, node_mass[0], node_q[0], L, ecfg)
    mark("real_space")
    u_k, a_k = _k_space_correction(dr, node_mass[0], node_q[0], L, ecfg)
    mark("k_space")
    ax = (ax + a_r[:, 0] + a_k[:, 0]) * cfg.G
    ay = (ay + a_r[:, 1] + a_k[:, 1]) * cfg.G
    az = (az + a_r[:, 2] + a_k[:, 2]) * cfg.G
    phi = (phi + u_r + u_k) * cfg.G
    egrav = 0.5 * torch.sum(m * phi)
    return ax, ay, az, egrav, diag
