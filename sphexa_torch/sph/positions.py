"""Time integration (sphexa_tpu/sph/positions.py): Press position update
and the compensated Adams-Bashforth energy step.

Everything here is eager float32 torch: each op rounds once, so the
two-sum carry of ``energy_update`` keeps the bits the float32 sum drops.
"""

from typing import Tuple

import torch

from sphexa_torch.sfc.box import BoundaryType, Box, put_in_box
from sphexa_torch.sph.particles import SimConstants


def position_update(dt, dt_m1, x, y, z, ax, ay, az, dx_m1, dy_m1, dz_m1, box: Box):
    """Press 2nd-order update (positions.hpp:66-80); returns new positions
    (PBC-folded), velocities and the new deltas."""
    delta_a = dt + 0.5 * dt_m1
    delta_b = 0.5 * (dt + dt_m1)
    inv_dtm1 = 1.0 / dt_m1

    valx, valy, valz = dx_m1 * inv_dtm1, dy_m1 * inv_dtm1, dz_m1 * inv_dtm1
    vx = valx + ax * delta_a
    vy = valy + ay * delta_a
    vz = valz + az * delta_a
    dx = dt * valx + ax * delta_b * dt
    dy = dt * valy + ay * delta_b * dt
    dz = dt * valz + az * delta_b * dt

    pos = put_in_box(box, torch.stack([x + dx, y + dy, z + dz], dim=-1))
    return pos[:, 0], pos[:, 1], pos[:, 2], vx, vy, vz, dx, dy, dz


def fixed_boundary_frozen(x, y, z, h, vx, vy, vz, box: Box) -> torch.Tensor:
    """Stationary particles within 2h of a fixed wall (positions.hpp:46-101)."""
    stationary = (vx == 0.0) & (vy == 0.0) & (vz == 0.0)
    frozen = torch.zeros_like(stationary)
    for dim, coord in enumerate((x, y, z)):
        if box.boundaries[dim] == BoundaryType.fixed:
            near = (torch.abs(box.hi[dim] - coord) < 2.0 * h) | (
                torch.abs(coord - box.lo[dim]) < 2.0 * h
            )
            frozen = frozen | near
    return stationary & frozen


def energy_update(u_old, dt, dt_m1, du, du_m1, u_lo):
    """2nd-order Adams-Bashforth step with a two-sum carry: returns
    (u_new, lo_new); the exponential fallback keeps u positive."""
    delta_a = 0.5 * dt * dt / dt_m1
    delta_b = dt + delta_a
    incr = du * delta_b - du_m1 * delta_a
    y = incr + u_lo
    s = u_old + y
    bb = s - u_old
    err = (u_old - (s - bb)) + (y - bb)
    neg = s < 0.0
    u_new = torch.where(
        neg, u_old * torch.exp(s * dt / torch.clamp_min(u_old, 1e-30)), s
    )
    return u_new, torch.where(neg, torch.zeros_like(err), err)


def compute_positions(state_fields: Tuple, ax, ay, az, dt, dt_m1, box: Box,
                      const: SimConstants):
    """Advance positions, velocities and temperature for one step.

    ``state_fields`` = (x, y, z, x_m1, y_m1, z_m1, vx, vy, vz, h, temp,
    temp_lo, du, du_m1); returns the same tuple advanced."""
    (x, y, z, x_m1, y_m1, z_m1, vx, vy, vz, h, temp, temp_lo, du,
     du_m1) = state_fields

    frozen = fixed_boundary_frozen(x, y, z, h, vx, vy, vz, box)
    nx, ny, nz, nvx, nvy, nvz, dx, dy, dz = position_update(
        dt, dt_m1, x, y, z, ax, ay, az, x_m1, y_m1, z_m1, box
    )

    def keep(new, old):
        return torch.where(frozen, old, new)

    nx, ny, nz = keep(nx, x), keep(ny, y), keep(nz, z)
    nvx, nvy, nvz = keep(nvx, vx), keep(nvy, vy), keep(nvz, vz)
    dx, dy, dz = keep(dx, x_m1), keep(dy, y_m1), keep(dz, z_m1)

    # compensate in temperature units: only the small increment is divided
    # by cv, so the untracked error per step is ulp(increment)
    n_temp, n_temp_lo = energy_update(
        temp, dt, dt_m1, du / const.cv, du_m1 / const.cv, temp_lo
    )
    n_temp = keep(n_temp, temp)
    n_temp_lo = keep(n_temp_lo, temp_lo)
    n_du_m1 = keep(du, du_m1)

    return (nx, ny, nz, dx, dy, dz, nvx, nvy, nvz, h, n_temp, n_temp_lo,
            du, n_du_m1)
