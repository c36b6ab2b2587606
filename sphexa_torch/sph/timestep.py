"""Global time-step selection (sphexa_tpu/sph/timestep.py)."""

import torch

from sphexa_torch.sph.particles import SimConstants


def acceleration_timestep(ax, ay, az, const: SimConstants) -> torch.Tensor:
    """eta sqrt(eps / |a|_max) (timestep.hpp:46-68), used with gravity."""
    max_acc = torch.sqrt(torch.max(ax * ax + ay * ay + az * az))
    return const.eta_acc * torch.sqrt(const.eps / max_acc)


def rho_timestep(divv: torch.Tensor, const: SimConstants) -> torch.Tensor:
    """Krho / |max divv| (timestep.hpp:71-94): max, then abs, as in the
    reference, so the limiter bounds the fastest expansion."""
    return const.k_rho / torch.abs(torch.max(divv))


def compute_timestep(min_dt_prev: torch.Tensor, min_dt_courant: torch.Tensor,
                     *extra_dts, const: SimConstants) -> torch.Tensor:
    """min(Courant dt, 1.1 x previous dt, extra candidates); 0-d float32."""
    dt = torch.minimum(min_dt_courant, const.max_dt_increase * min_dt_prev)
    for e in extra_dts:
        dt = torch.minimum(dt, e)
    return dt
