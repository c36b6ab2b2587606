"""Shared initial-condition assembly (sphexa_tpu/init/utils.py)."""

from typing import Dict, Optional

import numpy as np
import torch

from sphexa_torch.dtypes import HYDRO_DTYPE
from sphexa_torch.sph.particles import ParticleState, SimConstants, scalar


def settings_to_constants(settings: Dict[str, float]) -> SimConstants:
    """Map reference-style settings keys onto SimConstants."""
    key_map = {
        "ng0": ("ng0", int), "ngmax": ("ngmax", int), "gamma": ("gamma", float),
        "mui": ("mui", float), "gravConstant": ("g", float),
        "Kcour": ("k_cour", float), "Krho": ("k_rho", float),
        "alphamin": ("alphamin", float), "alphamax": ("alphamax", float),
    }
    kw = {field: cast(settings[skey])
          for skey, (field, cast) in key_map.items() if skey in settings}
    return SimConstants(**kw).normalized()


def build_state(x, y, z, vx, vy, vz, h, m, temp, min_dt: float, alpha,
                min_dt_m1: Optional[float] = None, device="cpu") -> ParticleState:
    """Assemble a ParticleState from numpy fields or scalars (scalars
    broadcast to the particle count); x_m1 = v * min_dt."""
    n = np.asarray(x).shape[0]

    def f32(a):
        if np.ndim(a) == 0:
            return torch.full((n,), float(a), dtype=HYDRO_DTYPE, device=device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    vx, vy, vz = f32(vx), f32(vy), f32(vz)
    zeros = torch.zeros(n, dtype=HYDRO_DTYPE, device=device)
    return ParticleState(
        x=f32(x), y=f32(y), z=f32(z),
        x_m1=vx * min_dt, y_m1=vy * min_dt, z_m1=vz * min_dt,
        vx=vx, vy=vy, vz=vz,
        h=f32(h), m=f32(m), temp=f32(temp), temp_lo=zeros,
        du=zeros.clone(), du_m1=zeros.clone(), alpha=f32(alpha),
        ttot=scalar(0.0, device), min_dt=scalar(min_dt, device),
        min_dt_m1=scalar(min_dt_m1 if min_dt_m1 is not None else min_dt, device),
    )


def sphere_h_init(ng0: float, volume: float, n: int) -> float:
    """h giving ~ng0 neighbours for n particles spread uniformly over volume."""
    return float(np.cbrt(3.0 / (4 * np.pi) * ng0 * volume / n) * 0.5)


def h_from_density(ng0: float, m_part: float, rho: float) -> float:
    """h for ~ng0 neighbours at mass density rho (0.5 cbrt(3 ng0 m/(4 pi rho)))."""
    return float(0.5 * np.cbrt(3.0 * ng0 * m_part / (4.0 * np.pi * rho)))
