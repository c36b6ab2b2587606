"""Wind shock, a cloud in a wind (sphexa_tpu/init/wind_shock.py; the
reference's main/src/init/wind_shock_init.hpp): a dense sphere (rhoInt 10)
in a supersonic wind (rhoExt 1, vx 2.7); the wind ablates and mixes the
cloud, and the surviving cloud-mass fraction is the observable
(wind_bubble_fraction.hpp). The fields are built in numpy exactly as the
JAX package builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import jittered_lattice
from sphexa_torch.init.utils import build_state, h_from_density, settings_to_constants
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def wind_shock_constants() -> Dict[str, float]:
    """Test-case settings (wind_shock_init.hpp WindShockConstants)."""
    return {
        "r": 0.125, "rSphere": 0.025, "rhoInt": 10.0, "rhoExt": 1.0,
        "uExt": 1.5, "vxExt": 2.7, "vyExt": 0.0, "vzExt": 0.0,
        "dim": 3, "gamma": 5.0 / 3.0, "minDt": 1e-10, "minDt_m1": 1e-10,
        "Kcour": 0.4, "epsilon": 0.0, "mui": 10.0, "gravConstant": 0.0,
        "ng0": 100, "ngmax": 150, "wind-shock": 1.0,
    }


def init_wind_shock(side: int, overrides: Optional[Dict[str, float]] = None,
                    device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Cloud in a wind (WindShockGlass::init): the periodic box (0, 8r) x
    (0, 2r)^2 holds an ambient lattice of 4 side^3 cells with the sphere
    at (r, r, r) carved out, refilled by a 10x denser lattice;
    equal-mass particles, h tapered by tanh just outside the cloud."""
    dev = resolve_device(device)
    settings = wind_shock_constants()
    if overrides:
        settings.update(overrides)
    r, r_sphere = settings["r"], settings["rSphere"]
    rho_int, rho_ext = settings["rhoInt"], settings["rhoExt"]
    center = (r, r, r)

    x, y, z = jittered_lattice((0, 0, 0), (8 * r, 2 * r, 2 * r), (4 * side, side, side),
                               seed=11)
    rpos2 = (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2
    keep = rpos2 > r_sphere**2
    x, y, z = x[keep], y[keep], z[keep]

    # the cloud's lattice: rho_int / rho_ext times the ambient number density
    nd_ext = side**3 / (2 * r) ** 3
    a_blob = (nd_ext * rho_int / rho_ext) ** (-1.0 / 3.0)
    nb = max(1, round(2 * r_sphere / a_blob))
    xb, yb, zb = jittered_lattice((r - r_sphere,) * 3, (r + r_sphere,) * 3, (nb, nb, nb),
                                  seed=12)
    rb2 = (xb - center[0]) ** 2 + (yb - center[1]) ** 2 + (zb - center[2]) ** 2
    inside = rb2 < r_sphere**2
    xb, yb, zb = xb[inside], yb[inside], zb[inside]
    n_blob = xb.shape[0]
    x = np.concatenate([x, xb])
    y = np.concatenate([y, yb])
    z = np.concatenate([z, zb])
    m_part = 4.0 / 3.0 * np.pi * r_sphere**3 * rho_int / n_blob

    const = settings_to_constants(settings)
    u_ext = settings["uExt"]
    u_int = u_ext / (rho_int / rho_ext)
    h_int = h_from_density(settings["ng0"], m_part, rho_int)
    h_ext = h_from_density(settings["ng0"], m_part, rho_ext)
    k = settings["ngmax"] / r
    cv = ideal_gas_cv(settings["mui"], settings["gamma"])
    eps = settings["epsilon"]

    rpos = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
    in_cloud = rpos <= r_sphere + eps
    # tanh taper of h just outside the cloud's surface (wind_shock_init.hpp:107)
    h_taper = h_int + 0.5 * (h_ext - h_int) * (1.0 + np.tanh(k * (rpos - r_sphere - h_ext)))
    far = rpos > r_sphere + 2 * h_ext
    h = np.where(in_cloud, h_int, np.where(far, h_ext, h_taper))
    temp = np.where(in_cloud, u_int, u_ext) / cv
    vx = np.where(in_cloud, 0.0, settings["vxExt"])
    vy = np.where(in_cloud, 0.0, settings["vyExt"])
    vz = np.where(in_cloud, 0.0, settings["vzExt"])

    box = Box.create(0, 8 * r, 0, 2 * r, 0, 2 * r, boundary=BoundaryType.periodic, device=dev)
    state = build_state(x, y, z, vx, vy, vz, h, m_part, temp, settings["minDt"],
                        const.alphamin, settings["minDt_m1"], device=dev)
    return state, box, const
