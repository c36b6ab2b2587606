"""Isobaric cube (sphexa_tpu/init/isobaric_cube.py; the reference's
main/src/init/isobaric_cube_init.hpp): a dense cube (rhoInt 8) in pressure
equilibrium with its surroundings (rhoExt 1, the same p). An exact scheme
keeps it still; spurious surface tension at the contact deforms it. The
fields are built in numpy exactly as the JAX package builds them, then
moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import (
    compress_center_cube, compute_stretch_factor, jittered_lattice,
)
from sphexa_torch.init.utils import build_state, h_from_density, settings_to_constants
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def isobaric_cube_constants() -> Dict[str, float]:
    """Test-case settings (isobaric_cube_init.hpp IsobaricCubeConstants)."""
    return {
        "r": 0.25, "rDelta": 0.25, "dim": 3, "gamma": 5.0 / 3.0,
        "rhoExt": 1.0, "rhoInt": 8.0, "pIsobaric": 2.5,
        "minDt": 1e-4, "minDt_m1": 1e-4, "epsilon": 1e-15,
        "pairInstability": 0.0, "mui": 10.0, "gravConstant": 0.0,
        "ng0": 100, "ngmax": 150,
    }


def init_isobaric_cube(side: int, overrides: Optional[Dict[str, float]] = None,
                       device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """IsobaricCubeGlass::init: a side^3 lattice over the periodic box
    [-2r, 2r]^3 whose centre [-s, s]^3 is compressed into [-r, r]^3 for
    the density contrast rhoInt / rhoExt; equal-mass particles, h tapered
    from the cube's to the surroundings' over 2 h_ext."""
    dev = resolve_device(device)
    settings = isobaric_cube_constants()
    if overrides:
        settings.update(overrides)
    r = settings["r"]
    r_ext = 2 * r
    rho_int, rho_ext = settings["rhoInt"], settings["rhoExt"]

    x, y, z = jittered_lattice((-r_ext, -r_ext, -r_ext), (r_ext, r_ext, r_ext),
                               (side, side, side))
    n = x.shape[0]
    s = compute_stretch_factor(r, r_ext, rho_int / rho_ext)
    x, y, z = compress_center_cube(x, y, z, r, s, r_ext, eps=settings["pairInstability"])
    n_internal = n * (s / r_ext) ** 3
    m_part = (2 * r) ** 3 * rho_int / n_internal

    const = settings_to_constants(settings)
    h_int = h_from_density(settings["ng0"], m_part, rho_int)
    h_ext = h_from_density(settings["ng0"], m_part, rho_ext)
    gamma = settings["gamma"]
    p_iso = settings["pIsobaric"]
    u_int = p_iso / (gamma - 1.0) / rho_int
    u_ext = p_iso / (gamma - 1.0) / rho_ext
    eps = settings["epsilon"]
    cv = ideal_gas_cv(settings["mui"], gamma)

    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    outside = (ax > r + eps) | (ay > r + eps) | (az > r + eps)
    far_out = (ax > r + 2 * h_ext) | (ay > r + 2 * h_ext) | (az > r + 2 * h_ext)
    dist = np.maximum.reduce([ax - r, ay - r, az - r])
    h_near = h_int * (1 - dist / (2 * h_ext)) + h_ext * dist / (2 * h_ext)
    h = np.where(outside, np.where(far_out, h_ext, h_near), h_int)
    temp = np.where(outside, u_ext, u_int) / cv

    box = Box.create(-r_ext, r_ext, boundary=BoundaryType.periodic, device=dev)
    state = build_state(x, y, z, 0.0, 0.0, 0.0, h, m_part, temp, settings["minDt"],
                        const.alphamin, settings["minDt_m1"], device=dev)
    return state, box, const
