"""Noh spherical implosion (sphexa_tpu/init/noh.py): a uniform-density
sphere in an open box with unit radial inflow; a standing shock forms at
the origin. The fields are built in numpy exactly as the JAX package
builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import cut_sphere, jittered_lattice
from sphexa_torch.init.utils import build_state, settings_to_constants, sphere_h_init
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def noh_constants() -> Dict[str, float]:
    """Test-case settings (noh_init.hpp nohConstants)."""
    return {
        "r0": 0.0, "r1": 0.5, "mTotal": 1.0, "dim": 3, "gamma": 5.0 / 3.0,
        "rho0": 1.0, "u0": 1e-20, "p0": 0.0, "vr0": -1.0, "cs0": 0.0,
        "minDt": 1e-4, "minDt_m1": 1e-4, "gravConstant": 0.0,
        "ng0": 100, "ngmax": 150, "mui": 10.0,
    }


def init_noh(side: int, overrides: Optional[Dict[str, float]] = None,
             device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Glass-sphere Noh setup (noh_init.hpp NohGlassSphere::init): fill the
    cube [-r1, r1]^3 with side^3 jittered lattice points, cut the
    inscribed sphere, point every velocity at the origin."""
    dev = resolve_device(device)
    settings = noh_constants()
    if overrides:
        settings.update(overrides)
    r = settings["r1"]

    x, y, z = jittered_lattice((-r, -r, -r), (r, r, r), (side, side, side))
    x, y, z = cut_sphere(r, x, y, z)
    n = x.shape[0]

    const = settings_to_constants(settings)
    h_init = sphere_h_init(settings["ng0"], 4.0 * np.pi / 3.0 * r**3, n)
    m_part = settings["mTotal"] / n

    radius = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-10)
    vr0 = settings["vr0"]
    vx, vy, vz = vr0 * x / radius, vr0 * y / radius, vr0 * z / radius

    cv = ideal_gas_cv(settings["mui"], settings["gamma"])
    temp0 = settings["u0"] / cv

    box = Box.create(-r, r, boundary=BoundaryType.open, device=dev)
    state = build_state(
        x, y, z, vx, vy, vz, h_init, m_part, temp0,
        settings["minDt"], const.alphamin, settings["minDt_m1"], device=dev,
    )
    return state, box, const
