"""Evrard adiabatic collapse (sphexa_tpu/init/evrard.py): a cold,
self-gravitating gas sphere with rho ~ 1/r in an open box, the standard
test of hydrodynamics with self-gravity (it collapses, bounces, and a
shock runs outward), and its cooling twin. The fields are built in numpy exactly as the JAX
package builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import contract_rho_profile, cut_sphere, jittered_lattice
from sphexa_torch.init.utils import build_state, settings_to_constants
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def evrard_constants() -> Dict[str, float]:
    """Test-case settings (evrard_init.hpp evrardConstants)."""
    return {
        "gravConstant": 1.0, "r": 1.0, "mTotal": 1.0, "gamma": 5.0 / 3.0,
        "u0": 0.05, "minDt": 1e-4, "minDt_m1": 1e-4, "mui": 10.0,
        "ng0": 100, "ngmax": 150,
    }


def init_evrard_cooling(side: int, overrides: Optional[Dict[str, float]] = None,
                        device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Evrard collapse with radiative cooling (run with --prop
    std-cooling): the fields are init_evrard's. The cooling unit system
    of the reference case (m_code_in_ms 1e16, l_code_in_kpc 46400,
    evrard_cooling_init.hpp:59-60) is physics.cooling.CoolingConfig's
    default; Simulation(cooling_cfg=...) takes another."""
    return init_evrard(side, overrides, device=device)


def init_evrard(side: int, overrides: Optional[Dict[str, float]] = None,
                device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Glass-sphere Evrard setup (evrard_init.hpp EvrardGlassSphere::init):
    the side^3 jittered lattice cut to the sphere of radius r and
    contracted by sqrt(radius) to the rho ~ 1/r profile; h follows the
    local concentration c(r) = c0 / r."""
    dev = resolve_device(device)
    settings = evrard_constants()
    if overrides:
        settings.update(overrides)
    r = settings["r"]

    x, y, z = jittered_lattice((-r, -r, -r), (r, r, r), (side, side, side))
    x, y, z = cut_sphere(r, x, y, z)
    n = x.shape[0]
    x, y, z = contract_rho_profile(x, y, z)

    const = settings_to_constants(settings)
    m_part = settings["mTotal"] / n

    # local particle concentration after contraction: c(r) = 2/3 n/(V r)
    total_volume = 4.0 * np.pi / 3.0 * r**3
    c0 = 2.0 / 3.0 * n / total_volume
    radius = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-10)
    h = np.cbrt(3.0 / (4 * np.pi) * settings["ng0"] * radius / c0) * 0.5

    cv = ideal_gas_cv(settings["mui"], settings["gamma"])
    temp0 = settings["u0"] / cv

    box = Box.create(-r, r, boundary=BoundaryType.open, device=dev)
    state = build_state(
        x, y, z, 0.0, 0.0, 0.0, h, m_part, temp0,
        settings["minDt"], const.alphamin, settings["minDt_m1"], device=dev,
    )
    return state, box, const
