"""Gresho-Chan vortex (sphexa_tpu/init/gresho_chan.py): a stationary 2D
vortex in a thin periodic slab whose centrifugal force the pressure
gradient balances exactly; any decay of its azimuthal velocity profile
measures numerical viscosity. The fields are built in numpy exactly as
the JAX package builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import jittered_lattice
from sphexa_torch.init.utils import build_state, h_from_density, settings_to_constants
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv

_ZHALF = 0.0555  # slab half-thickness (gresho_chan.hpp:143)


def gresho_chan_constants() -> Dict[str, float]:
    """Test-case settings (gresho_chan.hpp GreshoChanSettings)."""
    return {
        "R1": 0.2, "v0": 1.0, "P0": 5.0, "gamma": 5.0 / 3.0, "mTotal": 1.0,
        "minDt": 1e-7, "minDt_m1": 1e-7, "rho": 1.0, "Kcour": 0.2,
        "ng0": 100, "ngmax": 150, "gravConstant": 0.0, "mui": 10.0,
    }


def init_gresho_chan(side: int, overrides: Optional[Dict[str, float]] = None,
                     device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Thin-slab vortex setup (gresho_chan.hpp:133-161): periodic box
    (-0.5, 0.5)^2 x (-zh, zh) with about side^3 particles at isotropic
    spacing; the azimuthal velocity rises linearly to v0 at psi = r/R1 = 1
    and falls back to 0 at psi = 2; the pressure balances it."""
    dev = resolve_device(device)
    settings = gresho_chan_constants()
    if overrides:
        settings.update(overrides)

    lz = 2 * _ZHALF
    spacing = (1.0 * 1.0 * lz / side**3) ** (1.0 / 3.0)
    nx = max(1, round(1.0 / spacing))
    nz = max(1, round(lz / spacing))
    x, y, z = jittered_lattice((-0.5, -0.5, -_ZHALF), (0.5, 0.5, _ZHALF), (nx, nx, nz))
    n = x.shape[0]

    const = settings_to_constants(settings)
    rho = settings["rho"]
    m_part = 1.0 * 1.0 * lz * rho / n
    h_init = h_from_density(settings["ng0"], m_part, rho)

    R1, v0, P0 = settings["R1"], settings["v0"], settings["P0"]
    gamma = settings["gamma"]
    psi = np.sqrt(x * x + y * y) / R1
    theta = np.arctan2(y, x)
    p = np.where(
        psi <= 1.0,
        P0 + 4 * v0 * v0 * psi * psi / 8,
        np.where(
            psi <= 2.0,
            P0 + 4 * v0 * v0 * (psi * psi / 8 - psi + np.log(np.maximum(psi, 1e-30)) + 1),
            P0 + 4 * v0 * v0 * (np.log(2.0) - 0.5),
        ),
    )
    v = np.where(psi <= 1.0, v0 * psi, np.where(psi <= 2.0, v0 * (2 - psi), 0.0))

    cv = ideal_gas_cv(settings["mui"], gamma)
    temp = p / ((gamma - 1.0) * rho) / cv
    vx = -v * np.sin(theta)
    vy = v * np.cos(theta)

    box = Box.create(-0.5, 0.5, -0.5, 0.5, -_ZHALF, _ZHALF, boundary=BoundaryType.periodic,
                     device=dev)
    state = build_state(
        x, y, z, vx, vy, 0.0, h_init, m_part, temp,
        settings["minDt"], const.alphamin, settings["minDt_m1"], device=dev,
    )
    return state, box, const
