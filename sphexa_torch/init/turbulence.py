"""Driven-turbulence box (sphexa_tpu/init/turbulence.py; the reference's
main/src/init/turbulence_init.hpp): a uniform, nearly isothermal
(gamma 1.001) periodic box at rest, which the turb-ve propagator's OU
stirring drives to a target RMS Mach number (the machRMS observable).
The fields are built in numpy exactly as the JAX package builds them,
then moved to the device."""

from typing import Dict, Optional, Tuple

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import jittered_lattice
from sphexa_torch.init.utils import build_state, settings_to_constants, sphere_h_init
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def turbulence_constants() -> Dict[str, float]:
    """Test-case settings (turbulence_init.hpp TurbulenceConstants)."""
    return {
        "solWeight": 0.5, "stMaxModes": 100000, "Lbox": 1.0,
        "stEnergyPrefac": 5.0e-3, "stMachVelocity": 0.3,
        "minDt": 1e-4, "minDt_m1": 1e-4,
        "rngSeed": 251299, "stSpectForm": 1, "mTotal": 1.0,
        "powerLawExp": 5.0 / 3.0, "anglesExp": 2.0,
        "gamma": 1.001, "mui": 0.62, "u0": 1000.0, "Kcour": 0.4,
        "gravConstant": 0.0, "ng0": 100, "ngmax": 150, "turbulence": 1.0,
    }


def init_turbulence(side: int, overrides: Optional[Dict[str, float]] = None,
                    device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Uniform periodic box [-L/2, L/2]^3 at rest with u = u0
    (initTurbulenceHydroFields), the lattice jittered from the case's
    seed."""
    dev = resolve_device(device)
    settings = turbulence_constants()
    if overrides:
        settings.update(overrides)
    lbox = settings["Lbox"]
    half = lbox / 2.0

    x, y, z = jittered_lattice((-half, -half, -half), (half, half, half), (side, side, side),
                               seed=int(settings["rngSeed"]) % (2**31))
    n = x.shape[0]

    const = settings_to_constants(settings)
    m_part = settings["mTotal"] / n
    h_init = sphere_h_init(settings["ng0"], lbox**3, n)
    cv = ideal_gas_cv(settings["mui"], settings["gamma"])
    temp0 = settings["u0"] / cv

    box = Box.create(-half, half, boundary=BoundaryType.periodic, device=dev)
    state = build_state(x, y, z, 0.0, 0.0, 0.0, h_init, m_part, temp0, settings["minDt"],
                        const.alphamin, settings["minDt_m1"], device=dev)
    return state, box, const
