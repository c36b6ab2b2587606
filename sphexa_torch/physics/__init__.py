"""Physics beyond hydrodynamics (sphexa_tpu/physics): the reduced
tabulated radiative cooling and the evolved primordial network that take
the place of the reference's GRACKLE wrapper, with the same coupling to
the propagator (the cooling-time step limiter and the du source term)."""

from sphexa_torch.physics.cooling import (
    ChemistryData,
    CoolingConfig,
    cool_particles,
    cooling_rate,
    cooling_timestep,
    eos_cooling,
    temp_to_u,
    u_to_temp,
)

__all__ = [
    "ChemistryData",
    "CoolingConfig",
    "cool_particles",
    "cooling_rate",
    "cooling_timestep",
    "eos_cooling",
    "temp_to_u",
    "u_to_temp",
]
