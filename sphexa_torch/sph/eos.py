"""Equations of state (sphexa_tpu/sph/eos.py; the reference's
sph/include/sph/eos.hpp): the temperature-based and u-based ideal gas
forms and the polytropic neutron-star EOS. The std and VE force stages
call their fused forms (hydro_std, hydro_ve); the cooling EOS
(physics/cooling.eos_cooling) calls ``ideal_gas_eos_u``."""

import torch

from sphexa_torch.sph.particles import ideal_gas_cv

# Kpol for a 1.4 M_sun, 12.8 km neutron star (eos.hpp:52-53); not valid
# for other masses or radii
KPOL_NS = 2.246341237993810232e-10
GAMMA_POL = 3.0


def ideal_gas_eos(temp, rho, mui: float, gamma: float):
    """(p, c) from temperature (eos.hpp:31-41)."""
    tmp = ideal_gas_cv(mui, gamma) * temp * (gamma - 1.0)
    return rho * tmp, torch.sqrt(tmp)


def ideal_gas_eos_u(u, rho, gamma: float):
    """(p, c) from specific internal energy: p = (gamma-1) rho u."""
    tmp = u * (gamma - 1.0)
    return rho * tmp, torch.sqrt(gamma * tmp)


def polytropic_eos(rho, k_pol: float = KPOL_NS, gamma_pol: float = GAMMA_POL):
    """(p, c) for a polytrope p = K rho^Gamma (eos.hpp:43-60)."""
    p = k_pol * rho ** gamma_pol
    c = torch.sqrt(gamma_pol * p / torch.clamp(rho, min=1e-30))
    return p, c
