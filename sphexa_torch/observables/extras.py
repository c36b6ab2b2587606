"""Case-specific observables (sphexa_tpu/observables/extras.py): the
Kelvin-Helmholtz growth rate (time_energy_growth.hpp:45-110), the
turbulence Mach RMS (turbulence_mach_rms.hpp:39-85) and the wind-bubble
survivor fraction (wind_bubble_fraction.hpp:43-97), as reductions over
tensors in the inputs' dtype, the JAX package's. The gravitational-wave
signal waits: no ledger path calls it."""

import math

import torch


def _own(t: torch.Tensor) -> torch.Tensor:
    return t


def kh_growth_rate(x, y, vy, vol, box, total=_own) -> torch.Tensor:
    """Kelvin-Helmholtz instability amplitude growth (McNally et al. 2012
    mode projection; time_energy_growth.hpp:45-70): project vy onto the
    seeded sin(4 pi x) mode, weighted toward the two interfaces. The three
    projections are one stacked reduction, as in the JAX package.
    ``total`` (every extra here): the sum of a rank's partial sums over
    the ranks, under a mesh."""
    ybox = box.lengths[1]
    aux = torch.where(
        y < ybox * 0.5,
        torch.exp(-4.0 * math.pi * torch.abs(y - 0.25)),
        torch.exp(-4.0 * math.pi * torch.abs(ybox - y - 0.25)),
    )
    w = vy * vol * aux
    s = torch.sum(torch.stack([
        w * torch.sin(4.0 * math.pi * x),
        w * torch.cos(4.0 * math.pi * x),
        vol * aux,
    ]), dim=1)
    s = total(s)
    return 2.0 * torch.sqrt(s[0]**2 + s[1]**2) / s[2]


def mach_rms(vx, vy, vz, c, total=None) -> torch.Tensor:
    """Root-mean-square Mach number (turbulence_mach_rms.hpp:39-85)."""
    m2 = (vx**2 + vy**2 + vz**2) / (c * c)
    if total is None:
        return torch.sqrt(torch.mean(m2))
    s = total(torch.stack([m2.sum(), torch.tensor(float(m2.numel()), device=m2.device)]))
    return torch.sqrt(s[0] / s[1])


def wind_bubble_fraction(rho, temp, m, rho_bubble: float, temp_wind: float,
                         initial_mass: float, total=_own) -> torch.Tensor:
    """Fraction of the initial cloud mass still in the cloud phase: denser
    than 0.64 rho_bubble and cooler than 0.9 T_wind
    (wind_bubble_fraction.hpp:43-57,96)."""
    survive = (rho >= 0.64 * rho_bubble) & (temp <= 0.9 * temp_wind)
    return total(torch.sum(torch.where(survive, m, torch.zeros_like(m)))) / initial_mass
