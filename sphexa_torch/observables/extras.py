"""Case-specific observables (sphexa_tpu/observables/extras.py): the
Kelvin-Helmholtz growth rate (time_energy_growth.hpp:45-110), the
turbulence Mach RMS (turbulence_mach_rms.hpp:39-85) and the wind-bubble
survivor fraction (wind_bubble_fraction.hpp:43-97) and the
gravitational-wave quadrupole signal (grav_waves_calculations.hpp:30-121),
as reductions over tensors in the inputs' dtype, the JAX package's. The
gravitational-wave signal has no caller in either package's step."""

import math
from typing import Dict, Tuple

import torch

# gravitational-wave unit at 10 kpc: G / c^4 / (10 kpc in cm), cgs
# (grav_waves_calculations.hpp:56-58)
_G_CGS = 6.6726e-8
_C_CGS = 2.997924562e10
GW_UNITS = _G_CGS / _C_CGS**4 / 3.08568025e22


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


def _d2_quadrupole(i, j, pos, vel, acc, m) -> torch.Tensor:
    """Second time derivative of the traceless quadrupole moment component
    (i, j), from positions, velocities and accelerations
    (grav_waves_calculations.hpp:88-121)."""
    if i == j:
        v2 = vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2
        rdota = pos[0] * acc[0] + pos[1] * acc[1] + pos[2] * acc[2]
        out = torch.sum((3.0 * (vel[i] ** 2 + pos[i] * acc[i]) - v2 - rdota) * m)
        return out * 2.0 / 3.0
    return torch.sum((2.0 * vel[i] * vel[j] + acc[i] * pos[j] + pos[i] * acc[j]) * m)


def gravitational_wave_signal(x, y, z, vx, vy, vz, ax, ay, az, m, theta: float, phi: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(h+_tt, hx_tt, the d2Q components) for an observer at (theta, phi),
    10 kpc, cgs units (gravitational_waves.hpp and computeHtt)."""
    pos, vel, acc = (x, y, z), (vx, vy, vz), (ax, ay, az)
    q = {
        "xx": _d2_quadrupole(0, 0, pos, vel, acc, m),
        "yy": _d2_quadrupole(1, 1, pos, vel, acc, m),
        "zz": _d2_quadrupole(2, 2, pos, vel, acc, m),
        "xy": _d2_quadrupole(0, 1, pos, vel, acc, m),
        "xz": _d2_quadrupole(0, 2, pos, vel, acc, m),
        "yz": _d2_quadrupole(1, 2, pos, vel, acc, m),
    }
    # the observer's angles in the inputs' dtype, as jnp evaluates them
    th, ph = (torch.tensor(float(v), dtype=x.dtype, device=x.device) for v in (theta, phi))
    sin2t, sin2p = torch.sin(2 * th), torch.sin(2 * ph)
    cos2p = torch.cos(2 * ph)
    sint, cost = torch.sin(th), torch.cos(th)
    sinp, cosp = torch.sin(ph), torch.cos(ph)

    ibar_tt = ((q["xx"] * cosp**2 + q["yy"] * sinp**2 + q["xy"] * sin2p) * cost**2
               + q["zz"] * sint**2
               - (q["xz"] * cosp + q["yz"] * sinp) * sin2t)
    ibar_pp = q["xx"] * sinp**2 + q["yy"] * cosp**2 - q["xy"] * sin2p
    ibar_tp = (0.5 * (q["yy"] - q["xx"]) * cost * sin2p
               + q["xy"] * cost * cos2p
               + (q["xz"] * sinp - q["yz"] * cosp) * sint)
    htt_plus = (ibar_tt - ibar_pp) * GW_UNITS
    htt_cross = 2.0 * ibar_tp * GW_UNITS
    return htt_plus, htt_cross, q
