"""Noh spherical implosion analytic solution.

W.F. Noh, "Errors for Calculations of Strong Shocks Using an Artificial
Viscosity and an Artificial Heat Flux", JCP 72 (1987) 78-120 — the same
closed-form solution evaluated by the reference's
``main/src/analytical_solutions/compare_noh.py`` (nohRho/nohU/nohP/nohVel).

The JAX package's sphexa_tpu/analysis/noh.py, copied: numpy and scipy
only, so that the port imports nothing of that package.
"""

from typing import Dict

import numpy as np


def noh_solution(
    r: np.ndarray,
    time: float,
    gamma: float = 5.0 / 3.0,
    rho0: float = 1.0,
    vel0: float = -1.0,
    u0: float = 0.0,
    p0: float = 0.0,
    cs0: float = 0.0,
    xgeom: float = 3.0,
) -> Dict[str, np.ndarray]:
    """Evaluate the Noh solution at radii ``r`` and time ``time``.

    Upstream of the shock the gas is in free radial fall (density piles up
    geometrically); downstream it is at rest at the stagnation density.
    Returns dict with 'rho', 'p', 'u', 'vel', 'cs' and scalar 'r_shock'.
    """
    r = np.asarray(r, np.float64)
    gamm1, gamp1 = gamma - 1.0, gamma + 1.0
    r_shock = 0.5 * gamm1 * abs(vel0) * time

    rsafe = np.maximum(r, 1e-30)
    inside = r <= r_shock

    rho_out = rho0 * (1.0 - vel0 * time / rsafe) ** (xgeom - 1.0)
    rho_in = rho0 * (gamp1 / gamm1) ** xgeom
    rho = np.where(inside, rho_in, rho_out)

    u = np.where(inside, 0.5 * vel0**2, u0)
    p = np.where(inside, gamm1 * rho * u, p0)
    vel = np.where(inside, 0.0, abs(vel0))
    with np.errstate(divide="ignore", invalid="ignore"):
        cs = np.where(inside, np.sqrt(gamma * p / rho), cs0)

    return {"rho": rho, "p": p, "u": u, "vel": vel, "cs": cs, "r_shock": r_shock}
