"""Sedov-Taylor blast-wave semi-analytic solution (standard case).

Implements the Kamm & Timmes formulation ("On Efficient Generation of
Numerically Robust Sedov Solutions", LA-UR-07-2849) — the same solution the
reference evaluates in ``main/src/analytical_solutions/sedov_solution/
sedov_solution.cpp`` — as a vectorized numpy routine. Only the *standard*
case (shock ahead of the singular point, which holds for every built-in
test configuration: gamma = 5/3, omega = 0, spherical) is supported; the
singular/vacuum branches raise.

The self-similar profile is closed-form in the similarity variable v
(Kamm eqs. 29-41); radius -> v inversion is done by dense monotonic
tabulation + interpolation instead of per-point root finding, so evaluating
the solution at 10^6 particle radii is a single vectorized pass.

The JAX package's sphexa_tpu/analysis/sedov.py, copied: numpy and scipy
only, so that the port imports nothing of that package.
"""

from typing import Dict

import numpy as np
from scipy.integrate import quad


def _exponents(xgeom: float, omega: float, gamma: float):
    """Kamm eqs. 42-47 exponents + eqs. 33-37 coefficient combinations."""
    gamm1, gamp1 = gamma - 1.0, gamma + 1.0
    xg2 = xgeom + 2.0 - omega
    denom2 = 2.0 * gamm1 + xgeom - gamma * omega
    denom3 = xgeom * (2.0 - gamma) - omega
    if abs(denom2) < 1e-6 or abs(denom3) < 1e-6:
        raise NotImplementedError(
            "omega2/omega3 degenerate Sedov cases are not implemented"
        )
    a0 = 2.0 / xg2
    a2 = -gamm1 / denom2
    a1 = (
        xg2 * gamma / (2.0 + xgeom * gamm1)
        * (2.0 * (xgeom * (2.0 - gamma) - omega) / (gamma * xg2 * xg2) - a2)
    )
    a3 = (xgeom - omega) / denom2
    a4 = xg2 * (xgeom - omega) * a1 / denom3
    a5 = (omega * gamp1 - 2.0 * xgeom) / denom3
    coef = dict(
        a=0.25 * xg2 * gamp1,
        b=gamp1 / gamm1,
        c=0.5 * xg2 * gamma,
        d=(xg2 * gamp1) / (xg2 * gamp1 - 2.0 * (2.0 + xgeom * gamm1)),
        e=0.5 * (2.0 + xgeom * gamm1),
    )
    return (a0, a1, a2, a3, a4, a5), coef, xg2


def _similarity_funcs(v, expo, coef, xgeom, omega, xg2):
    """lambda(v), f(v), g(v), h(v): Kamm eqs. 38-41 (standard case).

    Returns (l_fun, dlamdv, f_fun, g_fun, h_fun), all vectorized over v.
    """
    a0, a1, a2, a3, a4, a5 = expo
    x1 = coef["a"] * v
    x2 = coef["b"] * np.maximum(coef["c"] * v - 1.0, 1e-30)
    x3 = coef["d"] * (1.0 - coef["e"] * v)
    x4 = coef["b"] * (1.0 - 0.5 * xg2 * v)
    l_fun = x1**-a0 * x2**-a2 * x3**-a1
    dlamdv = (
        -(a0 * coef["a"] / x1 + a2 * coef["b"] * coef["c"] / x2
          - a1 * coef["d"] * coef["e"] / x3) * l_fun
    )
    f_fun = x1 * l_fun
    g_fun = (
        x1 ** (a0 * omega) * x2 ** (a3 + a2 * omega)
        * x3 ** (a4 + a1 * omega) * x4**a5
    )
    h_fun = x1 ** (a0 * xgeom) * x3 ** (a4 + a1 * (omega - 2.0)) * x4 ** (1.0 + a5)
    return l_fun, dlamdv, f_fun, g_fun, h_fun


def _energy_alpha(expo, coef, xgeom, omega, gamma, xg2) -> float:
    """Dimensionless energy integral alpha (Kamm eqs. 57-58, 67-68)."""
    gamm1, gamp1 = gamma - 1.0, gamma + 1.0
    gpogm = gamp1 / gamm1
    v0 = 2.0 / (xg2 * gamma)
    v2 = 4.0 / (xg2 * gamp1)

    def integrand1(v):
        l_fun, dlamdv, f_fun, g_fun, _ = _similarity_funcs(
            v, expo, coef, xgeom, omega, xg2
        )
        return dlamdv * l_fun ** (xgeom + 1.0) * gpogm * g_fun * v**2

    def integrand2(v):
        l_fun, dlamdv, f_fun, g_fun, h_fun = _similarity_funcs(
            v, expo, coef, xgeom, omega, xg2
        )
        z = 8.0 / ((xgeom + 2.0 - omega) ** 2 * gamp1)
        return dlamdv * l_fun ** (xgeom - 1.0) * h_fun * z

    # integrable algebraic singularity at v0; scipy's adaptive QAGS handles it
    eval1, _ = quad(integrand1, v0, v2, epsabs=1e-12, epsrel=1e-10, limit=200)
    eval2, _ = quad(integrand2, v0, v2, epsabs=1e-12, epsrel=1e-10, limit=200)
    if xgeom == 1:
        return 0.5 * eval1 + eval2 / gamm1
    return (xgeom - 1.0) * np.pi * (eval1 + 2.0 * eval2 / gamm1)


def sedov_solution(
    r: np.ndarray,
    time: float,
    eblast: float = 1.0,
    gamma: float = 5.0 / 3.0,
    rho0: float = 1.0,
    omega: float = 0.0,
    xgeom: float = 3.0,
    u0: float = 0.0,
    p0: float = 0.0,
    vel0: float = 0.0,
    cs0: float = 0.0,
    grid: int = 4096,
) -> Dict[str, np.ndarray]:
    """Evaluate the standard-case Sedov solution at radii ``r``.

    Returns dict with 'rho', 'p', 'u', 'vel', 'cs' arrays (same shape as r)
    and scalar 'r_shock'. Mirrors SedovSolution::sedovSol outputs.
    """
    r = np.asarray(r, np.float64)
    gamm1, gamp1 = gamma - 1.0, gamma + 1.0
    expo, coef, xg2 = _exponents(xgeom, omega, gamma)

    v0 = 2.0 / (xg2 * gamma)
    v2 = 4.0 / (xg2 * gamp1)
    vstar = 2.0 / (gamm1 * xgeom + 2.0)
    if not v2 < vstar - 1e-4:
        raise NotImplementedError("only the standard Sedov case is supported")

    alpha = _energy_alpha(expo, coef, xgeom, omega, gamma, xg2)

    # post-shock state (Kamm eqs. 5, 13, 14, 16)
    r2 = (eblast / (alpha * rho0)) ** (1.0 / xg2) * time ** (2.0 / xg2)
    us = (2.0 / xg2) * r2 / time
    rho1 = rho0 * r2**-omega
    rho_shock = gamp1 / gamm1 * rho1
    p_shock = 2.0 * rho1 * us**2 / gamp1
    vel_shock = 2.0 * us / gamp1
    cs_shock = np.sqrt(gamma * p_shock / rho_shock)

    # dense monotone table lambda(v) on [v0, v2], clustered toward v0 where
    # lambda -> 0 steeply; inversion by interpolation
    s = np.linspace(0.0, 1.0, grid)
    vtab = v0 + (v2 - v0) * s**4
    vtab[0] = v0 * (1.0 + 1e-12)
    l_tab, _, f_tab, g_tab, h_tab = _similarity_funcs(
        vtab, expo, coef, xgeom, omega, xg2
    )
    l_tab[0] = 0.0

    lam = np.clip(r / max(r2, 1e-300), 0.0, None)
    inside = lam <= 1.0
    lam_in = np.where(inside, lam, 1.0)
    f = np.interp(lam_in, l_tab, f_tab)
    g = np.interp(lam_in, l_tab, g_tab)
    h = np.interp(lam_in, l_tab, h_tab)

    rho_in = rho_shock * g
    p_in = p_shock * h
    vel_in = vel_shock * f
    with np.errstate(divide="ignore", invalid="ignore"):
        u_in = np.where(rho_in > 0, p_in / (gamm1 * rho_in), 0.0)
        cs_in = np.where(rho_in > 0, np.sqrt(gamma * p_in / rho_in), 0.0)

    out = {
        "rho": np.where(inside, rho_in, rho0 * np.where(r > 0, r, 1.0) ** -omega),
        "p": np.where(inside, p_in, p0),
        "u": np.where(inside, u_in, u0),
        "vel": np.where(inside, vel_in, vel0),
        "cs": np.where(inside, cs_in, cs0),
        "r_shock": r2,
    }
    return out
