"""The evolved 6-species primordial chemistry (H, H+, He, He+, He++, e)
(sphexa_tpu/physics/primordial.py; the role of the reference's GRACKLE
solver, physics/cooling/cooler.cpp:313 solve_chemistry).

A fixed number of sub-cycles (a Python loop of elementwise work), each a
sequential semi-implicit species update (the Anninos et al. 1997 scheme
GRACKLE uses, each ionization pair solved implicitly through its
closure), the species-resolved cooling plus the metal residual of the
CIE table, and the positive implicit u update. Rates are the Cen 1992 /
Katz, Weinberg & Hernquist 1996 fits:

    HI   + e -> HII   + 2e      k1      HII   + e -> HI   (+ photon) k2
    HeI  + e -> HeII  + 2e      k3      HeII  + e -> HeI  (incl. di) k4
    HeII + e -> HeIII + 2e      k5      HeIII + e -> HeII            k6

The species are mass fractions (ChemistryData); the solver works in
per-mass number fractions y_X = X / A_X, with n_X = rho_cgs y_X / m_H:

    dy/dt [code] = k(T) y_e rho_code R0,   R0 = rho_to_cgs / m_H t_code
    du/dt [code] = -rho_code C0 sum y_e y_X lam24(T),
                   C0 = rho_to_cgs / m_H^2 t_code / u_to_cgs 1e-24

where lam24 = Lambda 1e24, and R0 and C0 are float64 host prefactors
rounded to float32, as in the JAX package.
"""

from typing import Optional

import numpy as np
import torch

from sphexa_torch.physics.cooling import (
    MH, ChemistryData, CoolingConfig, _log_lambda_cie, u_to_temp,
)

__all__ = ["k1_ci_hi", "k2_rec_hii", "k3_ci_hei", "k4_rec_heii", "k5_ci_heii",
           "k6_rec_heiii", "lam24_channels", "species_cooling24", "metal_cooling24",
           "equilibrium_fractions", "relax_to_equilibrium", "evolve_primordial",
           "primordial_cooling_timestep"]

# the solar metallicity the CIE table's metal residual is scaled by
Z_SUN = 0.0122


# rate coefficients [cm^3/s] (Cen 1992; KWH96 eqs. 24-30)

def _rdiv(c: float, t):
    """c / t as one float32 division (``c / t`` on a tensor is c times the
    reciprocal: two roundings)."""
    return torch.div(torch.tensor(c, dtype=t.dtype), t)


def _t5(T):
    return 1.0 + torch.sqrt(T * 1e-5)


def k1_ci_hi(T):
    """HI collisional ionization."""
    return 5.85e-11 * torch.sqrt(T) / _t5(T) * torch.exp(_rdiv(-157809.1, T))


def k2_rec_hii(T):
    """HII radiative recombination (case A)."""
    return _rdiv(8.4e-11, torch.sqrt(T)) * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7)


def k3_ci_hei(T):
    """HeI collisional ionization."""
    return 2.38e-11 * torch.sqrt(T) / _t5(T) * torch.exp(_rdiv(-285335.4, T))


def k4_rec_heii(T):
    """HeII recombination: radiative and dielectronic."""
    rad = 1.5e-10 * T ** -0.6353
    di = (1.9e-3 * T ** -1.5 * torch.exp(_rdiv(-470000.0, T))
          * (1.0 + 0.3 * torch.exp(_rdiv(-94000.0, T))))
    return rad + di


def k5_ci_heii(T):
    """HeII collisional ionization."""
    return 5.68e-12 * torch.sqrt(T) / _t5(T) * torch.exp(_rdiv(-631515.0, T))


def k6_rec_heiii(T):
    """HeIII radiative recombination."""
    return _rdiv(3.36e-10, torch.sqrt(T)) * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7)


def lam24_channels(T):
    """The cooling channels per (n_e n_X), Lambda 1e24 [erg cm^3/s] (KWH96
    Table 1), keyed by which species' number fraction multiplies each."""
    sq = torch.sqrt(T)
    t5 = _t5(T)
    return {
        # collisional excitation
        "ce_hi": 7.50e5 * torch.exp(_rdiv(-118348.0, T)) / t5,
        "ce_heii": 5.54e7 * T ** -0.397 * torch.exp(_rdiv(-473638.0, T)) / t5,
        # collisional ionization
        "ci_hi": 1.27e3 * sq * torch.exp(_rdiv(-157809.1, T)) / t5,
        "ci_hei": 9.38e2 * sq * torch.exp(_rdiv(-285335.4, T)) / t5,
        "ci_heii": 4.95e2 * sq * torch.exp(_rdiv(-631515.0, T)) / t5,
        # recombination
        "rec_hii": 8.70e-3 * sq * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7),
        "rec_heii": 1.55e-2 * T ** 0.3647,
        "rec_heiii": 3.48e-2 * sq * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7),
        "di_heii": (1.24e11 * T ** -1.5 * torch.exp(_rdiv(-470000.0, T))
                    * (1.0 + 0.3 * torch.exp(_rdiv(-94000.0, T)))),
        # bremsstrahlung (g_ff = 1.3), x (n_HII + n_HeII + 4 n_HeIII)
        "brem": 1.42e-3 * 1.3 * sq,
    }


def species_cooling24(T, y):
    """The sum over the channels of y_e y_X lam24(T): the
    composition-resolved cooling function (per rho_code C0)."""
    lam = lam24_channels(T)
    return y["e"] * (
        lam["ce_hi"] * y["hi"] + lam["ce_heii"] * y["heii"]
        + lam["ci_hi"] * y["hi"] + lam["ci_hei"] * y["hei"]
        + lam["ci_heii"] * y["heii"]
        + lam["rec_hii"] * y["hii"]
        + (lam["rec_heii"] + lam["di_heii"]) * y["heii"]
        + lam["rec_heiii"] * y["heiii"]
        + lam["brem"] * (y["hii"] + y["heii"] + 4.0 * y["heiii"])
    )


def metal_cooling24(T, metal, cfg: CoolingConfig, x_h: Optional[float] = None):
    """Metal-line cooling on top of the network (GRACKLE's network plus
    metal table): the residual of the solar CIE table over the network's
    own equilibrium cooling at T, per (rho/m_H)^2 (the table's n_H^2 is
    converted with x_h^2, ``cfg.hydrogen_fraction`` by default), scaled
    linearly in the particle's metal mass fraction."""
    if x_h is None:
        x_h = cfg.hydrogen_fraction
    lam_cie24 = 10.0 ** (_log_lambda_cie(T, cfg) + 24.0) * x_h ** 2
    lam_prim24 = species_cooling24(T, equilibrium_fractions(T, x_h, 1.0 - x_h))
    return torch.clamp(lam_cie24 - lam_prim24, min=0.0) * (metal / Z_SUN)


def equilibrium_fractions(T, x_h, x_he):
    """The analytic CIE ionization balance at T (rate ratios only: the
    density cancels), as per-mass number fractions."""
    r_h = k1_ci_hi(T) / k2_rec_hii(T)          # y_HII / y_HI
    r_he1 = k3_ci_hei(T) / k4_rec_heii(T)      # y_HeII / y_HeI
    r_he2 = k5_ci_heii(T) / k6_rec_heiii(T)    # y_HeIII / y_HeII
    y_hi = _rdiv(x_h, 1.0 + r_h)
    y_hii = x_h - y_hi
    y_he = x_he / 4.0
    d = 1.0 + r_he1 + r_he1 * r_he2
    y_hei = _rdiv(y_he, d)
    y_heii = y_hei * r_he1
    y_heiii = y_heii * r_he2
    return dict(hi=y_hi, hii=y_hii, hei=y_hei, heii=y_heii, heiii=y_heiii,
                e=y_hii + y_heii + 2.0 * y_heiii)


def _prefactors(cfg: CoolingConfig):
    """(R0, C0): the float64 unit folds, rounded to float32."""
    r0 = cfg.rho_to_cgs / MH * cfg.t_code_s
    c0 = cfg.rho_to_cgs / MH**2 * cfg.t_code_s / cfg.u_to_cgs * 1e-24
    return float(np.float32(r0)), float(np.float32(c0))


def _y_of(chem: ChemistryData):
    return dict(hi=chem.hi, hii=chem.hii, hei=chem.hei / 4.0, heii=chem.heii / 4.0,
                heiii=chem.heiii / 4.0, e=chem.e)


def _chem_of(y, metal) -> ChemistryData:
    return ChemistryData(hi=y["hi"], hii=y["hii"], hei=y["hei"] * 4.0, heii=y["heii"] * 4.0,
                         heiii=y["heiii"] * 4.0, e=y["e"], metal=metal)


def _mu_of_y(y, metal):
    inv_mu = y["hi"] + y["hii"] + y["hei"] + y["heii"] + y["heiii"] + y["e"] + metal / 2.0
    return 1.0 / torch.clamp(inv_mu, min=1e-10)


def _clip(v, hi):
    """jnp.clip(v, 0, hi): max with 0, then min with ``hi``."""
    return torch.minimum(torch.clamp(v, min=0.0), hi)


def _species_update(y, T, a, x_h, y_he_tot):
    """One network sub-cycle at temperature T with the rate factor a = dt
    n_H-equivalent y_e. Each ionization pair is solved implicitly through
    its closure (y_HII = X - y_HI, and HeIII's recombination into HeII
    through y_HeIII = Y/4 - y_HeI - y_HeII), so stiff factors relax
    monotonically onto the exact CIE balance."""
    k1, k2 = k1_ci_hi(T), k2_rec_hii(T)
    y_hi = (y["hi"] + a * k2 * x_h) / (1.0 + a * (k1 + k2))
    y_hi = _clip(y_hi, x_h)
    y_hii = x_h - y_hi

    k3, k4 = k3_ci_hei(T), k4_rec_heii(T)
    k5, k6 = k5_ci_heii(T), k6_rec_heiii(T)
    y_hei = (y["hei"] + a * k4 * y["heii"]) / (1.0 + a * k3)
    y_hei = _clip(y_hei, y_he_tot)
    y_heii = ((y["heii"] + a * (k3 * y_hei + k6 * (y_he_tot - y_hei)))
              / (1.0 + a * (k4 + k5 + k6)))
    y_heii = _clip(y_heii, y_he_tot - y_hei)
    y_heiii = y_he_tot - y_hei - y_heii
    return dict(hi=y_hi, hii=y_hii, hei=y_hei, heii=y_heii, heiii=y_heiii,
                e=y_hii + y_heii + 2.0 * y_heiii)


def relax_to_equilibrium(T, rho_code, chem: ChemistryData, cfg: CoolingConfig,
                         dt_sub, steps: int = 2048) -> ChemistryData:
    """Species-only relaxation at a fixed temperature: the CIE limit and an
    equilibrium initial-condition generator. ``dt_sub`` is the code time
    of each of the ``steps`` sub-cycles."""
    r0, _ = _prefactors(cfg)
    x_h = chem.hi + chem.hii
    y_he_tot = (chem.hei + chem.heii + chem.heiii) / 4.0
    dens = rho_code * r0
    y = _y_of(chem)
    for _ in range(steps):
        y = _species_update(y, T, dt_sub * dens * y["e"], x_h, y_he_tot)
    return _chem_of(y, chem.metal)


def evolve_primordial(dt, rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """The sub-cycled coupled (species, energy) update over one step: per
    sub-cycle T from (u, mu), the rates, the sequential species update,
    the species-resolved and metal-residual cooling, and the implicit u
    update. Returns (du_avg, the new ChemistryData); the metal fraction
    passes through."""
    r0, c0 = _prefactors(cfg)
    dt_sub = dt / cfg.substeps
    x_h = chem.hi + chem.hii
    y_he_tot = (chem.hei + chem.heii + chem.heiii) / 4.0
    metal = chem.metal
    dens = rho_code * r0  # k dens y_e = dy/dt per code time
    u, y = u_code, _y_of(chem)
    for _ in range(cfg.substeps):
        mu = _mu_of_y(y, metal)
        T = torch.clamp(u_to_temp(u, mu, cfg), min=10.0)
        a = dt_sub * dens * y["e"]
        y = _species_update(y, T, a, x_h, y_he_tot)
        cool = rho_code * c0 * (species_cooling24(T, y) + metal_cooling24(T, metal, cfg))
        u = u / (1.0 + dt_sub * cool / torch.clamp(u, min=1e-30)) + dt_sub * cfg.heating_code
    return (u - u_code) / dt, _chem_of(y, metal)


def primordial_cooling_timestep(rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """ct_crit times the least |u / (du/dt)| with the species-resolved
    rate (the eos_cooling.hpp:12-25 contract, network form)."""
    _, c0 = _prefactors(cfg)
    y = _y_of(chem)
    T = torch.clamp(u_to_temp(u_code, _mu_of_y(y, chem.metal), cfg), min=10.0)
    dudt = (rho_code * c0 * (species_cooling24(T, y) + metal_cooling24(T, chem.metal, cfg))
            - cfg.heating_code)
    tc = torch.abs(u_code / torch.where(torch.abs(dudt) > 0, dudt, 1e-30))
    return cfg.ct_crit * torch.min(tc)
