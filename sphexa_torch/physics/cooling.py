"""Radiative cooling, the reduced tabulated model (sphexa_tpu/physics/cooling.py;
the role of the reference's GRACKLE wrapper, physics/cooling/).

- a collisional-ionization-equilibrium (CIE) cooling curve Lambda(T),
  tabulated at solar composition and interpolated in log-log (the table
  is a config field);
- an optional constant photoelectric heating rate Gamma;
- ``ChemistryData``: the ionization fractions the reference tracks, which
  set the mean molecular weight (diagnostic under CIE, evolved by
  physics/primordial.py with ``evolve_species``);
- the semi-implicit sub-cycled du/dt integration and the ct_crit time
  step limiter (eos_cooling.hpp:12-25).

The simulation runs in code units; ``CoolingConfig`` carries the code to
cgs conversions. The raw cgs chain under- and overflows float32, so the
conversions are folded into float64 prefactors on the host and the
device works in code-unit magnitudes, as in the JAX package. PyTorch has
no ``interp``: ``_interp`` is jnp.interp's formula.
"""

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sphexa_torch.util.phases import named_phase

# cgs constants
KB = 1.380658e-16          # erg/K
MH = 1.6726231e-24         # g
G_CGS = 6.6726e-8          # cm^3 g^-1 s^-2
MSUN = 1.98892e33          # g
KPC = 3.0856776e21         # cm

# the approximate solar-metallicity CIE cooling curve, log10 T [K] ->
# log10 Lambda [erg cm^3 / s] (the shape of Sutherland & Dopita 1993 to
# about 0.1 dex: the H/He and metal line peak near 1e5 K,
# bremsstrahlung ~ sqrt(T) beyond 1e7.5 K)
_LOGT_TABLE = np.array([3.8, 4.0, 4.2, 4.6, 5.0, 5.4, 5.8, 6.2, 6.6, 7.0, 7.5, 8.0, 8.5])
_LOGL_TABLE = np.array([-28.0, -23.2, -21.8, -21.4, -21.1, -21.3, -21.7, -22.1, -22.5,
                        -22.7, -22.65, -22.55, -22.4])


@dataclasses.dataclass(frozen=True)
class CoolingConfig:
    """Static cooling parameters and the unit system (cooler.hpp's
    attributes; evrard_cooling_init.hpp:59-60's m_code_in_ms 1e16 and
    l_code_in_kpc 46400 as the defaults)."""

    ct_crit: float = 0.1            # cooling-time step fraction (cooler.hpp:90)
    gamma: float = 5.0 / 3.0
    mu: float = 0.6                 # mean molecular weight (ionized solar)
    hydrogen_fraction: float = 0.76
    heating_rate: float = 0.0       # Gamma, erg/s per H atom (photoelectric)
    m_code_g: float = 1e16 * MSUN
    l_code_cm: float = 46400.0 * KPC
    substeps: int = 8               # sub-cycles of the semi-implicit update
    logT_table: Tuple[float, ...] = tuple(_LOGT_TABLE)
    logL_table: Tuple[float, ...] = tuple(_LOGL_TABLE)
    # evolve the 6-species primordial network (physics/primordial.py) in
    # place of the CIE table (the cooler.cpp solve_chemistry role)
    evolve_species: bool = False

    @property
    def t_code_s(self) -> float:
        """The G=1 time unit: sqrt(l^3 / (G m))."""
        return float(np.sqrt(self.l_code_cm**3 / (G_CGS * self.m_code_g)))

    @property
    def rho_to_cgs(self) -> float:
        return float(self.m_code_g / self.l_code_cm**3)

    @property
    def u_to_cgs(self) -> float:
        """Specific energy: (l/t)^2."""
        return float((self.l_code_cm / self.t_code_s) ** 2)

    @property
    def log_cool_prefac(self) -> float:
        """log10 of (X/m_H)^2 rho_to_cgs t_code / u_to_cgs: du/dt_cool in
        code units is -10^(logL + log_cool_prefac) rho_code."""
        x_over_mh = self.hydrogen_fraction / MH
        return float(2.0 * np.log10(x_over_mh) + np.log10(self.rho_to_cgs)
                     + np.log10(self.t_code_s) - np.log10(self.u_to_cgs))

    @property
    def heating_code(self) -> float:
        """The specific heating rate X Gamma / m_H in code units."""
        if self.heating_rate == 0.0:
            return 0.0
        return float(self.hydrogen_fraction * self.heating_rate / MH
                     * self.t_code_s / self.u_to_cgs)


#: ChemistryData's fields, in declaration (and dump) order
CHEM_FIELDS = ("hi", "hii", "hei", "heii", "heiii", "e", "metal")


@dataclasses.dataclass
class ChemistryData:
    """Per-particle chemistry fractions (mass fractions; ``e`` is the
    electron abundance per mass, y_e = n_e m_H / rho), float32 (n,)
    tensors. The reference tracks 21 GRACKLE species
    (cooling/chemistry_data.hpp:47-116); the CIE closure needs only the
    composition that fixes the mean molecular weight."""

    hi: torch.Tensor
    hii: torch.Tensor
    hei: torch.Tensor
    heii: torch.Tensor
    heiii: torch.Tensor
    e: torch.Tensor
    metal: torch.Tensor

    @staticmethod
    def ionized(n: int, hydrogen_fraction: float = 0.76, metallicity: float = 0.0122,
                device="cpu") -> "ChemistryData":
        """Fully ionized primordial gas with solar metals."""
        x = hydrogen_fraction
        y = 1.0 - x - metallicity
        vals = {"hi": 0.0, "hii": x, "hei": 0.0, "heii": 0.0, "heiii": y, "e": x + y / 2.0,
                "metal": metallicity}
        return ChemistryData(**{k: torch.full((n,), float(np.float32(v)),
                                              dtype=torch.float32, device=device)
                                for k, v in vals.items()})

    def to(self, device) -> "ChemistryData":
        return ChemistryData(**{k: getattr(self, k).to(device) for k in CHEM_FIELDS})

    def mean_molecular_weight(self) -> torch.Tensor:
        """mu from the composition: 1/mu = 2 X_HII + X_HI + ... (amu)."""
        inv_mu = (self.hi + 2.0 * self.hii + self.hei / 4.0 + self.heii / 2.0
                  + 3.0 * self.heiii / 4.0 + self.metal / 2.0)
        return 1.0 / torch.clamp(inv_mu, min=1e-10)


def u_to_temp(u_code, mu, cfg: CoolingConfig):
    """T[K] = (gamma-1) mu m_H u_cgs / kB (cooler energy_to_temperature)."""
    u_cgs = u_code * cfg.u_to_cgs
    return (cfg.gamma - 1.0) * mu * MH * u_cgs / KB


def temp_to_u(temp, mu, cfg: CoolingConfig):
    """Inverse of u_to_temp, in code units."""
    u_cgs = temp * KB / ((cfg.gamma - 1.0) * mu * MH)
    return u_cgs / cfg.u_to_cgs


def _interp(x, xp, fp, left: float, right: float):
    """jnp.interp(x, xp, fp, left, right): the segment by searchsorted
    (side right, clipped to [1, len - 1]), fp[i-1] + (x - xp[i-1]) /
    (xp[i] - xp[i-1]) * (fp[i] - fp[i-1]), ``left`` below xp[0] and
    ``right`` above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


@functools.lru_cache(maxsize=None)
def _cie_table(cfg: CoolingConfig, device: torch.device):
    """The CIE table as float32 tensors on ``device``, copied there once
    (a copy from the host at every call would stall the stream)."""
    return tuple(torch.tensor(t, dtype=torch.float32, device=device)
                 for t in (cfg.logT_table, cfg.logL_table))


def _log_lambda_cie(temp, cfg: CoolingConfig):
    """log10 Lambda(T) [erg cm^3/s] interpolated in the CIE table; no
    radiative cooling below it (-60), its last value above it."""
    log_t = torch.log10(torch.clamp(temp, min=1.0))
    xp, fp = _cie_table(cfg, temp.device)
    return _interp(log_t, xp, fp, left=-60.0, right=float(cfg.logL_table[-1]))


def cooling_rate(rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """du/dt in code units: (n_H Gamma - n_H^2 Lambda(T)) / rho, negative
    for net cooling (the two-body CIE form of GRACKLE's tabulated mode),
    the unit conversions folded into log-space prefactors."""
    mu = chem.mean_molecular_weight()
    temp = u_to_temp(u_code, mu, cfg)
    log_lam = _log_lambda_cie(temp, cfg)
    cool = 10.0 ** (log_lam + cfg.log_cool_prefac) * rho_code
    return cfg.heating_code - cool


def cooling_timestep(rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """ct_crit times the least |u / (du/dt)| over the particles
    (eos_cooling.hpp:12-25)."""
    dudt = cooling_rate(rho_code, u_code, chem, cfg)
    tc = torch.abs(u_code / torch.where(torch.abs(dudt) > 0, dudt, 1e-30))
    return cfg.ct_crit * torch.min(tc)


def cool_particles(dt, rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """The cooling source integrated over dt, as the du/dt averaged over
    the step that the propagator adds to du (std_hydro_grackle.hpp:214-226):
    ``cfg.substeps`` semi-implicit sub-cycles u' = u / (1 + dt_sub L/u) +
    dt_sub H, stable and positive for net cooling."""
    dt_sub = dt / cfg.substeps
    u = u_code
    for _ in range(cfg.substeps):
        dudt = cooling_rate(rho_code, u, chem, cfg)
        cool = torch.where(dudt < 0, -dudt, 0.0)
        heat = torch.where(dudt > 0, dudt, 0.0)
        u = u / (1.0 + dt_sub * cool / torch.clamp(u, min=1e-30)) + dt_sub * heat
    return (u - u_code) / dt


@named_phase("cooling")
def cool_step(dt, rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """One cooling source update: (du_avg, the new ChemistryData), by the
    evolved primordial network with ``cfg.evolve_species``, else the CIE
    table with the fractions passed through."""
    if cfg.evolve_species:
        from sphexa_torch.physics.primordial import evolve_primordial

        return evolve_primordial(dt, rho_code, u_code, chem, cfg)
    return cool_particles(dt, rho_code, u_code, chem, cfg), chem


@named_phase("cooling")
def cool_timestep(rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """The ct_crit cooling-time limiter, by the same dispatch as cool_step."""
    if cfg.evolve_species:
        from sphexa_torch.physics.primordial import primordial_cooling_timestep

        return primordial_cooling_timestep(rho_code, u_code, chem, cfg)
    return cooling_timestep(rho_code, u_code, chem, cfg)


def eos_cooling(rho_code, u_code, chem: ChemistryData, cfg: CoolingConfig):
    """The cooling propagator's EOS (eos_cooling.hpp:27-47): under the CIE
    closure the composition enters only through the u <-> T conversion,
    so the pressure is the ideal gas's p = (gamma-1) rho u, which the std
    force stage already evaluates; this states that identity."""
    from sphexa_torch.sph.eos import ideal_gas_eos_u

    del chem
    return ideal_gas_eos_u(u_code, rho_code, cfg.gamma)


def chemistry_to_fields(chem: ChemistryData):
    """The chemistry as the JAX package's dump datasets (``chem_<field>``,
    float32; std_hydro_grackle.hpp:89-106's per-particle fields)."""
    return {f"chem_{k}": getattr(chem, k).cpu().numpy() for k in CHEM_FIELDS}


def chemistry_from_fields(extra, device="cpu") -> ChemistryData:
    """ChemistryData from the datasets ``chemistry_to_fields`` writes."""
    return ChemistryData(**{k: torch.as_tensor(np.asarray(extra[f"chem_{k}"], np.float32),
                                               device=device) for k in CHEM_FIELDS})
