"""Kelvin-Helmholtz instability (sphexa_tpu/init/kelvin_helmholtz.py; the
reference's main/src/init/kelvin_helmholtz_init.hpp): a dense band (rhoInt
2, y in [0.25, 0.75]) shearing against a light background (rhoExt 1) in a
thin periodic slab, seeded with a sinusoidal vy; the billow growth rate is
the observable (time_energy_growth.hpp). The fields are built in numpy
exactly as the JAX package builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.glass import jittered_lattice
from sphexa_torch.init.utils import build_state, h_from_density, settings_to_constants
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv

_LZ = 0.0625  # slab thickness (kelvin_helmholtz_init.hpp:145)


def kelvin_helmholtz_constants() -> Dict[str, float]:
    """Test-case settings (kelvin_helmholtz_init.hpp)."""
    return {
        "rhoInt": 2.0, "rhoExt": 1.0, "vxExt": 0.5, "vxInt": -0.5,
        "gamma": 5.0 / 3.0, "p": 2.5, "omega0": 0.01, "Kcour": 0.4,
        "ng0": 100, "ngmax": 150, "minDt": 1e-7, "minDt_m1": 1e-7,
        "gravConstant": 0.0, "mui": 10.0, "kelvin-helmholtz": 1.0,
    }


def _layer(lo, hi, spacing, seed, keep_fraction=1.0):
    """A jittered lattice at ``spacing`` over [lo, hi); the density
    contrast comes from exact thinning (a seeded ``rng.choice``), since
    integer per-axis counts round too coarsely in a thin slab."""
    ext = np.asarray(hi) - np.asarray(lo)
    counts = np.maximum(1, np.round(ext / spacing).astype(int))
    lx, ly, lz = jittered_lattice(lo, hi, counts, seed=seed)
    if keep_fraction < 1.0:
        n = lx.shape[0]
        rng = np.random.default_rng(seed + 1000)
        keep = rng.choice(n, size=round(n * keep_fraction), replace=False)
        lx, ly, lz = lx[keep], ly[keep], lz[keep]
    return lx, ly, lz


def init_kelvin_helmholtz(side: int, overrides: Optional[Dict[str, float]] = None,
                          device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Three-layer slab (KelvinHelmholtzGlass::init) of about side^3
    equal-mass particles: the middle band holds twice the number density
    of the outer layers; the shear relaxes over ls = 0.025 at the
    interfaces and h tapers from the band's to the background's."""
    dev = resolve_device(device)
    settings = kelvin_helmholtz_constants()
    if overrides:
        settings.update(overrides)
    rho_int, rho_ext = settings["rhoInt"], settings["rhoExt"]

    v_in = 1.0 * 0.5 * _LZ
    v_out = 1.0 * 0.5 * _LZ
    nd_int = side**3 / (v_in + v_out * rho_ext / rho_int)
    a_int = nd_int ** (-1.0 / 3.0)

    thin = rho_ext / rho_int
    x2, y2, z2 = _layer((0, 0.25, 0), (1, 0.75, _LZ), a_int, seed=2)
    x1, y1, z1 = _layer((0, 0.0, 0), (1, 0.25, _LZ), a_int, seed=1, keep_fraction=thin)
    x3, y3, z3 = _layer((0, 0.75, 0), (1, 1.0, _LZ), a_int, seed=3, keep_fraction=thin)
    x = np.concatenate([x1, x2, x3])
    y = np.concatenate([y1, y2, y3])
    z = np.concatenate([z1, z2, z3])
    m_part = v_in * rho_int / x2.shape[0]

    const = settings_to_constants(settings)
    gamma, p = settings["gamma"], settings["p"]
    u_int = p / ((gamma - 1.0) * rho_int)
    u_ext = p / ((gamma - 1.0) * rho_ext)
    vx_int, vx_ext = settings["vxInt"], settings["vxExt"]
    v_dif = 0.5 * (vx_ext - vx_int)
    ls = 0.025
    h_int = h_from_density(settings["ng0"], m_part, rho_int)
    h_ext = h_from_density(settings["ng0"], m_part, rho_ext)
    cv = ideal_gas_cv(settings["mui"], gamma)
    inner = (y > 0.25) & (y < 0.75)

    # the shear, relaxing exponentially toward the interfaces
    vx_in = vx_int + v_dif * np.where(y > 0.5, np.exp((y - 0.75) / ls),
                                      np.exp((0.25 - y) / ls))
    vx_out = vx_ext - v_dif * np.where(y < 0.25, np.exp((y - 0.25) / ls),
                                       np.exp((0.75 - y) / ls))
    vx = np.where(inner, vx_in, vx_out)
    vy = settings["omega0"] * np.sin(4 * np.pi * x)

    # h from h_int at the band's edge to h_ext two h_ext away
    dist = np.where(y > 0.75, y - 0.75, 0.25 - y)
    far = (y > 0.75 + 2 * h_ext) | (y < 0.25 - 2 * h_ext)
    h_near = h_int * (1 - dist / (2 * h_ext)) + h_ext * dist / (2 * h_ext)
    h = np.where(inner, h_int, np.where(far, h_ext, h_near))
    temp = np.where(inner, u_int, u_ext) / cv

    box = Box.create(0, 1, 0, 1, 0, _LZ, boundary=BoundaryType.periodic, device=dev)
    state = build_state(x, y, z, vx, vy, 0.0, h, m_part, temp, settings["minDt"],
                        const.alphamax, settings["minDt_m1"], device=dev)
    return state, box, const
