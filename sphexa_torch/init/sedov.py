"""Sedov-Taylor blast wave (sphexa_tpu/init/sedov.py): a uniform periodic
cube with a Gaussian thermal spike at the origin. The fields are built in
numpy exactly as the JAX package builds them, then moved to the device."""

from typing import Dict, Optional, Tuple

import numpy as np

from sphexa_torch.device import resolve_device
from sphexa_torch.init.grid import regular_grid
from sphexa_torch.init.utils import build_state, settings_to_constants, sphere_h_init
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.particles import ParticleState, SimConstants, ideal_gas_cv


def sedov_constants() -> Dict[str, float]:
    """Test-case settings (sedov_constants.hpp:11-21)."""
    c = {
        "dim": 3, "gamma": 5.0 / 3.0, "omega": 0.0, "r0": 0.0, "r1": 0.5,
        "mTotal": 1.0, "energyTotal": 1.0, "width": 0.1, "rho0": 1.0,
        "u0": 1e-8, "p0": 0.0, "vr0": 0.0, "cs0": 0.0,
        "minDt": 1e-6, "minDt_m1": 1e-6, "gravConstant": 0.0,
        "ng0": 100, "ngmax": 150, "mui": 10.0,
    }
    c["ener0"] = c["energyTotal"] / np.pi**1.5 / c["width"] ** 3
    return c


def init_sedov(side: int, overrides: Optional[Dict[str, float]] = None,
               device=None) -> Tuple[ParticleState, Box, SimConstants]:
    """Sedov grid case with side**3 particles (sedov_init.hpp:48-133)."""
    dev = resolve_device(device)
    settings = sedov_constants()
    if overrides:
        settings.update(overrides)
        if "ener0" not in overrides:
            settings["ener0"] = (
                settings["energyTotal"] / np.pi**1.5 / settings["width"] ** 3
            )

    n = side**3
    r = settings["r1"]
    box = Box.create(-r, r, boundary=BoundaryType.periodic, device=dev)
    x, y, z = regular_grid(r, side)

    h_init = sphere_h_init(settings["ng0"], (2 * r) ** 3, n)
    m_part = settings["mTotal"] / n
    const = settings_to_constants(settings)

    cv = ideal_gas_cv(settings["mui"], settings["gamma"])
    r2 = x**2 + y**2 + z**2
    u = settings["ener0"] * np.exp(-(r2 / settings["width"] ** 2)) + settings["u0"]
    temp = u / cv

    state = build_state(
        x, y, z, 0.0, 0.0, 0.0, h_init, m_part, temp,
        settings["minDt"], const.alphamin, settings["minDt_m1"], device=dev,
    )
    return state, box, const


def jitter_sedov(fields: Dict[str, np.ndarray], side: int, seed: int
                 ) -> Dict[str, np.ndarray]:
    """A seeded numpy perturbation of a Sedov lattice (fields as
    ``convert.state_to_numpy`` gives them): positions by up to 0.1 lattice
    spacings, wrapped into the unit periodic box, h by up to -2%, and
    velocities of the order of the sound speed. On the bare lattice every
    velocity is zero, so the viscosity, the energy rate and the IAD
    off-diagonals vanish; after this every term of the pair math is
    non-zero, which is what the kernel checks need."""
    rng = np.random.default_rng(seed)
    n = side**3
    dx = np.float32(1.0 / side)
    out = dict(fields)
    for f in ("x", "y", "z"):
        v = out[f] + (rng.uniform(-0.1, 0.1, n) * dx).astype(np.float32)
        out[f] = (np.mod(v + np.float32(0.5), np.float32(1.0)) - np.float32(0.5)).astype(np.float32)
    out["h"] = (out["h"] * rng.uniform(0.98, 1.0, n)).astype(np.float32)
    for f in ("vx", "vy", "vz"):
        out[f] = rng.normal(0.0, 0.3, n).astype(np.float32)
    return out


def stretch_box(fields: Dict[str, np.ndarray], box: Dict, z_scale: float,
                boundaries) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A case stretched along z, with other boundaries (numpy fields and
    box as ``convert.state_to_numpy`` gives them): z and the box's z bounds
    times ``z_scale`` in float32, the boundary types replaced by
    ``boundaries`` (three ints of ``BoundaryType``). A mixed-box case for
    the per-cell image shifts: Sedov 24 stretched 1.3x, periodic in x and
    open in y and z, keeps persistent lists at cell_target 16."""
    s = np.float32(z_scale)
    out = dict(fields)
    out["z"] = (out["z"] * s).astype(np.float32)
    lo, hi = (np.array(box[k], np.float32) for k in ("lo", "hi"))
    lo[2], hi[2] = lo[2] * s, hi[2] * s
    return out, {"lo": lo, "hi": hi, "boundaries": [int(b) for b in boundaries]}
