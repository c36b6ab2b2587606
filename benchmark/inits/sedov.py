"""Sedov-Taylor blast (SPH-EXA sedov_init.hpp, sedov_constants.hpp): a
uniform periodic cube of side**3 particles on a cubic lattice, at rest,
with a Gaussian thermal spike at the origin. The seed moves every
particle by a uniform jitter of up to ``jitter`` lattice spacings per
coordinate (``assumed`` in the configuration), wrapped into the box."""

import numpy as np

from benchmark.inits import rng

R_GAS = 8.317e7  # sph/eos.hpp


def make(cfg: dict, seed: int) -> dict:
    s = cfg["settings"]
    side = int(cfg["side"])
    n = side**3
    r = float(s["r1"])
    step = 2.0 * r / side
    line = (-r + 0.5 * step + step * np.arange(side)).astype(np.float32)
    z, y, x = (a.ravel() for a in np.meshgrid(line, line, line, indexing="ij"))
    g = rng(seed, "init")
    jit = float(cfg["assumed"]["jitter"])
    box_len = np.float32(2.0 * r)
    pos = []
    for a in (x, y, z):
        v = a + (g.uniform(-jit, jit, n) * step).astype(np.float32)
        pos.append((np.mod(v + np.float32(r), box_len) - np.float32(r)).astype(np.float32))
    x, y, z = pos
    # h for ~ng0 neighbours at the mean density (sphere_h_init)
    h = float(np.cbrt(3.0 / (4 * np.pi) * s["ng0"] * (2 * r) ** 3 / n) * 0.5)
    cv = R_GAS / s["mui"] / (s["gamma"] - 1.0)
    ener0 = s["energyTotal"] / np.pi**1.5 / s["width"] ** 3
    r2 = x.astype(np.float64) ** 2 + y.astype(np.float64) ** 2 + z.astype(np.float64) ** 2
    u = ener0 * np.exp(-(r2 / s["width"] ** 2)) + s["u0"]
    zeros = np.zeros(n, np.float32)
    fields = {"x": x, "y": y, "z": z, "vx": zeros, "vy": zeros, "vz": zeros,
              "h": np.full(n, h, np.float32), "m": np.full(n, s["mTotal"] / n, np.float32),
              "temp": (u / cv).astype(np.float32),
              "alpha": np.full(n, cfg["constants"]["alphamin"], np.float32)}
    return {"fields": fields,
            "scalars": {"min_dt": s["minDt"], "min_dt_m1": s["minDt_m1"]},
            "box": {"lo": [-r] * 3, "hi": [r] * 3, "periodic": [True] * 3}}
