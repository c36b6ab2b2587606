"""Evrard collapse (SPH-EXA evrard_init.hpp, EvrardGlassSphere): a cold
gas sphere of radius r with rho ~ 1/r in an open box. The side**3
lattice over [-r, r]^3 is jittered by up to ``jitter`` spacings per
coordinate (uniform; the stand-in for the glass block), cut to the sphere and contracted by sqrt(radius) to the 1/r profile; h
follows the local concentration c(r) = c0 / r.

The lattice's jitter comes from the configuration's fixed
``lattice_seed``, so that every run holds the same particles and the
solver the same work (a jitter drawn from the run's seed moved the
sampled gravity caps, and with them the step time, by up to 12%); the
run's seed permutes the order the particles are handed over in."""

import numpy as np

from benchmark.inits import rng

R_GAS = 8.317e7  # sph/eos.hpp


def make(cfg: dict, seed: int) -> dict:
    s = cfg["settings"]
    side = int(cfg["side"])
    r = float(s["r"])
    step = 2.0 * r / side
    line = -r + step * (0.5 + np.arange(side))
    zz, yy, xx = np.meshgrid(line, line, line, indexing="ij")
    g = np.random.default_rng(int(cfg["assumed"]["lattice_seed"]))
    jit = float(cfg["assumed"]["jitter"])
    pos = []
    for grid in (xx, yy, zz):
        delta = g.uniform(-jit, jit, size=grid.size) * step
        pos.append(-r + np.mod(grid.ravel() + delta + r, 2 * r))
    x, y, z = pos
    keep = x * x + y * y + z * z <= r * r
    x, y, z = x[keep], y[keep], z[keep]
    n = x.shape[0]
    c = np.sqrt(np.sqrt(x * x + y * y + z * z))
    x, y, z = x * c, y * c, z * c
    c0 = 2.0 / 3.0 * n / (4.0 * np.pi / 3.0 * r**3)
    radius = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-10)
    h = np.cbrt(3.0 / (4 * np.pi) * s["ng0"] * radius / c0) * 0.5
    cv = R_GAS / s["mui"] / (s["gamma"] - 1.0)
    order = rng(seed, "init").permutation(n)
    x, y, z, h = x[order], y[order], z[order], h[order]
    zeros = np.zeros(n, np.float32)
    fields = {"x": x.astype(np.float32), "y": y.astype(np.float32),
              "z": z.astype(np.float32), "vx": zeros, "vy": zeros, "vz": zeros,
              "h": h.astype(np.float32), "m": np.full(n, s["mTotal"] / n, np.float32),
              "temp": np.full(n, s["u0"] / cv, np.float32),
              "alpha": np.full(n, cfg["constants"]["alphamin"], np.float32)}
    return {"fields": fields,
            "scalars": {"min_dt": s["minDt"], "min_dt_m1": s["minDt_m1"]},
            "box": {"lo": [-r] * 3, "hi": [r] * 3, "periodic": [False] * 3}}
