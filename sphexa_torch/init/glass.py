"""Particle-lattice helpers for initial conditions (sphexa_tpu/init/
glass.py): a lattice with seeded sub-spacing jitter, which breaks the grid
axes' alignment as a relaxed glass would, the sphere cut, the rho ~ 1/r
contraction, the capped-pyramid stretch of the isobaric cube, and the
glass templates: a relaxed block made by damped std-SPH steps on the
port's own Simulation, written to and read from HDF5 and tiled into any
cuboid. A template installed with ``set_glass_template`` (the CLI's
``--glass``) replaces the jittered lattice in every case, as the
reference's glass blocks do. The fields are numpy float64 throughout."""

import dataclasses
from typing import Tuple

import numpy as np

#: the installed template (x, y, z in [0, 1)^3), or None: this module's
#: own, independent of the JAX package's
_ACTIVE_TEMPLATE = None


def jittered_lattice(lo, hi, counts, seed: int = 42, jitter: float = 0.2
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Jittered lattice of ``counts=(nx, ny, nz)`` points spanning the
    cuboid [lo, hi): cell centres moved by up to ``jitter`` spacings (numpy
    generator ``seed``) and wrapped into the cuboid; float64 (x, y, z).
    With a glass template installed, the template tiled instead."""
    if _ACTIVE_TEMPLATE is not None:
        return assemble_glass_cuboid(_ACTIVE_TEMPLATE, lo, hi, counts)
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    steps = (hi - lo) / np.asarray(counts, np.float64)
    lines = [lo[d] + steps[d] * (0.5 + np.arange(counts[d])) for d in range(3)]
    zz, yy, xx = np.meshgrid(lines[2], lines[1], lines[0], indexing="ij")
    n = int(np.prod(counts))
    out = []
    for d, grid in enumerate((xx, yy, zz)):
        delta = rng.uniform(-jitter, jitter, size=n) * steps[d]
        out.append(lo[d] + np.mod(grid.ravel() + delta - lo[d], hi[d] - lo[d]))
    return out[0], out[1], out[2]


def cut_sphere(r: float, x, y, z, center=None):
    """Keep only the particles inside radius r (grid.hpp cutSphere)."""
    if center is None:
        center = (0.0, 0.0, 0.0)
    keep = (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2 <= r * r
    return x[keep], y[keep], z[keep]


def contract_rho_profile(x, y, z):
    """Multiply coordinates by sqrt(r): uniform sphere -> rho ~ 1/r
    profile (evrard_init.hpp contractRhoProfile)."""
    c = np.sqrt(np.sqrt(x * x + y * y + z * z))
    return x * c, y * c, z * c


def compute_stretch_factor(r_int: float, r_ext: float, rho_ratio: float) -> float:
    """Radius s such that contracting [-s, s]^3 into the inner cube and
    expanding the rest gives the density ratio rho_ratio (grid.hpp:399-409)."""
    hc = r_int**3
    rc = r_ext**3
    s = np.cbrt(rho_ratio * hc * rc / (rc - hc + rho_ratio * hc))
    if not r_int < s < r_ext:
        raise ValueError(f"stretch factor {s} outside ({r_int}, {r_ext})")
    return float(s)


def capped_pyramid_stretch(x, y, z, r_int: float, s: float, r_ext: float):
    """Scale factor moving outer-shell points toward the origin at
    constant density (grid.hpp:334-378), for points with max|coord| > s
    (the caller masks the others)."""
    ax = np.stack([np.abs(x), np.abs(y), np.abs(z)])
    mx = np.maximum(ax.max(axis=0), 1e-30)
    radius = np.sqrt((ax**2).sum(axis=0))
    # the ray's distances to the outer, stretch and inner cubes
    rp = radius * (r_ext / mx)
    sp = radius * (s / mx)
    hp = radius * (r_int / mx)
    expo = 0.75
    a = (rp - hp) / np.power(np.maximum(rp - sp, 1e-30), expo)
    new_radius = a * np.power(np.maximum(radius - sp, 0.0), expo) + hp
    return new_radius / radius


def compress_center_cube(x, y, z, r_int: float, s: float, r_ext: float, eps=0.0):
    """A dense centre cube: [-s, s]^3 contracted by r_int / s and the
    shell around it pulled inward (isobaric_cube_init.hpp:129-152)."""
    inner = (np.abs(x) - s <= eps) & (np.abs(y) - s <= eps) & (np.abs(z) - s <= eps)
    scale = np.where(inner, r_int / s, capped_pyramid_stretch(x, y, z, r_int, s, r_ext))
    return x * scale, y * scale, z * scale


def generate_glass_template(side: int = 16, relax_steps: int = 40, seed: int = 7,
                            device=None):
    """A relaxed glass block in [0, 1)^3: the periodic Sedov lattice at
    uniform energy, stepped by the std pipeline (streaming) on the port's
    Simulation with the velocities, the energy rate and the temperature
    reset after every step, so that only the pressure gradients of the
    density fluctuations move the particles. ``seed`` is unused (the
    lattice is regular), as in the JAX package. Runs on ``device`` (None:
    the card). Returns numpy float64 (x, y, z)."""
    import torch

    from sphexa_torch.init.sedov import init_sedov
    from sphexa_torch.simulation import Simulation

    del seed
    state, box, const = init_sedov(side, device=device)
    state = dataclasses.replace(state, temp=torch.ones_like(state.temp),
                                du=torch.zeros_like(state.du),
                                du_m1=torch.zeros_like(state.du_m1))
    sim = Simulation(state, box, const, prop="std", device=device, use_lists=False)
    for _ in range(relax_steps):
        sim.step()
        s = sim.state
        z3 = torch.zeros_like(s.vx)
        sim.state = dataclasses.replace(s, vx=z3, vy=z3.clone(), vz=z3.clone(),
                                        temp=torch.ones_like(s.temp), du=z3.clone(),
                                        du_m1=z3.clone())
    lo = sim.box.lo.cpu().numpy().astype(np.float64)
    lengths = sim.box.lengths.cpu().numpy().astype(np.float64)
    return tuple((getattr(sim.state, f).cpu().numpy() - lo[d]) / lengths[d] % 1.0
                 for d, f in enumerate("xyz"))


def _h5py():
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py unavailable: glass templates are HDF5 files") from None
    return h5py


def write_template_block(path: str, x, y, z) -> None:
    """Save a template block to HDF5 (root datasets x, y, z in float64),
    readable by ``read_template_block`` and the reference's readTemplateBlock."""
    with _h5py().File(path, "w") as f:
        for name, v in (("x", x), ("y", y), ("z", z)):
            f.create_dataset(name, data=np.asarray(v, np.float64))


def read_template_block(path: str):
    """The x, y, z of a template file (a dump's last Step#n group, or root
    datasets), each mapped into [0, 1)^3 with a half-spacing margin, so
    that tiled copies meet no coincident points at the tile faces
    (readTemplateBlock, utils.hpp:73-86)."""
    with _h5py().File(path, "r") as f:
        steps = sorted((k for k in f.keys() if k.startswith("Step#")),
                       key=lambda k: int(k.split("#")[1]))
        g = f[steps[-1]] if steps else f
        coords = [np.asarray(g[c], np.float64) for c in "xyz"]
    out = []
    for v in coords:
        lo, hi = v.min(), v.max()
        extent = max(hi - lo, 1e-30)
        n_lin = max(len(v) ** (1.0 / 3.0), 2.0)
        out.append((v - lo) / extent * (1.0 - 1.0 / n_lin) + 0.5 / n_lin)
    return tuple(out)


def set_glass_template(path) -> None:
    """Install the template read from ``path`` for ``jittered_lattice``,
    or clear it with None."""
    global _ACTIVE_TEMPLATE
    _ACTIVE_TEMPLATE = read_template_block(path) if path else None


def assemble_glass_cuboid(template, lo, hi, counts):
    """Tile the normalized template into [lo, hi), its multiplicity per
    dimension the nearest to ``counts`` over the template's linear size
    (assembleCuboid, grid.hpp:201; noh_init.hpp:127-129)."""
    tx, ty, tz = template
    b_lin = max(len(tx) ** (1.0 / 3.0), 1.0)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    mx, my, mz = (max(1, int(np.rint(c / b_lin))) for c in counts)
    ox = np.arange(mx)[:, None, None, None]
    oy = np.arange(my)[None, :, None, None]
    oz = np.arange(mz)[None, None, :, None]
    X = lo[0] + (tx[None, None, None, :] + ox) * ((hi[0] - lo[0]) / mx)
    Y = lo[1] + (ty[None, None, None, :] + oy) * ((hi[1] - lo[1]) / my)
    Z = lo[2] + (tz[None, None, None, :] + oz) * ((hi[2] - lo[2]) / mz)
    X, Y, Z = np.broadcast_arrays(X, Y, Z)
    return tuple(np.ascontiguousarray(a.ravel()) for a in (X, Y, Z))
