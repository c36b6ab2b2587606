"""The std-SPH step (sphexa_tpu/propagator.py, the streaming pallas path).

One step: box regrow -> SFC keys -> stable sort -> candidate-run prologue
-> density -> EOS -> IAD -> momentum/energy -> timestep -> positions and
h update. PyTorch runs it eagerly; the three pair ops launch the CUDA
kernels on the card and their plain versions on the CPU.
"""

import dataclasses
from typing import Dict, Tuple

import torch

from sphexa_torch.neighbors.cell_list import NeighborConfig
from sphexa_torch.sfc.box import Box, make_global_box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.kernels import update_h
from sphexa_torch.sph.particles import PARTICLE_FIELDS, ParticleState, SimConstants
from sphexa_torch.sph.positions import compute_positions
from sphexa_torch.sph.timestep import compute_timestep

#: ``diagnostics["dt_limiter"]`` indexes this tuple
DT_LIMITERS = ("growth", "courant", "rho", "cool", "accel")


@dataclasses.dataclass(frozen=True)
class PropagatorConfig:
    """Static per-run configuration: physics constants and the neighbour
    search (the fields of the JAX PropagatorConfig this slice reads; the
    backend is always the fused search+op kernels)."""

    const: SimConstants
    nbr: NeighborConfig
    curve: str = "hilbert"


def _dt_limiter(min_dt_prev, const: SimConstants, courant=None, rho=None,
                cool=None, accel=None) -> torch.Tensor:
    """Index into DT_LIMITERS of the binding dt candidate (ties resolve to
    the earlier name, like argmin)."""
    dev = min_dt_prev.device
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    cands = [const.max_dt_increase * min_dt_prev, courant, rho, cool, accel]
    stack = torch.stack([inf if c is None else torch.as_tensor(c, dtype=torch.float32,
                                                               device=dev)
                         for c in cands])
    return torch.argmin(stack).to(torch.int32)


def _sort_by_keys(state: ParticleState, box: Box, curve: str):
    """Global SFC sort: keys, a stable argsort (jnp.argsort is stable), and
    a row gather of the per-particle fields stacked into one (n, F) matrix
    (the JAX package's permute_tree). Returns (state, sorted_keys, order)."""
    keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve)
    order = torch.argsort(keys, stable=True)
    mat = torch.stack([getattr(state, f) for f in PARTICLE_FIELDS], dim=1)
    mat = mat.index_select(0, order)
    fields = {f: mat[:, k].contiguous() for k, f in enumerate(PARTICLE_FIELDS)}
    new = dataclasses.replace(state, **fields)
    return new, keys[order], order


def _force_stage_prologue(state: ParticleState, box: Box, cfg: PropagatorConfig):
    """Box regrow + global sort. Returns (state, box, sorted_keys)."""
    box = make_global_box(state.x, state.y, state.z, box)
    state, keys, _ = _sort_by_keys(state, box, cfg.curve)
    return state, box, keys


def _std_forces(state: ParticleState, box: Box, cfg: PropagatorConfig):
    """The std-SPH force stage: sort -> prologue -> density -> EOS -> IAD ->
    momentum/energy. Returns (state, box, ax, ay, az, du, dt_courant, nc,
    occ, rho, c)."""
    const = cfg.const
    state, box, keys = _force_stage_prologue(state, box, cfg)
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    ranges = pe.group_cell_ranges(x, y, z, h, keys, box, cfg.nbr)
    rho, nc, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, cfg.nbr,
                                   ranges=ranges)
    p, c = compute_eos_std(state.temp, rho, const)
    (c11, c12, c13, c22, c23, c33), _ = pe.pallas_iad(
        x, y, z, h, m / rho, keys, box, const, cfg.nbr, ranges=ranges)
    ax, ay, az, du, dt_courant, _ = pe.pallas_momentum_energy_std(
        x, y, z, state.vx, state.vy, state.vz, h, m, rho, p, c,
        c11, c12, c13, c22, c23, c33, keys, box, const, cfg.nbr, ranges=ranges)
    return (state, box, ax, ay, az, du, dt_courant, nc, ranges.occupancy,
            rho, c)


def _integrate_and_finish(state: ParticleState, box: Box, cfg: PropagatorConfig,
                          ax, ay, az, du, dt, nc, occ, rho, dt_limiter=None
                          ) -> Tuple[ParticleState, Box, Dict[str, torch.Tensor]]:
    """Drift/kick + PBC wrap, smoothing-length nudge, diagnostics."""
    const = cfg.const
    fields = (state.x, state.y, state.z, state.x_m1, state.y_m1, state.z_m1,
              state.vx, state.vy, state.vz, state.h, state.temp, state.temp_lo,
              du, state.du_m1)
    (nx, ny, nz, dxm, dym, dzm, vx, vy, vz, h, temp, temp_lo, du,
     du_m1) = compute_positions(fields, ax, ay, az, dt, state.min_dt, box, const)
    new_h = update_h(const.ng0, nc + 1, h)
    new_state = dataclasses.replace(
        state, x=nx, y=ny, z=nz, x_m1=dxm, y_m1=dym, z_m1=dzm,
        vx=vx, vy=vy, vz=vz, h=new_h, temp=temp, temp_lo=temp_lo,
        du=du, du_m1=du_m1,
        ttot=state.ttot + dt, min_dt=dt, min_dt_m1=state.min_dt,
    )
    diagnostics = {
        "dt": dt,
        "nc_mean": torch.mean(nc.to(torch.float32)) + 1.0,
        "nc_max": torch.max(nc) + 1,
        "occupancy": occ,
        "rho_max": torch.max(rho),
        "h_max": torch.max(new_h),
    }
    if dt_limiter is not None:
        diagnostics["dt_limiter"] = dt_limiter
    return new_state, box, diagnostics


def _step_hydro_std(state: ParticleState, box: Box, cfg: PropagatorConfig):
    """One standard-SPH time step (std_hydro.hpp:123-175 sequence).
    Returns (new_state, new_box, diagnostics)."""
    (state, box, ax, ay, az, du, dt_courant, nc, occ, rho,
     _c) = _std_forces(state, box, cfg)
    dt = compute_timestep(state.min_dt, dt_courant, const=cfg.const)
    limiter = _dt_limiter(state.min_dt, cfg.const, courant=dt_courant)
    return _integrate_and_finish(state, box, cfg, ax, ay, az, du, dt, nc, occ,
                                 rho, dt_limiter=limiter)

