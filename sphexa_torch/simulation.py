"""Host-side driver of the port (sphexa_tpu/simulation.py, the std subset):
static neighbour-config sizing, the step loop with the overflow contract,
and the energy-drift diagnostic."""

import time
from typing import Dict, Optional

import numpy as np
import torch

from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.neighbors.cell_list import (
    NeighborConfig, choose_grid_level, pad_cap, window_cells,
)
from sphexa_torch.observables.conserved import conserved_quantities
from sphexa_torch.propagator import PropagatorConfig, _step_hydro_std
from sphexa_torch.sfc.box import Box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph.particles import ParticleState, SimConstants

#: engine defaults of make_propagator_config (simulation.py:142-143)
_DEFAULTS = {"cell_target": 128, "run_cap": 1536, "gap": 384, "group": 64}


def _max_cell_occupancy(sorted_keys: np.ndarray, level: int) -> int:
    """Densest level-``level`` cell of sorted keys (a run-length count)."""
    if len(sorted_keys) == 0:
        return 0
    cells = sorted_keys >> (3 * (KEY_BITS - level))
    bounds = np.flatnonzero(np.diff(cells)) + 1
    runs = np.diff(np.concatenate([[0], bounds, [len(cells)]]))
    return int(runs.max())


def _group_extents(x, y, z, order: np.ndarray, group: int):
    """Max per-dimension float32 extent over SFC-consecutive groups."""
    n = len(x)
    ng = -(-n // group)
    pad = ng * group - n
    out = []
    for a in (x, y, z):
        s = a[order]
        if pad:
            s = np.concatenate([s, np.repeat(s[-1], pad)])
        g = s.reshape(ng, group)
        out.append(float((g.max(axis=1) - g.min(axis=1)).max()))
    return tuple(out)


def make_propagator_config(
    state: ParticleState, box: Box, const: SimConstants,
    curve: str = "hilbert", min_cap: int = 0,
    cell_target: Optional[int] = None,
    run_cap: Optional[int] = None, gap: Optional[int] = None,
    group: Optional[int] = None,
) -> PropagatorConfig:
    """Size the static neighbour config from the current particles, as the
    JAX function does for its streaming pallas backend (``use_lists=False``;
    the other backends are not ported): grid level from h_max and the mean
    cell occupancy, cap from the densest cell, window from the widest SFC
    group. The host sizing pass (native C++ in the JAX package) is numpy
    here: keys, a stable argsort, the densest cell and the group extents."""
    cell_target = cell_target or _DEFAULTS["cell_target"]
    run_cap = _DEFAULTS["run_cap"] if run_cap is None else run_cap
    gap = _DEFAULTS["gap"] if gap is None else gap
    group = group or _DEFAULTS["group"]

    lengths = box.lengths.cpu().numpy()
    h_max = float(state.h.max().item())
    level = choose_grid_level(lengths, h_max)
    level_occ = max(1, round(np.log2(max(state.n / float(cell_target), 1.0)) / 3.0))
    level = min(level, level_occ)

    keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve).cpu().numpy()
    order = np.argsort(keys, kind="stable")
    cap = pad_cap(_max_cell_occupancy(keys[order], level))
    if min_cap > 0:
        cap = max(cap, pad_cap(min_cap))
    ncell = 1 << level
    ext = _group_extents(state.x.cpu().numpy(), state.y.cpu().numpy(),
                         state.z.cpu().numpy(), order, group)

    # 10% radius slack absorbs drift between reconfigurations
    radius = 4.0 * h_max * 1.1
    window = 1
    for e, edge in zip(ext, lengths / ncell):
        window = max(window, window_cells(e, radius, float(edge), ncell,
                                          margin_cells=0))
    nbr = NeighborConfig(level=level, cap=cap, curve=curve, group=group,
                         window=window, run_cap=run_cap, gap=gap)
    return PropagatorConfig(const=const, nbr=nbr, curve=curve)


class Simulation:
    """Owns the state and the static config; re-sizes the config when a
    step reports a cell-cap or window overflow (and replays that step from
    its input) or when the grid no longer covers the 2h radius.

    ``device=None`` runs on the CUDA device and raises without one;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels."""

    def __init__(self, state: ParticleState, box: Box, const: SimConstants,
                 prop: str = "std", device=None, curve: str = "hilbert",
                 cell_target: Optional[int] = None):
        if prop != "std":
            raise NotImplementedError(f"--prop {prop!r}: not ported yet")
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self.box = box.to(self.device)
        self.const = const
        self.curve = curve
        self.cell_target = cell_target
        self.iteration = 0
        self.reconfigures = 0  # re-sizes after the initial one
        self.replays = 0  # steps discarded for an overflow and run again
        self.energy_drift: Optional[float] = None
        self._etot0: Optional[float] = None
        self.last_step_seconds = 0.0
        self._configure()

    @property
    def cfg(self) -> PropagatorConfig:
        return self._cfg

    def _configure(self, min_cap: int = 0) -> None:
        self._cfg = make_propagator_config(
            self.state, self.box, self.const, curve=self.curve,
            min_cap=min_cap, cell_target=self.cell_target)

    def _config_still_valid(self, h_max: float, min_length: float) -> bool:
        return 2.0 * h_max <= min_length / (1 << self._cfg.nbr.level)

    def step(self) -> Dict[str, float]:
        """Advance one step; a step whose occupancy exceeds the cap (a
        truncated cell, or ``cap + 1`` for a blown window) is discarded,
        the config re-sized, and the step replayed from its saved input.
        The host reads the device once per attempt, after its last kernel:
        the diagnostics, the conserved sums and the box edge in one copy."""
        t0 = time.perf_counter()
        for _attempt in range(4):
            new_state, new_box, diag = _step_hydro_std(self.state, self.box, self._cfg)
            cq = conserved_quantities(new_state, self.const)
            named = {**diag, **cq, "min_length": new_box.lengths.min()}
            host = dict(zip(named, torch.stack(
                [v.to(torch.float64) for v in named.values()]).tolist()))
            occ = int(host["occupancy"])
            cap = self._cfg.nbr.cap
            if occ <= cap:
                break
            # cap + 1 is the window sentinel, not a real occupancy: a plain
            # re-size grows the window instead of ratcheting the cap
            self._configure(min_cap=0 if occ == cap + 1 else occ)
            self.reconfigures += 1
            self.replays += 1
        else:
            raise RuntimeError("neighbour caps failed to converge in 4 attempts")
        self.state, self.box = new_state, new_box
        self.iteration += 1
        self.last_step_seconds = time.perf_counter() - t0

        min_length = host.pop("min_length")
        result = host
        if self._etot0 is None and np.isfinite(result["etot"]):
            self._etot0 = result["etot"]
        if self._etot0 is not None:
            self.energy_drift = abs(result["etot"] - self._etot0) / (abs(self._etot0) or 1.0)
        result["energy_drift"] = self.energy_drift
        result["reconfigured"] = 0.0
        if not self._config_still_valid(result["h_max"], min_length):
            self._configure()
            self.reconfigures += 1
            result["reconfigured"] = 1.0
        return result

    def run(self, num_steps: int, printer=None):
        """Advance ``num_steps`` steps; returns the last step's diagnostics."""
        d = {}
        for _ in range(num_steps):
            d = self.step()
            if printer is not None:
                printer(self.iteration, d)
        return d
