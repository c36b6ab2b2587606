"""Host-side driver of the port (sphexa_tpu/simulation.py, the std and VE
propagators on one card): static neighbour-config sizing, the gravity
tree and its caps, the step loop with the overflow contract, the
persistent-list lifecycle, and the energy-drift diagnostic."""

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.gravity.traversal import (
    GRAV_BUCKET, GravityConfig, estimate_gravity_caps, gravity_tuning,
)
from sphexa_torch.gravity.tree import linkage_from_leaves
from sphexa_torch.neighbors.cell_list import (
    NeighborConfig, choose_grid_level, pad_cap, window_cells,
)
from sphexa_torch.observables.conserved import conserved_quantities
from sphexa_torch.propagator import (
    PropagatorConfig, _step_hydro_std, _step_hydro_ve, rebuild_pair_lists,
)
from sphexa_torch.parallel.sizing import leaf_array_from_device_keys
from sphexa_torch.sfc.box import BoundaryType, Box, make_global_box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph.pair_engine import engine_fold
from sphexa_torch.sph.pair_lists import estimate_slot_cap
from sphexa_torch.sph.particles import ParticleState, SimConstants

#: engine defaults of make_propagator_config (simulation.py:142-143)
_DEFAULTS = {"cell_target": 128, "run_cap": 1536, "gap": 384, "group": 64,
             "list_skin_rel": 0.2}

#: the ported propagators' step functions
_STEPS = {"std": _step_hydro_std, "ve": _step_hydro_ve}


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
    use_lists: bool = False,
    list_skin_rel: Optional[float] = None,
    list_slot_margin: float = 1.3,
    sizing_cache=None,
) -> PropagatorConfig:
    """Size the static neighbour config from the current particles, as the
    JAX function does for its pallas backend (the other backends are not
    ported): grid level from h_max and the mean cell occupancy, cap from
    the densest cell, window from the widest SFC group. The host sizing
    pass (native C++ in the JAX package) is numpy here: keys, a stable
    argsort, the densest cell and the group extents.

    ``use_lists``: size the persistent lists too. The window then also
    covers the skin, (4 h_max + skin) * 1.1; the slot budget comes from
    the sizing pass's own sorted keys. Where the grid is in fold mode
    (before or after the wider window) lists are unavailable: the
    un-inflated window stays and ``list_slot_cap`` stays 0."""
    cell_target = cell_target or _DEFAULTS["cell_target"]
    run_cap = _DEFAULTS["run_cap"] if run_cap is None else run_cap
    gap = _DEFAULTS["gap"] if gap is None else gap
    group = group or _DEFAULTS["group"]
    if list_skin_rel is None:
        list_skin_rel = _DEFAULTS["list_skin_rel"]

    lengths = box.lengths.cpu().numpy()
    h_max = float(state.h.max().item())
    level = choose_grid_level(lengths, h_max)
    level_occ = max(1, round(np.log2(max(state.n / float(cell_target), 1.0)) / 3.0))
    level = min(level, level_occ)

    if sizing_cache is None:
        keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve).cpu().numpy()
        order = np.argsort(keys, kind="stable")
    else:
        keys, order = (a.cpu().numpy() for a in sizing_cache)
    cap = pad_cap(_max_cell_occupancy(keys[order], level))
    if min_cap > 0:
        cap = max(cap, pad_cap(min_cap))
    ncell = 1 << level
    xa, ya, za = (a.cpu().numpy() for a in (state.x, state.y, state.z))
    ext = _group_extents(xa, ya, za, order, group)

    def make_nbr(radius):
        window = 1
        for e, edge in zip(ext, lengths / ncell):
            window = max(window, window_cells(e, radius, float(edge), ncell,
                                              margin_cells=0))
        return NeighborConfig(level=level, cap=cap, curve=curve, group=group,
                              window=window, run_cap=run_cap, gap=gap)

    # 10% radius slack absorbs drift between reconfigurations
    nbr = make_nbr(4.0 * h_max * 1.1)
    slot_cap = 0
    skin = list_skin_rel * 2.0 * h_max
    if use_lists and not engine_fold(box, nbr):
        # in list mode the window must also cover the skin
        nbr = make_nbr((4.0 * h_max + skin) * 1.1)
        if engine_fold(box, nbr):
            nbr = make_nbr(4.0 * h_max * 1.1)
        else:
            # the sizing pass's sorted arrays, back on the state's device
            dev = state.x.device
            sx, sy, sz, sh, skeys = (torch.as_tensor(a[order], device=dev) for a in
                                     (xa, ya, za, state.h.cpu().numpy(), keys))
            slot_cap = estimate_slot_cap(sx, sy, sz, sh, skeys, box, nbr, skin,
                                         margin=list_slot_margin)
    return PropagatorConfig(const=const, nbr=nbr, curve=curve,
                            list_slot_cap=slot_cap, list_skin_rel=list_skin_rel)


class Simulation:
    """Owns the state and the static config; re-sizes the config when a
    step reports a cell-cap or window overflow (and replays that step from
    its input) or when the grid no longer covers the 2h radius.

    ``use_lists`` (the default, as in the JAX package): steady steps run
    on persistent neighbour lists, built on the first step and rebuilt
    when their skin runs low (proactively, below ``_LIST_SLACK_REBUILD``)
    or has run out (the step is then discarded and replayed on fresh
    lists). Where lists are unavailable (a grid in fold mode leaves
    ``list_slot_cap`` at 0) the steps stream, as with ``use_lists=False``;
    each step's ``use_lists`` diagnostic says which ran.

    ``prop``: "std" or "ve" (``av_clean`` adds the VE viscosity's
    velocity-gradient correction); the list lifecycle and the overflow
    contract are the same for both. ``device=None`` runs on the CUDA
    device and raises without one; ``device="cpu"`` runs the plain
    PyTorch versions of the kernels.

    Self-gravity is on when ``const.g != 0`` (open boxes only: a periodic
    box would need Ewald gravity, which is not ported). Each
    (re)configuration then builds the gravity tree from the particles'
    keys and sizes its caps, with the JAX package's default opening
    angle, bucket and cap margin; the steps sort every time (no lists). A step
    whose interaction lists or leaves outgrow their caps is discarded, the
    caps re-sized with a 1.5x larger margin, and the step replayed."""

    # rebuild proactively below this remaining-skin fraction: the next
    # step would likely expire and be discarded
    _LIST_SLACK_REBUILD = 0.25

    def __init__(self, state: ParticleState, box: Box, const: SimConstants,
                 prop: str = "std", device=None, curve: str = "hilbert",
                 cell_target: Optional[int] = None, use_lists: bool = True,
                 list_skin_rel: Optional[float] = None, av_clean: bool = False):
        if prop not in _STEPS:
            raise NotImplementedError(f"--prop {prop!r}: not ported yet")
        self.gravity_on = const.g != 0.0
        if self.gravity_on and any(b == BoundaryType.periodic for b in box.boundaries):
            raise NotImplementedError(
                "Ewald gravity not ported: self-gravity needs an open box")
        self._gtree = None
        self.grav_configure_seconds = 0.0  # the last tree build and cap sizing
        self.av_clean = av_clean
        self._step_fn = _STEPS[prop]
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self.box = box.to(self.device)
        self.const = const
        self.curve = curve
        self.cell_target = cell_target
        self.iteration = 0
        self.reconfigures = 0  # re-sizes after the initial one
        self.replays = 0  # steps discarded (overflow or stale lists) and run again
        self.rebuilds = 0  # list builds (mark passes), the first one included
        self.energy_drift: Optional[float] = None
        self._etot0: Optional[float] = None
        self.last_step_seconds = 0.0
        # the gravity tree is built from fresh keys: gravity steps sort
        self._want_lists = use_lists and not self.gravity_on
        self._list_skin_rel = list_skin_rel
        self._slot_margin = 1.3
        self._lists = None
        self._configure()

    @property
    def cfg(self) -> PropagatorConfig:
        return self._cfg

    @property
    def lists(self):
        """The current persistent lists (None while streaming or before
        the first build)."""
        return self._lists

    def _configure(self, min_cap: int = 0, grav_margin: float = 1.5) -> None:
        self._lists = None  # any re-size invalidates the lists
        sizing_cache = None
        if self.gravity_on:
            # one keygen + stable argsort, shared by the grid sizing and
            # the tree build; keys against the regrown box (equal to the
            # box until particles leave it)
            s = self.state
            gbox = make_global_box(s.x, s.y, s.z, self.box)
            keys = compute_sfc_keys(s.x, s.y, s.z, gbox, curve=self.curve)
            sizing_cache = (keys, torch.argsort(keys, stable=True))
        cfg = make_propagator_config(
            self.state, self.box, self.const, curve=self.curve,
            min_cap=min_cap, cell_target=self.cell_target,
            use_lists=self._want_lists, list_skin_rel=self._list_skin_rel,
            list_slot_margin=self._slot_margin, sizing_cache=sizing_cache)
        self._cfg = dataclasses.replace(cfg, av_clean=self.av_clean)
        if self.gravity_on:
            self._configure_gravity(grav_margin, sizing_cache)

    def _configure_gravity(self, margin: float, keys_cache) -> None:
        """(Re)build the gravity tree from the particles' keys and size
        the interaction-list caps (simulation.py _configure_gravity): the
        leaf array from device histograms (only O(8^level) counts reach
        the host), the linkage on the host, the caps from a sampled
        classification; the multipoles of every step follow the tree."""
        t0 = time.perf_counter()
        s = self.state
        keys, order = keys_cache
        leaf_tree = leaf_array_from_device_keys(keys, bucket_size=GRAV_BUCKET)
        gtree, meta = linkage_from_leaves(leaf_tree, curve=self.curve, device=self.device)
        xs, ys, zs, ms = s.x[order], s.y[order], s.z[order], s.m[order]
        gcfg = estimate_gravity_caps(
            xs, ys, zs, ms, keys[order], self.box, gtree, meta,
            GravityConfig(G=self.const.g, **gravity_tuning(s.n)),
            margin=margin)
        self._gtree = gtree
        self._cfg = dataclasses.replace(self._cfg, gravity=gcfg, grav_meta=meta)
        self.grav_configure_seconds = time.perf_counter() - t0

    @property
    def gtree(self):
        """The gravity tree of the current configuration (None without
        gravity)."""
        return self._gtree

    def _gravity_overflowed(self, host: Dict[str, float]) -> bool:
        """An interaction list, a leaf or a superblock list outgrew its cap."""
        if not self.gravity_on:
            return False
        g = self._cfg.gravity
        return (host["m2p_max"] > g.m2p_cap or host["p2p_max"] > g.p2p_cap
                or host["leaf_occ"] > g.leaf_cap or host["c_max"] > g.super_cap)

    @property
    def _use_lists(self) -> bool:
        return self._want_lists and self._cfg.list_slot_cap > 0

    def _rebuild_lists(self) -> None:
        """(Re)build the lists: regrow, sort, mark. Host reads: the
        overflow sentinel, and on the card the size of the list walk's
        mask-word buffer; a slot overflow grows the slot margin 1.5x and
        re-sizes, at most three times."""
        for _ in range(3):
            if not self._use_lists:
                return  # a re-size left the grid without lists: stream
            state, box, lists = rebuild_pair_lists(self.state, self.box, self._cfg)
            self.rebuilds += 1
            if not int(lists.overflow):
                self.state, self.box, self._lists = state, box, lists
                return
            self._slot_margin *= 1.5
            self._configure()
            self.reconfigures += 1
        raise RuntimeError("pair-list slot cap failed to converge")

    def _config_still_valid(self, h_max: float, min_length: float) -> bool:
        return 2.0 * h_max <= min_length / (1 << self._cfg.nbr.level)

    def step(self) -> Dict[str, float]:
        """Advance one step. A step whose occupancy exceeds the cap (a
        truncated cell, or ``cap + 1`` for a blown window) is discarded,
        the config re-sized, and the step replayed from its saved input;
        a list-mode step whose lists no longer cover its input
        (``list_ok`` 0) is discarded and replayed on rebuilt lists. The
        host reads the device once per attempt, after its last kernel: the
        diagnostics, the conserved sums and the box edge in one copy. With
        gravity a step whose lists or leaves outgrow the caps is discarded
        too, and the caps re-sized with a 1.5x larger margin."""
        t0 = time.perf_counter()
        grav_margin = 1.5
        for _attempt in range(4):
            if self._use_lists and self._lists is None:
                self._rebuild_lists()
            lists = self._lists if self._use_lists else None
            new_state, new_box, diag = self._step_fn(self.state, self.box, self._cfg,
                                                     self._gtree, lists=lists)
            cq = conserved_quantities(new_state, self.const, egrav=diag.get("egrav"))
            named = {**diag, **cq, "min_length": new_box.lengths.min()}
            host = dict(zip(named, torch.stack(
                [v.to(torch.float64) for v in named.values()]).tolist()))
            occ = int(host["occupancy"])
            cap = self._cfg.nbr.cap
            if lists is not None and not int(host["list_ok"]):
                # stale lists: rebuild them (no re-size) and replay
                self._rebuild_lists()
                self.replays += 1
                continue
            grav_over = self._gravity_overflowed(host)
            if occ <= cap and not grav_over:
                break
            if grav_over:
                grav_margin *= 1.5
            # cap + 1 is the window sentinel, not a real occupancy: a plain
            # re-size grows the window instead of ratcheting the cap
            self._configure(min_cap=0 if occ == cap + 1 or occ <= cap else occ,
                            grav_margin=grav_margin)
            self.reconfigures += 1
            self.replays += 1
        else:
            raise RuntimeError("neighbour/gravity caps failed to converge in 4 attempts")
        self.state, self.box = new_state, new_box
        self.iteration += 1

        min_length = host.pop("min_length")
        result = host
        if self._etot0 is None and np.isfinite(result["etot"]):
            self._etot0 = result["etot"]
        if self._etot0 is not None:
            self.energy_drift = abs(result["etot"] - self._etot0) / (abs(self._etot0) or 1.0)
        result["energy_drift"] = self.energy_drift
        result["use_lists"] = float(lists is not None)
        result["reconfigured"] = 0.0
        # the config check first: a re-size drops the lists, so a
        # proactive rebuild before it would be wasted
        if not self._config_still_valid(result["h_max"], min_length):
            self._configure()
            self.reconfigures += 1
            result["reconfigured"] = 1.0
        elif lists is not None and result["list_slack"] < self._LIST_SLACK_REBUILD:
            self._rebuild_lists()
        self.last_step_seconds = time.perf_counter() - t0
        return result

    def run(self, num_steps: int, printer=None):
        """Advance ``num_steps`` steps; returns the last step's diagnostics."""
        d = {}
        for _ in range(num_steps):
            d = self.step()
            if printer is not None:
                printer(self.iteration, d)
        return d
