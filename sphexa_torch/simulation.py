"""Host-side driver of the port (sphexa_tpu/simulation.py, the std, VE,
turb-ve, std-cooling and N-body propagators and the std and VE block time
steps, on one card or across ranks, with or without self-gravity): static
neighbour-config sizing, the gravity tree and its caps (open-box or
Ewald periodic gravity), the step loop with the overflow contract,
deferred check windows with rollback and replay of the whole carry (the
stirring state and the chemistry included), the persistent-list
lifecycle, the science ledger's rows and watchdogs, the halo sizing of
the sharded steps and of the gravity near field with the escape
sentinels' regrow, and the driver's telemetry events."""

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.gravity.ewald import EwaldConfig, replica_shells
from sphexa_torch.gravity.traversal import (
    GRAV_BUCKET, M2P_CAP_MARGIN, THETA, GravityConfig, compute_multipoles_sharded,
    estimate_gravity_caps, gravity_tuning,
)
from sphexa_torch.gravity.tree import linkage_from_leaves
from sphexa_torch.init.turbulence import turbulence_constants
from sphexa_torch.neighbors.cell_list import (
    NeighborConfig, choose_grid_level, pad_cap, window_cells,
)
from sphexa_torch.physics.cooling import ChemistryData, CoolingConfig
from sphexa_torch.propagator import (
    BACKENDS, DT_LIMITERS, STEP_AUX_SLOT, PropagatorConfig, _step_hydro_std,
    _step_hydro_std_blockdt, _step_hydro_std_cooling, _step_hydro_ve, _step_hydro_ve_blockdt,
    _step_nbody, _step_turb_ve, exchange_fields_per_step, rebuild_pair_lists, step_sim_state,
)
from sphexa_torch.parallel import mesh as pmesh
from sphexa_torch.parallel.sizing import (
    device_gravity_halo, halo_sizes, leaf_array_from_device_keys, sizing_stats,
)
from sphexa_torch.parallel.sort import distributed_sort
from sphexa_torch.sfc.box import BoundaryType, Box, make_global_box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph.blockdt import make_blockdt_state
from sphexa_torch.sph.pair_engine import engine_fold
from sphexa_torch.sph.hydro_turb import create_stirring_modes
from sphexa_torch.sph.pair_lists import estimate_slot_cap
from sphexa_torch.sph.particles import ParticleState, SimConstants
from sphexa_torch.state import SimState
from sphexa_torch.telemetry import Telemetry, emit_memory_event
from sphexa_torch.util.phases import debug_checks as _debug_checks

#: array diagnostics that ride ``_launch``'s packed read as whole blocks
#: (observables/snapshot.py SNAP_DIAG_KEYS and the frame's box)
_ARRAY_KEYS = ("snap_grid", "snap_min", "snap_max", "snap_pts", "snap_lo", "snap_lengths")

#: defaults of make_propagator_config (simulation.py:142-143)
_DEFAULTS = {"block": 2048, "cell_target": 128, "run_cap": 1536, "gap": 384, "group": 64,
             "list_skin_rel": 0.2}


def resolve_backend(backend: str) -> str:
    """The force stages' backend from a name the JAX CLI accepts: "pallas"
    (the pair engine), "xla" (the gather path) or "auto", which is the
    engine on every device. (The JAX package's "auto" is its gather path
    wherever it is not on a TPU; the port keeps its engine.)"""
    if backend == "auto":
        return "pallas"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choices: auto, {', '.join(BACKENDS)}")
    return backend


#: tuned knobs the (re)configurations forward whole: the neighbour engine's
#: shape into make_propagator_config, the gravity solver's on top of
#: gravity_tuning (the JAX package's _NBR_FORWARDED / _GRAV_FORWARDED, less
#: blocks_per_chunk, which the port does not have)
_NBR_FORWARDED = ("cell_target", "run_cap", "gap", "group")
_GRAV_FORWARDED = ("target_block", "super_factor")

#: every knob name the Simulation constructor consumes: the ones it
#: resolves itself and the forwarded groups. tuning.knobs checks the off
#: sentinels against it at import, so that a renamed resolution site fails
#: there instead of ``tuned={name: off}`` silently doing nothing
CONSUMED_KNOBS = (
    "block", "list_skin_rel", "m2p_cap_margin", "check_every",
    "grav_window", "grav_window_margin", "dt_bins", "bin_sync_every",
    "bin_resort_drift",
) + _NBR_FORWARDED + _GRAV_FORWARDED

#: the propagators' step functions (the JAX package's _PROPAGATORS)
_STEPS = {"std": _step_hydro_std, "ve": _step_hydro_ve, "turb-ve": _step_turb_ve,
          "std-cooling": _step_hydro_std_cooling, "nbody": _step_nbody}

#: their block-time-step twins (``Simulation(dt_bins=...)``): std and VE only
_STEPS_BLOCKDT = {"std": _step_hydro_std_blockdt, "ve": _step_hydro_ve_blockdt}


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
    ngmax: Optional[int] = None, block: Optional[int] = None,
    curve: str = "hilbert", min_cap: int = 0,
    cell_target: Optional[int] = None,
    run_cap: Optional[int] = None, gap: Optional[int] = None,
    group: Optional[int] = None,
    use_lists: bool = False,
    list_skin_rel: Optional[float] = None,
    list_slot_margin: float = 1.3,
    sizing_cache=None,
    mesh=None,
    backend: str = "pallas",
    tuned: object = None,
    workload: Optional[str] = None,
) -> PropagatorConfig:
    """Size the static neighbour config from the current particles, as the
    JAX function does: grid level from h_max and the mean cell occupancy,
    cap from the densest cell, window from the widest SFC group; the
    sizing is the same on both backends (``resolve_backend``: "pallas",
    "xla" or "auto"). ``ngmax`` (default ``const.ngmax``) and ``block``
    (default 2048) are the gather backend's. The host sizing pass (native
    C++ in the JAX package) is numpy here: keys, a stable argsort, the
    densest cell and the group extents.

    ``use_lists``: size the persistent lists too. The window then also
    covers the skin, (4 h_max + skin) * 1.1; the slot budget comes from
    the sizing pass's own sorted keys. Where the grid is in fold mode
    (before or after the wider window) lists are unavailable: the
    un-inflated window stays and ``list_slot_cap`` stays 0. Lists are
    the engine's: the gather backend never sizes them.

    ``mesh``: the state is this rank's slab; h_max, n, the densest cell
    and the widest group are taken over every rank (``sizing_stats``:
    the slabs sorted as the step sorts them, groups within each slab for
    the engine, the global array's groups for the gather backend, whose
    config is then the one-device one), and the lists stay off.

    ``tuned`` (sphexa_torch/tuning: None, "auto", a table path or dict, or
    a knob dict) and ``workload`` resolve the engine knobs (block,
    cell_target, run_cap, gap, group, list_skin_rel): a keyword given here
    beats a table entry, which beats the defaults. The lookup is the
    one-device one (P = 1); ``Simulation`` resolves with its rank count
    and passes the winners explicitly."""
    backend = resolve_backend(backend)
    explicit = {k: v for k, v in (("block", block), ("cell_target", cell_target),
                                  ("run_cap", run_cap), ("gap", gap), ("group", group),
                                  ("list_skin_rel", list_skin_rel))
                if v is not None}
    table = {}
    if tuned is not None:
        from sphexa_torch.tuning.table import resolve_knobs

        n_all = state.n * (mesh.size if mesh is not None else 1)
        table, _ = resolve_knobs(tuned, workload=workload, n=n_all, p=1, backend=backend,
                                 explicit=explicit)
    block, cell_target, run_cap, gap, group, list_skin_rel = (
        explicit.get(k, table.get(k, _DEFAULTS[k]))
        for k in ("block", "cell_target", "run_cap", "gap", "group", "list_skin_rel"))

    lengths = box.lengths.cpu().numpy()
    h_max = state.h.max()
    n = state.n
    if mesh is not None:
        _, (h_max,), _ = pmesh.reduce_scalars(mesh, maxes=[h_max])
        n *= mesh.size
        use_lists = False
    h_max = float(h_max.item())
    level = choose_grid_level(lengths, h_max)
    level_occ = max(1, round(np.log2(max(n / float(cell_target), 1.0)) / 3.0))
    level = min(level, level_occ)

    if mesh is not None:
        occ, ext = sizing_stats(mesh, state.x, state.y, state.z, box, level, group, curve,
                                global_groups=backend == "xla")
    else:
        if sizing_cache is None:
            keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve).cpu().numpy()
            order = np.argsort(keys, kind="stable")
        else:
            keys, order = (a.cpu().numpy() for a in sizing_cache)
        occ = _max_cell_occupancy(keys[order], level)
        xa, ya, za = (a.cpu().numpy() for a in (state.x, state.y, state.z))
        ext = _group_extents(xa, ya, za, order, group)
    cap = pad_cap(occ)
    if min_cap > 0:
        cap = max(cap, pad_cap(min_cap))
    ncell = 1 << level

    def make_nbr(radius):
        window = 1
        for e, edge in zip(ext, lengths / ncell):
            window = max(window, window_cells(e, radius, float(edge), ncell,
                                              margin_cells=0))
        return NeighborConfig(level=level, cap=cap, ngmax=ngmax or const.ngmax, block=block,
                              curve=curve, group=group, window=window, run_cap=run_cap,
                              gap=gap)

    # 10% radius slack absorbs drift between reconfigurations
    nbr = make_nbr(4.0 * h_max * 1.1)
    slot_cap = 0
    skin = list_skin_rel * 2.0 * h_max
    if use_lists and backend == "pallas" and not engine_fold(box, nbr):
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
    return PropagatorConfig(const=const, nbr=nbr, curve=curve, backend=backend,
                            list_slot_cap=slot_cap, list_skin_rel=list_skin_rel)




class Simulation:
    """Owns the carry and the static config; re-sizes the config when a
    step reports a cell-cap or window overflow (and replays that step from
    its input) or when the grid no longer covers the 2h radius.

    ``use_lists`` (the default, as in the JAX package): steady steps run
    on persistent neighbour lists, built on the first step and rebuilt
    when their skin runs low (proactively, below ``_LIST_SLACK_REBUILD``,
    at a check boundary) or has run out (the step is then discarded and
    replayed on fresh lists). Where lists are unavailable (a grid in fold
    mode leaves ``list_slot_cap`` at 0) the steps stream, as with
    ``use_lists=False``; each step's ``use_lists`` diagnostic says which
    ran.

    ``check_every`` > 1: deferred check windows (``step``, ``flush``).
    ``obs_spec``: the science ledger inside the step (energies, momenta,
    numerics health); without it the diagnostics carry no energies and
    ``energy_drift`` stays None. ``science_rows``: keep one row per
    verified step for ``drain_science``. ``drift_budget``: the
    conservation-drift watchdog's limit (None: report only).
    ``telemetry``: the registry that receives the driver's events.

    ``prop``: "std" or "ve" (``av_clean`` adds the VE viscosity's
    velocity-gradient correction), with the same list lifecycle and
    overflow contract; "turb-ve", the VE step with the OU stirring, whose
    state (``turb_state`` and ``turb_cfg``, else built from the
    turbulence case's settings updated by ``turb_settings`` and the box's
    largest edge) is the carry's ``turb`` slot; "std-cooling", the std
    step with radiative cooling (``cooling_cfg``, default
    ``CoolingConfig(gamma=const.gamma)``), whose per-particle chemistry
    (``chem``, default fully ionized) is the carry's ``chem`` slot and
    rides every sort and list rebuild; or "nbody" (gravity alone; it
    needs ``const.g`` and skips the SPH sizing, the lists and the h
    check). A deferred window pins the whole carry, aux slots included:
    a rollback restores the stirring's key and phases and the chemistry,
    and the replay draws the same noise. ``device=None``
    runs on the CUDA device and raises without one; ``device="cpu"`` runs
    the plain PyTorch versions of the kernels.

    ``dt_bins`` (std and VE only; None: the global dt): hierarchical block
    time steps with that many power-of-two dt bins (sph/blockdt.py); each
    ``step()`` is a substep. The BlockDtState is the carry's ``bdt`` slot
    (a rollback restores it), bins are reassigned every
    ``bin_sync_every``-th cycle, and the sort keeps the order while the
    folded keys' inversions stay within ``bin_resort_drift`` of n. Lists
    stay off (the steps sort every time). ``bdt_updates`` /
    ``bdt_updates_full`` count the particle updates made against the
    global dt's over the same substeps, ``bdt_resorts`` / ``bdt_keeps``
    the sort's decisions; a ``dt_bins`` event goes out at every check or
    flush boundary.

    Self-gravity is on when ``const.g != 0``: in an open box, or in a
    fully periodic cubic one through Ewald summation (``ewald_on``; mixed
    boundaries and non-cubic periodic boxes are refused). Each
    (re)configuration then builds the gravity tree from the particles'
    keys and sizes its caps (on the base box), with the opening angle
    ``theta``, the JAX package's bucket and the m2p cap margin
    ``m2p_cap_margin`` (None: its default); the steps sort every time (no
    lists). A step whose interaction lists or leaves outgrow their caps
    (an Ewald solve's worst replica pass) is discarded, the caps re-sized
    with a 1.5x larger margin, and the step replayed.

    ``num_devices`` P > 1 (every propagator and the block time steps,
    with or without self-gravity, open or Ewald): this process is one of P
    ranks (parallel/mesh.py ``spawn``) and joins their process group;
    ``state`` (and ``chem``) is the whole initial state, of which the rank
    keeps its slab (the BlockDtState too; the stirring's state is
    replicated: every rank advances the same key chain), and ``device`` is
    the rank's. The block-dt counters and the ``dt_bins`` event count the
    global rows. The steps stream (no lists) over the sharded force
    stages (the N-body step has none: no SPH halo is sized for it) with
    the ``halo_mode`` exchange
    ("sparse", per-distance row caps, or "windowed", one window per
    peer), sized at every (re)configuration from the current particles
    with a margin; a step whose runs escape the served halo (the
    occupancy's cap + 1 sentinel) is discarded, the margin grown 1.5x and
    the step replayed, deferred windows included. With self-gravity every
    rank builds the same tree from the summed key histograms, the caps
    (the essential set's ``let_cap`` too) come from the sharded upsweep,
    and the near field's sparse serve is sized by the MAC need
    (``device_gravity_halo``) padded by ``grav_window_margin`` to
    multiples of ``grav_window`` rows (0: whole slabs); a step whose near
    field escapes it (``p2p_max`` at the cap + 1 sentinel) is replayed
    with the margin grown 1.5x, and at a second trip within one step with
    whole slabs. Every rank takes every decision from the replicated
    scalars. At each check or flush boundary a ``shard_load`` and an
    ``exchange`` event go out (with the sparse gravity serve a second
    ``exchange``, stage "gravity"), and an ``imbalance`` event where a
    per-rank metric's max over its mean reaches ``imbalance_ratio``.

    ``snap_spec`` (observables/snapshot.py ``SnapshotSpec``): every step
    deposits its field grid, which rides the step's one packed read; at a
    check or flush boundary every verified step whose iteration is a
    multiple of ``snap_every`` writes one ``.npz`` frame into the ring
    ``snap_dir`` (default: ``snapshots/`` beside the telemetry's
    events.jsonl; None: events only), at most ``snap_keep`` frames (0:
    unbounded), and a ``snapshot`` event; ``drain_snapshots()`` hands
    the frames written since the last drain. A rolled-back window writes
    no frame of its discarded steps; its replay writes them. On a mesh
    rank 0 alone writes the frames.

    ``backend``: "pallas" (the pair engine: the CUDA kernels on the card,
    their plain versions on the CPU), "xla" (the gather path: each row's
    first ``ngmax`` neighbours, default ``const.ngmax``, in candidate
    order, the reference's findneighbors.hpp truncation, over row blocks
    of ``block``; plain PyTorch on either device, no kernel; the gravity
    near field gathered and the one-level sort compaction at every N;
    lists off; with ``num_devices`` each rank searches the global groups
    that meet its slab against a halo of their whole window cells, so that
    every row keeps the one-device lists, as the JAX package's GSPMD
    program does) or "auto", which is the engine on every
    device, not the JAX package's CPU default (its gather path). The
    sizing, the overflow contract (the search's occupancy, the densest of
    all window cells or cap + 1) and the deferred windows are the same on
    both.

    ``tuned`` (sphexa_torch/tuning): None, "auto" (the port's committed
    ``TUNING_TABLE_TORCH.json``), a table path or dict, or a plain knob
    dict (a sweep's candidate), resolved once here for (``workload``, N,
    ``num_devices``, the resolved backend): a keyword the caller gave (not
    None) beats a table entry, which beats the default or the
    ``gravity_tuning`` heuristic. The neighbour knobs (cell_target,
    run_cap, gap, group) reach every (re)configuration, on one card and
    on a mesh; the gravity knobs (target_block, super_factor) go on top of
    ``gravity_tuning``'s shape (super_factor > 0 with the bitmask
    compaction on the engine backend, else the sort). ``tuning_provenance``
    names the winner of each knob, and a ``tuning`` event goes out when
    ``tuned`` is not None. Without ``tuned`` nothing changes.

    ``debug_checks``: every step runs under the sanitizer
    (util/phases.py): the first NaN or Inf of a stage's outputs, or the
    first out-of-range run of a kernel's index tables, is the step's
    ``check_error`` ("" when clean). It checks every step (``check_every``
    1), streams (no lists) and refuses a mesh."""

    # rebuild proactively below this remaining-skin fraction: the next
    # step would likely expire and be discarded
    _LIST_SLACK_REBUILD = 0.25

    def __init__(self, state: ParticleState, box: Box, const: SimConstants,
                 prop: str = "std", device=None, curve: str = "hilbert",
                 cell_target: Optional[int] = None, use_lists: bool = True,
                 list_skin_rel: Optional[float] = None, av_clean: bool = False,
                 check_every: Optional[int] = None, obs_spec=None,
                 telemetry: Optional[Telemetry] = None, science_rows: bool = False,
                 drift_budget: Optional[float] = None, theta: float = THETA,
                 m2p_cap_margin: Optional[float] = None, turb_cfg=None, turb_state=None,
                 turb_settings: Optional[Dict] = None,
                 cooling_cfg: Optional[CoolingConfig] = None,
                 chem: Optional[ChemistryData] = None, dt_bins: Optional[int] = None,
                 bin_sync_every: Optional[int] = None,
                 bin_resort_drift: Optional[float] = None,
                 num_devices: Optional[int] = None, halo_mode: str = "sparse",
                 imbalance_ratio: float = 1.5, grav_window: Optional[int] = None,
                 grav_window_margin: Optional[float] = None, snap_spec=None,
                 snap_every: Optional[int] = None, snap_keep: Optional[int] = None,
                 snap_dir: Optional[str] = None, debug_checks: bool = False,
                 backend: str = "auto", ngmax: Optional[int] = None,
                 block: Optional[int] = None, tuned: object = None,
                 workload: Optional[str] = None):
        self.backend = resolve_backend(backend)
        # the tuned knobs: a keyword given here beats the table entry,
        # which beats the default (the keywords default to None so that
        # they stay detectable)
        explicit = {k: v for k, v in (
            ("block", block), ("cell_target", cell_target), ("list_skin_rel", list_skin_rel),
            ("m2p_cap_margin", m2p_cap_margin), ("check_every", check_every),
            ("grav_window", grav_window), ("grav_window_margin", grav_window_margin),
            ("dt_bins", dt_bins), ("bin_sync_every", bin_sync_every),
            ("bin_resort_drift", bin_resort_drift)) if v is not None}
        from sphexa_torch.tuning.table import resolve_knobs

        knobs, self.tuning_provenance = resolve_knobs(
            tuned, workload=workload, n=state.n, p=num_devices or 1, backend=self.backend,
            explicit=explicit)

        def _knob(name, default):
            return explicit.get(name, knobs.get(name, default))

        block = _knob("block", None)
        list_skin_rel = _knob("list_skin_rel", None)
        m2p_cap_margin = _knob("m2p_cap_margin", None)
        check_every = _knob("check_every", 1)
        grav_window = _knob("grav_window", 256)
        grav_window_margin = _knob("grav_window_margin", 1.4)
        dt_bins = _knob("dt_bins", None)
        bin_sync_every = _knob("bin_sync_every", 1)
        bin_resort_drift = _knob("bin_resort_drift", 0.0)
        # the knobs every (re)configuration forwards
        self._nbr_knobs = {k: knobs[k] for k in _NBR_FORWARDED if k in knobs}
        self._grav_knobs = {k: knobs[k] for k in _GRAV_FORWARDED if k in knobs}
        self.ngmax = ngmax or const.ngmax
        self.block = block
        if prop not in _STEPS:
            raise ValueError(f"unknown propagator {prop!r}; available: {sorted(_STEPS)}")
        if dt_bins is not None:
            if prop not in _STEPS_BLOCKDT:
                raise ValueError(f"dt_bins (hierarchical block time steps) supports the "
                                 f"std/ve propagators, not prop={prop!r}")
            dt_bins = int(dt_bins)
            if dt_bins < 1:
                raise ValueError(f"dt_bins must be >= 1, got {dt_bins}")
            if int(bin_sync_every) < 1:
                raise ValueError(f"bin_sync_every must be >= 1, got {bin_sync_every}")
            if float(bin_resort_drift) < 0.0:
                raise ValueError(f"bin_resort_drift must be >= 0, got {bin_resort_drift}")
        self.dt_bins = dt_bins
        self.bin_sync_every = int(bin_sync_every)
        self.bin_resort_drift = float(bin_resort_drift)
        # the block time steps' host counters, over every verified substep
        self.bdt_updates = 0
        self.bdt_updates_full = 0
        self.bdt_resorts = 0
        self.bdt_keeps = 0
        if prop == "nbody" and const.g == 0.0:
            raise ValueError(
                "prop='nbody' needs a gravitational constant: set SimConstants(g=...)")
        self.prop_name = prop
        self.gravity_on = const.g != 0.0
        # the sanitizer localizes a failure to one step: every step checked,
        # no lists, one device
        self.debug_checks = bool(debug_checks)
        if self.debug_checks:
            if num_devices is not None and num_devices > 1:
                raise ValueError("debug_checks is single-device; drop num_devices or the flag")
            check_every = 1
            use_lists = False
        if halo_mode not in ("sparse", "windowed"):
            raise ValueError(f"halo_mode must be 'sparse' or 'windowed', got {halo_mode!r}")
        self.mesh = None
        if num_devices is not None and num_devices > 1:
            self.mesh = pmesh.make_mesh(num_devices, device=device)
        self._halo_mode = halo_mode
        self._halo_margin = 1.4  # grown 1.5x by every escape-sentinel trip
        self._halo_info: Dict = {}
        # the gravity near field's sparse serve: the caps' quantum in rows
        # (0: whole slabs) and the MAC need's margin, grown 1.5x by every
        # escape-sentinel trip
        self.grav_window = int(grav_window)
        if self.grav_window < 0:
            raise ValueError(f"grav_window must be >= 0, got {self.grav_window}")
        self._grav_halo_margin = float(grav_window_margin)
        self._grav_cells: tuple = ()
        self._grav_halo_info: Dict = {}
        self._imbalance_ratio = float(imbalance_ratio)
        any_periodic = any(b == BoundaryType.periodic for b in box.boundaries)
        all_periodic = all(b == BoundaryType.periodic for b in box.boundaries)
        self.ewald_on = self.gravity_on and all_periodic
        if self.gravity_on and any_periodic and not all_periodic:
            raise NotImplementedError(
                "self-gravity supports fully periodic (Ewald) or fully open boundaries, "
                "not mixed ones (same restriction as the reference's computeGravityEwald)")
        if self.ewald_on:
            lx = box.lengths.cpu().numpy()
            if not np.allclose(lx, lx[0]):
                raise ValueError(
                    "Ewald gravity requires a cubic periodic box (traversal_ewald_cpu.hpp:366)")
        self.theta = theta
        self.m2p_cap_margin = M2P_CAP_MARGIN if m2p_cap_margin is None else m2p_cap_margin
        # every control-flow event (reconfigure, rollback, replay, list
        # rebuild) and step timing reports here; the instrumentation is
        # host-only and adds no read of the card to a deferred window
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        if tuned is not None:
            # the decision is itself telemetry: which knobs are active and why
            self.telemetry.event("tuning", workload=workload, **self.tuning_provenance)
        self._gtree = None
        self.grav_configure_seconds = 0.0  # the last tree build and cap sizing
        self.av_clean = av_clean
        self._step_fn = (_STEPS_BLOCKDT if dt_bins is not None else _STEPS)[prop]
        if self.mesh is not None:
            self.device = self.mesh.device
            self.state = pmesh.shard_state(state, self.mesh)
        else:
            self.device = resolve_device(device)
            self.state = state.to(self.device)
        self.bdt_state = make_blockdt_state(self.state, dt_bins) if dt_bins is not None else None
        self.box = box.to(self.device)
        self.const = const
        # the turbulence stirring (turb-ve): built from the case settings
        # unless a (cfg, state) pair is given, e.g. restored from a dump; a
        # given state keeps the config derived here when no cfg comes with it
        self.turb_cfg, self.turb_state = turb_cfg, turb_state
        if prop == "turb-ve" and self.turb_cfg is None:
            st = dict(turbulence_constants(), **(turb_settings or {}))
            self.turb_cfg, fresh = create_stirring_modes(
                lbox=float(self.box.lengths.max()), st_max_modes=int(st["stMaxModes"]),
                energy_prefac=st["stEnergyPrefac"], mach_velocity=st["stMachVelocity"],
                sol_weight=st["solWeight"], spect_form=int(st["stSpectForm"]),
                seed=int(st["rngSeed"]), power_law_exp=float(st.get("powerLawExp", 5.0 / 3.0)),
                angles_exp=float(st.get("anglesExp", 2.0)), device=self.device)
            if self.turb_state is None:
                self.turb_state = fresh
        if self.turb_state is not None:
            self.turb_state = self.turb_state.to(self.device)
        # radiative cooling (std-cooling): the reduced CIE model
        self.cooling_cfg, self.chem = cooling_cfg, chem
        if prop == "std-cooling":
            if self.cooling_cfg is None:
                self.cooling_cfg = CoolingConfig(gamma=const.gamma)
            if self.chem is None:
                self.chem = ChemistryData.ionized(state.n, device=self.device)
        if self.chem is not None:
            if self.mesh is not None and self.chem.hi.shape[0] == state.n:
                # the chemistry rides the slabs as the state does
                self.chem = pmesh.shard_state(self.chem, self.mesh, n=state.n)
            self.chem = self.chem.to(self.device)
        self.curve = curve
        self.cell_target = cell_target
        self.iteration = 0
        self.reconfigures = 0  # re-sizes after the initial one
        self.replays = 0  # step launches discarded (overflow or stale lists) and run again
        self.rebuilds = 0  # list builds (mark passes), the first one included
        self.rollbacks = 0  # deferred windows rolled back to their first step
        self.last_step_seconds = 0.0  # the last checked step, its rebuild included
        # the science ledger: conservation and numerics-health scalars of
        # every step, read with the other scalars at check and flush
        # boundaries; the drift and field-health watchdogs read them there
        self._obs_spec = obs_spec
        self._drift_budget = None if drift_budget is None else float(drift_budget)
        self._etot0: Optional[float] = None
        #: |etot - etot0| / |etot0| at the last verified step
        self.energy_drift: Optional[float] = None
        self._collect_science = bool(science_rows)
        self._science: list = []
        # the field snapshots: the deposit rides every step's packed read,
        # the frames are written at check and flush boundaries
        self._snap_spec = snap_spec
        self._snap_every = max(1, int(snap_every)) if snap_every else 1
        self._snap_keep = int(snap_keep) if snap_keep else 0
        self._snap_dir = snap_dir
        if snap_spec is not None and snap_dir is None:
            # default: beside events.jsonl (the JsonlSink's directory)
            for sink in self.telemetry.sinks:
                path = getattr(sink, "path", None)
                if path:
                    self._snap_dir = os.path.join(os.path.dirname(str(path)) or ".",
                                                  "snapshots")
                    break
        self._snap_frames: list = []  # (iteration, path) since the last drain
        self._snap_ring: list = []  # the ring's paths, oldest first
        # the gravity tree is built from fresh keys, and the block time
        # steps sort on the folded key: both sort every step
        self._want_lists = (use_lists and not self.gravity_on and dt_bins is None
                            and self.mesh is None and self.backend == "pallas")
        self._list_skin_rel = list_skin_rel
        self._slot_margin = 1.3
        self._lists = None
        # deferred checking (check_every > 1): the happy path launches
        # steps with no read of the card; the scalars of the window's
        # steps stay on the card, one packed tensor a step, and the flush
        # reads them in one copy. The steps are functional (each builds a
        # new state; nothing writes a state tensor in place), so the
        # rollback point is the window's first carry, held by reference.
        self.check_every = max(1, int(check_every))
        self._pending: list = []  # (names, packed scalars, used lists) per launch
        self._window_prior = None  # (SimState, iteration) at the window's start
        self._window_t0 = None  # host stamp of the window's first launch
        self._last_diag: Dict[str, float] = {"reconfigured": 0.0}
        self._mem_post_compile = False  # the "post-compile" memory event went out
        self._configure(reason="initial")

    @property
    def cfg(self) -> PropagatorConfig:
        return self._cfg

    @property
    def lists(self):
        """The current persistent lists (None while streaming or before
        the first build)."""
        return self._lists

    @property
    def sim_state(self) -> SimState:
        """The driver's state as the carry every launch consumes and
        returns, the stirring, the chemistry and the block-dt state in their
        slots."""
        return SimState(particles=self.state, box=self.box, turb=self.turb_state,
                        chem=self.chem, bdt=self.bdt_state)

    def _set_sim_state(self, sim: SimState) -> None:
        """Write a carry back onto the driver: the one commit point for
        step outputs and window rollbacks."""
        self.state = sim.particles
        self.box = sim.box
        self.turb_state = sim.turb
        self.chem = sim.chem
        self.bdt_state = sim.bdt

    @property
    def _aux_cfg(self):
        """The static config of the active propagator's aux slot."""
        return {"turb": self.turb_cfg, "chem": self.cooling_cfg}.get(
            STEP_AUX_SLOT.get(self._step_fn))

    def _configure(self, min_cap: int = 0, grav_margin: float = 1.5,
                   reason: str = "reconfigure") -> None:
        with self.telemetry.annotate("sphexa:reconfigure"):
            self._configure_impl(min_cap, grav_margin)
        # the construction-time sizing stays out of the counters
        if reason != "initial":
            self.reconfigures += 1
            self.telemetry.count("reconfigures")
        self.telemetry.event("reconfigure", it=self.iteration, reason=reason)

    def _configure_impl(self, min_cap: int = 0, grav_margin: float = 1.5) -> None:
        self._lists = None  # any re-size invalidates the lists
        sizing_cache = None
        if self.gravity_on and self.mesh is None:
            # one keygen + stable argsort, shared by the grid sizing and
            # the tree build; keys against the regrown box (equal to the
            # box until particles leave it)
            s = self.state
            gbox = make_global_box(s.x, s.y, s.z, self.box)
            keys = compute_sfc_keys(s.x, s.y, s.z, gbox, curve=self.curve)
            sizing_cache = (keys, torch.argsort(keys, stable=True))
        if self.prop_name == "nbody":
            # no SPH: the neighbour config is a placeholder the step never
            # reads (its occupancy is 0)
            cfg = PropagatorConfig(const=self.const, curve=self.curve, backend=self.backend,
                                   nbr=NeighborConfig(level=1, cap=1, ngmax=self.ngmax,
                                                      curve=self.curve))
        else:
            # the tuned neighbour knobs ride every (re)configuration
            nbr_knobs = {"cell_target": self.cell_target, **self._nbr_knobs}
            cfg = make_propagator_config(
                self.state, self.box, self.const, ngmax=self.ngmax, block=self.block,
                backend=self.backend, curve=self.curve, min_cap=min_cap,
                use_lists=self._want_lists, list_skin_rel=self._list_skin_rel,
                list_slot_margin=self._slot_margin, sizing_cache=sizing_cache,
                mesh=self.mesh, **nbr_knobs)
        self._cfg = dataclasses.replace(cfg, av_clean=self.av_clean, obs=self._obs_spec,
                                        snap=self._snap_spec, dt_bins=self.dt_bins,
                                        bin_sync_every=self.bin_sync_every,
                                        bin_resort_drift=self.bin_resort_drift)
        if self.gravity_on:
            self._configure_gravity(grav_margin, sizing_cache)
        if self.mesh is not None:
            self._configure_sharded()

    def _configure_sharded(self) -> None:
        """Size the halo exchange from the current particles (the box
        regrown and the slabs sorted as the next step will) with the
        current margin, and bind the mesh and the sizes into the config
        (parallel/mesh.py ``make_sharded_step``). Only the P - 1 caps, or
        the window, reach the host. The N-body step has no SPH halo: no
        sizing (the JAX package's ``_halo_sizing_needed``), and its
        ``halo_info`` stays empty."""
        mesh, S, P = self.mesh, self.state.n, self.mesh.size
        sizes = {}
        if self.prop_name != "nbody":
            sizes = halo_sizes(mesh, self.state, self.box, self._cfg.nbr, self._halo_mode,
                               margin=self._halo_margin, curve=self.curve,
                               backend=self.backend)
        stepper = pmesh.make_sharded_step(mesh, self._cfg, self._step_fn, **sizes,
                                          grav_cells=self._grav_cells, aux_cfg=self._aux_cfg)
        self._halo_info = {}
        if "halo_cells" in sizes:
            caps = sizes["halo_cells"]
            self._halo_info = {"mode": "sparse", "caps": caps, "shipped_rows": sum(caps)}
        elif "halo_window" in sizes:
            wmax = sizes["halo_window"]
            self._halo_info = {"mode": "windowed", "wmax": wmax, "shipped_rows": (P - 1) * wmax}
        if self._halo_info:
            self._halo_info["slab"] = S
            self._halo_info["bytes_per_step"] = 4 * self._halo_info["shipped_rows"] * \
                exchange_fields_per_step(self.prop_name, self.av_clean)
        self._grav_halo_info = {}
        if self.gravity_on:
            # the near field serves x, y, z, m, h once a solve pass (27 in
            # an Ewald solve)
            nshell = len(replica_shells(self._cfg.ewald)) if self._cfg.ewald else 1
            if self._grav_cells:
                caps = tuple(min(int(c), S) for c in self._grav_cells)
                self._grav_halo_info = {"mode": "sparse", "caps": caps,
                                        "shipped_rows": sum(caps)}
            else:
                self._grav_halo_info = {"mode": "windowed", "wmax": S,
                                        "shipped_rows": (P - 1) * S}
            self._grav_halo_info["bytes_per_step"] = \
                self._grav_halo_info["shipped_rows"] * 5 * 4 * nshell
        self._cfg = stepper.cfg

    @property
    def halo_info(self) -> Dict:
        """The sharded run's exchange shape at the last sizing: its mode,
        the caps or the window, the rows a serve ships, the slab and the
        bytes a step ships ({} on one device and for N-body). On the
        gather backend it is the gather halo's ("sparse" or "windowed":
        the exchange the ranks make), where the JAX package's GSPMD run
        reports {"mode": "gspmd", "shipped_rows": 0}."""
        return dict(self._halo_info)

    @property
    def grav_halo_info(self) -> Dict:
        """The gravity near field's exchange shape on a mesh: "sparse" with
        its per-distance caps, or "windowed" (whole slabs), the rows a serve
        ships and the bytes a step ships ({} without)."""
        return dict(self._grav_halo_info)

    def _gravity_shape(self, n: int) -> Dict:
        """The solver's shape at n particles: ``gravity_tuning``'s, the
        tuned gravity knobs on top; a tuned super_factor keeps the
        heuristic's invariant (the two-level classification exists only as
        the engine backend's bitmask compaction; 0 is the sort)."""
        shape = gravity_tuning(n, self.backend == "pallas")
        shape.update(self._grav_knobs)
        if "super_factor" in self._grav_knobs:
            shape["compaction"] = ("bitmask" if shape["super_factor"] > 0
                                   and self.backend == "pallas" else "sort")
        return shape

    def _configure_gravity(self, margin: float, keys_cache) -> None:
        """(Re)build the gravity tree from the particles' keys and size
        the interaction-list caps (simulation.py _configure_gravity): the
        leaf array from device histograms (only O(8^level) counts reach
        the host), the linkage on the host, the caps from a sampled
        classification of the base box (an Ewald solve's shifted passes
        are guarded by the overflow diagnostics); the multipoles of every
        step follow the tree."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            self._configure_gravity_sharded(margin)
            self.grav_configure_seconds = time.perf_counter() - t0
            return
        s = self.state
        keys, order = keys_cache
        leaf_tree = leaf_array_from_device_keys(keys, bucket_size=GRAV_BUCKET)
        gtree, meta = linkage_from_leaves(leaf_tree, curve=self.curve, device=self.device)
        xs, ys, zs, ms = s.x[order], s.y[order], s.z[order], s.m[order]
        gcfg = estimate_gravity_caps(
            xs, ys, zs, ms, keys[order], self.box, gtree, meta,
            GravityConfig(theta=self.theta, G=self.const.g,
                          m2p_cap_margin=self.m2p_cap_margin, **self._gravity_shape(s.n)),
            margin=margin)
        self._gtree = gtree
        self._cfg = dataclasses.replace(self._cfg, gravity=gcfg, grav_meta=meta,
                                        ewald=EwaldConfig() if self.ewald_on else None)
        self.grav_configure_seconds = time.perf_counter() - t0

    def _configure_gravity_sharded(self, margin: float) -> None:
        """``_configure_gravity`` on a mesh (the JAX package's, with
        ``let_shards``): the tree from the key histograms summed over the
        ranks (every rank builds the same one), the slabs sorted as the
        step sorts them, the sharded upsweep, the caps sized over the
        global array's blocks with the essential set's cap, and the sparse
        gravity serve's caps from the MAC need (``device_gravity_halo``,
        over the Ewald replica shifts in a periodic box), unless
        ``grav_window`` is 0 (whole slabs)."""
        s, mesh = self.state, self.mesh
        gbox = make_global_box(s.x, s.y, s.z, self.box, mesh=mesh)
        keys = compute_sfc_keys(s.x, s.y, s.z, gbox, curve=self.curve)
        leaf_tree = leaf_array_from_device_keys(keys, bucket_size=GRAV_BUCKET, mesh=mesh)
        gtree, meta = linkage_from_leaves(leaf_tree, curve=self.curve, device=self.device)
        skeys, mat = distributed_sort(mesh, keys, torch.stack([s.x, s.y, s.z, s.m], dim=1))
        xs, ys, zs, ms = (a.contiguous() for a in mat.unbind(1))
        mps = compute_multipoles_sharded(mesh, xs, ys, zs, ms, skeys, gtree, meta)
        gcfg = estimate_gravity_caps(
            xs, ys, zs, ms, skeys, self.box, gtree, meta,
            GravityConfig(theta=self.theta, G=self.const.g,
                          m2p_cap_margin=self.m2p_cap_margin,
                          **self._gravity_shape(s.n * mesh.size)),
            margin=margin, multipoles=mps, let_shards=mesh.size, mesh=mesh)
        ewald = EwaldConfig() if self.ewald_on else None
        self._grav_cells = ()
        if self.grav_window > 0:
            shifts = None
            if ewald is not None:
                # a shifted slab reaches wrap-around leaves the base pass
                # never opens: the need is the union over the shifts
                shifts = torch.as_tensor(replica_shells(ewald), device=self.device) * \
                    self.box.lengths[0]
            self._grav_cells = device_gravity_halo(
                mesh, xs, ys, zs, ms, skeys, self.box, gtree, meta, self.theta, shifts=shifts,
                margin=self._grav_halo_margin, quantum=self.grav_window, multipoles=mps)
        self._gtree = gtree
        self._cfg = dataclasses.replace(self._cfg, gravity=gcfg, grav_meta=meta, ewald=ewald)

    @property
    def gtree(self):
        """The gravity tree of the current configuration (None without
        gravity)."""
        return self._gtree

    def _gravity_overflowed(self, d: Dict[str, float]) -> bool:
        """An interaction list, a leaf, a superblock list or a rank's
        essential set outgrew its cap (on a mesh, ``p2p_max`` at the cap
        + 1 may be the near field's escape sentinel:
        ``_grav_window_blown``)."""
        if not self.gravity_on:
            return False
        g = self._cfg.gravity
        return (d["m2p_max"] > g.m2p_cap or d["p2p_max"] > g.p2p_cap
                or d["leaf_occ"] > g.leaf_cap or d["c_max"] > g.super_cap
                or (g.let_cap > 0 and d.get("let_max", 0) > g.let_cap))

    def _grav_window_blown(self, d: Dict[str, float]) -> bool:
        """The sparse gravity serve's escape sentinel: ``p2p_max`` exactly
        the cap + 1 while its caps are active. A real overflow landing on
        cap + 1 is handled the same way: the margin's regrowth ends at
        whole slabs, where every row is served and the sentinel cannot
        fire, and a persisting overflow is then the caps'."""
        return (self.gravity_on and bool(self._grav_cells)
                and int(d["p2p_max"]) == self._cfg.gravity.p2p_cap + 1)

    def _config_still_valid(self, d: Dict[str, float]) -> bool:
        """The step's occupancy within the cap and the cell edge still
        covering 2 h_max (the box edge rides the step's scalars); the
        N-body step has no cells to cover."""
        nbr = self._cfg.nbr
        if int(d["occupancy"]) > nbr.cap:
            return False
        if self.prop_name == "nbody":
            return True
        return 2.0 * d["h_max"] <= d["min_length"] / (1 << nbr.level)

    @property
    def _use_lists(self) -> bool:
        return self._want_lists and self._cfg.list_slot_cap > 0

    def _maybe_rebuild_lists(self, d: Dict[str, float]) -> None:
        if self._use_lists and d.get("list_slack", 1.0) < self._LIST_SLACK_REBUILD:
            self._rebuild_lists()

    def _rebuild_lists(self) -> None:
        """(Re)build the lists: regrow, sort (the chemistry permuted with
        the state), mark. Host reads: the overflow sentinel, and on the
        card the size of the list walk's mask-word buffer; a slot overflow
        grows the slot margin 1.5x and re-sizes, at most three times."""
        self.telemetry.event("rebuild_lists", it=self.iteration)
        for _ in range(3):
            if not self._use_lists:
                return  # a re-size left the grid without lists: stream
            with self.telemetry.annotate("sphexa:rebuild-lists"):
                state, box, lists, *chem = rebuild_pair_lists(self.state, self.box,
                                                               self._cfg, aux=self.chem)
                self.rebuilds += 1
                # torchlint: disable=JXL002 -- the build's slot overflow decides a re-size
                overflow = int(lists.overflow)
            if not overflow:
                self.state, self.box, self._lists = state, box, lists
                if chem:
                    self.chem = chem[0]
                return
            self._slot_margin *= 1.5
            self._configure(reason="list-slot")
        raise RuntimeError("pair-list slot cap failed to converge")

    # -- main loop ----------------------------------------------------------
    def _launch(self):
        """Run one step on the current carry, reading nothing from the
        card (a missing list build reads its own two scalars). Returns
        (new SimState, names, the scalars packed into one (K,) float64
        device tensor, whether the step ran on lists). ``names`` holds a
        scalar's name, or (name, shape) for an array diagnostic (the
        snapshot's grids and the frame's box), whose values follow the
        scalars' in the packed tensor."""
        with self.telemetry.annotate("sphexa:launch"):
            if self._use_lists and self._lists is None:
                self._rebuild_lists()
            lists = self._lists if self._use_lists else None
            sim, diag = step_sim_state(self._step_fn, self.sim_state, self._cfg, self._gtree,
                                       self._aux_cfg, lists=lists)
            named = {**diag, "min_length": sim.box.lengths.min()}
            arrays = []
            if self._snap_spec is not None:
                # the frame's box rides the same read
                named.update(snap_lo=sim.box.lo, snap_lengths=sim.box.lengths)
                arrays = [(k, named.pop(k)) for k in _ARRAY_KEYS if k in named]
            # a (B,) diagnostic (the bin populations) rides as B scalars "k[i]"
            for k in [k for k, v in named.items() if v.dim() == 1]:
                named.update({f"{k}[{i}]": e for i, e in enumerate(named.pop(k).unbind(0))})
            # packed a dtype at a time: a stack and a conversion each,
            # where one per scalar would add some twenty launches a step
            by_dtype: Dict[torch.dtype, list] = {}
            for k, v in named.items():
                by_dtype.setdefault(v.dtype, []).append(k)
            names = tuple(k for ks in by_dtype.values() for k in ks)
            parts = [torch.stack([named[k] for k in ks]).to(torch.float64)
                     for ks in by_dtype.values()]
            if arrays:
                # whole blocks, flattened: a (G, G) grid as G^2 scalars
                # would cost G^2 views on the host
                names += tuple((k, tuple(a.shape)) for k, a in arrays)
                parts.append(torch.cat([a.reshape(-1) for _, a in arrays]).to(torch.float64))
            packed = torch.cat(parts)
        return sim, names, packed, lists is not None

    def _fetch_scalars(self, entries) -> List[Dict[str, float]]:
        """One device-to-host read of the diagnostics of every step in
        ``entries`` ((names, packed) pairs): the packed tensors
        concatenated and copied once (a whole grid as a numpy block: as
        Python floats it would cost milliseconds a window); scalars come
        back as floats, array diagnostics as float64 numpy arrays of their
        shapes."""
        host = torch.cat([p for _, p in entries]).cpu().numpy()
        out, i = [], 0
        for names, _ in entries:
            scalars = [k for k in names if isinstance(k, str)]
            d = dict(zip(scalars, host[i:i + len(scalars)].tolist()))
            i += len(scalars)
            for k, shape in (k for k in names if not isinstance(k, str)):
                size = int(np.prod(shape))
                d[k] = host[i:i + size].reshape(shape).copy()
                i += size
            out.append(d)
        return out

    @staticmethod
    def _lists_fresh(d: Dict[str, float]) -> bool:
        """False when the step ran on expired lists (drift or growth ate
        the skin before it ran): its sums may have missed neighbours, so
        it is discarded and replayed on fresh lists, a rebuild and no
        re-size."""
        return int(d.get("list_ok", 1)) != 0

    def _overflowed(self, d: Dict[str, float]) -> bool:
        return (int(d["occupancy"]) > self._cfg.nbr.cap or self._gravity_overflowed(d)
                or not self._lists_fresh(d))

    def _reconfigure_after_overflow(self, d: Dict[str, float], grav_margin: float) -> None:
        # cap + 1 is the window sentinel, not a real occupancy: a plain
        # re-size grows the window instead of ratcheting the cap
        occ = int(d["occupancy"])
        cap = self._cfg.nbr.cap
        if self.mesh is not None and occ == cap + 1:
            # under a mesh the sentinel is also how runs that escaped the
            # served halo surface: grow the halo sizing's margin
            self._halo_margin *= 1.5
            self.telemetry.count("halo_trips")
        self._configure(min_cap=0 if occ == cap + 1 or occ <= cap else occ,
                        grav_margin=grav_margin, reason="overflow")

    @staticmethod
    def _result(d: Dict[str, float], used_lists: bool) -> Dict[str, float]:
        result = {k: v for k, v in d.items()
                  if k not in ("min_length", "snap_lo", "snap_lengths")}
        result["use_lists"] = float(used_lists)
        return result

    def _step_checked(self) -> Dict[str, float]:
        """Advance one step synchronously. A step whose occupancy exceeds
        the cap (a truncated cell, or ``cap + 1`` for a blown window) is
        discarded, the config re-sized, and the step replayed from its
        input; a list-mode step whose lists no longer cover its input
        (``list_ok`` 0) is discarded and replayed on rebuilt lists; with
        gravity a step whose lists or leaves outgrow the caps is discarded
        too, and the caps re-sized with a 1.5x larger margin. One read of
        the card per attempt, after its last kernel."""
        t0 = time.perf_counter()
        reconfigured = False
        grav_margin = 1.5
        grav_blown_once = False
        for _attempt in range(4):
            with _debug_checks() if self.debug_checks else contextlib.nullcontext() as dbg:
                sim, names, packed, used_lists = self._launch()
            (d,) = self._fetch_scalars([(names, packed)])
            if not self._overflowed(d):
                break
            self.replays += 1
            if not self._lists_fresh(d):
                # stale lists: rebuild them (no re-size) and replay
                self._rebuild_lists()
                continue
            if self._grav_window_blown(d):
                # escaped near-field runs: grow the MAC need's margin, not
                # the caps; a second trip in one step serves whole slabs
                self._grav_halo_margin = 1e9 if grav_blown_once else \
                    self._grav_halo_margin * 1.5
                grav_blown_once = True
                self.telemetry.count("grav_halo_trips")
            elif self._gravity_overflowed(d):
                grav_margin *= 1.5
            self._reconfigure_after_overflow(d, grav_margin)
            reconfigured = True
        else:
            raise RuntimeError("neighbour/gravity caps failed to converge in 4 attempts")
        # launch to the read is the step's device span; retries count here
        wall = time.perf_counter() - t0
        self._set_sim_state(sim)
        self.iteration += 1
        # the config check first: a re-size drops the lists, so a
        # proactive rebuild before it would be wasted
        if not self._config_still_valid(d):
            self._configure(reason="stale-grid")
            reconfigured = True
        else:
            self._maybe_rebuild_lists(d)
        result = self._result(d, used_lists)
        result["reconfigured"] = float(reconfigured)
        self.telemetry.timing("step", wall)
        self.telemetry.event("step", it=self.iteration, wall_s=round(wall, 6),
                             dt=result.get("dt"), reconfigured=reconfigured)
        self._emit_distributed(d, 1)
        self._emit_science([d], [self.iteration])
        self._emit_blockdt([d], [self.iteration])
        self._emit_snapshot([d], [self.iteration])
        self._emit_memory("post-compile")
        if self.debug_checks:
            # the first failed check of this step's last attempt ("" clean)
            result["check_error"] = dbg.error
        self._last_diag = result
        self.last_step_seconds = time.perf_counter() - t0
        return result

    def step(self) -> Dict[str, float]:
        """Advance one step.

        With ``check_every == 1`` (the default) the step is checked
        synchronously. With ``check_every > 1`` steps launch with no read
        of the card; every ``check_every`` steps the window's scalars are
        read in one copy and, if a step overflowed, the simulation rolls
        back to the window's first state and replays the window through
        the checked path. Between check boundaries the diagnostics
        returned are the last verified ones, marked ``{"deferred": 1.0}``.
        """
        if self.check_every <= 1:
            return self._step_checked()
        if not self._pending:
            # the window's first launch: the flush charges the window's
            # device time against this stamp, and only this carry is
            # pinned for a rollback
            self._window_t0 = time.perf_counter()
            self._window_prior = (self.sim_state, self.iteration)
        sim, names, packed, used_lists = self._launch()
        self._set_sim_state(sim)
        self.iteration += 1
        # the happy path's telemetry is host-side only
        self.telemetry.event("launch", it=self.iteration)
        self._pending.append((names, packed, used_lists))
        if len(self._pending) >= self.check_every:
            return self.flush()
        return {**self._last_diag, "deferred": 1.0}

    def flush(self) -> Dict[str, float]:
        """Drain the deferred window: one read of every pending step's
        scalars; if a step overflowed or ran on expired lists, roll back to
        the window's first state and replay the whole window through the
        checked path (expired lists only: fresh lists and no re-size)."""
        if not self._pending:
            return self._last_diag
        pending, self._pending = self._pending, []
        prior, self._window_prior = self._window_prior, None
        t0, self._window_t0 = self._window_t0, None
        with self.telemetry.annotate("sphexa:flush"):
            fetched = self._fetch_scalars([(names, packed) for names, packed, _ in pending])
        # the read drains every launched step: this host span is the
        # window's device time, and its mean the per-step time
        window_wall = time.perf_counter() - t0
        bad = next((i for i, d in enumerate(fetched) if self._overflowed(d)), None)
        if bad is None:
            self.telemetry.timing("step", window_wall)
            self.telemetry.event("window", it=self.iteration, steps=len(pending),
                                 wall_s=round(window_wall, 6),
                                 per_step_s=round(window_wall / len(pending), 6))
            # the ledger rides the same read: a science row for every step
            win_its = list(range(self.iteration - len(pending) + 1, self.iteration + 1))
            self._emit_distributed(fetched[-1], len(pending))
            self._emit_science(fetched, win_its)
            self._emit_blockdt(fetched, win_its)
            self._emit_snapshot(fetched, win_its)
            self._emit_memory("post-compile")
            self._emit_memory("flush")
            result = self._result(fetched[-1], pending[-1][2])
            result["reconfigured"] = 0.0
            self._last_diag = result
            if not self._config_still_valid(fetched[-1]):
                self._configure(reason="stale-grid")
                result["reconfigured"] = 1.0
            else:
                self._maybe_rebuild_lists(fetched[-1])
            return result
        d_bad = fetched[bad]
        expiry_only = (not self._lists_fresh(d_bad)
                       and int(d_bad["occupancy"]) <= self._cfg.nbr.cap
                       and not self._gravity_overflowed(d_bad))
        self.rollbacks += 1
        self.replays += len(pending)
        self.telemetry.count("rollbacks")
        self.telemetry.event("rollback", it=self.iteration, to_it=prior[1],
                             steps=len(pending), bad_index=bad,
                             reason="list-expiry" if expiry_only else "overflow")
        self._set_sim_state(prior[0])
        self.iteration = prior[1]
        if expiry_only:
            self._rebuild_lists()
        else:
            grav_margin = 1.5
            if self._grav_window_blown(d_bad):
                # the replay below escalates to whole slabs on a repeat trip
                self._grav_halo_margin *= 1.5
                self.telemetry.count("grav_halo_trips")
            elif self._gravity_overflowed(d_bad):
                grav_margin = 1.5 * 1.5
            self._reconfigure_after_overflow(d_bad, grav_margin)
        for _ in range(len(pending)):
            result = self._step_checked()
        self.telemetry.event("replay", it=self.iteration, steps=len(pending))
        result["reconfigured"] = 1.0
        self._last_diag = result
        return result

    def _emit_distributed(self, d: Dict[str, float], steps: int) -> None:
        """At a check or flush boundary under a mesh: one ``shard_load`` and
        one ``exchange`` event from the step's per-rank scalars (already
        read), and the imbalance watchdog (max over mean of each per-rank
        metric against ``imbalance_ratio``)."""
        if self.mesh is None:
            return
        tel, P = self.telemetry, self.mesh.size

        def per_rank(key):
            return [d[f"{key}[{r}]"] for r in range(P)] if f"{key}[0]" in d else None

        work, rows, occ = per_rank("shard_work"), per_rank("shard_rows"), per_rank("shard_occ")
        tel.event("shard_load", it=self.iteration, steps=steps,
                  particles=[self.state.n] * P, stage="sph",
                  **({"work": work} if work is not None else {}))
        info = self._halo_info
        if rows is not None:
            tel.event("exchange", it=self.iteration, steps=steps, mode=info["mode"],
                      shipped_rows=int(info["shipped_rows"]), rows=[int(r) for r in rows],
                      occ=[round(float(o), 4) for o in occ],
                      bytes_per_step=int(info["bytes_per_step"]),
                      trips=int(tel.counters.get("halo_trips", 0)), stage="sph")
        grows, gocc = per_rank("gshard_rows"), per_rank("gshard_occ")
        if grows is not None:
            ginfo = self._grav_halo_info
            tel.event("exchange", it=self.iteration, steps=steps, mode=ginfo["mode"],
                      shipped_rows=int(ginfo["shipped_rows"]), rows=[int(r) for r in grows],
                      occ=[round(float(o), 4) for o in gocc],
                      bytes_per_step=int(ginfo["bytes_per_step"]),
                      trips=int(tel.counters.get("grav_halo_trips", 0)), stage="gravity")
        for metric, a in (("work", work), ("halo_rows", rows), ("halo_occ", occ)):
            if not a:
                continue
            mean = float(np.mean(a))
            if mean <= 0.0:
                continue
            ratio = float(np.max(a)) / mean
            if ratio >= self._imbalance_ratio:
                tel.count("imbalances")
                tel.event("imbalance", it=self.iteration, metric=metric, ratio=round(ratio, 4),
                          threshold=self._imbalance_ratio)

    def _emit_memory(self, point: str) -> None:
        """A ``memory`` event (telemetry/memory.py: the allocator's host
        counters, no read of the card): "post-compile" once, after the
        first verified step or window; "flush" at every clean flush."""
        if point == "post-compile":
            if self._mem_post_compile:
                return
            self._mem_post_compile = True
        emit_memory_event(self.telemetry, point, devices=[self.device], it=self.iteration)

    def _emit_blockdt(self, fetched, its) -> None:
        """At a check or flush boundary: one ``dt_bins`` event over the
        verified substeps (their bdt_* scalars, already read) and the host
        counters. Every substep advances the time by dt_min under both
        schemes, so the global dt's cost of the same span is n updates a
        substep."""
        steps = [(it, d) for it, d in zip(its, fetched) if "bdt_active" in d]
        if not steps:
            return
        ds = [d for _, d in steps]
        updates = sum(int(d["bdt_active"]) for d in ds)
        full = self.state.n * (1 if self.mesh is None else self.mesh.size) * len(ds)
        resorts = sum(int(d["bdt_resort"]) for d in ds)
        self.bdt_updates += updates
        self.bdt_updates_full += full
        self.bdt_resorts += resorts
        self.bdt_keeps += len(ds) - resorts
        self.telemetry.event(
            "dt_bins", it=steps[-1][0], steps=len(ds),
            pop=[int(ds[-1][f"bdt_pop[{k}]"]) for k in range(self.dt_bins)],
            updates=updates, updates_full=full,
            saved=round(1.0 - updates / full, 6) if full else 0.0,
            resorts=resorts, keeps=len(ds) - resorts,
            drift_max=max(int(d["bdt_drift"]) for d in ds),
            work=sum(float(d["bdt_work"]) for d in ds))

    def drain_snapshots(self) -> list:
        """(iteration, npz path) of every frame written since the last
        drain, in iteration order (the ``--insitu`` renderer's input: host
        file IO only). Frames appear at check and flush boundaries only, so
        under deferral a window's due frames land together."""
        frames, self._snap_frames = self._snap_frames, []
        return frames

    def _emit_snapshot(self, fetched, its) -> None:
        """At a check or flush boundary: for every verified step due
        (``it % snap_every == 0``) one ``.npz`` frame into the ring (the
        grid, its extrema, the spec and the step's box, read with its
        scalars; at most ``snap_keep`` frames) and one ``snapshot`` event
        (the grid's meta and extrema, the frame's path). Host numpy and
        file IO on diagnostics already read; on a mesh rank 0 writes."""
        spec = self._snap_spec
        if spec is None:
            return
        steps = [(it, d) for it, d in zip(its, fetched)
                 if "snap_grid" in d and it % self._snap_every == 0]
        writer = self.mesh is None or self.mesh.rank == 0
        for it, d in steps:
            vmin = [float(v) for v in d["snap_min"]]
            vmax = [float(v) for v in d["snap_max"]]
            path = None
            if self._snap_dir and writer:
                os.makedirs(self._snap_dir, exist_ok=True)
                path = os.path.join(self._snap_dir, f"snap_{int(it):06d}.npz")
                payload = {
                    "grid": d["snap_grid"].astype(np.float32), "it": np.int64(it),
                    "fields": np.asarray(spec.fields), "axis": np.int64(spec.axis),
                    "reduce": np.asarray(spec.reduce), "volume": np.bool_(spec.volume),
                    "lo": d["snap_lo"], "lengths": d["snap_lengths"],
                    "vmin": np.asarray(vmin), "vmax": np.asarray(vmax),
                }
                if "snap_pts" in d:
                    payload["pts"] = d["snap_pts"].astype(np.float32)
                np.savez(path, **payload)
                self._snap_frames.append((int(it), path))
                self._snap_ring.append(path)
                while self._snap_keep > 0 and len(self._snap_ring) > self._snap_keep:
                    old = self._snap_ring.pop(0)
                    try:
                        os.remove(old)
                    except OSError:
                        pass
            self.telemetry.event("snapshot", it=int(it), fields=list(spec.fields),
                                 grid=spec.grid, axis=spec.axis, reduce=spec.reduce,
                                 volume=spec.volume, vmin=vmin, vmax=vmax, path=path)

    def drain_science(self) -> list:
        """Per-step science rows (constants.txt material: it, t, dt,
        energies, momenta, the case extra) since the last drain, one per
        verified step in iteration order, from scalars already read.
        Under deferral a window's rows land at its flush; a rolled-back
        window leaves none (its replay does). Needs
        ``Simulation(science_rows=True)``."""
        rows, self._science = self._science, []
        return rows

    def _emit_science(self, fetched, its) -> None:
        """At a check or flush boundary: one ``physics`` and one
        ``numerics`` event per checked step or clean window (per-step
        lists), the science rows, and the drift and field-health
        watchdogs; host arithmetic on scalars already read."""
        steps = [(it, d) for it, d in zip(its, fetched) if "obs_etot" in d]
        if not steps:
            return
        tel = self.telemetry
        rows = []
        for it, d in steps:
            row = {"it": int(it), "t": float(d["obs_ttot"]), "dt": float(d["dt"]),
                   "etot": float(d["obs_etot"]), "ecin": float(d["obs_ecin"]),
                   "eint": float(d["obs_eint"]), "egrav": float(d["obs_egrav"]),
                   "linmom": float(d["obs_linmom"]), "angmom": float(d["obs_angmom"])}
            if "obs_extra" in d:
                row["extra"] = float(d["obs_extra"])
            rows.append(row)
        if self._collect_science:
            self._science.extend(rows)
        if self._etot0 is None and np.isfinite(rows[0]["etot"]):
            self._etot0 = rows[0]["etot"]
        payload = {k: [r[k] for r in rows]
                   for k in ("dt", "etot", "ecin", "eint", "egrav", "linmom", "angmom")}
        # simulated time travels as t_sim: the envelope owns "t"
        payload["t_sim"] = [r["t"] for r in rows]
        if all("extra" in r for r in rows):
            payload["extra"] = [r["extra"] for r in rows]
        tel.event("physics", it=rows[-1]["it"], steps=len(rows),
                  its=[r["it"] for r in rows], **payload)

        # numerics: limiter histogram and window-aggregate health scalars
        lim: Dict[str, int] = {}
        bad = {"rho": 0, "h": 0, "du": 0}
        first_bad = None
        for it, d in steps:
            if "dt_limiter" in d:
                name = DT_LIMITERS[int(d["dt_limiter"])]
                lim[name] = lim.get(name, 0) + 1
            step_bad = {f: int(d.get(f"n_bad_{f}", 0)) for f in bad}
            for f in bad:
                bad[f] = max(bad[f], step_bad[f])
            if first_bad is None and sum(step_bad.values()) > 0:
                first_bad = (it, step_bad)
        ds = [d for _, d in steps]

        def ext(key, fn):
            # over the window's finite samples only: Python min/max of a
            # NaN depends on the order; the counts report the corruption
            arr = np.asarray([float(d.get(key, np.nan)) for d in ds])
            finite = arr[np.isfinite(arr)]
            return float(fn(finite)) if finite.size else float("nan")

        agg = {
            "nc_clip": max(int(d.get("n_nc_clip", 0)) for d in ds),
            "h_sat": max(int(d.get("n_h_sat", 0)) for d in ds),
            "rho_min": ext("rho_min", np.min),
            "rho_max": ext("rho_max", np.max),
            "h_min": ext("h_min", np.min),
            "h_max": ext("h_max", np.max),
            "du_max": ext("du_max", np.max),
        }
        tel.event("numerics", it=rows[-1]["it"], steps=len(rows), limiter=lim,
                  nonfinite=bad, **agg)

        # conservation-drift watchdog over every step of the window (a
        # mid-window excursion that relaxes by the flush still fires);
        # energy_drift is the latest verified value
        if self._etot0 is not None:
            denom = abs(self._etot0) or 1.0
            drifts = [abs(r["etot"] - self._etot0) / denom for r in rows]
            self.energy_drift = drifts[-1]
            worst = max(range(len(rows)),
                        key=lambda i: drifts[i] if np.isfinite(drifts[i]) else -1.0)
            if self._drift_budget is not None and drifts[worst] > self._drift_budget:
                tel.count("drifts")
                tel.event("drift", it=rows[worst]["it"], drift=drifts[worst],
                          budget=self._drift_budget, etot0=self._etot0,
                          etot=rows[worst]["etot"])
        # field-health watchdog: nonfinite rho/h/du, naming the first bad step
        if first_bad is not None:
            it_bad, step_bad = first_bad
            tel.count("field_health")
            tel.event("field_health", it=it_bad, nonfinite=sum(step_bad.values()),
                      fields=step_bad,
                      hint="re-run with --debug-checks to localize")

    def run(self, num_steps: int, log_every: int = 0, printer=print):
        """Advance ``num_steps`` steps, then flush the last window: the
        state is verified before it is handed back. Every ``log_every``
        iterations a report line goes through the telemetry's console sink
        (else ``printer``). Returns the state."""
        emit = self.telemetry.console_printer(printer)
        nan = float("nan")
        for _ in range(num_steps):
            d = self.step()
            if log_every and self.iteration % log_every == 0:
                if d.get("deferred"):
                    emit(f"it {self.iteration:5d}  (deferred check)")
                else:
                    emit(f"it {self.iteration:5d}  t={float(self.state.ttot):.6g}  "
                         f"dt={d.get('dt', nan):.4g}  nc~{d.get('nc_mean', nan):.1f}  "
                         f"rho_max={d.get('rho_max', nan):.4g}")
        self.flush()
        return self.state
