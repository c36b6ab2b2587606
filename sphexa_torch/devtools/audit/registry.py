"""The audit entry registry of the port (the JAX package's
devtools/audit/registry.py): the package's hot paths, on one device and
on ranks.

Each ``@entrypoint`` builder constructs a small case (the init cases at
the JAX registry's sides, through the same ``Simulation`` the CLI uses,
so that the audited config is the shipped config) and returns the
callable + example args an audit runs. Builders run lazily per audit run
and build on ``audit_context().device`` ("cuda" unless the caller asks
for the CPU, ``cost --cpu``), so importing this module stays cheap and
device-free.

The step entries run the propagator's step on the Simulation's carry
(``propagator.step_sim_state``: the step every ``Simulation.step()``
launches) without the Simulation's read of the card. At these sides every
SPH case streams (its grid folds), so the step entries launch K1, the
self-gravity ones K12, the block time steps K13's one-row form, and
``gravity_solve`` K12 and K13. The two list-mode cases (Noh at
``LIST_SIDE``, whose grid does not fold) build the lists (K5) and walk
them (K6). ``knob_inertness`` carries the JXA402 probes. ``step_std``
and ``gravity_solve`` declare statecheck's grow probe (side 8), the
steps their carry (JXA503).

The sharded entries (``mesh_axes=("p",)``) build inside the ranks that
``core.run_sharded`` starts (``audit_mesh()``: the rank's Mesh, of
``audit_context().mesh_size`` ranks; the CLI's modes run 2, ``preflight
--mesh P`` P) at the JAX builders' cases: Sedov side 6 (side 8 where 216
rows do not split over P), Evrard side 6 trimmed to a multiple of 16,
Evrard side 20 at theta 0.8 for the MAC-sized gravity serve. Each rank
holds its slab of the globally sorted arrays (the sort untallied, as the
JAX builders sort in numpy) where the JAX entry's arguments are sorted;
the gravity entries run the bitmask compaction, so that K13 runs beside
K12's jdata form.
The two step entries run the sharded Simulation's step, whose force
stage starts with the port's distributed sort, which the JAX entries
leave out (they audit ``step_hydro_std`` without the stepper's
re-sharding prologue): its all_to_all and counts enter the JXA203 gate
as ``sort_bytes`` beside the JAX builders' ``exchange_budget_bytes``,
and its read of the cut table is a declared host sync.
"""

import dataclasses
import functools

from sphexa_torch.devtools.audit.core import (
    EntryCase,
    audit_context,
    audit_mesh,
    entrypoint,
)

# the JAX registry's sizes: big enough for a real neighbour grid and a
# multi-level gravity tree, small enough that a step runs in well under a
# second on a CPU host
_SIDE = 6          # 216 particles (cube cases)
_SIDE_GRAV = 6     # sphere cuts (evrard) keep about half of side^3
#: statecheck's second point (the JAX registry's grow side)
_SIDE_GROW = 8
#: the side of the list-mode cases: Noh's grid does not fold there, so its
#: steps take the lists (the side-6 entries all stream)
LIST_SIDE = 12


@functools.lru_cache(maxsize=None)
def _sim(case: str, side: int, prop: str, device: str, **kw):
    """Memoized Simulation construction: entries only READ the sim's
    state and config (each step builds a new state), so entries share
    one build per device."""
    from sphexa_torch.init import make_initializer
    from sphexa_torch.simulation import Simulation

    state, box, const = make_initializer(case)(side, device=device)
    return Simulation(state, box, const, prop=prop, device=device, **kw)


def _step_case(sim) -> EntryCase:
    """One step of ``sim``'s propagator on its carry, on its lists where
    it keeps them."""
    from sphexa_torch.propagator import step_sim_state

    lists = None
    if sim._use_lists:
        if sim.lists is None:
            sim._rebuild_lists()
        lists = sim.lists
    return EntryCase(
        fn=lambda carry: step_sim_state(sim._step_fn, carry, sim.cfg, sim.gtree,
                                        sim._aux_cfg, lists=lists),
        args=(sim.sim_state,),
        carry=lambda args, out: (out[0],),
    )


# ---------------------------------------------------------------------------
# propagator steps (the five production steps)
# ---------------------------------------------------------------------------


@entrypoint("step_std", grow=lambda: _step_case(_sim("sedov", _SIDE_GROW, "std",
                                                     audit_context().device)))
def step_std():
    return _step_case(_sim("sedov", _SIDE, "std", audit_context().device))


@entrypoint("step_ve")
def step_ve():
    return _step_case(_sim("sedov", _SIDE, "ve", audit_context().device))


@entrypoint("step_nbody")
def step_nbody():
    return _step_case(_sim("evrard", _SIDE_GRAV, "nbody", audit_context().device))


@entrypoint("step_turb_ve")
def step_turb_ve():
    return _step_case(_sim("turbulence", _SIDE, "turb-ve", audit_context().device))


@entrypoint("step_std_cooling")
def step_std_cooling():
    return _step_case(_sim("evrard-cooling", _SIDE_GRAV, "std-cooling",
                           audit_context().device))


# ---------------------------------------------------------------------------
# gravity solve (gravity/traversal.py)
# ---------------------------------------------------------------------------


def _gravity_case(side: int) -> EntryCase:
    from sphexa_torch.gravity.traversal import compute_gravity
    from sphexa_torch.propagator import _force_stage_prologue

    sim = _sim("evrard", side, "nbody", audit_context().device)
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    meta = sim.cfg.grav_meta
    gcfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g, compaction="bitmask")
    return EntryCase(
        fn=lambda x, y, z, m, h, sk: compute_gravity(x, y, z, m, h, sk, box, sim.gtree,
                                                     meta, gcfg),
        args=(ss.x, ss.y, ss.z, ss.m, ss.h, keys),
    )


@entrypoint("gravity_solve", grow=lambda: _gravity_case(_SIDE_GROW))
def gravity_solve():
    """The Evrard solve on the step's sorted arrays (the sort untallied),
    in the engine backend's bitmask compaction (its form from 500k
    particles, one-level here): the list compaction K13 runs, beside the
    near field K12. The steps' solves at this size take the sort
    compaction, as the JAX registry's do."""
    return _gravity_case(_SIDE_GRAV)


# ---------------------------------------------------------------------------
# block time steps
# ---------------------------------------------------------------------------


@entrypoint("step_std_blockdt")
def step_std_blockdt():
    return _step_case(_sim("sedov", _SIDE, "std", audit_context().device, dt_bins=4,
                           bin_resort_drift=0.01))


# ---------------------------------------------------------------------------
# the in-step science ledger and field snapshot (observables/), audited
# standalone as in the JAX registry
# ---------------------------------------------------------------------------


@entrypoint("observable_ledger")
def observable_ledger():
    import torch

    from sphexa_torch.observables.ledger import ObservableSpec, ledger_diagnostics

    sim = _sim("sedov", _SIDE, "std", audit_context().device)
    s, box, const = sim.state, sim.box, sim.const
    ngmax = sim.cfg.nbr.ngmax
    spec = ObservableSpec(extra="mach")  # exercises the case-extra path
    rho = torch.ones_like(s.m)
    c = torch.ones_like(s.m)
    nc = torch.full((s.n,), const.ng0 - 1, dtype=torch.int32, device=s.m.device)
    egrav = torch.zeros((), dtype=torch.float32, device=s.m.device)

    def fn(state, rho, nc, c):
        return ledger_diagnostics(state, rho, nc, const, ngmax, spec=spec, egrav=egrav,
                                  box=box, c=c)

    return EntryCase(fn=fn, args=(s, rho, nc, c))


@entrypoint("observable_snapshot")
def observable_snapshot():
    import torch

    from sphexa_torch.observables.snapshot import SnapshotSpec, snapshot_diagnostics

    sim = _sim("sedov", _SIDE, "std", audit_context().device)
    s, box = sim.state, sim.box
    # exercises the multi-field stack and the particle-subsample tap
    spec = SnapshotSpec(fields=("rho", "temp"), grid=8, stride=7)
    rho = torch.ones_like(s.m)

    def fn(state, rho):
        return snapshot_diagnostics(state, rho, box, spec)

    return EntryCase(fn=fn, args=(s, rho))


# ---------------------------------------------------------------------------
# list mode (kernels/cost_checks.py holds them on the card)
# ---------------------------------------------------------------------------


def _list_case(prop: str) -> EntryCase:
    """One list build (which sorts the Simulation's state) and one step on
    the lists from the sorted state, of Noh at ``LIST_SIDE`` with ``prop``:
    K5 and the prop's K6 walks in their mask modes. The untallied warm-up
    sorts the initial state, so that every recorded run starts from the
    same sorted state. Its two host syncs are the build's: the list's
    overflow read (``Simulation._rebuild_lists``) and the size of the
    walk's mask-word buffer (``pair_lists.build_pair_lists``)."""
    from sphexa_torch.propagator import step_sim_state

    sim = _sim("noh", LIST_SIDE, prop, audit_context().device)
    if not sim._use_lists:
        raise AssertionError(f"noh {LIST_SIDE} {prop}: the step streams, no list mode")

    def run():
        sim._rebuild_lists()
        return step_sim_state(sim._step_fn, sim.sim_state, sim.cfg, sim.gtree,
                              sim._aux_cfg, lists=sim.lists)

    return EntryCase(fn=run)


@entrypoint("step_std_lists", host_syncs=2)
def step_std_lists():
    return _list_case("std")


@entrypoint("step_ve_lists", host_syncs=2)
def step_ve_lists():
    return _list_case("ve")


# ---------------------------------------------------------------------------
# JXA402's carrier
# ---------------------------------------------------------------------------


@entrypoint("knob_inertness", phase_coverage_min=0.0)
def knob_inertness():
    """JXA402 carrier: its run is a stub; the rule's work is the off-vs-unset
    probes of ``lowerdiff.production_knob_probes`` (a probe Simulation's
    step for every off-sentinel knob of tuning/knobs.py against the step
    that never names it). An entry of its own keeps the probes out of the
    step entries' rule loops while every package audit runs them."""
    import torch

    from sphexa_torch.devtools.audit.lowerdiff import production_knob_probes

    return EntryCase(fn=lambda x: x * 1.0,
                     args=(torch.ones(8, device=audit_context().device),),
                     knob_probes=production_knob_probes)


# ---------------------------------------------------------------------------
# the sharded entries: P ranks, one slab each
# ---------------------------------------------------------------------------

#: headroom added to every analytic exchange budget (the JAX registry's):
#: the small collectives riding a stage (escape flags, the gathered
#: telemetry scalars, range bounds)
_EXCHANGE_HEADROOM = 262_144

# The host syncs of the sharded stages (JXA104, declared at P = 2; the XLA
# programs of the JAX package have none), by the code that needs them:
#: ``exchange.global_cell_table``'s histogram (a ``bincount``)
_SYNC_TABLE = 1
#: the windowed exchange's window bounds over the active runs (boolean
#: masks, ``exchange.window_bounds``)
_SYNCS_WINDOWS = 4
#: the sparse exchange's per-distance caps made into tensors
#: (``localize_ranges_sparse``, ``exchange_metrics_sparse``: 3) and the one
#: round's packing over the selected cells (boolean masks, ``_pack_rows``: 3)
_SYNCS_SPARSE = 3 + 3
#: the gravity traversal's infinity constant of the slab-boundary blocks
#: (``traversal._slab_blocks``)
_SYNC_GRAVITY = 1
#: the distributed sort's cut table (``sort.sort_slabs``)
_SYNC_SORT = 1


def _mesh_and_side():
    """(the rank's Mesh, a Sedov side whose particle count splits over its
    ranks: 6, or 8 where 216 does not split)."""
    mesh = audit_mesh()
    return mesh, (_SIDE if (_SIDE ** 3) % mesh.size == 0 else 8)


def _sorted_slab(mesh, state, box, curve: str = "hilbert"):
    """This rank's slab of the globally SFC-sorted arrays (every rank
    sorts the whole state, as the JAX builders sort in numpy): (keys, x,
    y, z, h, m)."""
    import torch

    from sphexa_torch.sfc.keys import compute_sfc_keys

    keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve)
    order = torch.argsort(keys, stable=True)
    S = state.n // mesh.size
    rows = order[mesh.rank * S:(mesh.rank + 1) * S]
    return tuple(a[rows].contiguous() for a in (keys, state.x, state.y, state.z, state.h,
                                                state.m))


def _halo_case(sparse: bool) -> EntryCase:
    """The halo exchange stage on the globally sorted slabs (the JAX
    builders' shard_map): the prologue against the global cell table, one
    serve of (x, y, z, m) into the j-buffers, and the stage's closing
    all_gather of the escape flags and exchange metrics
    (``propagator._shard_tail``)."""
    import torch

    from sphexa_torch.init import make_initializer
    from sphexa_torch.parallel import exchange as ex
    from sphexa_torch.propagator import _shard_tail
    from sphexa_torch.simulation import make_propagator_config

    mesh, side = _mesh_and_side()
    device = audit_context().device
    state, box, const = make_initializer("sedov")(side, device=device)
    cfg = make_propagator_config(state, box, const)
    keys, x, y, z, h, m = _sorted_slab(mesh, state, box, cfg.curve)
    P, S = mesh.size, state.n // mesh.size
    nbr = ex.slab_nbr(cfg.nbr, S)
    # full per-distance coverage at this size, as the JAX builders'
    hmax = (S,) * (P - 1)

    def stage(b, keys, x, y, z, h, m):
        if sparse:
            ranges, serve, jbuf, escaped, metrics = ex.shard_halo_stage_sparse(
                mesh, x, y, z, h, keys, b, nbr, hmax)
        else:
            ranges, serve, jbuf, escaped, metrics = ex.shard_halo_stage(
                mesh, x, y, z, h, keys, b, nbr, S)
        halo = serve((x, y, z, m))
        jx, jy, jz, jm = jbuf((x, y, z, m), halo)
        _, occ, sdiag = _shard_tail(mesh, [], torch.zeros((), dtype=torch.int32,
                                                          device=x.device),
                                    escaped, nbr.cap, ranges.lens.sum(), metrics)
        return jx, jy, jz, jm, occ, sdiag

    # the serve's volume: hmax rows a peer distance (the windowed: P windows
    # of S rows) x 4 fields of float32, as the JAX builders'
    rows = sum(hmax) if sparse else P * S
    return EntryCase(fn=stage, args=(box, keys, x, y, z, h, m),
                     exchange_budget_bytes=rows * 4 * 4 + _EXCHANGE_HEADROOM)


@entrypoint("halo_exchange_sparse", mesh_axes=("p",), host_syncs=_SYNC_TABLE + _SYNCS_SPARSE)
def halo_exchange_sparse():
    return _halo_case(sparse=True)


@entrypoint("halo_exchange_windowed", mesh_axes=("p",),
            host_syncs=_SYNC_TABLE + _SYNCS_WINDOWS)
def halo_exchange_windowed():
    return _halo_case(sparse=False)


def _gravity_sharded_case(side: int, theta=None, sparse: bool = False) -> EntryCase:
    """``propagator._gravity_sharded_stage`` on the globally sorted slabs of
    Evrard at ``side`` (trimmed to a multiple of 16, so that one state
    shards on any audited mesh), under the sharded N-body Simulation's
    tree and caps, in the bitmask compaction: the sharded upsweep, the
    classification against the rank's essential set, M2P, the near field
    through whole slabs or, ``sparse``, the MAC-sized serve
    (``sizing.device_gravity_halo``'s caps at the JAX builder's margin and
    quantum), and the stage's closing all_gather."""
    import torch

    from sphexa_torch import propagator as prop
    from sphexa_torch.init import make_initializer
    from sphexa_torch.parallel.sizing import device_gravity_halo
    from sphexa_torch.simulation import Simulation

    mesh = audit_mesh()
    device = audit_context().device
    state, box, const = make_initializer("evrard")(side, device=device)
    n16 = state.n // 16 * 16
    state = dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[:n16] for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name)) and getattr(state, f.name).dim() == 1
        and getattr(state, f.name).shape[0] == state.n})
    kw = {} if theta is None else {"theta": theta}
    sim = Simulation(state, box, const, prop="nbody", device=device, num_devices=mesh.size,
                     grav_window=0, **kw)
    keys, x, y, z, h, m = _sorted_slab(mesh, state, sim.box, sim.curve)
    own = dataclasses.replace(sim.state, x=x, y=y, z=z, h=h, m=m)
    # the engine backend's bitmask compaction (its form from 500k particles,
    # as in ``gravity_solve``): K13 runs beside K12's jdata form
    cfg = dataclasses.replace(sim.cfg, gravity=dataclasses.replace(sim.cfg.gravity,
                                                                   compaction="bitmask"))
    budget = None
    if sparse:
        cells = device_gravity_halo(mesh, x, y, z, m, keys, sim.box, sim.gtree,
                                    sim.cfg.grav_meta, sim.theta)
        cfg = dataclasses.replace(cfg, grav_cells=tuple(int(c) for c in cells))
        # 5 served fields (x, y, z, m, h) of float32, as the JAX builder's
        budget = sum(cells) * 5 * 4 + _EXCHANGE_HEADROOM
    zeros = torch.zeros_like(x)
    return EntryCase(
        fn=lambda st, b, k, gt: prop._gravity_sharded_stage(st, b, k, cfg, gt, zeros, zeros,
                                                            zeros),
        args=(own, sim.box, keys, sim.gtree), exchange_budget_bytes=budget)


# the near field's serve of whole slabs (the windowed exchange's bounds)
@entrypoint("gravity_sharded", mesh_axes=("p",), host_syncs=_SYNCS_WINDOWS + _SYNC_GRAVITY)
def gravity_sharded():
    return _gravity_sharded_case(_SIDE_GRAV)


# the MAC-sized sparse serve
@entrypoint("gravity_sharded_windowed", mesh_axes=("p",),
            host_syncs=_SYNCS_SPARSE + _SYNC_GRAVITY)
def gravity_sharded_windowed():
    """The MAC-sized sparse gravity serve, at a node count and opening
    angle where the MAC prunes (Evrard side 20, theta 0.8, the JAX
    builder's case)."""
    return _gravity_sharded_case(20, theta=0.8, sparse=True)


def _sort_bytes(sim) -> int:
    """The bytes a rank receives through the step's distributed sort: the
    all_to_all of its slab (every row, the worst case: the particle fields,
    the aux slot's rows and the key's and integers' bit columns, float32)
    and the counts (a (P - 1, 2^b - 1) int64 all_reduce a radix round, one
    (P, 2, P - 1) int64 all_gather)."""
    from sphexa_torch.parallel.sort import SPATIAL_KEY_BITS, _rounds
    from sphexa_torch.sph.blockdt import FOLD_BITS
    from sphexa_torch.sph.particles import PARTICLE_FIELDS

    S, P = sim.state.n, sim.mesh.size
    cols = len(PARTICLE_FIELDS) + 2
    key_bits = SPATIAL_KEY_BITS
    if sim.bdt_state is not None:
        key_bits += FOLD_BITS
        aux = sim.bdt_state
        cols += sum(getattr(aux, f.name).element_size() // 4 for f in dataclasses.fields(aux)
                    if getattr(aux, f.name).shape == (S,))
    counts = sum((P - 1) * ((1 << bits) - 1) * 8 for _, bits in _rounds(key_bits))
    return S * cols * 4 + counts + P * 2 * (P - 1) * 8


def _sharded_step_case(**kw) -> EntryCase:
    """One step of the sharded std Simulation on Sedov (its carry, the
    config ``make_sharded_step`` bound: the sparse halo caps the sizing
    measured), with the JAX builders' budget, ``_halo_info["bytes_per_step"]``
    plus the headroom, and the distributed sort's bytes."""
    mesh, side = _mesh_and_side()
    device = audit_context().device
    sim = _sim("sedov", side, "std", device, num_devices=mesh.size, **kw)
    case = _step_case(sim)
    case.exchange_budget_bytes = sim.halo_info["bytes_per_step"] + _EXCHANGE_HEADROOM
    case.sort_bytes = _sort_bytes(sim)
    return case


@entrypoint("step_std_sharded", mesh_axes=("p",),
            host_syncs=_SYNC_SORT + _SYNC_TABLE + _SYNCS_SPARSE)
def step_std_sharded():
    """The sharded std step; its host syncs: the distributed sort's read of
    the cut table (``parallel/sort.py``: the all_to_all's sizes) and the
    sparse halo exchange's."""
    return _sharded_step_case()


@entrypoint("step_std_blockdt_sharded", mesh_axes=("p",),
            host_syncs=_SYNC_SORT + _SYNC_TABLE + _SYNCS_SPARSE)
def step_std_blockdt_sharded():
    """The sharded block-time-step step at dt_bins 4: the folded-key sort,
    the bins riding it, K13's one-row form on the rank's due rows; its host
    syncs are ``step_std_sharded``'s."""
    return _sharded_step_case(dt_bins=4)


@entrypoint("observable_ledger_sharded", mesh_axes=("p",))
def observable_ledger_sharded():
    """The ledger on the ranks' slabs: its sums, counts and extrema in the
    mesh's one ``reduce_scalars`` (an all_gather and rank-order sums)."""
    import torch

    from sphexa_torch.init import make_initializer
    from sphexa_torch.observables.ledger import ledger_diagnostics
    from sphexa_torch.parallel.mesh import shard_state
    from sphexa_torch.simulation import make_propagator_config

    mesh, side = _mesh_and_side()
    device = audit_context().device
    state, box, const = make_initializer("sedov")(side, device=device)
    ngmax = make_propagator_config(state, box, const).nbr.ngmax
    own = shard_state(state, mesh)
    rho = torch.ones_like(own.m)
    nc = torch.full((own.n,), const.ng0 - 1, dtype=torch.int32, device=own.m.device)
    return EntryCase(fn=lambda st, rho, nc: ledger_diagnostics(st, rho, nc, const, ngmax,
                                                                mesh=mesh),
                     args=(own, rho, nc))


@entrypoint("observable_snapshot_sharded", mesh_axes=("p",))
def observable_snapshot_sharded():
    """The snapshot deposit on the ranks' slabs, the partial grids summed
    in the mesh's one ``reduce_scalars``."""
    import torch

    from sphexa_torch.init import make_initializer
    from sphexa_torch.observables.snapshot import SnapshotSpec, snapshot_diagnostics
    from sphexa_torch.parallel.mesh import shard_state

    mesh, side = _mesh_and_side()
    device = audit_context().device
    state, box, _ = make_initializer("sedov")(side, device=device)
    own = shard_state(state, mesh)
    spec = SnapshotSpec(fields=("rho",), grid=8)
    return EntryCase(fn=lambda st, rho, b: snapshot_diagnostics(st, rho, b, spec, mesh=mesh),
                     args=(own, torch.ones_like(own.m), box))


# phase_coverage_min=0: a reconfigure-time program, outside the step taxonomy
@entrypoint("tree_build_sizing", mesh_axes=("p",), phase_coverage_min=0.0, host_syncs=7)
def tree_build_sizing():
    """The neighbour sizing on the ranks (``parallel.sizing.sizing_stats``:
    the densest cell and the widest group over every rank's particles,
    read on the host; the groups of 64 over the global sorted array, as the
    JAX entry's one-device sizing forms them) and the key histogram the
    over the ranks. Its host syncs: the sort's cut table, the global cell
    table's histogram, the two constants of the global groups' bounds
    (``cell_list.slab_group_bounds``), the two reads of the sizing's
    results and the key histogram (a ``bincount``)."""
    from sphexa_torch.dtypes import INDEX_DTYPE
    from sphexa_torch.init import make_initializer
    from sphexa_torch.parallel import sizing
    from sphexa_torch.parallel.mesh import all_reduce_sum, shard_state
    from sphexa_torch.sfc.keys import compute_sfc_keys

    mesh, side = _mesh_and_side()
    device = audit_context().device
    state, box, _ = make_initializer("sedov")(side, device=device)
    own = shard_state(state, mesh)
    level, group = 2, 64
    keys = compute_sfc_keys(own.x, own.y, own.z, box)

    def fn(x, y, z, b, keys):
        occ, ext = sizing.sizing_stats(mesh, x, y, z, b, level, group, global_groups=True)
        hist = all_reduce_sum(mesh, sizing.key_histogram(keys, level))
        # the JAX entry's int32 histogram (the outputs' integers are int32)
        return occ, ext, hist.to(INDEX_DTYPE)

    return EntryCase(fn=fn, args=(own.x, own.y, own.z, box, keys))
