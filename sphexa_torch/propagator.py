"""The std-SPH and VE steps (sphexa_tpu/propagator.py, the pallas paths).

Streaming step: box regrow -> SFC keys -> stable sort -> candidate-run
prologue -> the force stage -> timestep -> positions and h update. The
std force stage is density -> EOS -> IAD -> momentum/energy; the VE one
(the reference's flagship, ve_hydro.hpp:131-208) is xmass -> grad-h ->
EOS -> IAD -> divv/curlv -> AV switches -> momentum/energy, all six ops
on one set of runs. With self-gravity (``cfg.gravity``, open boxes) the
Barnes-Hut accelerations of the sorted particles are added to the hydro
ones (``_add_gravity``), the acceleration condition joins the time step
candidates and egrav the diagnostics; in a fully periodic box
(``cfg.ewald``) the solve is Ewald's (gravity/ewald.py). The N-body step
(``_step_nbody``) runs the gravity alone: sort, solve, the acceleration
time step and the drift, no SPH. With persistent lists (``lists=``,
not under gravity) a steady step runs in the order frozen at the last
``rebuild_pair_lists``: no regrow, no sort, no prologue; it reports the
lists' remaining skin (``list_slack``) and whether they still cover its
input (``list_ok``). With ``cfg.obs`` set the step tail also computes
the science ledger (observables/ledger.py) over the post-integration
state. The turb-ve step (``_step_turb_ve``) adds the OU stirring
(sph/hydro_turb.py) to the VE step's accelerations; the std-cooling step
(``_step_hydro_std_cooling``) adds the cooling time to the std step's dt
candidates and the cooling source to du (physics/cooling.py), and its
per-particle chemistry rides the sort: ``_sort_by_keys``,
``rebuild_pair_lists`` and the force stages' prologue take it as
``aux`` and permute it by the same gather as the state. The block time
step twins (``_step_hydro_std_blockdt``, ``_step_hydro_ve_blockdt``;
sph/blockdt.py, ``cfg.dt_bins``) sort on the bin-folded key, drift-aware,
run the full force stage, then kick only the due rows, which K13's
one-row form lists; their BlockDtState rides the sort as the aux. PyTorch
runs the steps eagerly; the pair ops launch the CUDA kernels on the card
and their plain versions on the CPU.

The gather backend (``cfg.backend`` "xla", the JAX package's XLA path)
replaces the pair stage of the std and VE force stages (and so of
turb-ve, std-cooling and the block time steps): ``find_neighbors`` keeps
each row's first ``nbr.ngmax`` neighbours in candidate order, and the
masked j-reductions of sph/hydro_std.py and sph/hydro_ve.py run over
those lists in plain PyTorch on either device; the gravity near field is
``traversal._p2p_xla`` (``compute_gravity``'s ``gather_p2p``) and the block
time steps list their due rows without K13. No kernel launches. On a mesh
its force stages are ``_std_gather_sharded`` / ``_ve_gather_sharded``.

Under a mesh (``cfg.mesh``, parallel/mesh.py ``make_sharded_step``;
every step function) the state is this rank's slab: the box
regrow reduces the extrema over the ranks, the sort is the distributed
one (parallel/sort.py: rank k ends with rows [k S, (k + 1) S) of the
global stable sort; the chemistry and the BlockDtState ride it as extra
columns, the block time steps' on the folded key), and the
force stage is ``_std_forces_sharded`` / ``_ve_forces_sharded``: K1 on
the slab against [own slab | halo rows] j-buffers (parallel/exchange.py),
one serve of halo rows per field set the next op reads on its j side
(on the gather backend ``_std_gather_sharded`` / ``_ve_gather_sharded``:
the search of the global groups that meet the slab against a halo of
their whole window cells, then the gather ops on the same j-buffers);
self-gravity is ``_gravity_sharded_stage`` (the sharded upsweep, the
rank's essential set, the near field on served halo rows, open or
Ewald). The N-body step runs the gravity stage alone; the stirring of
turb-ve is replicated (every rank advances the same key chain with the
same dt, over the global mode tables); the block time steps list each
slab's due rows with K13's one-row form. The step's scalars (dt, the
occupancy with the halo escape sentinel folded in, egrav, the
diagnostics, the block counts and the ledger) are reduced over the
ranks, so that every rank returns the same ones.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sphexa_torch.gravity.ewald import EwaldConfig, compute_gravity_ewald
from sphexa_torch.gravity.traversal import GravityConfig, compute_gravity
from sphexa_torch.gravity.tree import GravityTree, GravityTreeMeta
from sphexa_torch.neighbors.cell_list import NeighborConfig, find_neighbors
from sphexa_torch.observables.ledger import ObservableSpec, ledger_diagnostics
from sphexa_torch.observables.snapshot import SnapshotSpec
from sphexa_torch.observables import snapshot as snap
from sphexa_torch.physics.cooling import CoolingConfig, cool_step, cool_timestep
from sphexa_torch.sfc.box import Box, make_global_box, put_in_box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph import blockdt as bdt
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.pair_lists import PairLists, build_pair_lists, list_slack
from sphexa_torch.sph import hydro_std, hydro_ve
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_turb import TurbulenceConfig, drive_turbulence
from sphexa_torch.sph.hydro_ve import compute_eos_ve
from sphexa_torch.sph.kernels import update_h
from sphexa_torch.sph.particles import PARTICLE_FIELDS, ParticleState, SimConstants
from sphexa_torch.sph.positions import compute_positions
from sphexa_torch.sph.timestep import acceleration_timestep, compute_timestep, rho_timestep
from sphexa_torch.state import SimState
from sphexa_torch.util.phases import check_finite, debug_active, named_phase, phase_scope

#: the scalar diagnostics every step emits (``_integrate_and_finish`` is
#: their one producer); the others (egrav, list_slack, the ledger's
#: OBS_DIAG_KEYS / NUM_DIAG_KEYS, ...) ride along, and consumers .get() them
STEP_DIAG_KEYS = ("dt", "nc_mean", "nc_max", "occupancy", "rho_max", "h_max")

#: ``diagnostics["dt_limiter"]`` indexes this tuple
DT_LIMITERS = ("growth", "courant", "rho", "cool", "accel")

#: per-rank (P,) diagnostics of the sharded force stages, the same on every
#: rank: each rank's true remote halo rows, its fullest halo buffer's
#: occupancy, its candidate rows a pair op streams, its escape trips
SHARD_DIAG_KEYS = ("shard_rows", "shard_occ", "shard_work", "shard_trips")

#: the gravity stage's (P,) diagnostics, with the MAC-sized sparse serve:
#: each rank's true remote near-field rows and its fullest per-distance
#: buffer's occupancy
GRAV_SHARD_DIAG_KEYS = ("gshard_rows", "gshard_occ")

#: step diagnostics reduced by min over the ranks (with the step's other
#: scalars, no collective of their own)
_MESH_MIN_KEYS = ("du_cool_min",)


#: the force stages' backends: "pallas" the fused search+op kernels (the
#: pair engine; CUDA kernels on the card, their plain versions on the
#: CPU), "xla" the gather path (find_neighbors' (N, ngmax) lists and the
#: masked j-reductions of sph/hydro_std.py and sph/hydro_ve.py, plain
#: PyTorch on either device; no kernel launches)
BACKENDS = ("pallas", "xla")


@dataclasses.dataclass(frozen=True)
class PropagatorConfig:
    """Static per-run configuration: physics constants and the neighbour
    search (the fields of the JAX PropagatorConfig this slice reads)."""

    const: SimConstants
    nbr: NeighborConfig
    curve: str = "hilbert"
    # the force stages' backend (BACKENDS); "xla" keeps the first
    # nbr.ngmax neighbours of each row, "pallas" sums every pair within 2h
    backend: str = "pallas"
    # persistent-list mode: > 0 enables it with this per-group slot budget
    list_slot_cap: int = 0
    # Verlet skin as a fraction of the 2 h_max search radius
    list_skin_rel: float = 0.2
    # VE: the av_clean velocity-gradient correction of the viscosity
    av_clean: bool = False
    # self-gravity (const.g != 0): the solver's caps and the tree's static
    # structure; the tree itself is the steps' ``gtree`` argument
    gravity: Optional[GravityConfig] = None
    grav_meta: Optional[GravityTreeMeta] = None
    # the science ledger (observables/ledger.py); None = no ledger
    obs: Optional[ObservableSpec] = None
    # the field-grid deposit of the step tail (observables/snapshot.py);
    # None = no deposit
    snap: Optional[SnapshotSpec] = None
    # periodic self-gravity: the Ewald solve's parameters (None: open box)
    ewald: Optional[EwaldConfig] = None
    # block time steps (sph/blockdt.py): the number of power-of-two dt bins
    # the *_blockdt steps use (None: the global-dt steps, which never read
    # these three), the re-bin cadence in cycles, and the tolerated share
    # of folded-key inversions under which the sort keeps the order
    dt_bins: Optional[int] = None
    bin_sync_every: int = 1
    bin_resort_drift: float = 0.0
    # this rank's mesh (parallel/mesh.py Mesh; None: one device) and the
    # halo exchange's static sizes: per-distance row caps of the sparse
    # exchange (P - 1 of them), else the windowed exchange's per-peer
    # window (0: whole slabs); the gravity near field's per-distance caps
    # (empty: whole slabs)
    mesh: Optional[object] = None
    halo_window: int = 0
    halo_cells: Tuple[int, ...] = ()
    grav_cells: Tuple[int, ...] = ()


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


def _sort_by_keys(state: ParticleState, box: Box, curve: str, aux=None, bins=None,
                  resort_drift: float = 0.0):
    """Global SFC sort: keys, a stable argsort (jnp.argsort is stable), and
    a row gather of the per-particle fields stacked into one (n, F) matrix
    (the JAX package's permute_tree). Returns (state, sorted_keys, order);
    with ``aux`` (a dataclass of per-particle tensors and scalars, such as
    the ChemistryData or the BlockDtState) its (n,) float32 fields join the
    same gather, its other (n,) fields are gathered by the same order, its
    scalars pass through, and the permuted aux comes fourth.

    ``bins`` (block time steps): the sort key is ``blockdt.fold_bin_key``
    and drift-aware: the folded keys' inversions are counted, and where
    they are at most ``int(resort_drift * n)`` the order is kept (the
    identity permutation, nothing moves). Both outcomes are selected on
    the card (``torch.where`` on the order): the argsort runs either way,
    and no host read decides, so a deferred window keeps its one read.
    Returns (state, keys, order, aux, resorted () int32, inversions ()
    int32), ``keys`` permuted as the state."""
    with phase_scope("sort"):
        keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve)
    n = state.n
    extra = ()
    if bins is None:
        with phase_scope("sort"):
            order = torch.argsort(keys, stable=True)
    else:
        with phase_scope("dt-bins"):
            skey = bdt.fold_bin_key(keys, bins)
            inv = torch.sum(skey[1:] < skey[:-1], dtype=torch.int32)
            resort = inv > int(resort_drift * n)
        with phase_scope("sort"):
            order = torch.where(resort, torch.argsort(skey, stable=True),
                                torch.arange(n, device=keys.device))
        extra = (resort.to(torch.int32), inv)
    with phase_scope("sort"):
        return _permute(state, keys, order, aux, bins, extra)


def _permute(state: ParticleState, keys, order, aux, bins, extra):
    """``_sort_by_keys``'s row gather and its returns."""
    n = state.n
    dtype = state.x.dtype
    per = [] if aux is None else [f.name for f in dataclasses.fields(aux)
                                  if getattr(aux, f.name).shape == (n,)]
    joined = [f for f in per if getattr(aux, f).dtype == dtype]
    cols = [getattr(state, f) for f in PARTICLE_FIELDS] + [getattr(aux, f) for f in joined]
    mat = torch.stack(cols, dim=1).index_select(0, order)
    nf = len(PARTICLE_FIELDS)
    new = dataclasses.replace(state, **{f: mat[:, k].contiguous()
                                        for k, f in enumerate(PARTICLE_FIELDS)})
    if aux is not None:
        moved = {f: mat[:, nf + k].contiguous() for k, f in enumerate(joined)}
        moved.update({f: getattr(aux, f).index_select(0, order) for f in per
                      if f not in moved})
        aux = dataclasses.replace(aux, **moved)
    if bins is not None:
        return (new, keys[order], order, aux, *extra)
    if aux is None:
        return new, keys[order], order
    return new, keys[order], order, aux


@named_phase("sort")
def _sort_by_keys_sharded(state: ParticleState, box: Box, curve: str, mesh, aux=None,
                          bins=None, resort_drift: float = 0.0):
    """``_sort_by_keys`` across ranks: this rank's slab of the global
    stable sort (parallel/sort.py). ``aux``'s (S,) fields ride the sort:
    float32 ones (the chemistry, dt_prev) as columns, int32 ones (the
    bins) as the bits of one. Returns (state, sorted keys), and the sorted
    aux third with ``aux``.

    ``bins`` (block time steps): the sort runs on the 32-bit folded key,
    drift-aware as on one device: the inversions are counted over the
    global array (each slab's own plus the P - 1 slab boundaries, the last
    key of rank r against the first of rank r + 1, in one all_gather), and
    at most ``int(resort_drift * N)`` of them keep the order. Every rank
    takes the decision from the same count and selects on the card (the
    sort runs either way, no host read decides): keeping, every rank keeps
    its own rows, and nothing moves between ranks. Returns (state, keys,
    aux, resorted () int32, inversions () int32)."""
    from sphexa_torch.parallel.mesh import all_gather
    from sphexa_torch.parallel.sort import SPATIAL_KEY_BITS, sort_slabs

    keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve)
    n = state.n
    per = [] if aux is None else [f.name for f in dataclasses.fields(aux)
                                  if getattr(aux, f.name).shape == (n,)]
    joined = [f for f in per if getattr(aux, f).dtype == state.x.dtype]
    ints = [f for f in per if f not in joined]
    cols = torch.stack([getattr(state, f) for f in PARTICLE_FIELDS]
                       + [getattr(aux, f) for f in joined], dim=1)
    extra = [getattr(aux, f) for f in ints]
    if bins is None:
        r = sort_slabs(mesh, keys, cols, extra=extra)
        skeys, mat, moved_ints = r.keys, r.rows, r.extra
    else:
        skey = bdt.fold_bin_key(keys, bins)
        local = torch.sum(skey[1:] < skey[:-1], dtype=torch.int64)
        g = all_gather(mesh, torch.stack([skey[0], skey[-1], local]))  # (P, 3)
        inv = (g[:, 2].sum() + torch.sum(g[1:, 0] < g[:-1, 1])).to(torch.int32)
        resort = inv > int(resort_drift * n * mesh.size)
        r = sort_slabs(mesh, skey, cols, key_bits=SPATIAL_KEY_BITS + bdt.FOLD_BITS,
                       extra=extra)
        skeys = torch.where(resort, r.keys >> bdt.FOLD_BITS, keys)
        mat = torch.where(resort, r.rows, cols)
        moved_ints = [torch.where(resort, a, b) for a, b in zip(r.extra, extra)]
    nf = len(PARTICLE_FIELDS)
    new = dataclasses.replace(state, **{f: mat[:, k].contiguous()
                                        for k, f in enumerate(PARTICLE_FIELDS)})
    if aux is not None:
        moved = {f: mat[:, nf + k].contiguous() for k, f in enumerate(joined)}
        moved.update(zip(ints, moved_ints))
        aux = dataclasses.replace(aux, **moved)
    if bins is not None:
        return new, skeys, aux, resort.to(torch.int32), inv
    if aux is None:
        return new, skeys
    return new, skeys, aux


def rebuild_pair_lists(state: ParticleState, box: Box, cfg: PropagatorConfig, aux=None):
    """Persistent-list rebuild: box regrow + global sort + list build. The
    returned state is the frozen sorted order every steady step runs in
    until the next rebuild. The skin follows the current h_max, computed
    in float32 in the JAX package's order: (f32(list_skin_rel) * 2) * max h.
    Returns (state, box, lists), and with ``aux`` (permuted as the state,
    ``_sort_by_keys``) (state, box, lists, aux)."""
    with phase_scope("sort"):
        box = make_global_box(state.x, state.y, state.z, box)
    state, keys, _, *rest = _sort_by_keys(state, box, cfg.curve, aux=aux)
    with phase_scope("neighbors"):
        skin = torch.max(state.h) * float(np.float32(cfg.list_skin_rel) * np.float32(2.0))
        lists = build_pair_lists(state.x, state.y, state.z, state.h, keys, box, cfg.nbr,
                                 skin, cfg.list_slot_cap)
    return (state, box, lists, *rest)


def _check_state(phase: str, state: ParticleState) -> None:
    """``--debug-checks``: the first non-finite per-particle field of a
    stage's output state (a no-op outside the debug checks)."""
    if debug_active():
        check_finite(phase, **{f: getattr(state, f) for f in PARTICLE_FIELDS})


def _force_stage_prologue(state: ParticleState, box: Box, cfg: PropagatorConfig,
                          lists: Optional[PairLists] = None, aux=None, keys=None):
    """Head of the force stage. Streaming: box regrow + global sort. List
    mode: nothing moves; the lists' validity for this step's input.
    ``keys``: the caller regrew the box and sorted (the block time steps'
    bin-folded sort): everything passes through. Returns (state, box,
    sorted_keys or None, list diagnostics or None), and with ``aux``
    (sorted with the state, ``_sort_by_keys``; in list mode as it is) the
    aux fifth."""
    tail = () if aux is None else (aux,)
    if keys is not None:
        return (state, box, keys, None, *tail)
    if cfg.mesh is not None:
        if lists is not None:
            raise ValueError("the sharded steps stream (no lists)")
        with phase_scope("sort"):
            box = make_global_box(state.x, state.y, state.z, box, mesh=cfg.mesh)
        state, keys, *tail = _sort_by_keys_sharded(state, box, cfg.curve, cfg.mesh, aux=aux)
        return (state, box, keys, None, *tail)
    if lists is not None:
        if cfg.gravity is not None:
            raise NotImplementedError("persistent lists compose with gravity-off steps; "
                                      "gravity runs sort every step")
        with phase_scope("neighbors"):
            slack = list_slack(state.x, state.y, state.z, state.h, lists)
            ldiag = {"list_slack": slack, "list_ok": (slack >= 0.0).to(torch.int32)}
        return (state, box, None, ldiag, *tail)
    with phase_scope("sort"):
        box = make_global_box(state.x, state.y, state.z, box)
    state, keys, _, *tail = _sort_by_keys(state, box, cfg.curve, aux=aux)
    _check_state("sort", state)
    return (state, box, keys, None, *tail)


def _gravity_sharded_stage(state: ParticleState, box: Box, keys, cfg: PropagatorConfig,
                           gtree: GravityTree, ax, ay, az):
    """Self-gravity on this rank's slab (the JAX package's
    _gravity_sharded_stage): the sharded multipole upsweep
    (``compute_multipoles_sharded``, O(tree) traffic), the classification
    against the rank's essential set on the replicated tree, M2P, and the
    near field through the halo exchange: the MAC-sized sparse serve with
    ``cfg.grav_cells`` (each cap at most the slab), else whole slabs (the
    SPH halo's sizes are never reused here: the near field reaches the
    MAC radius, far past 2h). The Ewald solve serves once per replica
    pass. On the gather backend the near field is ``_p2p_xla`` on the
    same j-buffer. Then one all_gather closes the stage, as the JAX package's
    _chain_stage_reductions and its gathers: egrav summed in rank order,
    the acceleration dt candidate (over the hydro and gravity
    accelerations) a min, the solver diagnostics a max, and with the
    sparse serve each rank's ``halo_rows`` / ``halo_occ`` as the (P,)
    GRAV_SHARD_DIAG_KEYS. Returns (ax, ay, az, egrav, dt_acc, gravity
    diagnostics), the scalars the same on every rank."""
    from sphexa_torch.gravity.traversal import compute_multipoles_sharded
    from sphexa_torch.parallel.mesh import all_gather

    mesh, S = cfg.mesh, state.n
    win = tuple(min(int(c), S) for c in cfg.grav_cells) if cfg.grav_cells else S
    gcfg = dataclasses.replace(cfg.gravity, G=cfg.const.g)
    args = (state.x, state.y, state.z, state.m, state.h, keys, box, gtree, cfg.grav_meta, gcfg)
    gather = cfg.backend == "xla"
    if cfg.ewald is not None:
        gx, gy, gz, egrav, gdiag = compute_gravity_ewald(*args, cfg.ewald, shard=(mesh, win),
                                                         gather_p2p=gather)
    else:
        mps = compute_multipoles_sharded(mesh, state.x, state.y, state.z, state.m, keys, gtree,
                                         cfg.grav_meta, order=gcfg.multipole_order)
        gx, gy, gz, egrav, gdiag = compute_gravity(*args, multipoles=mps, shard=(mesh, win),
                                                   gather_p2p=gather)
    ax, ay, az = ax + gx, ay + gy, az + gz
    with phase_scope("timestep"):
        dt_acc = acceleration_timestep(ax, ay, az, cfg.const)
    grows, gocc = gdiag.pop("halo_rows", None), gdiag.pop("halo_occ", None)
    names = sorted(gdiag)
    f64 = torch.float64
    cols = [egrav, dt_acc] + [gdiag[k] for k in names]
    if grows is not None:
        cols += [grows, gocc]
    with phase_scope("shard-metrics"):
        g = all_gather(mesh, torch.stack([c.to(f64) for c in cols]))  # (P, K)
    acc = g[0, 0]
    for r in range(1, mesh.size):
        acc = acc + g[r, 0]
    egrav = acc.to(egrav.dtype)
    dt_acc = g[:, 1].min().to(dt_acc.dtype)
    diag = {k: g[:, 2 + i].max().to(gdiag[k].dtype) for i, k in enumerate(names)}
    if grows is not None:
        diag["gshard_rows"] = g[:, -2].to(torch.int32)
        diag["gshard_occ"] = g[:, -1].to(torch.float32)
    return ax, ay, az, egrav, dt_acc, diag


def _add_gravity(state: ParticleState, box: Box, keys, cfg: PropagatorConfig,
                 gtree: GravityTree, ax, ay, az):
    """Self-gravity coupling (gravity_wrapper.hpp:97-123): the Barnes-Hut
    accelerations of the sorted particles added to the hydro ones, by the
    Ewald solve with ``cfg.ewald`` (a periodic box), else the open-box
    one; on a mesh ``_gravity_sharded_stage``. Returns (ax, ay, az, egrav,
    dt_acc, gravity diagnostics)."""
    if cfg.mesh is not None:
        return _gravity_sharded_stage(state, box, keys, cfg, gtree, ax, ay, az)
    gcfg = dataclasses.replace(cfg.gravity, G=cfg.const.g)
    args = (state.x, state.y, state.z, state.m, state.h, keys, box, gtree, cfg.grav_meta, gcfg)
    gather = cfg.backend == "xla"
    if cfg.ewald is not None:
        gx, gy, gz, egrav, gdiag = compute_gravity_ewald(*args, cfg.ewald, gather_p2p=gather)
    else:
        gx, gy, gz, egrav, gdiag = compute_gravity(*args, gather_p2p=gather)
    check_finite("gravity-p2p", gx=gx, gy=gy, gz=gz, egrav=egrav)
    ax, ay, az = ax + gx, ay + gy, az + gz
    with phase_scope("timestep"):
        dt_acc = acceleration_timestep(ax, ay, az, cfg.const)
    return ax, ay, az, egrav, dt_acc, gdiag


def _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az, diag):
    """The force stages' gravity tail: with ``cfg.gravity``, the gravity
    accelerations added, the acceleration dt candidate and egrav plus the
    solver diagnostics merged into ``diag``. Returns (ax, ay, az,
    extra_dts, diag)."""
    if cfg.gravity is None:
        return ax, ay, az, (), diag
    ax, ay, az, egrav, dt_acc, gdiag = _add_gravity(state, box, keys, cfg, gtree, ax, ay, az)
    return ax, ay, az, (dt_acc,), {**(diag or {}), **gdiag, "egrav": egrav}


def _std_forces(state: ParticleState, box: Box, cfg: PropagatorConfig,
                gtree: Optional[GravityTree] = None, lists: Optional[PairLists] = None,
                aux=None, keys=None):
    """The std-SPH force stage: [sort -> prologue ->] density -> EOS -> IAD
    -> momentum/energy [-> gravity]; with ``lists`` every pair op walks
    the lists' marked lanes, and the density walk keeps its mask for the
    later walks (``pair_engine.engine_lists_kernel``'s mask modes: the
    positions and smoothing lengths are the same); on the gather backend
    (``cfg.backend`` "xla") the four stages run over find_neighbors' lists
    (``_std_gather``). ``aux``: per-particle
    fields sorted with the state (the cooling step's chemistry); ``keys``:
    the state is sorted already (``_force_stage_prologue``). Returns
    (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho, c,
    diagnostics or None, aux)."""
    const = cfg.const
    state, box, keys, diag, *rest = _force_stage_prologue(state, box, cfg, lists, aux=aux,
                                                          keys=keys)
    if cfg.mesh is not None:
        sharded = _std_gather_sharded if cfg.backend == "xla" else _std_forces_sharded
        rho, c, nc, occ, ax, ay, az, du, dt_courant, sdiag = sharded(state, box, cfg, keys)
        ax, ay, az, extra_dts, sdiag = _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az,
                                                     sdiag)
        return (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho, c, sdiag,
                *(rest or [None]))
    if cfg.backend == "xla":
        rho, c, nc, occ, ax, ay, az, du, dt_courant = _std_gather(state, box, cfg, keys)
        ax, ay, az, extra_dts, diag = _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az,
                                                    diag)
        return (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho, c, diag,
                *(rest or [None]))
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    ranges = lists.ranges if lists is not None else \
        pe.group_cell_ranges(x, y, z, h, keys, box, cfg.nbr)
    rho, nc, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, cfg.nbr,
                                   ranges=ranges, lists=lists, mask="write")
    check_finite("density", rho=rho)
    with phase_scope("eos"):
        p, c = compute_eos_std(state.temp, rho, const)
    check_finite("eos", p=p, c=c)
    (c11, c12, c13, c22, c23, c33), _ = pe.pallas_iad(
        x, y, z, h, m / rho, keys, box, const, cfg.nbr, ranges=ranges, lists=lists,
        mask="read")
    check_finite("iad", c11=c11, c12=c12, c13=c13, c22=c22, c23=c23, c33=c33)
    ax, ay, az, du, dt_courant, _ = pe.pallas_momentum_energy_std(
        x, y, z, state.vx, state.vy, state.vz, h, m, rho, p, c,
        c11, c12, c13, c22, c23, c33, keys, box, const, cfg.nbr, ranges=ranges,
        lists=lists, mask="read")
    check_finite("momentum-energy", ax=ax, ay=ay, az=az, du=du, dt_courant=dt_courant)
    ax, ay, az, extra_dts, diag = _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az,
                                                diag)
    return (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, ranges.occupancy,
            rho, c, diag, *(rest or [None]))


def _std_gather(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The std pair stage on the gather backend (the JAX package's XLA
    branch of _std_forces): find_neighbors' lists, then density, EOS, IAD
    and momentum/energy over them. Returns (rho, c, nc, occ, ax, ay, az,
    du, dt_courant); occ is the search's (the densest of all window
    cells, or cap + 1 for a blown window)."""
    const, nbr = cfg.const, cfg.nbr
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    nidx, nmask, nc, occ = find_neighbors(x, y, z, h, keys, box, nbr)
    rho = hydro_std.compute_density(x, y, z, h, m, nidx, nmask, box, const, nbr.block)
    check_finite("density", rho=rho)
    with phase_scope("eos"):
        p, c = compute_eos_std(state.temp, rho, const)
    check_finite("eos", p=p, c=c)
    cs = hydro_std.compute_iad(x, y, z, h, m / rho, nidx, nmask, box, const, nbr.block)
    check_finite("iad", **dict(zip(("c11", "c12", "c13", "c22", "c23", "c33"), cs)))
    ax, ay, az, du, dt_courant = hydro_std.compute_momentum_energy_std(
        x, y, z, state.vx, state.vy, state.vz, h, m, rho, p, c, *cs, nidx, nmask, box, const,
        nbr.block)
    check_finite("momentum-energy", ax=ax, ay=ay, az=az, du=du, dt_courant=dt_courant)
    return rho, c, nc, occ, ax, ay, az, du, dt_courant


def _ve_gather(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The VE pair stage on the gather backend (the JAX package's XLA
    branch of _ve_forces): find_neighbors' lists, then xmass, grad-h, EOS,
    IAD, divv/curlv (with gradv under av_clean), the AV switches and
    momentum/energy over them. Returns (rho, c, nc, occ, ax, ay, az, du,
    dt_courant, dt_rho, alpha)."""
    const, nbr = cfg.const, cfg.nbr
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    nidx, nmask, nc, occ = find_neighbors(x, y, z, h, keys, box, nbr)
    lst = (nidx, nmask)
    xm = hydro_ve.compute_xmass(x, y, z, h, m, *lst, box, const, nbr.block)
    check_finite("xmass", xm=xm)
    kx, gradh = hydro_ve.compute_ve_def_gradh(x, y, z, h, m, xm, *lst, box, const, nbr.block)
    check_finite("gradh", kx=kx, gradh=gradh)
    with phase_scope("eos"):
        prho, c, rho, _p = compute_eos_ve(state.temp, m, kx, xm, gradh, const)
    check_finite("eos", prho=prho, c=c, rho=rho)
    cs = hydro_std.compute_iad(x, y, z, h, xm / kx, *lst, box, const, nbr.block)
    check_finite("iad", **dict(zip(("c11", "c12", "c13", "c22", "c23", "c33"), cs)))
    dvout = hydro_ve.compute_iad_divv_curlv(x, y, z, vx, vy, vz, h, kx, xm, *cs, *lst, box,
                                            const, nbr.block, with_gradv=cfg.av_clean)
    divv, curlv, gradv = _split_dvout(dvout, cfg.av_clean)
    check_finite("divv-curlv", divv=divv, curlv=curlv)
    with phase_scope("timestep"):
        dt_rho = rho_timestep(divv, const)
    alpha = hydro_ve.compute_av_switches(x, y, z, vx, vy, vz, h, c, kx, xm, divv, state.alpha,
                                         *cs, *lst, box, state.min_dt, const, nbr.block)
    check_finite("av-switches", alpha=alpha)
    ax, ay, az, du, dt_courant = hydro_ve.compute_momentum_energy_ve(
        x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha, *cs, *lst, nc, box, const,
        nbr.block, gradv=gradv)
    check_finite("momentum-energy", ax=ax, ay=ay, az=az, du=du, dt_courant=dt_courant)
    return rho, c, nc, occ, ax, ay, az, du, dt_courant, dt_rho, alpha


def _halo_stage(cfg: PropagatorConfig, S: int, x, y, z, h, keys, box):
    """The sharded stages' shared prologue (parallel/exchange.py) with the
    halo exchange the config names: sparse with ``cfg.halo_cells`` (the
    default the Simulation sizes), else windowed (``cfg.halo_window``; 0
    serves whole slabs); run_cap clamped to the slab. Returns (ranges,
    serve, jbuf, escaped, metrics, nbr)."""
    from sphexa_torch.parallel import exchange as ex

    nbr = ex.slab_nbr(cfg.nbr, S)
    if cfg.halo_cells:
        hmax = tuple(min(c, S) for c in cfg.halo_cells)
        out = ex.shard_halo_stage_sparse(cfg.mesh, x, y, z, h, keys, box, nbr, hmax)
    else:
        wmax = min(cfg.halo_window, S) or S
        out = ex.shard_halo_stage(cfg.mesh, x, y, z, h, keys, box, nbr, wmax)
    return (*out, nbr)


def exchange_fields_per_step(prop: str, av_clean: bool = False) -> int:
    """float32 fields the sharded force stage serves a step: std (and
    std-cooling) 4 (x, y, z, m) + 1 (m/rho) + 13 (h, v, rho, p, c, the six
    IAD terms); VE (and turb-ve) 5 (x, y, z, h, m) + 1 (xm) + 6 (kx, prho,
    c, v) + 1 (divv) + 7 (alpha, the six IAD terms), and with av_clean the
    six gradv terms too (the JAX package's docstring counts three); N-body
    none. The rows a serve ships times this times 4 is the exchange's
    bytes a step."""
    stage = {"std": "std", "std-cooling": "std", "ve": "ve", "turb-ve": "ve"}.get(prop)
    if stage is None:
        return 0
    return {"std": 18, "ve": 20}[stage] + (6 if av_clean and stage == "ve" else 0)


@named_phase("shard-metrics")
def _shard_tail(mesh, mins, occ, escaped, cap: int, work, metrics, window_ok=None):
    """The sharded stages' closing collective, one all_gather: the dt
    candidates ``mins`` reduced by min, the occupancy (the escape sentinel
    folded in) by max, and each rank's exchange metrics (SHARD_DIAG_KEYS,
    ``shard_work`` = ``work``, the candidate rows a pair op or the search
    streams). ``window_ok`` (the gather search): the rank's windows all
    cover, and the occupancy is then the one-device search's, the max of
    the ranks' unless a window anywhere blew (cap + 1), with any rank's
    escape folded in after. Returns (mins, occ, shard diagnostics)."""
    from sphexa_torch.parallel.exchange import fold_escape_sentinel
    from sphexa_torch.parallel.mesh import all_gather

    f64 = torch.float64
    if window_ok is None:
        occ = fold_escape_sentinel(occ, escaped, cap)
    cols = [*(t.to(f64) for t in mins), occ.to(f64), metrics["halo_rows"].to(f64),
            metrics["halo_occ"].to(f64), work.to(f64), escaped.to(f64)]
    if window_ok is not None:
        cols.append(window_ok.to(f64))
    g = all_gather(mesh, torch.stack(cols))  # (P, K)
    nm = len(mins)
    out = [g[:, i].min().to(t.dtype) for i, t in enumerate(mins)]
    sdiag = {"shard_rows": g[:, nm + 1].to(torch.int32),
             "shard_occ": g[:, nm + 2].to(torch.float32),
             "shard_work": g[:, nm + 3].to(torch.float32),
             "shard_trips": g[:, nm + 4].to(torch.int32)}
    occ_all = g[:, nm].max()
    if window_ok is not None:
        blown = (g[:, nm + 4].max() > 0) | (g[:, nm + 5].min() == 0)
        occ_all = torch.where(blown, float(cap + 1), occ_all)
    return out, occ_all.to(occ.dtype), sdiag


def _std_forces_sharded(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The std pair stage on this rank's slab (the JAX package's
    _std_forces_sharded): the shared prologue against the global cell
    table, then density, EOS, IAD and momentum/energy on K1's jdata form,
    a serve before each op of the fields it reads on the j side that the
    last serve did not ship (x y z m; m/rho; h v rho p c and the IAD
    terms). Returns (rho, c, nc, occ, ax, ay, az, du, dt_courant, shard
    diagnostics), dt and occ reduced over the ranks."""
    const = cfg.const
    S = state.n
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    ranges, serve, jbuf, escaped, hmetrics, nbr = _halo_stage(cfg, S, x, y, z, h, keys, box)
    kw = {"ranges": ranges}

    hx, hy, hz, hm = serve((x, y, z, m))
    rho, nc, occ = pe.pallas_density(x, y, z, h, m, None, box, const, nbr,
                                     jdata=jbuf((x, y, z, m), (hx, hy, hz, hm)), **kw)
    with phase_scope("eos"):
        p, c = compute_eos_std(state.temp, rho, const)
    vol = m / rho
    (hvol,) = serve((vol,))
    cs, _ = pe.pallas_iad(x, y, z, h, vol, None, box, const, nbr,
                          jdata=jbuf((x, y, z, vol), (hx, hy, hz, hvol)), **kw)
    hh, hvx, hvy, hvz, hrho, hp, hc, *hcs = serve((h, vx, vy, vz, rho, p, c, *cs))
    ax, ay, az, du, dt_c, _ = pe.pallas_momentum_energy_std(
        x, y, z, vx, vy, vz, h, m, rho, p, c, *cs, None, box, const, nbr,
        jdata=jbuf((x, y, z, h, vx, vy, vz, m, rho, p, c, *cs),
                   (hx, hy, hz, hh, hvx, hvy, hvz, hm, hrho, hp, hc, *hcs)), **kw)
    (dt_c,), occ, sdiag = _shard_tail(cfg.mesh, [dt_c], occ, escaped, cfg.nbr.cap,
                                      ranges.lens.to(torch.float64).sum(), hmetrics)
    return rho, c, nc, occ, ax, ay, az, du, dt_c, sdiag


def _ve_forces_sharded(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The VE pair stage on this rank's slab (the JAX package's
    _ve_forces_sharded), one serve per halo epoch of the reference
    (ve_hydro.hpp:154-188): x y z h m; xm; kx prho c v; divv; alpha and the
    IAD terms (and gradv with av_clean). Returns (rho, c, nc, occ, ax, ay,
    az, du, dt_courant, dt_rho, alpha, shard diagnostics), the dt
    candidates and occ reduced over the ranks."""
    const = cfg.const
    S = state.n
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    ranges, serve, jbuf, escaped, hmetrics, nbr = _halo_stage(cfg, S, x, y, z, h, keys, box)
    kw = {"ranges": ranges}

    hx, hy, hz, hh, hm = serve((x, y, z, h, m))
    xm, nc, occ = pe.pallas_xmass(x, y, z, h, m, None, box, const, nbr,
                                  jdata=jbuf((x, y, z, m), (hx, hy, hz, hm)), **kw)
    (hxm,) = serve((xm,))
    (kx, gradh), _ = pe.pallas_ve_def_gradh(
        x, y, z, h, m, xm, None, box, const, nbr,
        jdata=jbuf((x, y, z, m, xm), (hx, hy, hz, hm, hxm)), **kw)
    with phase_scope("eos"):
        prho, c, rho, _p = compute_eos_ve(state.temp, m, kx, xm, gradh, const)
    hkx, hprho, hc, hvx, hvy, hvz = serve((kx, prho, c, vx, vy, vz))
    cs, _ = pe.pallas_iad(x, y, z, h, xm / kx, None, box, const, nbr,
                          jdata=jbuf((x, y, z, xm / kx), (hx, hy, hz, hxm / hkx)), **kw)
    dvout, _ = pe.pallas_iad_divv_curlv(
        x, y, z, vx, vy, vz, h, kx, xm, *cs, None, box, const, nbr,
        with_gradv=cfg.av_clean,
        jdata=jbuf((x, y, z, xm, vx, vy, vz), (hx, hy, hz, hxm, hvx, hvy, hvz)), **kw)
    divv, _curlv, gradv = _split_dvout(dvout, cfg.av_clean)
    with phase_scope("timestep"):
        dt_rho = rho_timestep(divv, const)
    (hdivv,) = serve((divv,))
    alpha, _ = pe.pallas_av_switches(
        x, y, z, vx, vy, vz, h, c, kx, xm, divv, state.alpha, *cs, None, box, state.min_dt,
        const, nbr, jdata=jbuf((x, y, z, c, vx, vy, vz, xm / kx, divv),
                               (hx, hy, hz, hc, hvx, hvy, hvz, hxm / hkx, hdivv)), **kw)
    gv = tuple(gradv or ())
    halpha, *rest = serve((alpha, *cs) + gv)
    hcs, hgv = rest[:6], tuple(rest[6:])
    ax, ay, az, du, dt_c, _ = pe.pallas_momentum_energy_ve(
        x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha, *cs, None, box, const, nbr,
        nc=nc, gradv=gradv,
        jdata=jbuf((x, y, z, h, vx, vy, vz, c, alpha, m, xm, kx, prho, *cs) + gv,
                   (hx, hy, hz, hh, hvx, hvy, hvz, hc, halpha, hm, hxm, hkx, hprho, *hcs)
                   + hgv), **kw)
    (dt_c, dt_rho), occ, sdiag = _shard_tail(cfg.mesh, [dt_c, dt_rho], occ, escaped,
                                             cfg.nbr.cap, ranges.lens.to(torch.float64).sum(),
                                             hmetrics)
    return rho, c, nc, occ, ax, ay, az, du, dt_c, dt_rho, alpha, sdiag


def _gather_stage(cfg: PropagatorConfig, x, y, z, h, keys, box: Box, first):
    """The sharded gather stages' shared head (parallel/exchange.py
    ``gather_halo_stage``): the halo of the global groups' window cells,
    sparse with ``cfg.halo_cells`` else windowed (``cfg.halo_window``; 0:
    whole slabs); the first serve, of the fields ``first`` (x, y, z
    first); the search of the slab's rows on its [own | halo] positions
    (``cell_list.search_slab``), its global rows localized into the
    j-buffer. Returns (the halo stage, the first serve's halo fields, nidx
    (j-buffer rows), nmask, nc, escaped, the candidates streamed)."""
    from sphexa_torch.neighbors.cell_list import search_slab
    from sphexa_torch.parallel import exchange as ex

    sizes = tuple(cfg.halo_cells) if cfg.halo_cells else int(cfg.halo_window)
    st = ex.gather_halo_stage(cfg.mesh, x, y, z, h, keys, box, cfg.nbr, sizes)
    halo = st.serve(first)
    jxyz = ex.jbuf(first[:3], halo[:3])
    nidx, nmask, nc, work, unserved = search_slab(cfg.mesh, st.win, x, y, z, h, jxyz, st.g2l,
                                                  box, cfg.nbr)
    with phase_scope("halo-exchange"):
        nidx, lost = ex.localize_rows(st.g2l, nidx)
    return st, halo, nidx, nmask, nc, st.escaped | unserved | lost, work


def _std_gather_sharded(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The std pair stage on this rank's slab on the gather backend (the
    JAX package's GSPMD program of ``_std_gather``): the search of the
    global groups that meet the slab against the served window cells,
    then density, EOS, IAD and momentum/energy over the lists on [own
    slab | halo rows] j-buffers, a serve before each op of the fields it
    reads on the j side that the last serve did not ship (x y z m; m/rho;
    h v rho p c and the IAD terms), as ``_std_forces_sharded``. Each row's
    lists, and so its sums, are the one-device step's. Returns (rho, c,
    nc, occ, ax, ay, az, du, dt_courant, shard diagnostics), dt and occ
    reduced over the ranks."""
    from sphexa_torch.parallel.exchange import jbuf

    const, nbr = cfg.const, cfg.nbr
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    st, first, nidx, nmask, nc, escaped, work = _gather_stage(cfg, x, y, z, h, keys, box,
                                                              (x, y, z, m))
    jx, jy, jz, jm = jbuf((x, y, z, m), first)
    lst = (nidx, nmask)
    rho = hydro_std.compute_density(jx, jy, jz, h, jm, *lst, box, const, nbr.block)
    with phase_scope("eos"):
        p, c = compute_eos_std(state.temp, rho, const)
    vol = m / rho
    (jvol,) = jbuf((vol,), st.serve((vol,)))
    cs = hydro_std.compute_iad(jx, jy, jz, h, jvol, *lst, box, const, nbr.block)
    own = (h, vx, vy, vz, rho, p, c, *cs)
    jh, jvx, jvy, jvz, jrho, jp, jc, *jcs = jbuf(own, st.serve(own))
    ax, ay, az, du, dt_c = hydro_std.compute_momentum_energy_std(
        jx, jy, jz, jvx, jvy, jvz, jh, jm, jrho, jp, jc, *jcs, *lst, box, const, nbr.block)
    (dt_c,), occ, sdiag = _shard_tail(cfg.mesh, [dt_c], st.win.occ, escaped, nbr.cap, work,
                                      st.metrics, window_ok=st.win.window_ok)
    return rho, c, nc, occ, ax, ay, az, du, dt_c, sdiag


def _ve_gather_sharded(state: ParticleState, box: Box, cfg: PropagatorConfig, keys):
    """The VE pair stage on this rank's slab on the gather backend (the
    JAX package's GSPMD program of ``_ve_gather``), the serves of
    ``_ve_forces_sharded``: x y z h m; xm; kx prho c v; divv; alpha and the
    IAD terms (and gradv with av_clean). Returns (rho, c, nc, occ, ax, ay,
    az, du, dt_courant, dt_rho, alpha, shard diagnostics), the dt
    candidates and occ reduced over the ranks."""
    from sphexa_torch.parallel.exchange import jbuf

    const, nbr = cfg.const, cfg.nbr
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    st, first, nidx, nmask, nc, escaped, work = _gather_stage(cfg, x, y, z, h, keys, box,
                                                              (x, y, z, h, m))
    jx, jy, jz, jh, jm = jbuf((x, y, z, h, m), first)
    lst = (nidx, nmask)
    xm = hydro_ve.compute_xmass(jx, jy, jz, h, jm, *lst, box, const, nbr.block)
    (jxm,) = jbuf((xm,), st.serve((xm,)))
    kx, gradh = hydro_ve.compute_ve_def_gradh(jx, jy, jz, h, jm, jxm, *lst, box, const,
                                              nbr.block)
    with phase_scope("eos"):
        prho, c, rho, _p = compute_eos_ve(state.temp, m, kx, xm, gradh, const)
    own = (kx, prho, c, vx, vy, vz)
    jkx, jprho, jc, jvx, jvy, jvz = jbuf(own, st.serve(own))
    cs = hydro_std.compute_iad(jx, jy, jz, h, jxm / jkx, *lst, box, const, nbr.block)
    dvout = hydro_ve.compute_iad_divv_curlv(jx, jy, jz, jvx, jvy, jvz, h, kx, jxm, *cs, *lst,
                                            box, const, nbr.block, with_gradv=cfg.av_clean)
    divv, _curlv, gradv = _split_dvout(dvout, cfg.av_clean)
    with phase_scope("timestep"):
        dt_rho = rho_timestep(divv, const)
    (jdivv,) = jbuf((divv,), st.serve((divv,)))
    alpha = hydro_ve.compute_av_switches(jx, jy, jz, jvx, jvy, jvz, h, jc, jkx, jxm, jdivv,
                                         state.alpha, *cs, *lst, box, state.min_dt, const,
                                         nbr.block)
    gv = tuple(gradv or ())
    own = (alpha, *cs) + gv
    jalpha, *rest = jbuf(own, st.serve(own))
    jcs, jgv = rest[:6], tuple(rest[6:])
    ax, ay, az, du, dt_c = hydro_ve.compute_momentum_energy_ve(
        jx, jy, jz, jvx, jvy, jvz, jh, jm, jprho, jc, jkx, jxm, jalpha, *jcs, *lst, nc, box,
        const, nbr.block, gradv=jgv or None)
    (dt_c, dt_rho), occ, sdiag = _shard_tail(cfg.mesh, [dt_c, dt_rho], st.win.occ, escaped,
                                             nbr.cap, work, st.metrics,
                                             window_ok=st.win.window_ok)
    return rho, c, nc, occ, ax, ay, az, du, dt_c, dt_rho, alpha, sdiag


def _integrate_and_finish(state: ParticleState, box: Box, cfg: PropagatorConfig,
                          ax, ay, az, du, dt, nc, occ, rho, dt_limiter=None,
                          extra_diag=None, extra=None, c=None, update_smoothing: bool = True
                          ) -> Tuple[ParticleState, Box, Dict[str, torch.Tensor]]:
    """Drift/kick + PBC wrap, smoothing-length nudge, diagnostics: the
    STEP_DIAG_KEYS scalars and, with ``cfg.obs``, the science ledger over
    the post-integration state with the force stage's rho, c and egrav.
    ``extra``: further fields of the new state (the VE step's alpha);
    ``update_smoothing`` False (the N-body step) keeps h as it is."""
    const = cfg.const
    with phase_scope("integrate"):
        fields = (state.x, state.y, state.z, state.x_m1, state.y_m1, state.z_m1,
                  state.vx, state.vy, state.vz, state.h, state.temp, state.temp_lo,
                  du, state.du_m1)
        (nx, ny, nz, dxm, dym, dzm, vx, vy, vz, h, temp, temp_lo, du,
         du_m1) = compute_positions(fields, ax, ay, az, dt, state.min_dt, box, const)
        new_h = update_h(const.ng0, nc + 1, h) if update_smoothing else h
        new_state = dataclasses.replace(
            state, x=nx, y=ny, z=nz, x_m1=dxm, y_m1=dym, z_m1=dzm,
            vx=vx, vy=vy, vz=vz, h=new_h, temp=temp, temp_lo=temp_lo,
            du=du, du_m1=du_m1,
            ttot=state.ttot + dt, min_dt=dt, min_dt_m1=state.min_dt,
            **(extra or {}),
        )
    _check_state("integrate", new_state)
    return new_state, box, _step_diagnostics(cfg, new_state, box, dt, nc, occ, rho, dt_limiter,
                                             extra_diag, c, update_smoothing)


def _step_diagnostics(cfg: PropagatorConfig, new_state: ParticleState, box: Box, dt, nc, occ,
                      rho, dt_limiter, extra_diag, c, smoothing: bool) -> Dict[str, torch.Tensor]:
    """A step's diagnostics: the STEP_DIAG_KEYS scalars, the exact
    neighbour total, the science ledger with ``cfg.obs``, the snapshot
    deposit with ``cfg.snap`` (over all rows: the block time steps' frame
    shows the frozen rows too), the limiter and ``extra_diag``. On a mesh
    the snapshot's partial grids are summed (or maxed) over the ranks in
    the step's one ``reduce_scalars`` gather."""
    const = cfg.const
    with phase_scope("integrate"):
        diagnostics = {
            "dt": dt,
            "nc_mean": torch.mean(nc.to(torch.float32)) + 1.0,
            # the exact neighbour total: the float32 mean may round its
            # division differently on two devices
            "nc_sum": torch.sum(nc, dtype=torch.int64),
            "nc_max": torch.max(nc) + 1,
            "occupancy": occ,
            "rho_max": torch.max(rho),
            "h_max": torch.max(new_state.h),
        }
    spec = cfg.snap
    grid = None
    if spec is not None:
        with phase_scope("snapshot"):
            grid = snap.deposit(new_state, rho, box, spec)
    mesh = cfg.mesh
    if mesh is not None:
        from sphexa_torch.parallel.mesh import reduce_scalars

        keys = ("nc_max", "rho_max", "h_max")
        mkeys = [k for k in _MESH_MIN_KEYS if k in (extra_diag or {})]
        gsum = [grid] if grid is not None and spec.reduce == "sum" else []
        gmax = [grid] if grid is not None and spec.reduce == "max" else []
        with phase_scope("shard-metrics"):
            (nc_sum, *gsum), maxes, mins = reduce_scalars(
                mesh, sums=[diagnostics["nc_sum"]] + gsum,
                maxes=[diagnostics[k] for k in keys] + gmax,
                mins=[extra_diag[k] for k in mkeys])
        if grid is not None:
            grid = gsum[0] if gsum else maxes.pop()
        diagnostics.update(zip(keys, maxes))
        extra_diag = {**(extra_diag or {}), **dict(zip(mkeys, mins))}
        diagnostics["nc_sum"] = nc_sum
        n_all = float(new_state.n * mesh.size)
        diagnostics["nc_mean"] = (nc_sum.to(torch.float64) / n_all).to(torch.float32) + 1.0
    if cfg.obs is not None:
        diagnostics.update(ledger_diagnostics(
            new_state, rho, nc, const, cfg.nbr.ngmax, spec=cfg.obs,
            egrav=(extra_diag or {}).get("egrav"), box=box, c=c,
            smoothing=smoothing, mesh=mesh))
    if grid is not None:
        with phase_scope("snapshot"):
            diagnostics.update(snap.finish(grid, spec))
            if spec.stride > 0:
                diagnostics["snap_pts"] = snap.snapshot_points(new_state, rho, spec, mesh)
    if dt_limiter is not None:
        diagnostics["dt_limiter"] = dt_limiter
    if extra_diag:
        diagnostics.update(extra_diag)
    return diagnostics


def _step_hydro_std(state: ParticleState, box: Box, cfg: PropagatorConfig,
                    gtree: Optional[GravityTree] = None,
                    lists: Optional[PairLists] = None):
    """One standard-SPH time step (std_hydro.hpp:123-175 sequence); with
    ``lists`` a steady list-mode step; ``gtree``: the gravity tree when
    ``cfg.gravity`` is set. Returns (new_state, new_box, diagnostics)."""
    (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho,
     c, diag, _) = _std_forces(state, box, cfg, gtree, lists)
    with phase_scope("timestep"):
        dt = compute_timestep(state.min_dt, dt_courant, *extra_dts, const=cfg.const)
        limiter = _dt_limiter(state.min_dt, cfg.const, courant=dt_courant,
                              accel=extra_dts[0] if extra_dts else None)
    check_finite("timestep", dt=dt)
    return _integrate_and_finish(state, box, cfg, ax, ay, az, du, dt, nc, occ,
                                 rho, dt_limiter=limiter, extra_diag=diag, c=c)


def _step_hydro_std_cooling(state: ParticleState, box: Box, cfg: PropagatorConfig,
                            gtree: Optional[GravityTree], chem, cool_cfg: CoolingConfig,
                            lists: Optional[PairLists] = None):
    """One std-SPH step with radiative cooling (HydroGrackleProp::step,
    std_hydro_grackle.hpp:193-233): the std force stage, with the
    chemistry sorted along -> the time step with the cooling-time
    candidate -> the cooling source (the evolved network advances the
    species too) added to du -> positions and the smoothing-length
    update; ``dt_cool`` and ``du_cool_min`` join the diagnostics. Returns
    (new_state, new_box, diagnostics, chemistry)."""
    const = cfg.const
    (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho, c, diag,
     chem) = _std_forces(state, box, cfg, gtree, lists, aux=chem)
    with phase_scope("cooling"):
        u = const.cv * state.temp
        dt_cool = cool_timestep(rho, u, chem, cool_cfg)
        if cfg.mesh is not None:
            from sphexa_torch.parallel.mesh import reduce_scalars

            # a global minimum, as the JAX package's jnp.min over the slabs
            _, _, (dt_cool,) = reduce_scalars(cfg.mesh, mins=[dt_cool])
    with phase_scope("timestep"):
        dt = compute_timestep(state.min_dt, dt_courant, dt_cool, *extra_dts, const=const)
    check_finite("timestep", dt=dt)
    with phase_scope("cooling"):
        du_cool, chem = cool_step(dt, rho, u, chem, cool_cfg)
        du = du + du_cool
        diag = {**(diag or {}), "dt_cool": dt_cool, "du_cool_min": torch.min(du_cool)}
    check_finite("cooling", dt_cool=dt_cool, du_cool=du_cool)
    with phase_scope("timestep"):
        limiter = _dt_limiter(state.min_dt, const, courant=dt_courant, cool=dt_cool,
                              accel=extra_dts[0] if extra_dts else None)
    new_state, box, diagnostics = _integrate_and_finish(
        state, box, cfg, ax, ay, az, du, dt, nc, occ, rho, dt_limiter=limiter,
        extra_diag=diag, c=c)
    return new_state, box, diagnostics, chem


def _split_dvout(dvout, av_clean: bool):
    """Unpack the divv/curlv op's outputs: (divv, curlv, gradv or None)."""
    if av_clean:
        divv, curlv, *gradv = dvout
        return divv, curlv, tuple(gradv)
    divv, curlv = dvout
    return divv, curlv, None


def _ve_forces(state: ParticleState, box: Box, cfg: PropagatorConfig,
               gtree: Optional[GravityTree] = None, lists: Optional[PairLists] = None,
               keys=None, raw_dts: bool = False):
    """The VE force stage (HydroVeProp::computeForces, ve_hydro.hpp:131-208):
    [sort -> prologue ->] xmass -> grad-h -> EOS -> IAD -> divv/curlv -> AV
    switches -> momentum/energy [-> gravity], one set of runs (or the
    lists', the xmass walk keeping its mask for the five after it) for all
    six ops, then the time step: min of Courant,
    Krho/|max divv|, 1.1x the previous dt [and the acceleration
    condition]. On the gather backend (``cfg.backend`` "xla") the six ops
    run over find_neighbors' lists (``_ve_gather``). Returns (state, box,
    ax, ay, az, du, dt, alpha, nc, occ, rho, c, diagnostics); ``raw_dts``
    (the block time steps, which combine them at their sync substep):
    (dt_courant, dt_rho, extra_dts) in dt's place and no limiter.
    ``keys``: the state is sorted already."""
    const, nbr = cfg.const, cfg.nbr
    state, box, keys, ldiag = _force_stage_prologue(state, box, cfg, lists, keys=keys)
    if cfg.mesh is not None:
        sharded = _ve_gather_sharded if cfg.backend == "xla" else _ve_forces_sharded
        (rho, c, nc, occ, ax, ay, az, du, dt_courant, dt_rho, alpha,
         sdiag) = sharded(state, box, cfg, keys)
        ax, ay, az, extra_dts, sdiag = _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az,
                                                     sdiag)
        if raw_dts:
            return (state, box, ax, ay, az, du, (dt_courant, dt_rho, extra_dts), alpha, nc, occ,
                    rho, c, sdiag)
        with phase_scope("timestep"):
            dt = compute_timestep(state.min_dt, dt_courant, dt_rho, *extra_dts, const=const)
            diag = {**sdiag, "dt_limiter": _dt_limiter(
                state.min_dt, const, courant=dt_courant, rho=dt_rho,
                accel=extra_dts[0] if extra_dts else None)}
        return state, box, ax, ay, az, du, dt, alpha, nc, occ, rho, c, diag
    if cfg.backend == "xla":
        (rho, c, nc, occ, ax, ay, az, du, dt_courant, dt_rho,
         alpha) = _ve_gather(state, box, cfg, keys)
        return _ve_tail(state, box, cfg, gtree, keys, ax, ay, az, du, dt_courant, dt_rho, alpha,
                        nc, occ, rho, c, ldiag, raw_dts)
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz
    ranges = None if lists is not None else pe.group_cell_ranges(x, y, z, h, keys, box, nbr)
    kw = {"ranges": ranges, "lists": lists}
    rd = {**kw, "mask": "read"}  # the walks after xmass read its mask

    xm, nc, occ = pe.pallas_xmass(x, y, z, h, m, keys, box, const, nbr, mask="write", **kw)
    check_finite("xmass", xm=xm)
    (kx, gradh), _ = pe.pallas_ve_def_gradh(x, y, z, h, m, xm, keys, box, const, nbr, **rd)
    check_finite("gradh", kx=kx, gradh=gradh)
    with phase_scope("eos"):
        prho, c, rho, _p = compute_eos_ve(state.temp, m, kx, xm, gradh, const)
    check_finite("eos", prho=prho, c=c, rho=rho)
    cs, _ = pe.pallas_iad(x, y, z, h, xm / kx, keys, box, const, nbr, **rd)
    check_finite("iad", **dict(zip(("c11", "c12", "c13", "c22", "c23", "c33"), cs)))
    dvout, _ = pe.pallas_iad_divv_curlv(x, y, z, vx, vy, vz, h, kx, xm, *cs, keys, box,
                                        const, nbr, with_gradv=cfg.av_clean, **rd)
    divv, _curlv, gradv = _split_dvout(dvout, cfg.av_clean)
    check_finite("divv-curlv", divv=divv, curlv=_curlv)
    with phase_scope("timestep"):
        dt_rho = rho_timestep(divv, const)
    alpha, _ = pe.pallas_av_switches(x, y, z, vx, vy, vz, h, c, kx, xm, divv, state.alpha,
                                     *cs, keys, box, state.min_dt, const, nbr, **rd)
    check_finite("av-switches", alpha=alpha)
    ax, ay, az, du, dt_courant, _ = pe.pallas_momentum_energy_ve(
        x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha, *cs, keys, box, const, nbr,
        nc=nc, gradv=gradv, **rd)
    check_finite("momentum-energy", ax=ax, ay=ay, az=az, du=du, dt_courant=dt_courant)
    return _ve_tail(state, box, cfg, gtree, keys, ax, ay, az, du, dt_courant, dt_rho, alpha, nc,
                    occ, rho, c, ldiag, raw_dts)


def _ve_tail(state, box, cfg, gtree, keys, ax, ay, az, du, dt_courant, dt_rho, alpha, nc, occ,
             rho, c, ldiag, raw_dts):
    """The VE force stage's one-device tail (either backend): the gravity
    tail, then the time step and its limiter, or with ``raw_dts`` the raw
    candidates; ``_ve_forces``' returns."""
    const = cfg.const
    ax, ay, az, extra_dts, ldiag = _gravity_tail(state, box, keys, cfg, gtree, ax, ay, az,
                                                 ldiag)
    if raw_dts:
        return (state, box, ax, ay, az, du, (dt_courant, dt_rho, extra_dts), alpha, nc, occ,
                rho, c, ldiag)
    with phase_scope("timestep"):
        dt = compute_timestep(state.min_dt, dt_courant, dt_rho, *extra_dts, const=const)
        diag = {**(ldiag or {}),
                "dt_limiter": _dt_limiter(state.min_dt, const, courant=dt_courant, rho=dt_rho,
                                          accel=extra_dts[0] if extra_dts else None)}
    check_finite("timestep", dt=dt)
    return state, box, ax, ay, az, du, dt, alpha, nc, occ, rho, c, diag


def _step_hydro_ve(state: ParticleState, box: Box, cfg: PropagatorConfig,
                   gtree: Optional[GravityTree] = None,
                   lists: Optional[PairLists] = None):
    """One generalised-volume-element SPH time step (HydroVeProp::step,
    ve_hydro.hpp:210-223): the VE force stage, then positions and the
    smoothing-length update; the new state carries the AV switches'
    alpha. With ``lists`` a steady list-mode step; ``gtree``: the gravity
    tree when ``cfg.gravity`` is set. Returns (new_state, new_box,
    diagnostics)."""
    (state, box, ax, ay, az, du, dt, alpha, nc, occ, rho, c,
     diag) = _ve_forces(state, box, cfg, gtree, lists)
    return _integrate_and_finish(state, box, cfg, ax, ay, az, du, dt, nc, occ, rho,
                                 extra_diag=diag, extra={"alpha": alpha}, c=c)


def _step_turb_ve(state: ParticleState, box: Box, cfg: PropagatorConfig,
                  gtree: Optional[GravityTree], turb, turb_cfg: TurbulenceConfig,
                  lists: Optional[PairLists] = None):
    """One stirred VE step (TurbVeProp::step, turb_ve.hpp:70-86): the VE
    force stage and time step -> the OU stirring accelerations (the
    step's dt damps the phases) -> positions and the smoothing-length
    update. Returns (new_state, new_box, diagnostics, the advanced
    TurbulenceState)."""
    (state, box, ax, ay, az, du, dt, alpha, nc, occ, rho, c,
     diag) = _ve_forces(state, box, cfg, gtree, lists)
    with phase_scope("turbulence"):
        ax, ay, az, turb = drive_turbulence(state.x, state.y, state.z, ax, ay, az, dt, turb,
                                            turb_cfg)
    check_finite("turbulence", ax=ax, ay=ay, az=az)
    new_state, box, diagnostics = _integrate_and_finish(
        state, box, cfg, ax, ay, az, du, dt, nc, occ, rho, extra_diag=diag,
        extra={"alpha": alpha}, c=c)
    return new_state, box, diagnostics, turb


def _step_nbody(state: ParticleState, box: Box, cfg: PropagatorConfig,
                gtree: Optional[GravityTree] = None, lists: Optional[PairLists] = None):
    """One gravity-only N-body step (main/src/propagator/nbody.hpp:51-156):
    box regrow and sort -> multipole upsweep -> Barnes-Hut solve (Ewald's
    in a periodic box) -> the acceleration time step -> positions. No
    hydro field moves (du = 0) and h stays; the neighbour counts, the
    occupancy and rho are zeros, as in the JAX package. ``lists`` is
    refused: the step sorts every time. Returns (new_state, new_box,
    diagnostics)."""
    if lists is not None:
        raise ValueError("the N-body step takes no neighbour lists")
    const = cfg.const
    with phase_scope("sort"):
        box = make_global_box(state.x, state.y, state.z, box, mesh=cfg.mesh)
    if cfg.mesh is not None:
        state, keys = _sort_by_keys_sharded(state, box, cfg.curve, cfg.mesh)
    else:
        state, keys, _ = _sort_by_keys(state, box, cfg.curve)
    _check_state("sort", state)
    zero = torch.zeros_like(state.x)
    ax, ay, az, egrav, dt_acc, gdiag = _add_gravity(state, box, keys, cfg, gtree,
                                                    zero, zero, zero)
    with phase_scope("timestep"):
        dt = compute_timestep(state.min_dt, dt_acc, const=const)
        limiter = _dt_limiter(state.min_dt, const, accel=dt_acc)
    check_finite("timestep", dt=dt)
    nc = torch.zeros_like(state.x, dtype=torch.int32)
    occ = torch.zeros((), dtype=torch.int32, device=state.x.device)
    return _integrate_and_finish(state, box, cfg, ax, ay, az, zero, dt, nc, occ, zero,
                                 dt_limiter=limiter, extra_diag={**gdiag, "egrav": egrav},
                                 update_smoothing=False)


def _integrate_and_finish_blockdt(state: ParticleState, box: Box, cfg: PropagatorConfig,
                                  ax, ay, az, du, dt_min, dt_prev, due, bins, dt_eff, nc, occ,
                                  rho, extra=None, extra_diag=None, c=None, dt_limiter=None):
    """The block-time-step tail: the Press update with per-particle dt
    (``dt_eff``, ``dt_prev``; compute_positions is elementwise in them)
    kept on the due rows only, each of which first removes the drift
    since its last kick (its bin > 0: at bin 0 the term is zero, and
    ``a - 0.0`` is not bit-exact for a = -0.0); the other rows drift
    ``x += v dt_min`` (PBC-folded) with every other field kept. The
    ledger runs over all rows."""
    const = cfg.const
    with phase_scope("integrate"):
        new_state = _blockdt_update(state, box, const, ax, ay, az, du, dt_min, dt_prev, due,
                                    bins, dt_eff, nc, extra)
    _check_state("integrate", new_state)
    return new_state, box, _step_diagnostics(cfg, new_state, box, dt_min, nc, occ, rho,
                                             dt_limiter, extra_diag, c, True)


def _blockdt_update(state: ParticleState, box: Box, const: SimConstants, ax, ay, az, du,
                    dt_min, dt_prev, due, bins, dt_eff, nc, extra) -> ParticleState:
    """``_integrate_and_finish_blockdt``'s new state."""
    rebase = due & (bins > 0)
    dr = dt_eff - dt_min
    bx = torch.where(rebase, state.x - state.vx * dr, state.x)
    by = torch.where(rebase, state.y - state.vy * dr, state.y)
    bz = torch.where(rebase, state.z - state.vz * dr, state.z)
    fields = (bx, by, bz, state.x_m1, state.y_m1, state.z_m1, state.vx, state.vy, state.vz,
              state.h, state.temp, state.temp_lo, du, state.du_m1)
    (nx, ny, nz, dxm, dym, dzm, vx, vy, vz, h, temp, temp_lo, ndu,
     du_m1) = compute_positions(fields, ax, ay, az, dt_eff, dt_prev, box, const)
    drift = put_in_box(box, torch.stack([state.x + state.vx * dt_min,
                                         state.y + state.vy * dt_min,
                                         state.z + state.vz * dt_min], dim=-1))

    def sel(a, b):
        return torch.where(due, a, b)

    return dataclasses.replace(
        state, x=sel(nx, drift[:, 0]), y=sel(ny, drift[:, 1]), z=sel(nz, drift[:, 2]),
        x_m1=sel(dxm, state.x_m1), y_m1=sel(dym, state.y_m1), z_m1=sel(dzm, state.z_m1),
        vx=sel(vx, state.vx), vy=sel(vy, state.vy), vz=sel(vz, state.vz),
        h=sel(update_h(const.ng0, nc + 1, h), state.h), temp=sel(temp, state.temp),
        temp_lo=sel(temp_lo, state.temp_lo), du=sel(ndu, state.du),
        du_m1=sel(du_m1, state.du_m1),
        ttot=state.ttot + dt_min, min_dt=dt_min, min_dt_m1=state.min_dt,
        **(extra or {}),
    )


def _blockdt_prologue(state: ParticleState, box: Box, cfg: PropagatorConfig, bst):
    """Box regrow and the block-time-step sort, the BlockDtState riding it
    as the aux. ``dt_bins`` 1 takes the plain sort (no fold, no keep), so
    that the step is the global one. On a mesh the box regrow and the
    sort are the sharded ones (``_sort_by_keys_sharded``: the folded key
    over 32 bits, the inversions counted over the global array). Returns
    (state, box, keys, bst, resorted, inversions)."""
    mesh = cfg.mesh
    with phase_scope("sort"):
        box = make_global_box(state.x, state.y, state.z, box, mesh=mesh)
    if cfg.dt_bins == 1:
        if mesh is None:
            state, keys, _, bst = _sort_by_keys(state, box, cfg.curve, aux=bst)
        else:
            state, keys, bst = _sort_by_keys_sharded(state, box, cfg.curve, mesh, aux=bst)
        one = torch.ones((), dtype=torch.int32, device=keys.device)
        return state, box, keys, bst, one, torch.zeros_like(one)
    kw = {"aux": bst, "bins": bst.bins, "resort_drift": cfg.bin_resort_drift}
    if mesh is None:
        state, keys, _, bst, resorted, inv = _sort_by_keys(state, box, cfg.curve, **kw)
    else:
        state, keys, bst, resorted, inv = _sort_by_keys_sharded(state, box, cfg.curve, mesh,
                                                                **kw)
    _check_state("sort", state)
    return state, box, keys, bst, resorted, inv


def _blockdt_tail(state: ParticleState, box: Box, cfg: PropagatorConfig, ax, ay, az, du,
                  dt_sync, bst, resorted, inv, nc, occ, rho, c=None, dt_limiter=None,
                  gdiag=None, alpha=None):
    """The bins' bookkeeping and the due rows' update: at the sync substep
    dt_min refreshed and (every ``bin_sync_every``-th cycle) the bins
    reassigned; the due mask, the due rows' list and count (K13's one-row
    form on the card), the bin populations and the due rows' neighbour
    work, the advanced BlockDtState; then the block-time-step tail. On a
    mesh K13's one-row form lists the due rows of this rank's slab, and
    the active count, the populations and the work are summed over the
    ranks in one all_gather (dt_sync and dt_min are replicated already).
    Returns (state, box, diagnostics, bst)."""
    with phase_scope("dt-bins"):
        bdiag, due, bins, dt_min, dt_eff, new_bst = _blockdt_bins(state, cfg, bst, c, ax, ay,
                                                                   az, dt_sync, nc, resorted,
                                                                   inv)
    extra = None if alpha is None else {"alpha": torch.where(due, alpha, state.alpha)}
    # dt_bins 1: the scalars the global step feeds compute_positions
    if cfg.dt_bins == 1:
        cp_dt, cp_dtm1 = dt_min, state.min_dt
    else:
        cp_dt, cp_dtm1 = dt_eff, bst.dt_prev
    new_state, box, diag = _integrate_and_finish_blockdt(
        state, box, cfg, ax, ay, az, du, dt_min, cp_dtm1, due, bins, cp_dt, nc, occ, rho,
        extra=extra, extra_diag={**(gdiag or {}), **bdiag}, c=c, dt_limiter=dt_limiter)
    return new_state, box, diag, new_bst


def _blockdt_bins(state: ParticleState, cfg: PropagatorConfig, bst, c, ax, ay, az, dt_sync,
                  nc, resorted, inv):
    """``_blockdt_tail``'s bookkeeping: (block diagnostics, due mask, bins,
    dt_min, dt_eff, the advanced BlockDtState)."""
    const = cfg.const
    B = cfg.dt_bins
    is_sync = bst.substep == 0
    dt_min = torch.where(is_sync, dt_sync, bst.dt_min)
    grav = cfg.gravity is not None
    cand = bdt.particle_dt_candidates(state.h, c, const, ax=ax if grav else None,
                                      ay=ay if grav else None, az=az if grav else None)
    rebin = is_sync & (bst.cycle % cfg.bin_sync_every == 0)
    bins = torch.where(rebin, bdt.assign_bins(cand, dt_min, B), bst.bins)
    due = bdt.due_mask(bins, bst.substep)
    # an exact power of two: the integer shift, then float32
    dt_eff = dt_min * torch.bitwise_left_shift(torch.ones_like(bins), bins).to(torch.float32)
    # the gather backend lists them in plain PyTorch (no K13), as the JAX
    # package's use_kernel=False
    idx_act, n_active = bdt.compact_active(due, use_kernel=cfg.backend == "pallas")
    lane = torch.arange(state.n, dtype=torch.int32, device=due.device)
    # the due rows' neighbours, summed exactly and rounded once to float32
    work = torch.sum(torch.where(lane < n_active, nc[idx_act.long()], 0), dtype=torch.int64)
    pop = bdt.bin_populations(bins, B)
    if cfg.mesh is not None:
        from sphexa_torch.parallel.mesh import reduce_scalars

        # integer sums, exact in any order
        (n_active, pop, work), _, _ = reduce_scalars(cfg.mesh, sums=[n_active, pop, work])
    bdiag = {"bdt_active": n_active, "bdt_pop": pop,
             "bdt_substep": bst.substep, "bdt_resort": resorted, "bdt_drift": inv,
             "bdt_work": work.to(torch.float32)}
    wrap = bst.substep + 1 >= bdt.cycle_length(B)
    new_bst = bdt.BlockDtState(
        bins=bins, dt_prev=torch.where(due, dt_eff, bst.dt_prev),
        substep=torch.where(wrap, torch.zeros_like(bst.substep), bst.substep + 1),
        cycle=bst.cycle + wrap.to(torch.int32), dt_min=dt_min)
    return bdiag, due, bins, dt_min, dt_eff, new_bst


def _step_hydro_std_blockdt(state: ParticleState, box: Box, cfg: PropagatorConfig,
                            gtree: Optional[GravityTree], bst,
                            lists: Optional[PairLists] = None):
    """One std-SPH substep under block time steps (the JAX package's
    _step_hydro_std_blockdt): the bin-folded drift-aware sort -> the full
    force stage (inactive rows are sources at their drifted positions) ->
    the sync substep's dt -> the due rows' update. ``lists`` is refused:
    the step sorts every time. Returns (state, box, diagnostics, bst)."""
    if lists is not None:
        raise ValueError("block time steps take no neighbour lists")
    const = cfg.const
    state, box, keys, bst, resorted, inv = _blockdt_prologue(state, box, cfg, bst)
    (state, box, ax, ay, az, du, dt_courant, extra_dts, nc, occ, rho, c, diag,
     _) = _std_forces(state, box, cfg, gtree, keys=keys)
    with phase_scope("timestep"):
        dt_sync = compute_timestep(state.min_dt, dt_courant, *extra_dts, const=const)
        limiter = _dt_limiter(state.min_dt, const, courant=dt_courant,
                              accel=extra_dts[0] if extra_dts else None)
    return _blockdt_tail(state, box, cfg, ax, ay, az, du, dt_sync, bst, resorted, inv, nc,
                         occ, rho, c=c, dt_limiter=limiter, gdiag=diag)


def _step_hydro_ve_blockdt(state: ParticleState, box: Box, cfg: PropagatorConfig,
                           gtree: Optional[GravityTree], bst,
                           lists: Optional[PairLists] = None):
    """One VE substep under block time steps (the JAX package's
    _step_hydro_ve_blockdt): as the std one over the VE force stage, its
    raw dt candidates combined at the sync substep; alpha is kept on the
    inactive rows. Returns (state, box, diagnostics, bst)."""
    if lists is not None:
        raise ValueError("block time steps take no neighbour lists")
    const = cfg.const
    state, box, keys, bst, resorted, inv = _blockdt_prologue(state, box, cfg, bst)
    (state, box, ax, ay, az, du, (dt_courant, dt_rho, extra_dts), alpha, nc, occ, rho, c,
     gdiag) = _ve_forces(state, box, cfg, gtree, keys=keys, raw_dts=True)
    with phase_scope("timestep"):
        dt_sync = compute_timestep(state.min_dt, dt_courant, dt_rho, *extra_dts, const=const)
        limiter = _dt_limiter(state.min_dt, const, courant=dt_courant, rho=dt_rho,
                              accel=extra_dts[0] if extra_dts else None)
    return _blockdt_tail(state, box, cfg, ax, ay, az, du, dt_sync, bst, resorted, inv, nc,
                         occ, rho, c=c, dt_limiter=limiter, gdiag=gdiag, alpha=alpha)


#: step function -> the SimState aux slot it consumes and produces (the
#: JAX package's STEP_AUX_SLOT)
STEP_AUX_SLOT = {_step_turb_ve: "turb", _step_hydro_std_cooling: "chem",
                 _step_hydro_std_blockdt: "bdt", _step_hydro_ve_blockdt: "bdt"}

#: the aux steps that also take their slot's static config
#: (TurbulenceConfig, CoolingConfig) after the aux; the block time steps
#: take the BlockDtState alone
STEP_AUX_CFG = (_step_turb_ve, _step_hydro_std_cooling)


def step_sim_state(step_fn, sim: SimState, cfg: PropagatorConfig, gtree=None, aux_cfg=None,
                   lists: Optional[PairLists] = None):
    """Advance one step on a SimState carry: the carry mapped onto
    ``step_fn``'s arguments and its outputs folded back, only the slot the
    step owns replaced. Returns (new SimState, diagnostics)."""
    slot = STEP_AUX_SLOT.get(step_fn)
    if slot is None:
        s, b, diag = step_fn(sim.particles, sim.box, cfg, gtree, lists=lists)
        return sim.with_slot(None, None, particles=s, box=b), diag
    cfg_arg = (aux_cfg,) if step_fn in STEP_AUX_CFG else ()
    s, b, diag, aux = step_fn(sim.particles, sim.box, cfg, gtree, getattr(sim, slot), *cfg_arg,
                              lists=lists)
    return sim.with_slot(slot, aux, particles=s, box=b), diag
