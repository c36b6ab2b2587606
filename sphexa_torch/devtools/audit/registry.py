"""The audit entry registry of the port (the JAX package's
devtools/audit/registry.py): the package's hot one-device paths.

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

The sharded entries and ``tree_build_sizing`` are not ported yet
(ROADMAP Queue 1).
"""

import dataclasses
import functools

from sphexa_torch.devtools.audit.core import EntryCase, audit_context, entrypoint

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
