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
``gravity_solve`` K12 and K13.

The sharded entries and ``tree_build_sizing`` / ``knob_inertness`` are
not ported yet (ROADMAP Queue 1).
"""

import dataclasses
import functools

from sphexa_torch.devtools.audit.core import EntryCase, audit_context, entrypoint

# the JAX registry's sizes: big enough for a real neighbour grid and a
# multi-level gravity tree, small enough that a step runs in well under a
# second on a CPU host
_SIDE = 6          # 216 particles (cube cases)
_SIDE_GRAV = 6     # sphere cuts (evrard) keep about half of side^3


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
    )


# ---------------------------------------------------------------------------
# propagator steps (the five production steps)
# ---------------------------------------------------------------------------


@entrypoint("step_std")
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


@entrypoint("gravity_solve")
def gravity_solve():
    """The Evrard solve on the step's sorted arrays (the sort untallied),
    in the engine backend's bitmask compaction (its form from 500k
    particles, one-level here): the list compaction K13 runs, beside the
    near field K12. The steps' solves at this size take the sort
    compaction, as the JAX registry's do."""
    from sphexa_torch.gravity.traversal import compute_gravity
    from sphexa_torch.propagator import _force_stage_prologue

    sim = _sim("evrard", _SIDE_GRAV, "nbody", audit_context().device)
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    meta = sim.cfg.grav_meta
    gcfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g, compaction="bitmask")
    return EntryCase(
        fn=lambda x, y, z, m, h, sk: compute_gravity(x, y, z, m, h, sk, box, sim.gtree,
                                                     meta, gcfg),
        args=(ss.x, ss.y, ss.z, ss.m, ss.h, keys),
    )


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
