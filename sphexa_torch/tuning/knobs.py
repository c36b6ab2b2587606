"""The knob registry of the port (sphexa_tpu/tuning/knobs.py): every
tunable the autotuner may touch, typed.

Each ``KnobSpec`` names the knob, the config surface that owns it (a
frozen dataclass field or a constructor/factory keyword), the candidate
domain the search driver sweeps, and what changing it costs at run time
(``static`` = a fresh ``Simulation``; ``reconfigure`` = applied at the
next (re)configuration). The names, domains, costs and off sentinels are
the JAX package's, less the two knobs that have no counterpart here
(their lines below say why), so a table entry means the same on both.

``validate_registry()`` checks every spec against the live owning
dataclass or signature; ``sphexa_torch.tuning`` (the package
``__init__``) calls it at import, so that a renamed config field fails
loudly there instead of silently de-tuning a run. This module itself
imports no config module (the table tooling reads knob names alone); the
owners are imported inside ``validate_registry()``.
"""

import dataclasses
from typing import Dict, Tuple

#: where a knob's new value takes effect
COST_STATIC = "static"          # construction time only (a new Simulation)
COST_RECONFIGURE = "reconfigure"  # at the next (re)configuration


class _NoOff:
    """Marker: the knob has no off sentinel (``None`` is a real sentinel
    for dt_bins, so absence needs its own type)."""

    def __repr__(self):  # pragma: no cover - cosmetic
        return "NO_OFF"


NO_OFF = _NoOff()


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One tunable: identity, owning surface, search domain, cost."""

    name: str
    #: owning config surface, one of the keys of _OWNERS below
    owner: str
    #: field or parameter name on the owner (usually == name)
    field: str
    #: candidate values the search driver sweeps, in preference order
    #: (first = the default)
    domain: Tuple
    #: COST_STATIC or COST_RECONFIGURE
    cost: str
    description: str = ""
    #: the value that turns the knob's feature off (NO_OFF: no off state):
    #: ``tuned={name: off}`` must leave the step what it is without the knob
    off_sentinel: object = NO_OFF

    @property
    def has_off_sentinel(self) -> bool:
        return self.off_sentinel is not NO_OFF


#: every registered knob, keyed by name, in the JAX registry's order
KNOBS: Dict[str, KnobSpec] = {
    spec.name: spec
    for spec in (
        # -- gravity solver shape (GravityConfig) -------------------------
        KnobSpec("target_block", "GravityConfig", "target_block",
                 (64, 128, 256), COST_RECONFIGURE,
                 "bodies per traversal block (MAC shared per block)"),
        # blocks_per_chunk: none; the port sizes classification chunks
        # from free memory (gravity/traversal.py _chunks)
        KnobSpec("super_factor", "GravityConfig", "super_factor",
                 (0, 4, 8, 16), COST_RECONFIGURE,
                 "superblock size in blocks for the two-level "
                 "classification (0 = flat; > 0 implies the bitmask "
                 "compaction on the pallas backend)",
                 off_sentinel=0),
        KnobSpec("m2p_cap_margin", "GravityConfig", "m2p_cap_margin",
                 (1.3, 1.15, 1.5), COST_RECONFIGURE,
                 "M2P interaction-list cap margin (eval cost is linear "
                 "in the cap; overflow is guarded and auto-regrown)"),
        # -- neighbour engine (NeighborConfig / make_propagator_config) ---
        KnobSpec("block", "NeighborConfig", "block",
                 (2048, 4096, 8192), COST_STATIC,
                 "particles per processing chunk (memory bound)"),
        KnobSpec("cell_target", "make_propagator_config", "cell_target",
                 (128, 64, 256), COST_RECONFIGURE,
                 "mean cell occupancy the grid level targets"),
        KnobSpec("run_cap", "NeighborConfig", "run_cap",
                 (1536, 1024, 2048), COST_RECONFIGURE,
                 "max slots per merged candidate run (pallas engine)"),
        KnobSpec("gap", "NeighborConfig", "gap",
                 (384, 128, 256, 512), COST_RECONFIGURE,
                 "key-space gap bridged when merging candidate cells"),
        KnobSpec("group", "NeighborConfig", "group",
                 (64, 32, 128), COST_RECONFIGURE,
                 "particles per target group (TravConfig targetSize)"),
        KnobSpec("list_skin_rel", "PropagatorConfig", "list_skin_rel",
                 (0.2, 0.1, 0.3), COST_RECONFIGURE,
                 "Verlet skin as a fraction of the 2h_max search radius "
                 "(persistent-list rebuild cadence)"),
        # -- Simulation driver --------------------------------------------
        KnobSpec("check_every", "Simulation", "check_every",
                 (1, 4, 8), COST_STATIC,
                 "deferred resort/verify window: steps launched between "
                 "batched diagnostic fetches (the resort cadence)",
                 off_sentinel=1),
        KnobSpec("grav_window", "Simulation", "grav_window",
                 (256, 0, 128, 512, 1024), COST_RECONFIGURE,
                 "pad quantum (rows) for the MAC-sized sparse gravity "
                 "near-field exchange; 0 = ship full peer slabs (the "
                 "pre-sizing lowering, byte-identical)",
                 off_sentinel=0),
        # donate: none; XLA buffer donation, where the port's steps write
        # in place
        KnobSpec("grav_window_margin", "Simulation", "grav_window_margin",
                 (1.4, 1.2, 1.7, 2.0), COST_RECONFIGURE,
                 "headroom over the measured MAC-need rows per gravity "
                 "halo cap (escape sentinel trips regrow it; larger = "
                 "fewer trips, more comm volume)"),
        # -- hierarchical block time steps (sph/blockdt.py) ---------------
        # dt_bins changes the integration scheme, not just its cost: sweep
        # it only under a conservation-drift budget, never on wall time
        KnobSpec("dt_bins", "PropagatorConfig", "dt_bins",
                 (2, 4, 8), COST_STATIC,
                 "power-of-two per-particle dt bins (None/absent = the "
                 "global-dt path; updates saved scale with occupancy of "
                 "the deep bins)",
                 off_sentinel=None),
        KnobSpec("bin_sync_every", "PropagatorConfig", "bin_sync_every",
                 (1, 2, 4), COST_STATIC,
                 "cycles between bin reassignments at the sync substep "
                 "(higher = fewer rebin passes, staler bins)",
                 off_sentinel=1),
        KnobSpec("bin_resort_drift", "PropagatorConfig",
                 "bin_resort_drift", (0.0, 0.01, 0.05), COST_STATIC,
                 "drift-aware resort threshold: keep the current order "
                 "while folded-key inversions stay under this fraction "
                 "of n (0 = resort whenever any inversion appears)",
                 off_sentinel=0.0),
    )
}

#: owner key -> how to resolve the live surface ("dataclass": a field of
#: dataclasses.fields; "signature": a keyword of inspect.signature),
#: imported inside validate_registry()
_OWNERS = {
    "GravityConfig": ("dataclass", "sphexa_torch.gravity.traversal",
                      "GravityConfig"),
    "NeighborConfig": ("dataclass", "sphexa_torch.neighbors.cell_list",
                       "NeighborConfig"),
    "PropagatorConfig": ("dataclass", "sphexa_torch.propagator",
                         "PropagatorConfig"),
    "make_propagator_config": ("signature", "sphexa_torch.simulation",
                               "make_propagator_config"),
    "Simulation": ("signature", "sphexa_torch.simulation", "Simulation"),
}

#: knobs applied on top of gravity_tuning's solver shape
GRAVITY_KNOBS = ("target_block", "super_factor", "m2p_cap_margin")
#: knobs forwarded into make_propagator_config by Simulation._configure
NEIGHBOR_KNOBS = ("block", "cell_target", "run_cap", "gap", "group",
                  "list_skin_rel")
#: knobs resolved on the Simulation constructor itself
SIMULATION_KNOBS = ("check_every", "grav_window", "grav_window_margin")
#: block-timestep knobs (resolved on the Simulation constructor; they land
#: on PropagatorConfig)
BLOCKDT_KNOBS = ("dt_bins", "bin_sync_every", "bin_resort_drift")


def knob_names() -> Tuple[str, ...]:
    return tuple(KNOBS)


def off_sentinel_knobs() -> Tuple[KnobSpec, ...]:
    """The specs carrying an off sentinel, in registry order."""
    return tuple(s for s in KNOBS.values() if s.has_off_sentinel)


def validate_off_sentinels() -> None:
    """Check every off-sentinel declaration against the live Simulation
    consumption surface (``simulation.CONSUMED_KNOBS``); raises
    ``RuntimeError`` naming each drifted knob: a sentinel whose name the
    constructor no longer resolves would make ``tuned={name: off}`` a
    silent no-op."""
    import importlib

    sim_mod = importlib.import_module("sphexa_torch.simulation")
    consumed = set(getattr(sim_mod, "CONSUMED_KNOBS", ()))
    problems = []
    for spec in off_sentinel_knobs():
        if spec.name not in consumed:
            problems.append(
                f"{spec.name}: off_sentinel={spec.off_sentinel!r} declared "
                f"but the name is not in simulation.CONSUMED_KNOBS: the "
                f"constructor no longer resolves it (re-wire the "
                f"resolution site or drop the sentinel)")
        if spec.off_sentinel is not None and spec.domain \
                and type(spec.off_sentinel) not in {type(d) for d in
                                                    spec.domain} | {bool}:
            problems.append(
                f"{spec.name}: off_sentinel {spec.off_sentinel!r} type "
                f"does not match the domain {spec.domain!r}")
    if problems:
        raise RuntimeError(
            "off-sentinel knob declarations drifted from the live "
            "Simulation consumption surface:\n  " + "\n  ".join(problems))


def validate_registry() -> None:
    """Check every spec against its live owning surface; raises
    ``RuntimeError`` naming each drifted knob. Imports the config modules
    (and with them torch)."""
    import importlib
    import inspect

    problems = []
    for spec in KNOBS.values():
        if spec.owner not in _OWNERS:
            problems.append(f"{spec.name}: unknown owner {spec.owner!r}")
            continue
        kind, module, attr = _OWNERS[spec.owner]
        obj = getattr(importlib.import_module(module), attr)
        if kind == "dataclass":
            fields = {f.name for f in dataclasses.fields(obj)}
        else:
            target = obj.__init__ if inspect.isclass(obj) else obj
            fields = set(inspect.signature(target).parameters)
        if spec.field not in fields:
            problems.append(
                f"{spec.name}: {spec.owner}.{spec.field} no longer "
                f"exists (renamed/removed field: update the KnobSpec "
                f"or the tuning table)")
        if spec.cost not in (COST_STATIC, COST_RECONFIGURE):
            problems.append(f"{spec.name}: bad cost {spec.cost!r}")
        if not spec.domain:
            problems.append(f"{spec.name}: empty domain")
    if problems:
        raise RuntimeError(
            "tuning knob registry drifted from the live configs:\n  "
            + "\n  ".join(problems))
    validate_off_sentinels()
