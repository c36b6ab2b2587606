"""Workload replay of the port (sphexa_tpu/tuning/replay.py): rebuild a
run's Simulation and time one candidate.

A ``ReplaySpec`` reconstructs a workload either from a telemetry run
manifest (``spec_from_manifest``: the run that was slow is the workload
to tune) or from a named init case, and ``measure_candidate`` scores one
knob dict on it with the machinery the Simulation already uses:

* the candidate's knobs go through the same ``tuned=`` path a table
  entry takes (Simulation's direct-dict source), so that the sweep
  measures exactly what committing the entry would run;
* the score is the deferred window's own clock, the ``window`` event's
  ``per_step_s``: the candidate runs as one (or more) ``check_every``
  windows;
* with ``objective="phase:<name>"`` the score is one phase of the
  per-phase device-time table: the measured window runs under a
  torch.profiler capture (the CLI's ``--trace-dir`` capture) and
  ``telemetry/traceview.summarize_trace`` attributes it.

* with ``objective="static-cost:<name>"`` (``static_cost_candidate``)
  the score is the static roofline prediction of one phase
  (devtools/audit): one step of the candidate's Simulation run under the
  cost tally, no time measured, on the spec's device (``--device cpu``
  needs no card).

Exceptions propagate: ``search.run_sweep`` turns a dead candidate into a
``failed`` sweep event.
"""

import dataclasses
import math
import os
from typing import Dict, Optional

from sphexa_torch.telemetry import MemorySink, Telemetry, read_manifest

#: knob whose value doubles as the measurement window length
_CADENCE = "check_every"

#: the objective prefix of the static roofline prediction (devtools/audit)
STATIC_COST = "static-cost:"


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """One reconstructable workload: a named init case at a given scale
    on a given backend, device and rank count. Snapshot workloads are out
    of scope (a replay must be buildable from the manifest alone)."""

    case: str
    side: int
    prop: str = "std"
    backend: str = "auto"
    theta: float = 0.5
    devices: Optional[int] = None
    #: "cuda" or "cpu" (None: the card, as every entry point of the port)
    device: Optional[str] = None

    @property
    def n(self) -> int:
        return self.side ** 3


def spec_from_manifest(run_dir: str) -> ReplaySpec:
    """Rebuild the workload of a telemetry run from its manifest (the CLI
    stamps ``config`` = its arguments and top-level ``case``/``prop``).
    Raises ``FileNotFoundError`` (no manifest) or ``ValueError`` (one
    that does not describe a replayable case run)."""
    m = read_manifest(run_dir)
    if m is None:
        raise FileNotFoundError(f"{run_dir}: no manifest.json "
                                f"(not a telemetry run dir)")
    cfg = m.get("config") or {}
    case = m.get("case") or cfg.get("init")
    side = cfg.get("side")
    if not case or not side:
        raise ValueError(f"{run_dir}: manifest lacks case/side: "
                         f"cannot reconstruct the workload")
    from sphexa_torch.init import CASES, split_case_spec

    base, _ = split_case_spec(str(case))
    if base not in CASES:
        raise ValueError(f"{run_dir}: case {case!r} is not a named init "
                         f"case (snapshot replays are unsupported)")
    return ReplaySpec(
        case=str(case), side=int(side),
        prop=str(m.get("prop") or cfg.get("prop") or "std"),
        backend=str(cfg.get("backend") or "auto"),
        theta=float(cfg.get("theta") or 0.5),
        devices=cfg.get("devices"),
        device=cfg.get("device"),
    )


def build_case(spec: ReplaySpec):
    """(state, box, const) for the spec on its device: one initializer
    call (measure_candidate calls it per candidate, so that a candidate
    that corrupts state cannot poison the next one)."""
    from sphexa_torch.init import make_initializer

    return make_initializer(spec.case)(spec.side, device=spec.device)


def measure_candidate(spec: ReplaySpec, knobs: Dict, steps: int = 6,
                      warmup: int = 1,
                      objective: str = "per_step_s",
                      trace_dir: Optional[str] = None) -> Dict:
    """Score one knob dict on the spec's workload; returns ``{status,
    objective, value, per_step_s, steps, windows, rollbacks,
    reconfigures, config}`` (``config``: the neighbour config the
    candidate ran with). ``status`` is ``ok``, or ``overflow`` when the run
    needed a rollback and replay (the time then includes the recovery: a
    cap-busting candidate is legal but scored at its true cost and
    flagged). Lower is better for every objective."""
    if objective.startswith(STATIC_COST):
        return static_cost_candidate(spec, knobs, objective[len(STATIC_COST):])
    import torch

    from sphexa_torch.simulation import Simulation

    state, box, const = build_case(spec)
    mem = MemorySink()
    inner = Telemetry(sinks=[mem])
    # check_every is the measurement window: when the candidate does not
    # sweep it, the window is pinned to the measured step count (one read
    # a measurement)
    cadence = int(knobs.get(_CADENCE, steps))
    measured = max(cadence, math.ceil(steps / cadence) * cadence)
    sim = Simulation(
        state, box, const, prop=spec.prop, theta=spec.theta,
        backend=spec.backend, num_devices=spec.devices, device=spec.device,
        check_every=None if _CADENCE in knobs else measured,
        tuned=dict(knobs) if knobs else None, workload=spec.case,
        telemetry=inner,
    )
    # warm-up windows: the first window's allocations and list build stay
    # out of the score
    if warmup > 0:
        sim.run(warmup * cadence)
    mem.events.clear()
    base_rollbacks = inner.counters["rollbacks"]
    base_reconfigs = inner.counters["reconfigures"]
    tracing = objective.startswith("phase:")
    profiler = None
    if tracing:
        if not trace_dir:
            raise ValueError(f"objective {objective!r} needs trace_dir")
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if sim.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    try:
        sim.run(measured)
    finally:
        if profiler is not None:
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(trace_dir, "rank0.pt.trace.json"))
    windows = mem.of_kind("window")
    wall = sum(w["wall_s"] for w in windows)
    done = sum(w["steps"] for w in windows)
    per_step = wall / done if done else float("nan")
    rollbacks = int(inner.counters["rollbacks"] - base_rollbacks)
    result = {
        "status": "overflow" if rollbacks else "ok",
        "objective": objective,
        "value": per_step,
        "per_step_s": per_step,
        "steps": int(done),
        "windows": len(windows),
        "rollbacks": rollbacks,
        "reconfigures": int(inner.counters["reconfigures"] - base_reconfigs),
        # the neighbour config the candidate ran with (the JAX package's
        # result has no such key; the sweep events do not carry it)
        "config": {**{k: getattr(sim.cfg.nbr, k) for k in (
            "level", "window", "cap", "group", "run_cap", "gap")},
            "list_skin_rel": sim.cfg.list_skin_rel,
            "list_slot_cap": sim.cfg.list_slot_cap},
    }
    if tracing:
        from sphexa_torch.telemetry.traceview import summarize_trace

        want = objective.split(":", 1)[1]
        summary = summarize_trace(trace_dir)
        row = next((p for p in summary.get("phases", ())
                    if p.get("phase") == want), None)
        if row is None:
            raise ValueError(
                f"phase {want!r} absent from the trace (has: "
                f"{[p.get('phase') for p in summary.get('phases', ())]})")
        # per-step device microseconds of the one phase being tuned
        result["value"] = float(row["us"]) / max(done, 1)
        result["phase_us"] = float(row["us"])
    return result


def static_cost_candidate(spec: ReplaySpec, knobs: Dict, phase: str,
                          device: str = "h100") -> Dict:
    """Score one knob dict by the static roofline prediction of one phase
    (``objective="static-cost:<phase>"``).

    The candidate's knobs ride the same ``tuned=`` path as
    ``measure_candidate``, but instead of timing steps one step of the
    candidate's Simulation runs under the cost tally (the audit
    registry's step form, devtools/audit/registry.py) and the value is the
    predicted ms of the target phase on the named device model
    (devtools/audit/devices.py). No time is measured, so the step runs on
    the spec's device, the CPU included. The ranking is only as good as
    the cost model: hold it against a capture with ``python -m
    sphexa_torch.telemetry trace <capture> --predict`` before trusting it.
    Returns the JAX package's result dict (``steps`` 0: no measured
    step)."""
    from sphexa_torch.devtools.audit.core import EntryPoint, EntryTrace
    from sphexa_torch.devtools.audit.costmodel import cost_report, predict
    from sphexa_torch.devtools.audit.registry import _step_case
    from sphexa_torch.simulation import Simulation

    state, box, const = build_case(spec)
    sim = Simulation(
        state, box, const, prop=spec.prop, theta=spec.theta,
        backend=spec.backend, num_devices=spec.devices, device=spec.device,
        tuned=dict(knobs) if knobs else None, workload=spec.case,
    )
    case = _step_case(sim)
    entry = EntryPoint(name=f"{STATIC_COST}{phase}", build=lambda: case)
    pred = predict(cost_report(EntryTrace(entry, case)), device)
    row = pred.row(phase)
    if row is None or row.ms <= 0:
        raise ValueError(
            f"phase {phase!r} absent from the static prediction (has: "
            f"{[r.phase for r in pred.rows]})")
    return {
        "status": "ok",
        "objective": f"{STATIC_COST}{phase}",
        "value": row.ms,
        "predicted_ms": row.ms,
        "ai": row.ai,
        "bound": row.bound,
        "device": pred.device,
        "steps": 0, "windows": 0, "rollbacks": 0, "reconfigures": 0,
    }
