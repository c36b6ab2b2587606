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

A sweep over ranks (``sweep_on_ranks``, ``spec.devices`` = P > 1) starts
the P ranks once (``parallel.mesh.spawn``) and runs the unchanged
``search.run_sweep`` on every rank, each candidate a ``Simulation(
num_devices=P)`` inside the rank's process group. The search is
adaptive, so every rank must see the same result: ``rank_measure``
catches a rank's error and agrees each candidate over the ranks in one
all_gather (``agree``: the value is the maximum over the ranks, a step
being as slow as its slowest rank; the status ``failed`` if any rank
failed, else ``overflow`` if any overflowed, else ``ok``).
"""

import dataclasses
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional

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
    flagged). Lower is better for every objective. ``attempts`` (not in
    the JAX package's result) counts the step attempts the candidate's
    Simulation made, the warm-up's and the replays included. Inside the
    ranks of a sweep (``spec.devices`` > 1) the Simulation takes the
    rank's process group, and a phase capture is this rank's own."""
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
            rank = sim.mesh.rank if sim.mesh is not None else 0
            profiler.export_chrome_trace(os.path.join(trace_dir, f"rank{rank}.pt.trace.json"))
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
        "attempts": int(sim.iteration + sim.replays),
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
    step). A spec over ranks (``devices`` > 1) is tallied as the JAX
    package's static cost tallies it: the unsharded global step on the
    global state, in one process (its ``static_cost_candidate`` traces
    ``step_hydro_std`` and its siblings, which never take the mesh, on
    ``sim.state``)."""
    from sphexa_torch.devtools.audit.core import EntryPoint, EntryTrace
    from sphexa_torch.devtools.audit.costmodel import cost_report, predict
    from sphexa_torch.devtools.audit.registry import _step_case
    from sphexa_torch.simulation import Simulation

    state, box, const = build_case(spec)
    sim = Simulation(
        state, box, const, prop=spec.prop, theta=spec.theta,
        backend=spec.backend, device=spec.device,
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


# ---------------------------------------------------------------------------
# the sweep over ranks
# ---------------------------------------------------------------------------

#: a candidate's statuses, in the order the agreement takes the worst
_STATUSES = ("ok", "overflow", "failed")

#: seconds a sweep's ranks may run: a rank left waiting in a collective by
#: a peer that failed is stopped there
RANK_TIMEOUT = 3600.0


def agree(mesh, own: Dict) -> Dict:
    """One candidate's result agreed over the ranks of ``mesh`` in one
    all_gather of (status, value, per_step_s): ``status`` the worst of
    the ranks' (``failed`` over ``overflow`` over ``ok``), ``value`` and
    ``per_step_s`` the maximum over the ranks (None when failed),
    ``rank_values`` each rank's value in rank order. The rank's own
    result is kept under ``own``; the other keys are this rank's
    (``steps``, ``rollbacks``, ...: replicated decisions)."""
    import torch

    from sphexa_torch.parallel.mesh import all_gather

    status = own.get("status")
    code = _STATUSES.index(status) if status in _STATUSES else len(_STATUSES) - 1

    def num(v):
        return float(v) if code < 2 and isinstance(v, (int, float)) else math.nan

    row = torch.tensor([code, num(own.get("value")), num(own.get("per_step_s"))],
                       dtype=torch.float64, device=mesh.device)
    rows = all_gather(mesh, row).cpu().tolist()
    codes = [int(r[0]) for r in rows]
    worst = _STATUSES[max(codes)]

    def top(col):
        vals = [r[col] for r in rows]
        return math.nan if any(math.isnan(v) for v in vals) else max(vals)

    rec = {k: v for k, v in own.items() if k not in ("status", "value", "per_step_s", "error")}
    rec.update(status=worst, value=None, per_step_s=None,
               rank_values=[None if c == 2 else r[1] for c, r in zip(codes, rows)],
               own={k: own.get(k) for k in ("status", "value", "per_step_s", "error")
                    if k in own})
    if worst == "failed":
        rec["error"] = f"failed on rank(s) {[r for r, c in enumerate(codes) if c == 2]}"
    else:
        rec.update(value=top(1), per_step_s=top(2))
    return rec


def rank_measure(mesh, spec: ReplaySpec, steps: int = 6, warmup: int = 1,
                 objective: str = "per_step_s",
                 trace_dir: Optional[str] = None) -> Callable[[Dict], Dict]:
    """The ``measure`` of ``search.run_sweep`` on one rank of a sweep:
    ``measure_candidate`` on this rank (an error caught and taken as
    ``failed``, so that no rank is left waiting in the agreement), then
    ``agree``. An error raised while the peers still wait in a collective
    of the candidate's own Simulation cannot be agreed: gloo aborts on the
    mismatched collective, or the ranks wait until ``spawn``'s timeout,
    and ``sweep_on_ranks`` raises (the CLI exits 1). With ``objective="phase:<name>"`` candidate i's capture is
    ``<trace_dir>/cand<i>/rank-<r>``."""
    counter = {"i": 0}

    def measure(knobs: Dict) -> Dict:
        td = None
        if objective.startswith("phase:") and trace_dir:
            td = os.path.join(trace_dir, f"cand{counter['i']}", f"rank-{mesh.rank}")
        counter["i"] += 1
        try:
            own = measure_candidate(spec, knobs, steps=steps, warmup=warmup,
                                    objective=objective, trace_dir=td)
        except Exception as e:  # noqa: BLE001 - a dead candidate on this rank
            own = {"status": "failed", "value": None, "error": f"{type(e).__name__}: {e}"}
        return agree(mesh, own)

    return measure


def agreed_history(history: List[Dict]) -> List[tuple]:
    """What every rank of a sweep holds alike: each candidate's number,
    knobs, agreed status and value, and the ranks' values (the rest of a
    record is the rank's own)."""
    return [(h["candidate"], h["knobs"], h["status"], h["value"], h.get("rank_values"))
            for h in history]


def replayed(history: List[Dict]) -> Callable[[Dict], Dict]:
    """A ``measure`` that answers ``run_sweep`` with a finished sweep's
    results in their order, so that ``run_sweep`` walks the same
    candidates again and emits their ``sweep`` events and log lines where
    the sweep was not measured (the CLI's process, from rank 0's history).
    A candidate out of order gives a ``failed`` record, which the caller
    sees as a history that differs."""
    records = iter(history)

    def measure(knobs: Dict) -> Dict:
        rec = next(records)
        if rec["knobs"] != knobs:
            raise ValueError(f"replay out of order: {knobs} where the sweep ran "
                             f"{rec['knobs']}")
        return {k: v for k, v in rec.items() if k not in ("candidate", "knobs")}

    return measure


def _sweep_rank(mesh, spec: ReplaySpec, domains: Dict, budget: int, steps: int, warmup: int,
                objective: str, trace_dir: Optional[str]) -> Dict:
    """One rank of ``sweep_on_ranks``: ``run_sweep`` over ``rank_measure``,
    with this rank's kernel launches over the sweep (the wrappers' counts,
    zero on the CPU)."""
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.tuning.search import run_sweep

    pe.reset_launches()
    result = run_sweep(rank_measure(mesh, spec, steps, warmup, objective, trace_dir),
                       domains, budget, objective=objective)
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "launches": dict(pe.LAUNCHES), **result}


def rank_launch(device, nprocs: int) -> Dict:
    """``spawn``'s launch arguments for ``nprocs`` ranks (the app's rule):
    gloo ranks on the CPU with ``device="cpu"``, else NCCL with one card a
    rank; raises ``ValueError`` with fewer cards than ranks."""
    import torch

    if device is not None and str(device) == "cpu":
        return {"device": "cpu", "backend": "gloo",
                "threads": max(1, (os.cpu_count() or 1) // nprocs)}
    if torch.cuda.device_count() < nprocs:
        raise ValueError(f"--devices {nprocs}: NCCL needs one card per rank, "
                         f"{torch.cuda.device_count()} present (--device cpu runs gloo ranks)")
    return {"device": device, "backend": "nccl", "threads": None}


def sweep_on_ranks(spec: ReplaySpec, domains: Dict, budget: int, steps: int = 6,
                   warmup: int = 1, objective: str = "per_step_s",
                   trace_dir: Optional[str] = None, launch: Optional[Dict] = None,
                   timeout: float = RANK_TIMEOUT) -> List[Dict]:
    """The sweep of ``spec`` over its ``devices`` ranks, started once
    (``parallel.mesh.spawn``): every rank runs ``search.run_sweep`` with
    ``rank_measure``, so that every rank takes the same candidates and
    ends with the same history. Returns each rank's ``run_sweep`` result
    (``baseline``, ``best``, ``improved``, ``history``, ``candidates``)
    with its ``rank``, ``backend``, ``device`` and ``launches``, in rank
    order. ``launch``: ``spawn``'s device, backend and threads (default
    ``rank_launch``; gloo ranks sharing one card are asked for with
    ``{"device": None, "backend": "gloo"}``). A rank that dies, or ranks
    past ``timeout`` seconds, raise here. A ``static-cost:`` objective
    measures nothing on the ranks: it tallies the global step in one
    process (``static_cost_candidate``)."""
    from sphexa_torch.parallel.mesh import spawn

    P = spec.devices or 1
    if P < 2 or objective.startswith(STATIC_COST):
        raise ValueError(f"a sweep over ranks needs devices > 1 and a measured objective, "
                         f"got devices {spec.devices}, {objective!r}")
    launch = rank_launch(spec.device, P) if launch is None else launch
    with tempfile.TemporaryDirectory(prefix="sphexa-tune-ranks-") as wd:
        return spawn(_sweep_rank, P, args=(spec, domains, budget, steps, warmup, objective,
                                           trace_dir),
                     workdir=wd, timeout=timeout, **launch)
