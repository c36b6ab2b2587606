"""``python -m sphexa_torch.telemetry``: the port's reader of its telemetry
run dirs (the JAX package's ``sphexa-telemetry``, sphexa_tpu/telemetry/
cli.py), which needs no device and no JAX.

    python -m sphexa_torch.telemetry summary <run-dir> [--format text|json] [--strict]
    python -m sphexa_torch.telemetry shards  <run-dir> [--format text|json]
    python -m sphexa_torch.telemetry science <run-dir> [--format text|json] [--budget F]
    python -m sphexa_torch.telemetry diff <baseline> <candidate> [--threshold F] [--drift]
    python -m sphexa_torch.telemetry trace <trace-dir> [--min-coverage F] [--top N]
    python -m sphexa_torch.telemetry history <inputs...>
    python -m sphexa_torch.telemetry regress --lock <lock.json> [candidate] [--write]
    python -m sphexa_torch.telemetry tuning <run-dir | table.json> [--require K]
    python -m sphexa_torch.telemetry serve <dir|glob> [--out HTML] [--port N]
                                           [--refresh S] [--once]
    python -m sphexa_torch.telemetry fleet <glob> [--format text|json]

The subcommands, their JSON and their exit codes are the JAX CLI's:

- ``summary``: p50/p95/mean step time (checked steps and deferred
  windows' per-step means), retrace/rollback/reconfigure counts, per-phase
  means; ``--strict`` exits 1 on any schema-invalid event or unknown kind
  (unknown kinds are counted and reported either way);
- ``shards``: the per-rank view (``shard_load`` / ``exchange`` /
  ``memory`` / ``imbalance`` events); exit 1 without per-shard telemetry;
- ``science``: the conservation drift, the dt-limiter histogram, the
  extrema timeline, nonfinite counts, watchdog hits, the block time
  steps; exit 1 without physics telemetry, past ``--budget``, or (without
  it) when a watchdog fired;
- ``diff``: two run dirs, two bench JSONs or one of each; exit 0 within
  the threshold, 1 past it, 2 on unreadable input; ``--drift`` makes the
  energy drift a headline metric;
- ``trace``: the per-phase device time of a ``--trace-dir`` capture, the
  port's torch.profiler chrome traces (telemetry/traceview.py);
  ``--min-coverage`` exits 1 below that attributed share. The JAX CLI's
  ``--predict`` (its static cost model) is not available;
- ``history`` / ``regress``: the trend over the bench JSONs and run dirs
  named, and the lock-file gate (telemetry/history.py). With no inputs
  ``history`` exits 2: the repo's committed rounds are the JAX package's
  TPU measurements and are never read as the port's;
- ``tuning``: on a run dir the active knobs and their provenance (the
  manifest's ``tuning`` stamp, the ``tuning`` and ``sweep`` events), exit
  1 without tuning telemetry; on a table file its schema and knob names
  against the port's registry (sphexa_torch/tuning), its coverage, and
  ``--require workload,n,p,backend`` (exit 1 on a gap);
- ``serve`` / ``fleet``: the self-contained HTML dashboard, or a text
  table, over one or many run dirs with their ``snapshots/`` rings
  (telemetry/serve.py).

A run whose flight recorder left ``blackbox.json`` is explained next to
its partial aggregation.
"""

import argparse
import json
import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from sphexa_torch.telemetry.flightrec import read_blackbox
from sphexa_torch.telemetry.history import (
    HistoryError,
    parse_bench_json as _parse_bench_json,
)
from sphexa_torch.telemetry.manifest import read_manifest
from sphexa_torch.telemetry.registry import EVENT_KINDS, validate_event
from sphexa_torch.telemetry.tables import render_table
from sphexa_torch.telemetry.traceview import TraceError


class TelemetryError(Exception):
    """Unreadable/invalid input (CLI exit code 2)."""


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_events(run_dir: str) -> Tuple[List[dict], List[str]]:
    """(events, problems) from ``<run_dir>/events.jsonl``. Unparseable
    lines and schema violations are collected, not fatal — a killed run
    leaves a readable prefix and the summary should still work."""
    path = os.path.join(run_dir, "events.jsonl")
    if not os.path.exists(path):
        raise TelemetryError(f"no events.jsonl in {run_dir}")
    events: List[dict] = []
    problems: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError as exc:
                problems.append(f"line {lineno}: unparseable ({exc})")
                continue
            bad = validate_event(e)
            if bad:
                problems.append(f"line {lineno}: " + "; ".join(bad))
            events.append(e)
    return events, problems


def _of_kind(events: List[dict], kind: str) -> List[dict]:
    return [e for e in events if e.get("kind") == kind]


def _crash_view(run_dir: str) -> Optional[Dict]:
    """Compact blackbox digest for the summary/science views (None when
    the run has no flight-recorder dump)."""
    box = read_blackbox(run_dir)
    if box is None:
        return None
    tb = (box.get("traceback") or "").strip().splitlines()
    return {
        "reason": box.get("reason"),
        "watchdogs": box.get("watchdogs") or {},
        "buffered_events": len(box.get("events") or []),
        "traceback_tail": tb[-3:],
        "fault_log": box.get("fault_log"),
    }


def summarize_run(run_dir: str) -> Dict:
    """Aggregate one run directory into the summary dict.

    "Step time" unifies both checking modes: synchronous steps contribute
    their own wall time (``step`` events); deferred windows contribute
    their per-step mean once per window step (``window`` events) — the
    only honest per-step number when the happy path never syncs
    (docs/OBSERVABILITY.md, deferred-window semantics).
    """
    events, problems = load_events(run_dir)
    # schema-invalid events are reported as problems, never fatal — a
    # killed run's truncated line must not take the summary down with it
    samples: List[float] = []
    for e in _of_kind(events, "step"):
        if isinstance(e.get("wall_s"), (int, float)):
            samples.append(float(e["wall_s"]))
    for e in _of_kind(events, "window"):
        if isinstance(e.get("per_step_s"), (int, float)) \
                and isinstance(e.get("steps"), int):
            samples.extend([float(e["per_step_s"])] * e["steps"])

    phases: Dict[str, List[float]] = {}
    for e in _of_kind(events, "phases"):
        for k, v in e.items():
            if k in ("v", "seq", "t", "kind", "it"):
                continue
            if isinstance(v, (int, float)):
                phases.setdefault(k, []).append(float(v))

    step_time = {}
    if samples:
        arr = np.asarray(samples)
        step_time = {
            "count": len(samples),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "mean_s": float(arr.mean()),
            "max_s": float(arr.max()),
        }
    # forward compat: kinds this reader does not know are counted and
    # surfaced, not silently skipped (a v1 reader on a v2 file used to
    # drop exchange/shard_load/... without a trace)
    unknown_kinds = Counter(
        e.get("kind") for e in events if e.get("kind") not in EVENT_KINDS
    )
    return {
        "run_dir": run_dir,
        "manifest": read_manifest(run_dir),
        "events": len(events),
        "steps": len(samples),
        "windows": len(_of_kind(events, "window")),
        "launches": len(_of_kind(events, "launch")),
        "step_time": step_time,
        # partial/corrupt records (a killed run's half-written events)
        # degrade to defaults instead of TypeError-ing the aggregation
        "retraces": int(sum(
            e["delta"] if isinstance(e.get("delta"), (int, float)) else 1
            for e in _of_kind(events, "retrace"))),
        "rollbacks": len(_of_kind(events, "rollback")),
        "replayed_steps": int(sum(
            e["steps"] if isinstance(e.get("steps"), (int, float)) else 0
            for e in _of_kind(events, "replay"))),
        # construction-time sizing is expected once per run, not a
        # mid-run health signal — only non-initial rebuilds count
        "reconfigures": len([e for e in _of_kind(events, "reconfigure")
                             if e.get("reason") != "initial"]),
        "imbalances": len(_of_kind(events, "imbalance")),
        "phase_mean_s": {k: float(np.mean(v)) for k, v in sorted(
            phases.items())},
        "unknown_kinds": {str(k): int(n)
                          for k, n in sorted(unknown_kinds.items())},
        # the flight recorder's dump, when the run died abnormally: the
        # summary EXPLAINS a truncated record instead of tolerating it
        "crash": _crash_view(run_dir),
        "schema_problems": problems,
    }


# ---------------------------------------------------------------------------
# shards view (schema v2 distributed events)
# ---------------------------------------------------------------------------


def _per_shard_matrix(events: List[dict], key: str) -> Optional[np.ndarray]:
    """(n_events, P) float matrix of one per-shard list field; None when
    the field never appears. Ragged rows (a mid-run mesh change would be
    a different run anyway) are dropped rather than guessed at."""
    rows = [e[key] for e in events
            if isinstance(e.get(key), list) and e[key]]
    if not rows:
        return None
    width = len(rows[-1])
    rows = [r for r in rows if len(r) == width]
    try:
        return np.asarray(rows, dtype=np.float64)
    except (TypeError, ValueError):
        return None


def summarize_shards(run_dir: str) -> Dict:
    """Aggregate the distributed (schema-v2) events of one run into the
    per-shard view: load/work per shard, halo-exchange volume and
    occupancy percentiles, escape trips, imbalance-watchdog hits, and
    per-device HBM snapshots. Schema-v7 stages the exchange records:
    events with ``stage == "gravity"`` (the MAC-sized sparse gravity
    serve) aggregate into their own block next to the SPH one; pre-v7
    events carry no stage and read as SPH."""
    events, problems = load_events(run_dir)
    loads = _of_kind(events, "shard_load")
    all_ex = _of_kind(events, "exchange")
    exchanges = [e for e in all_ex if e.get("stage", "sph") != "gravity"]
    gexchanges = [e for e in all_ex if e.get("stage") == "gravity"]
    memories = _of_kind(events, "memory")
    imbalances = _of_kind(events, "imbalance")

    particles = _per_shard_matrix(loads, "particles")
    work = _per_shard_matrix(loads, "work")
    rows = _per_shard_matrix(exchanges, "rows")
    occ = _per_shard_matrix(exchanges, "occ")
    grows = _per_shard_matrix(gexchanges, "rows")
    gocc = _per_shard_matrix(gexchanges, "occ")

    shards: List[Dict] = []
    P = 0
    for m in (particles, work, rows, occ, grows, gocc):
        if m is not None:
            P = max(P, m.shape[1])
    for s in range(P):
        col = lambda m: None if m is None or s >= m.shape[1] else m[:, s]
        w = col(work)
        r = col(rows)
        o = col(occ)
        gr = col(grows)
        go = col(gocc)
        shards.append({
            "shard": s,
            "particles": int(particles[-1, s]) if particles is not None
            else None,
            "work_mean": float(w.mean()) if w is not None else None,
            "rows_mean": float(r.mean()) if r is not None else None,
            "occ_p95": float(np.percentile(o, 95)) if o is not None
            else None,
            "grav_rows_mean": float(gr.mean()) if gr is not None else None,
            "grav_occ_p95": float(np.percentile(go, 95)) if go is not None
            else None,
        })
    if work is not None and all(s["work_mean"] is not None for s in shards):
        total = sum(s["work_mean"] for s in shards) or 1.0
        for s in shards:
            s["work_share"] = s["work_mean"] / total
    last_ex = exchanges[-1] if exchanges else {}
    last_gex = gexchanges[-1] if gexchanges else {}
    gravity = None
    if gexchanges:
        gravity = {
            "windows": len(gexchanges),
            "mode": last_gex.get("mode"),
            "shipped_rows": last_gex.get("shipped_rows"),
            "bytes_per_step": last_gex.get("bytes_per_step"),
            "trips": last_gex.get("trips", 0),
        }
    # imbalance ratios over the run: max/mean of work per event row
    ratios = []
    if work is not None:
        means = work.mean(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratios = list(work.max(axis=1)[means > 0] / means[means > 0])
    return {
        "run_dir": run_dir,
        "manifest": read_manifest(run_dir),
        "shards": shards,
        "windows": len(exchanges),
        "mode": last_ex.get("mode"),
        "shipped_rows": last_ex.get("shipped_rows"),
        "bytes_per_step": last_ex.get("bytes_per_step"),
        "trips": last_ex.get("trips", 0),
        "gravity": gravity,
        "imbalance_events": len(imbalances),
        "work_ratio_p95": float(np.percentile(ratios, 95)) if ratios
        else None,
        "memory": [
            {k: e.get(k) for k in ("point", "it", "devices",
                                   "bytes_in_use", "peak_bytes_in_use")}
            for e in memories
        ],
        "schema_problems": problems,
    }


# ---------------------------------------------------------------------------
# science view (schema v3 physics-observability events)
# ---------------------------------------------------------------------------


def _concat_series(events: List[dict], key: str):
    """Flatten one per-step list field across physics/numerics events
    into a single python list (older/malformed events that carry a bare
    scalar contribute that scalar once; non-numeric entries drop)."""
    out: List[float] = []
    for e in events:
        v = e.get(key)
        if not isinstance(v, list):
            v = [v]
        out.extend(float(x) for x in v
                   if isinstance(x, (int, float)))
    return out


def summarize_science(run_dir: str) -> Dict:
    """Aggregate one run's physics-observability (schema v3) events:
    the per-step conservation series and its drift, the dt-limiter
    histogram, nonfinite counts, field extrema, watchdog hits. Partial
    records (crash before the first flush: no physics events at all)
    summarize to an empty-but-rendered view, never a traceback."""
    events, problems = load_events(run_dir)
    phys = _of_kind(events, "physics")
    nums = _of_kind(events, "numerics")
    bins = _of_kind(events, "dt_bins")

    its = [int(x) for x in _concat_series(phys, "its")]
    series = {k: _concat_series(phys, k)
              for k in ("t_sim", "dt", "etot", "ecin", "eint", "egrav",
                        "linmom", "angmom")}
    etot = np.asarray(series["etot"], dtype=np.float64)
    t_sim = np.asarray(series["t_sim"], dtype=np.float64)

    drift = {}
    finite = etot[np.isfinite(etot)]
    if finite.size:
        e0 = float(finite[0])
        denom = abs(e0) or 1.0
        with np.errstate(invalid="ignore"):
            d = np.abs(etot - e0) / denom
        dmax = float(np.nanmax(d)) if np.isfinite(d).any() else None
        dfin = float(d[-1]) if np.isfinite(d[-1]) else None
        drift = {"etot0": e0, "etot_final": float(etot[-1]),
                 "max": dmax, "final": dfin}
        if (dfin is not None and t_sim.size == etot.size
                and t_sim.size > 1 and t_sim[-1] > t_sim[0]):
            drift["per_time"] = dfin / float(t_sim[-1] - t_sim[0])

    limiter: Dict[str, int] = {}
    nonfinite: Dict[str, int] = {}
    extrema_rows: List[Dict] = []
    for e in nums:
        for name, n in (e.get("limiter") or {}).items():
            if isinstance(n, int):
                limiter[str(name)] = limiter.get(str(name), 0) + n
        for f, n in (e.get("nonfinite") or {}).items():
            if isinstance(n, int):
                nonfinite[str(f)] = max(nonfinite.get(str(f), 0), n)
        extrema_rows.append({
            k: e.get(k) for k in ("it", "rho_min", "rho_max", "h_min",
                                  "h_max", "du_max", "nc_clip", "h_sat")
        })

    # block-timestep view (schema v6 dt_bins events): the run-total
    # particle-update counters ARE the chip-free complexity proxy, the
    # last event's histogram shows where the bins settled
    dt_bins_view = None
    if bins:
        updates = sum(int(e.get("updates", 0)) for e in bins)
        full = sum(int(e.get("updates_full", 0)) for e in bins)
        dt_bins_view = {
            "events": len(bins),
            "pop": bins[-1].get("pop"),
            "updates": updates,
            "updates_full": full,
            "saved_factor": (full / updates) if updates else None,
            "resorts": sum(int(e.get("resorts", 0)) for e in bins),
            "keeps": sum(int(e.get("keeps", 0)) for e in bins),
        }

    return {
        "run_dir": run_dir,
        "manifest": read_manifest(run_dir),
        "physics_events": len(phys),
        "steps": len(its) or len(series["etot"]),
        "t_range": [float(t_sim[0]), float(t_sim[-1])] if t_sim.size
        else None,
        "drift": drift,
        "limiter": dict(sorted(limiter.items())),
        "nonfinite": nonfinite,
        "extrema": extrema_rows,
        "dt_bins": dt_bins_view,
        "drift_events": len(_of_kind(events, "drift")),
        "field_health_events": len(_of_kind(events, "field_health")),
        "crash": _crash_view(run_dir),
        "schema_problems": problems,
    }


def load_side(path: str) -> Dict:
    """One diff operand: a telemetry run dir or a bench JSON file
    (parsing shared with the history/regress machinery —
    telemetry/history.parse_bench_json owns the wrapper shapes)."""
    if os.path.isdir(path):
        s = summarize_run(path)
        return {"type": "run", "label": path, "summary": s}
    if os.path.isfile(path):
        try:
            b = _parse_bench_json(path)
        except HistoryError as e:
            raise TelemetryError(str(e))
        return {"type": "bench", "label": path, "bench": b}
    raise TelemetryError(f"{path}: neither a run directory nor a file")


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------


def _run_updates_per_sec(side: Dict) -> Optional[float]:
    s = side["summary"]
    manifest = s.get("manifest") or {}
    n = manifest.get("particles")
    p50 = s.get("step_time", {}).get("p50_s")
    if not n or not p50:
        return None
    return float(n) / float(p50)


def diff_sides(base: Dict, cand: Dict, threshold: float,
               drift: bool = False) -> Dict:
    """Compare candidate against baseline. Returns the comparison dict;
    ``regressed`` is True when a headline metric moved past the
    threshold in the bad direction (step time up / throughput down /
    energy drift up). ``drift`` promotes run-vs-run energy drift to a
    headline metric (drift-vs-drift, the conservation regression gate)
    and errors when either side lacks physics telemetry."""
    if drift and not (base["type"] == "run" and cand["type"] == "run"):
        raise TelemetryError("--drift compares two run directories")
    rows: List[Dict] = []

    def row(metric, a, b, higher_is_better, headline=False):
        if a is None or b is None:
            return
        if a == 0:
            change = 0.0 if b == 0 else float("inf")
        else:
            change = b / a - 1.0
        bad = (change < -threshold) if higher_is_better \
            else (change > threshold)
        rows.append({
            "metric": metric, "baseline": a, "candidate": b,
            "change": change, "headline": headline,
            "regressed": bool(headline and bad),
        })

    if base["type"] == "run" and cand["type"] == "run":
        a, b = base["summary"], cand["summary"]
        at, bt = a.get("step_time", {}), b.get("step_time", {})
        row("step_time_p50_s", at.get("p50_s"), bt.get("p50_s"),
            higher_is_better=False, headline=True)
        row("step_time_p95_s", at.get("p95_s"), bt.get("p95_s"),
            higher_is_better=False)
        row("retraces", a["retraces"], b["retraces"],
            higher_is_better=False)
        row("rollbacks", a["rollbacks"], b["rollbacks"],
            higher_is_better=False)
        row("reconfigures", a["reconfigures"], b["reconfigures"],
            higher_is_better=False)
        for k in sorted(set(a["phase_mean_s"]) & set(b["phase_mean_s"])):
            row(f"phase_{k}_mean_s", a["phase_mean_s"][k],
                b["phase_mean_s"][k], higher_is_better=False)
        # conservation: drift-vs-drift, computed ONLY under --drift —
        # each science view re-parses events.jsonl, and a plain
        # step-time diff (incl. of pre-v3 runs) must not pay that or
        # change behavior
        if drift:
            da = summarize_science(base["label"]).get("drift", {}).get(
                "max")
            db = summarize_science(cand["label"]).get("drift", {}).get(
                "max")
            if da is None or db is None:
                raise TelemetryError(
                    "--drift needs physics telemetry on both sides "
                    "(re-run with --telemetry-dir on a v3 writer)")
            # drift is legitimately EXACTLY zero on short baselines; a
            # ratio-only gate would turn any nonzero candidate into an
            # infinite regression — floor the baseline at 1e-9 (f32
            # noise scale) before the relative comparison
            base_eff = max(da, 1e-9)
            rows.append({
                "metric": "energy_drift_max", "baseline": da,
                "candidate": db, "change": db / base_eff - 1.0,
                "headline": True,
                "regressed": bool(db > base_eff * (1.0 + threshold)),
            })
    elif base["type"] == "bench" and cand["type"] == "bench":
        a, b = base["bench"], cand["bench"]
        # the headline is whatever the bench line's metric is: throughput
        # for bench.py, a saving ratio for measure_multichip --json —
        # both higher-is-better by construction
        label = ("saving" if "saving" in str(a.get("metric", ""))
                 else "updates_per_sec")
        row(label, a.get("value"), b.get("value"),
            higher_is_better=True, headline=True)
        ea, eb = a.get("extra", {}) or {}, b.get("extra", {}) or {}
        for k in sorted(set(ea) & set(eb)):
            if isinstance(ea[k], (int, float)) and isinstance(
                    eb[k], (int, float)):
                # throughput/saving metrics improve upward; everything
                # else (times, comm rows/fractions, byte counts) downward
                row(k, ea[k], eb[k],
                    higher_is_better="updates_per_sec" in k
                    or "saving" in k)
    else:
        # mixed: throughput is the one commensurable axis
        def ups(side):
            if side["type"] == "bench":
                return side["bench"].get("value")
            return _run_updates_per_sec(side)

        a, b = ups(base), ups(cand)
        if a is None or b is None:
            raise TelemetryError(
                "run-vs-bench diff needs 'particles' in the run manifest "
                "and a step-time p50 (re-run with --telemetry-dir)"
            )
        row("updates_per_sec", a, b, higher_is_better=True, headline=True)

    if not rows:
        raise TelemetryError("nothing comparable between the two inputs")
    return {
        "baseline": base["label"],
        "candidate": cand["label"],
        "threshold": threshold,
        "rows": rows,
        "regressed": any(r["regressed"] for r in rows),
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:.3f} ms"


def render_summary(s: Dict) -> str:
    m = s.get("manifest") or {}
    lines = [f"run: {s['run_dir']}"]
    if m:
        lines.append(
            f"  git {m.get('git_rev', '?')}  torch {m.get('torch_version', '?')}"
            f"  backend {m.get('backend', '?')}"
            f"  devices {m.get('device_count', '?')}"
            + (f"  mesh {m['mesh_shape']}" if m.get("mesh_shape") else "")
            + (f"  N={m['particles']}" if m.get("particles") else "")
        )
    else:
        lines.append("  (no manifest.json)")
    st = s.get("step_time") or {}
    rows = [
        ("steps", s["steps"]),
        ("deferred windows", s["windows"]),
        ("step time p50", _fmt_s(st.get("p50_s"))),
        ("step time p95", _fmt_s(st.get("p95_s"))),
        ("step time mean", _fmt_s(st.get("mean_s"))),
        ("retraces", s["retraces"]),
        ("rollbacks", s["rollbacks"]),
        ("replayed steps", s["replayed_steps"]),
        ("reconfigures", s["reconfigures"]),
    ]
    for k, v in s["phase_mean_s"].items():
        rows.append((f"phase {k} (mean)", _fmt_s(v)))
    if s.get("imbalances"):
        rows.append(("imbalance events", s["imbalances"]))
    lines.append(render_table(rows))
    lines.extend(_render_crash(s.get("crash")))
    for kind, n in s.get("unknown_kinds", {}).items():
        lines.append(f"  unknown kind: {kind} x{n} (newer writer? "
                     f"upgrade this reader)")
    for p in s["schema_problems"]:
        lines.append(f"  schema: {p}")
    return "\n".join(lines)


def _render_crash(crash: Optional[Dict]) -> List[str]:
    """Lines explaining a flight-recorder dump (empty for clean runs)."""
    if not crash:
        return []
    lines = [f"CRASH: {crash.get('reason', '?')} (blackbox.json, "
             f"{crash.get('buffered_events', 0)} buffered events)"]
    hot = {k: v for k, v in (crash.get("watchdogs") or {}).items()
           if v and k != "events_total"}
    if hot:
        lines.append("  watchdog state at death: "
                     + " ".join(f"{k}={v}" for k, v in sorted(hot.items())))
    for t in crash.get("traceback_tail") or []:
        lines.append(f"  | {t}")
    if crash.get("fault_log"):
        lines.append(f"  fault log: {crash['fault_log']}")
    return lines


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    return f"{v:.1f} GiB"


def render_shards(s: Dict) -> str:
    m = s.get("manifest") or {}
    lines = [f"run: {s['run_dir']}"]
    if m:
        lines.append(
            f"  devices {m.get('device_count', '?')}"
            + (f"  mesh {m['mesh_shape']}" if m.get("mesh_shape") else "")
            + (f"  N={m['particles']}" if m.get("particles") else "")
            + f"  backend {m.get('backend', '?')}"
        )
    if not s["shards"]:
        lines.append("  no per-shard telemetry in this run "
                     "(single-device, or a pre-v2 writer)")
        return "\n".join(lines)
    fmt = lambda v, f="{:.3g}": "-" if v is None else f.format(v)
    # gravity-stage columns render only when a v7 writer staged them
    grav = any(sh.get("grav_rows_mean") is not None for sh in s["shards"])
    rows = []
    for sh in s["shards"]:
        row = (
            sh["shard"],
            fmt(sh["particles"], "{}"),
            fmt(sh["work_mean"], "{:.4g}"),
            fmt(sh.get("work_share"), "{:.1%}"),
            fmt(sh["rows_mean"], "{:.4g}"),
            fmt(sh["occ_p95"], "{:.2f}"),
        )
        if grav:
            row += (fmt(sh.get("grav_rows_mean"), "{:.4g}"),
                    fmt(sh.get("grav_occ_p95"), "{:.2f}"))
        rows.append(row)
    headers = ("shard", "particles", "work", "share", "halo rows",
               "occ p95")
    if grav:
        headers += ("grav rows", "grav occ")
    lines.append(render_table(rows, headers=headers))
    info = [
        ("windows recorded", s["windows"]),
        ("exchange mode", s.get("mode") or "-"),
        ("shipped rows/serve", s.get("shipped_rows") or "-"),
        ("bytes/step", _fmt_bytes(s.get("bytes_per_step"))
         if s.get("bytes_per_step") else "-"),
        ("escape trips", s.get("trips", 0)),
        ("imbalance events", s.get("imbalance_events", 0)),
    ]
    g = s.get("gravity")
    if g:
        info += [
            ("gravity mode", g.get("mode") or "-"),
            ("gravity rows/serve", g.get("shipped_rows") or "-"),
            ("gravity bytes/step", _fmt_bytes(g.get("bytes_per_step"))
             if g.get("bytes_per_step") else "-"),
            ("gravity trips", g.get("trips", 0)),
        ]
    if s.get("work_ratio_p95") is not None:
        info.append(("work max/mean p95", f"{s['work_ratio_p95']:.3f}"))
    lines.append(render_table(info))
    if s["memory"]:
        lines.append("memory snapshots:")
        mrows = []
        for e in s["memory"]:
            bts = e.get("bytes_in_use") or []
            pks = e.get("peak_bytes_in_use") or []
            mrows.append((
                e.get("point", "?"),
                e.get("it", "-"),
                len(e.get("devices") or []),
                _fmt_bytes(max(bts)) if bts else "-",
                _fmt_bytes(max(pks)) if pks else "-",
            ))
        lines.append(render_table(
            mrows, headers=("point", "it", "devices", "max bytes",
                            "max peak")))
    for p in s["schema_problems"]:
        lines.append(f"  schema: {p}")
    return "\n".join(lines)


def _fmt_g(v, fmt="{:.6g}") -> str:
    return "-" if v is None else fmt.format(v)


def render_science(s: Dict) -> str:
    m = s.get("manifest") or {}
    lines = [f"run: {s['run_dir']}"]
    if m:
        lines.append(
            f"  backend {m.get('backend', '?')}"
            + (f"  N={m['particles']}" if m.get("particles") else "")
            + (f"  case {m['case']}" if m.get("case") else "")
        )
    if not s["physics_events"]:
        lines.append("  no physics telemetry in this run "
                     "(pre-v3 writer, or it crashed before the first "
                     "check/flush boundary)")
        lines.extend(_render_crash(s.get("crash")))
        return "\n".join(lines)
    d = s.get("drift") or {}
    rows = [
        ("steps", s["steps"]),
        ("t range", "-" if not s.get("t_range") else
         f"{s['t_range'][0]:.6g} .. {s['t_range'][1]:.6g}"),
        ("etot first", _fmt_g(d.get("etot0", None), "{:.10g}")),
        ("etot final", _fmt_g(d.get("etot_final", None), "{:.10g}")),
        ("|drift| final", _fmt_g(d.get("final"), "{:.3e}")),
        ("|drift| max", _fmt_g(d.get("max"), "{:.3e}")),
    ]
    if d.get("per_time") is not None:
        rows.append(("drift rate (/sim-time)", f"{d['per_time']:.3e}"))
    rows.append(("drift watchdog events", s["drift_events"]))
    rows.append(("field-health events", s["field_health_events"]))
    for f, n in sorted((s.get("nonfinite") or {}).items()):
        if n:
            rows.append((f"nonfinite {f} (max/step)", n))
    lines.append(render_table(rows))
    if s.get("limiter"):
        total = sum(s["limiter"].values()) or 1
        lines.append("timestep limiter:")
        lines.append(render_table(
            [(name, n, f"{n / total:.1%}")
             for name, n in sorted(s["limiter"].items(),
                                   key=lambda kv: -kv[1])],
            headers=("limiter", "steps", "share")))
    b = s.get("dt_bins")
    if b:
        pop = b.get("pop") or []
        tot = sum(pop) or 1
        lines.append("dt bins (hierarchical block time steps):")
        lines.append(render_table(
            [(f"2^{k} x dt_min", n, f"{n / tot:.1%}")
             for k, n in enumerate(pop)],
            headers=("bin", "particles", "share")))
        saved = b.get("saved_factor")
        lines.append(render_table([
            ("particle updates", b["updates"]),
            ("global-dt equivalent", b["updates_full"]),
            ("updates saved", "-" if saved is None else f"{saved:.2f}x"),
            ("resorts / keeps", f"{b['resorts']} / {b['keeps']}"),
        ]))
    ext = [r for r in s.get("extrema", []) if r.get("it") is not None]
    if ext:
        lines.append("extrema timeline (per checked step / window):")
        show = ext if len(ext) <= 12 else ext[:3] + ext[-9:]
        rows = [(r["it"], _fmt_g(r.get("rho_min"), "{:.4g}"),
                 _fmt_g(r.get("rho_max"), "{:.4g}"),
                 _fmt_g(r.get("h_min"), "{:.4g}"),
                 _fmt_g(r.get("h_max"), "{:.4g}"),
                 _fmt_g(r.get("du_max"), "{:.4g}"),
                 _fmt_g(r.get("nc_clip"), "{}"),
                 _fmt_g(r.get("h_sat"), "{}"))
                for r in show]
        lines.append(render_table(
            rows, headers=("it", "rho min", "rho max", "h min", "h max",
                           "|du| max", "nc clip", "h sat")))
        if len(ext) > 12:
            lines.append(f"  ({len(ext) - 12} middle windows elided)")
    lines.extend(_render_crash(s.get("crash")))
    for p in s["schema_problems"]:
        lines.append(f"  schema: {p}")
    return "\n".join(lines)


def render_diff(d: Dict) -> str:
    lines = [f"baseline:  {d['baseline']}",
             f"candidate: {d['candidate']}",
             f"threshold: {d['threshold'] * 100:.1f}%"]
    rows = []
    for r in d["rows"]:
        mark = "REGRESSED" if r["regressed"] else (
            "*" if r["headline"] else "")
        rows.append((r["metric"], f"{r['baseline']:.6g}",
                     f"{r['candidate']:.6g}",
                     f"{r['change'] * 100:+.1f}%", mark))
    lines.append(render_table(
        rows, headers=("metric", "baseline", "candidate", "change", "")))
    lines.append("regression detected" if d["regressed"]
                 else "within threshold")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# tuning view (schema v5: the autotuning evidence trail)
# ---------------------------------------------------------------------------


def summarize_tuning_run(run_dir: str) -> Dict:
    """The tuning story of one run dir: the manifest's top-level
    ``tuning`` stamp (what the Simulation resolved and why — the app
    passes it via write_manifest's ``extra``, which splats into the
    manifest root) plus the ``tuning`` decision events and the
    ``sweep`` candidates, if this dir is a sphexa-tune sweep."""
    manifest = read_manifest(run_dir)
    events, problems = load_events(run_dir)
    decisions = [e for e in events if e.get("kind") == "tuning"]
    sweeps = [e for e in events if e.get("kind") == "sweep"]
    stamp = (manifest or {}).get("tuning")
    by_status = Counter(e.get("status") for e in sweeps)
    ok = [e for e in sweeps
          if e.get("status") == "ok"
          and isinstance(e.get("value"), (int, float))]
    return {
        "run_dir": run_dir,
        "manifest_tuning": stamp,
        "decisions": decisions,
        "sweep_candidates": len(sweeps),
        "sweep_by_status": dict(by_status),
        "sweep_best": min(ok, key=lambda e: e["value"]) if ok else None,
        "schema_problems": problems,
    }


def render_tuning_run(s: Dict) -> str:
    lines = [f"tuning view: {s['run_dir']}"]
    stamp = s["manifest_tuning"]
    if stamp:
        lines.append(f"  active source: {stamp.get('source')}")
        if stamp.get("key"):
            k = stamp["key"]
            lines.append(f"  table entry:   {k.get('workload')} / "
                         f"{k.get('n_bucket')} / P={k.get('p')} / "
                         f"{k.get('backend')}")
        if stamp.get("knobs"):
            lines.append("  knobs:         " + ", ".join(
                f"{k}={v}" for k, v in sorted(stamp["knobs"].items())))
        if stamp.get("explicit"):
            lines.append("  explicit:      "
                         + ", ".join(stamp["explicit"]))
        prov = stamp.get("entry_provenance")
        if prov:
            lines.append(f"  provenance:    run={prov.get('source_run')} "
                         f"created={prov.get('created')} "
                         f"objective={prov.get('objective')} "
                         f"win={prov.get('win')}")
    for d in s["decisions"]:
        ctx = " ".join(f"{k}={v}" for k, v in d.items()
                       if k not in ("v", "seq", "t", "kind"))
        lines.append(f"  decision: {ctx}")
    if s["sweep_candidates"]:
        lines.append(f"  sweep: {s['sweep_candidates']} candidates "
                     + " ".join(f"{k}={v}" for k, v in
                                sorted(s["sweep_by_status"].items())))
        best = s["sweep_best"]
        if best:
            lines.append(f"  sweep best: {best.get('knobs')} -> "
                         f"{best.get('value')} ({best.get('objective')})")
    if not stamp and not s["decisions"] and not s["sweep_candidates"]:
        lines.append("  no tuning telemetry (run predates --tuned, or "
                     "heuristics-only)")
    return "\n".join(lines)


def _tuning_table_cmd(path: str, require: Optional[str],
                      fmt: str) -> int:
    """Validate + render a table file against the port's registry. The
    tuning package is imported here, in this branch only: its import
    validates the knob registry against the live configs (drift = exit 1,
    as a stale knob)."""
    try:
        from sphexa_torch.tuning import coverage, resolve_entry, \
            validate_table
        from sphexa_torch.tuning.table import load_table
    except RuntimeError as e:
        print(f"sphexa-torch-telemetry: {e}", file=sys.stderr)
        return 1
    try:
        table = load_table(path)
    except FileNotFoundError:
        raise TelemetryError(f"no such table: {path}")
    except ValueError as e:
        raise TelemetryError(str(e))
    problems = validate_table(table)
    out = {"table": path, "entries": len(table.get("entries", [])),
           "problems": problems, "coverage": coverage(table)}
    gap = None
    if require:
        parts = require.split(",")
        if len(parts) != 4:
            raise TelemetryError(
                f"--require wants workload,n,p,backend, got {require!r}")
        w, n, p, b = parts
        try:
            # float() first so the natural "1e6" spelling works
            n_i, p_i = int(float(n)), int(p)
        except ValueError:
            raise TelemetryError(
                f"--require wants numeric n and p, got {require!r}")
        entry = resolve_entry(table, w, n_i, p_i, b)
        gap = entry is None
        out["require"] = {"workload": w, "n": n_i, "p": p_i,
                          "backend": b, "covered": not gap}
    if fmt == "json":
        print(json.dumps(out, indent=2))
    else:
        print(f"tuning table: {path} ({out['entries']} entries)")
        for key, cov in out["coverage"].items():
            print(f"  {key}: N {','.join(map(str, cov['n_buckets']))} "
                  f"P {','.join(map(str, cov['p']))}")
        for prob in problems:
            print(f"  PROBLEM: {prob}")
        if require:
            print(f"  require {require}: "
                  f"{'covered' if not gap else 'COVERAGE GAP'}")
    return 1 if (problems or gap) else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphexa-torch-telemetry",
        description="summarize / diff the PyTorch/CUDA port's telemetry runs",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summary", help="summarize one run directory")
    ps.add_argument("run_dir")
    ps.add_argument("--format", choices=("text", "json"), default="text")
    ps.add_argument("--strict", action="store_true",
                    help="exit 1 on any schema-invalid event or unknown "
                         "event kind")
    ph = sub.add_parser(
        "shards", help="per-shard load/comm/HBM view of a multi-chip run")
    ph.add_argument("run_dir")
    ph.add_argument("--format", choices=("text", "json"), default="text")
    pc = sub.add_parser(
        "science",
        help="conservation/numerics view of a run (drift table + rate, "
             "dt-limiter histogram, extrema timeline, watchdog hits)")
    pc.add_argument("run_dir")
    pc.add_argument("--format", choices=("text", "json"), default="text")
    pc.add_argument("--budget", type=float, default=None,
                    help="exit 1 if max |etot-etot0|/|etot0| exceeds "
                         "this relative budget; without it, exit 1 when "
                         "a drift/field-health watchdog fired in-run")
    pd = sub.add_parser("diff", help="diff candidate against baseline")
    pd.add_argument("baseline", help="run dir or bench JSON")
    pd.add_argument("candidate", help="run dir or bench JSON")
    pd.add_argument("--threshold", type=float, default=0.10,
                    help="relative headline-regression threshold [0.10]")
    pd.add_argument("--drift", action="store_true",
                    help="run-vs-run: make energy drift a headline "
                         "metric (conservation regression gate)")
    pd.add_argument("--format", choices=("text", "json"), default="text")
    pt = sub.add_parser(
        "trace",
        help="per-phase device-time attribution of a --trace-dir "
             "torch.profiler capture (the sphexa/<phase> ranges)")
    pt.add_argument("trace_dir")
    pt.add_argument("--format", choices=("text", "json"), default="text")
    pt.add_argument("--min-coverage", type=float, default=None,
                    dest="min_coverage",
                    help="exit 1 when less than this fraction of "
                         "device-op time is attributed to sphexa/ "
                         "phases (the chip-harvest gate)")
    pt.add_argument("--top", type=int, default=8,
                    help="unattributed ops to list [8]")
    ph2 = sub.add_parser(
        "history",
        help="cross-run trend over the bench JSONs and run dirs named")
    ph2.add_argument("inputs", nargs="*",
                     help="bench JSONs / run dirs (required: the repo's "
                          "committed rounds are the JAX package's)")
    ph2.add_argument("--format", choices=("text", "json"), default="text")
    pr = sub.add_parser(
        "regress",
        help="gate the committed lock file: exit 1 when any locked, "
             "chip-measured metric regressed (or cannot be read)")
    pr.add_argument("candidate", nargs="?", default=None,
                    help="optional fresh bench JSON to check EVERY "
                         "locked metric against (pre-commit gate of a "
                         "new measurement); default: each metric's "
                         "committed source file")
    pr.add_argument("--lock", required=True,
                    help="lock file")
    pr.add_argument("--root", default=None,
                    help="base dir for the lock's source files "
                         "[the lock file's directory]")
    pr.add_argument("--write", action="store_true",
                    help="re-read every source and overwrite the locked "
                         "values (the harvest-day locking step)")
    pr.add_argument("--format", choices=("text", "json"), default="text")
    pn = sub.add_parser(
        "tuning",
        help="autotuning view: a run dir's active knobs + provenance, "
             "or a tuning table's validity + coverage (the port's registry)")
    pn.add_argument("target", help="run dir or tuning-table JSON file")
    pn.add_argument("--require", default=None,
                    help="workload,n,p,backend — exit 1 when the table "
                         "has no entry covering it (coverage-gap gate)")
    pn.add_argument("--format", choices=("text", "json"), default="text")
    pv = sub.add_parser(
        "serve",
        help="fleet dashboard: self-contained auto-refreshing HTML over "
             "one run dir or a glob of them (telemetry/serve.py)")
    pv.add_argument("target", help="run dir, fleet root, or glob")
    pv.add_argument("--out", default=None,
                    help="HTML output path [sphexa-dashboard.html]")
    pv.add_argument("--port", type=int, default=None,
                    help="serve live via http.server instead of writing "
                         "a file")
    pv.add_argument("--refresh", type=float, default=5.0,
                    help="page auto-refresh / rewrite interval in "
                         "seconds [5]")
    pv.add_argument("--once", action="store_true",
                    help="render one page and exit (the CI shape)")
    pf = sub.add_parser(
        "fleet",
        help="text aggregation table over a glob of run dirs")
    pf.add_argument("target", help="run dir, fleet root, or glob")
    pf.add_argument("--format", choices=("text", "json"), default="text")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "summary":
            s = summarize_run(args.run_dir)
            print(json.dumps(s, indent=2) if args.format == "json"
                  else render_summary(s))
            return 1 if (args.strict and (s["schema_problems"]
                                          or s["unknown_kinds"])) else 0
        if args.cmd == "shards":
            s = summarize_shards(args.run_dir)
            print(json.dumps(s, indent=2) if args.format == "json"
                  else render_shards(s))
            # a mesh smoke asserting the instrumentation fired needs a
            # distinct exit code for "run exists but no shard telemetry"
            return 0 if s["shards"] else 1
        if args.cmd == "science":
            s = summarize_science(args.run_dir)
            print(json.dumps(s, indent=2) if args.format == "json"
                  else render_science(s))
            if not s["physics_events"]:
                return 1  # no ledger: the smoke must notice broken wiring
            if args.budget is not None:
                dmax = (s.get("drift") or {}).get("max")
                return 1 if dmax is None or dmax > args.budget else 0
            return 1 if (s["drift_events"]
                         or s["field_health_events"]) else 0
        if args.cmd == "trace":
            from sphexa_torch.telemetry.traceview import (
                render_trace,
                summarize_trace,
            )

            s = summarize_trace(args.trace_dir, top=args.top)
            print(json.dumps(s, indent=2) if args.format == "json"
                  else render_trace(s))
            if not s["phases"]:
                return 1  # an unattributed capture must not pass green
            if args.min_coverage is not None \
                    and s["coverage"] < args.min_coverage:
                print(f"sphexa-torch-telemetry: coverage {s['coverage']:.1%} "
                      f"below --min-coverage {args.min_coverage:.1%}",
                      file=sys.stderr)
                return 1
            return 0
        if args.cmd == "history":
            from sphexa_torch.telemetry.history import (
                load_history,
                render_history,
            )

            if not args.inputs:
                raise TelemetryError(
                    "history needs inputs (bench JSONs / run dirs): the repo's "
                    "committed BENCH_r*/MULTICHIP_r* rounds are the JAX "
                    "package's TPU measurements, not the port's")
            rows = load_history(args.inputs)
            print(json.dumps(rows, indent=2) if args.format == "json"
                  else render_history(rows))
            return 0 if rows else 1
        if args.cmd == "regress":
            from sphexa_torch.telemetry.history import (
                evaluate_lock,
                load_lock,
                render_regress,
                write_lock,
            )

            lock = load_lock(args.lock)
            root = args.root if args.root is not None \
                else (os.path.dirname(os.path.abspath(args.lock)) or ".")
            if args.write:
                if args.candidate:
                    # --write re-reads the COMMITTED sources; accepting a
                    # candidate here would silently relock stale numbers
                    # while the user believes the fresh file was locked
                    raise TelemetryError(
                        "--write relocks from the committed sources and "
                        "ignores a candidate: gate the fresh file first "
                        "(regress --lock L <candidate>), commit it, point "
                        "the lock's sources at it, then --write")
                lock = write_lock(args.lock, lock, root)
                print(f"locked {len(lock['metrics'])} metrics -> "
                      f"{args.lock}")
                return 0
            res = evaluate_lock(lock, root, candidate=args.candidate)
            print(json.dumps(res, indent=2) if args.format == "json"
                  else render_regress(res))
            return 1 if res["regressed"] else 0
        if args.cmd == "serve":
            from sphexa_torch.telemetry.serve import serve_cmd

            return serve_cmd(args.target, out=args.out, port=args.port,
                             refresh=args.refresh, once=args.once)
        if args.cmd == "fleet":
            from sphexa_torch.telemetry.serve import fleet_cmd

            return fleet_cmd(args.target, fmt=args.format)
        if args.cmd == "tuning":
            if os.path.isdir(args.target):
                if args.require:
                    raise TelemetryError(
                        "--require applies to a table file, not a run dir")
                s = summarize_tuning_run(args.target)
                print(json.dumps(s, indent=2) if args.format == "json"
                      else render_tuning_run(s))
                return 0 if (s["manifest_tuning"] or s["decisions"]
                             or s["sweep_candidates"]) else 1
            return _tuning_table_cmd(args.target, args.require,
                                     args.format)
        d = diff_sides(load_side(args.baseline), load_side(args.candidate),
                       args.threshold, drift=args.drift)
        print(json.dumps(d, indent=2) if args.format == "json"
              else render_diff(d))
        return 1 if d["regressed"] else 0
    except (TelemetryError, TraceError, HistoryError) as e:
        print(f"sphexa-torch-telemetry: {e}", file=sys.stderr)
        return 2
    except (OSError, json.JSONDecodeError) as e:
        print(f"sphexa-torch-telemetry: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
