"""Per-phase attribution of a ``--trace-dir`` capture: the port's reader.

The step wraps its stages in ``sphexa/<phase>`` ranges (util/phases.py,
a ``torch.profiler.record_function`` while a profiler runs), and the CLI's
``--trace-dir`` exports a ``torch.profiler`` chrome trace per rank
(``rank<r>.pt.trace.json``). The JAX package's reader
(sphexa_tpu/telemetry/traceview.py) parses jax.profiler's xplane protos,
which a chrome trace is not; this one reads the chrome trace and returns
the same summary shape, so that ``phase_attr_digest`` and the
``phase_attr`` event are the JAX package's.

What counts as device time:

- on the card, every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event.
  A device event's phase is that of its launch: the CUDA runtime call
  with the same ``correlation`` id, inside the outermost ``sphexa/`` range
  open on the launching thread at that time. An event whose launch is not
  in the trace falls back to the ``gpu_user_annotation`` ranges the
  profiler lays on the device's own timeline;
- on the CPU (no device events in the trace), the top-level ``cpu_op``
  events of each thread, inside the outermost range open on that thread.

``coverage`` = attributed time / total time; the JAX package gates a
5-step Sedov capture at >= 0.8 of it (its traceview.py:426-428)."""

import bisect
import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: the phase of a range name: the first ``sphexa/<phase>`` segment
PHASE_RE = re.compile(r"sphexa/([A-Za-z0-9_.:+-]+)")

#: chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: chrome-trace categories of the host calls that launch it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class TraceError(Exception):
    """An unreadable or absent capture."""


def find_traces(trace_dir: str) -> List[str]:
    """The chrome traces of a capture: ``trace_dir`` itself when it is a
    file, else every ``*.json`` / ``*.json.gz`` under it."""
    if os.path.isfile(trace_dir):
        return [trace_dir]
    out = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
                 + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True))
    if not out:
        raise TraceError(f"no *.json trace under {trace_dir}: was the run started with "
                         f"--trace-dir?")
    return out


def load_events(path: str) -> List[dict]:
    """The complete ("X") events of one chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise TraceError(f"cannot read trace {path}: {e}") from e
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def _phase_of(name: Optional[str]) -> Optional[str]:
    m = PHASE_RE.search(name or "")
    return m.group(1) if m else None


def _outermost(intervals: List[Tuple[float, float, str]]):
    """The intervals no other one encloses, sorted: (starts, ends, tags)."""
    starts, ends, tags = [], [], []
    for t0, t1, tag in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if ends and t0 < ends[-1]:
            continue  # nested in the last kept one
        starts.append(t0)
        ends.append(t1)
        tags.append(tag)
    return starts, ends, tags


class _Ranges:
    """Outermost ``sphexa/`` ranges per (pid, tid), looked up by time."""

    def __init__(self, events: List[dict]):
        per = defaultdict(list)
        for e in events:
            phase = _phase_of(e.get("name"))
            if phase is not None:
                t0 = float(e.get("ts", 0.0))
                per[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e.get("dur", 0.0)),
                                                          phase))
        self._per = {k: _outermost(v) for k, v in per.items()}

    def at(self, pid, tid, ts: float) -> Optional[str]:
        r = self._per.get((pid, tid))
        if r is None:
            return None
        starts, ends, tags = r
        i = bisect.bisect_right(starts, ts) - 1
        return tags[i] if i >= 0 and ts < ends[i] else None


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def summarize_trace(trace_dir: str, top: int = 8) -> Dict:
    """Aggregate one capture (a directory of chrome traces, or one trace
    file) into the per-phase attribution summary: ``phases`` (phase, us,
    share, ops, events; by time), ``coverage``, ``total_device_us``,
    ``attributed_us``, ``device`` ("cuda" or "cpu": what was counted) and
    the ``top`` unattributed ops."""
    traces = find_traces(trace_dir)
    events: List[dict] = []
    for t in traces:
        events.extend(load_events(t))
    host = _Ranges([e for e in events if _cat(e) == "user_annotation"])
    device_events = [e for e in events if _cat(e) in DEVICE_CATS]
    work: List[Tuple[dict, Optional[str]]] = []
    if device_events:
        launches = {}
        for e in events:
            if _cat(e) in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        gpu = _Ranges([e for e in events if _cat(e) == "gpu_user_annotation"])
        for e in device_events:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            phase = None
            if launch is not None:
                phase = host.at(launch.get("pid"), launch.get("tid"), float(launch["ts"]))
            if phase is None:
                phase = gpu.at(e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
            work.append((e, phase))
        device = "cuda"
    else:
        per = defaultdict(list)
        for e in events:
            if _cat(e) == "cpu_op":
                t0 = float(e.get("ts", 0.0))
                per[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e.get("dur", 0.0)),
                                                          e))
        for (pid, tid), ivs in per.items():
            for t0, _t1, e in zip(*_outermost(ivs)):
                work.append((e, host.at(pid, tid, t0)))
        device = "cpu"

    phase_us: Dict[str, float] = defaultdict(float)
    phase_events: Dict[str, int] = defaultdict(int)
    phase_ops: Dict[str, set] = defaultdict(set)
    unattr_us: Dict[str, float] = defaultdict(float)
    total_us = 0.0
    for e, phase in work:
        dur = float(e.get("dur", 0.0))
        total_us += dur
        if phase is None:
            unattr_us[str(e.get("name"))] += dur
            continue
        phase_us[phase] += dur
        phase_events[phase] += 1
        phase_ops[phase].add(str(e.get("name")))
    attributed = sum(phase_us.values())
    phases = [{"phase": p, "us": round(us, 3), "share": us / total_us if total_us else 0.0,
               "ops": len(phase_ops[p]), "events": phase_events[p]}
              for p, us in sorted(phase_us.items(), key=lambda kv: -kv[1])]
    unattributed = [{"module": device, "op": op, "us": round(us, 3),
                     "share": us / total_us if total_us else 0.0}
                    for op, us in sorted(unattr_us.items(), key=lambda kv: -kv[1])[:top]]
    return {
        "trace_dir": trace_dir,
        "trace_files": [os.path.basename(t) for t in traces],
        "device": device,
        "device_op_events": len(work),
        "total_device_us": round(total_us, 3),
        "attributed_us": round(attributed, 3),
        "coverage": attributed / total_us if total_us else 0.0,
        "phases": phases,
        "unattributed_top": unattributed,
    }


def phase_attr_digest(summary: Dict) -> Dict:
    """The compact digest the ``phase_attr`` event carries (the JAX
    package's shape): {phase: us}, coverage and total device time."""
    return {
        "phases": {p["phase"]: round(p["us"], 1) for p in summary["phases"]},
        "coverage": round(summary["coverage"], 4),
        "total_device_us": summary["total_device_us"],
    }


def render_trace(s: Dict) -> str:
    """The text view of ``summarize_trace``'s summary (the ``trace``
    subcommand): the phases' device time and share, the coverage, and the
    top unattributed ops."""
    from sphexa_torch.telemetry.tables import render_table

    lines = [f"trace: {s['trace_dir']}"]
    lines.append(
        f"  {s['device_op_events']} {s['device']} op events, "
        f"{s['total_device_us'] / 1e3:.3f} ms op time, "
        f"{len(s['trace_files'])} chrome trace(s)")
    if not s["phases"]:
        lines.append("  no sphexa/ phases found: was the capture taken with "
                     "--trace-dir (the step's phase ranges open only under a "
                     "profiler)?")
        return "\n".join(lines)
    rows = [(p["phase"], f"{p['us'] / 1e3:.3f} ms", f"{p['share']:.1%}",
             p["ops"], p["events"]) for p in s["phases"]]
    lines.append(render_table(
        rows, headers=("phase", "device time", "share", "ops", "events")))
    lines.append(f"attributed: {s['attributed_us'] / 1e3:.3f} ms "
                 f"({s['coverage']:.1%} of op time)")
    if s["unattributed_top"]:
        lines.append("top unattributed ops:")
        rows = [(u["module"], u["op"], f"{u['us'] / 1e3:.3f} ms",
                 f"{u['share']:.1%}") for u in s["unattributed_top"]]
        lines.append(render_table(rows))
    return "\n".join(lines)
