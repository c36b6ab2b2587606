"""The traced stretch of a ``--trace 1`` run: a torch.profiler capture of
whole steps, and its reduction to what the per-layer metrics read.

Device time is attributed as the port's own reader attributes it
(sphexa_torch/telemetry/traceview.py, copied here): a kernel, copy or
fill belongs to the phase of its launch, the outermost ``sphexa/<phase>``
range open on the launching thread at the launch (matched through the
``correlation`` id), else the ``gpu_user_annotation`` range around it on
the device's own timeline. The harness adds its own spans: ``bench/step``
around each ``Simulation.step()`` and ``bench/ledger`` around the ledger's
drain. A device event's step is the ``bench/step`` open at its launch."""

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PHASE_RE = re.compile(r"sphexa/([A-Za-z0-9_.:+-]+)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_SPAN = "bench/step"


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def _phase_of(name: Optional[str]) -> Optional[str]:
    m = PHASE_RE.search(name or "")
    return m.group(1) if m else None


def _outermost(intervals):
    """The intervals no other one encloses, sorted: (starts, ends, tags)."""
    starts, ends, tags = [], [], []
    for t0, t1, tag in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if ends and t0 < ends[-1]:
            continue
        starts.append(t0)
        ends.append(t1)
        tags.append(tag)
    return starts, ends, tags


class _Ranges:
    """Outermost ranges per (pid, tid) whose tag ``key(name)`` gives, by time."""

    def __init__(self, events: List[dict], key):
        per = defaultdict(list)
        for e in events:
            tag = key(e.get("name"))
            if tag is not None:
                t0 = float(e.get("ts", 0.0))
                per[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e.get("dur", 0.0)), tag))
        self._per = {k: _outermost(v) for k, v in per.items()}

    def at(self, pid, tid, ts: float):
        r = self._per.get((pid, tid))
        if r is None:
            return None
        starts, ends, tags = r
        i = bisect.bisect_right(starts, ts) - 1
        return tags[i] if i >= 0 and ts < ends[i] else None


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the merged intervals) of ``intervals``."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def _innermost_host(spans, starts, ts: float) -> Optional[str]:
    """The innermost harness or port range open at ``ts`` on the host: of
    nested ranges, the one that started last and has not ended."""
    k = bisect.bisect_right(starts, ts) - 1
    stop = max(-1, k - 512)
    while k > stop:
        a, b, name = spans[k]
        if b > ts:
            return name
        k -= 1
    return None


def summarize(path: str) -> Dict:
    """The capture at ``path`` (a chrome trace) reduced: per phase the
    device us and events, per captured step (in order) its device us, the
    union of device time, the captured wall (first step's start to the
    last one's end), the device events, the attribution coverage, the
    device ops that took most time and the idle gaps named by what the
    host was doing when the device went idle."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    events = [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]
    host_ann = [e for e in events if _cat(e) == "user_annotation"]
    phases = _Ranges(host_ann, _phase_of)
    steps_r = _Ranges(host_ann, lambda n: n if n == STEP_SPAN else None)
    step_spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                        for e in host_ann if e.get("name") == STEP_SPAN)
    gpu = _Ranges([e for e in events if _cat(e) == "gpu_user_annotation"], _phase_of)
    launches = {}
    for e in events:
        if _cat(e) in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    dev = [e for e in events if _cat(e) in DEVICE_CATS]
    phase_us: Dict[str, float] = defaultdict(float)
    phase_ev: Dict[str, int] = defaultdict(int)
    step_us = [0.0] * len(step_spans)
    step_starts = [a for a, _ in step_spans]
    op_us: Dict[str, float] = defaultdict(float)
    total = attributed = 0.0
    for e in dev:
        dur = float(e.get("dur", 0.0))
        total += dur
        op_us[str(e.get("name"))] += dur
        launch = launches.get((e.get("args") or {}).get("correlation"))
        phase, lts = None, None
        if launch is not None:
            lts = float(launch["ts"])
            phase = phases.at(launch.get("pid"), launch.get("tid"), lts)
            if steps_r.at(launch.get("pid"), launch.get("tid"), lts) is not None:
                k = bisect.bisect_right(step_starts, lts) - 1
                if k >= 0:
                    step_us[k] += dur
        if phase is None:
            phase = gpu.at(e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
        if phase is not None:
            attributed += dur
            phase_us[phase] += dur
            phase_ev[phase] += 1
    if step_spans:
        w0, w1 = step_spans[0][0], step_spans[-1][1]
    else:
        w0 = w1 = 0.0
    in_window = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))
                 for e in dev]
    busy, merged = _union([iv for iv in in_window if iv[1] > iv[0]])
    # the idle gaps, each named by the innermost harness or port range the
    # host had open when the device went idle
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name")))
                   for e in host_ann if str(e.get("name", "")).startswith(("sphexa", "bench/")))
    starts = [s[0] for s in spans]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_innermost_host(spans, starts, a) or "host"] += b - a
    return {"phase_us": dict(phase_us), "phase_events": dict(phase_ev), "step_us": step_us,
            "steps": len(step_spans), "device_events": len(dev), "busy_us": busy,
            "window_us": w1 - w0, "coverage": attributed / total if total else 0.0,
            "total_device_us": total,
            "device_ops": sorted(op_us.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}

