"""The metrics registry: counters, gauges, phase timings, typed events
(sphexa_tpu/telemetry/registry.py).

One ``Telemetry`` instance is shared by everything that measures a run:
the Simulation driver and the app loop. Host-side only: nothing here
touches a tensor. Callers hand in host scalars; the deferred window's
one-read contract lives in the callers (Simulation.step/flush).

The event schema (version, kinds and their required fields) is the JAX
package's, copied whole, so that the port's ``events.jsonl`` validates
under the same rules (``sphexa-telemetry summary --strict``).
"""

import contextlib
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sphexa_torch.util.phases import profiling

#: events.jsonl schema version; bump on any incompatible field change and
#: document the migration in docs/OBSERVABILITY.md. v2 added the
#: distributed kinds (exchange / shard_load / memory / imbalance), v3
#: the physics-observability kinds (physics / numerics / drift /
#: field_health), v4 the time-and-history kinds (phase_attr / crash),
#: v5 the autotuning kinds (sweep / tuning), v6 the block-timestep kind
#: (dt_bins); v7 the optional ``stage`` payload ("sph" | "gravity") on
#: the exchange / shard_load kinds — the gravity near field's MAC-sized
#: sparse serve emits its own exchange record next to the SPH one (no
#: new kinds and no new REQUIRED fields); v8 the live-science-surface
#: kind (snapshot) — in-graph field-grid frames riding the flush
#: boundary (observables/snapshot.py), rendered by ``sphexa-telemetry
#: serve``. v8 only ADDS a kind, so v8 readers accept v1-v7 files
#: strictly clean and v7 readers count ``snapshot`` under unknown_kinds.
SCHEMA_VERSION = 8

#: event schema versions this reader understands (older versions only
#: ever ADD kinds, so the per-kind field table below covers them all)
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8)

#: every event kind the schema admits, with its required payload fields
#: (beyond the envelope ``v``/``seq``/``t``/``kind``). The CLI's --strict
#: validation enforces exactly this table.
EVENT_KINDS: Dict[str, tuple] = {
    "launch": ("it",),            # one deferred-window step dispatched
    "step": ("it", "wall_s"),     # one synchronously checked step done
    "window": ("it", "steps", "wall_s", "per_step_s"),  # deferred flush
    "reconfigure": ("it", "reason"),
    "rollback": ("it", "steps", "reason"),
    "replay": ("it", "steps"),
    "retrace": ("it", "delta"),   # jit cache grew on a launch (recompile)
    "rebuild_lists": ("it",),
    "phases": ("it",),            # per-iteration host phase laps
    "trace": ("dir",),            # profiler trace started
    "run_end": (),
    "note": (),
    # -- v2: distributed kinds (one run, P shards) ------------------------
    # per-window halo-exchange record: ``rows`` = per-shard TRUE candidate
    # need (device-measured), ``shipped_rows`` = the static sized volume
    # actually moved per serve (sum(hmax) sparse / (P-1)*Wmax windowed)
    "exchange": ("it", "shipped_rows", "rows"),
    # per-window load record: per-shard particle counts + work proxies
    "shard_load": ("it", "particles"),
    # per-device HBM snapshot at a named point (manifest / post-compile /
    # flush); bytes lists are empty on backends without memory_stats()
    "memory": ("point",),
    # imbalance watchdog: max/mean of a per-shard metric crossed the
    # configured ratio (the runtime analog of the retrace watchdog)
    "imbalance": ("it", "metric", "ratio", "threshold"),
    # -- v3: physics-observability kinds (the in-graph science ledger) ----
    # per-window conservation record: parallel per-step lists (``its``,
    # ``t``, ``dt``, ``etot``/``ecin``/``eint``/``egrav``, ``linmom``,
    # ``angmom``, optional ``extra``) — every step keeps its row even
    # under deferred checking
    "physics": ("it", "etot"),
    # per-window numerics health: dt-limiter histogram, neighbor-cap
    # clip / h-saturation counts, nonfinite counts, field extrema
    "numerics": ("it",),
    # conservation-drift watchdog: |etot - etot0|/|etot0| crossed the
    # configured budget (Simulation(drift_budget=...) / --drift-budget)
    "drift": ("it", "drift", "budget"),
    # field-health watchdog: nonfinite rho/h/du values appeared in a
    # verified step (localize with --debug-checks)
    "field_health": ("it", "nonfinite"),
    # -- v4: time-and-history kinds (profiler attribution + crash) --------
    # per-phase device-time attribution of a --trace-dir capture
    # (the JAX package's telemetry/traceview.py): ``phases`` =
    # {"<phase>": device_us}, plus coverage/total_device_us/dir context
    "phase_attr": ("phases",),
    # crash flight recorder (telemetry/flightrec.py): appended by the
    # abnormal-exit hooks alongside blackbox.json so the event stream
    # itself records WHY it ends mid-run
    "crash": ("reason",),
    # -- v5: autotuning kinds (the JAX package's tuning/) ------------------------
    # one sweep candidate measured by the replay harness: the knob dict
    # tried, its status ("ok" / "overflow" / "failed"), and on success
    # the objective name + value (per_step_s, or phase:<name> device us)
    "sweep": ("candidate", "knobs", "status"),
    # one tuning decision: where the active knobs came from ("table" /
    # "heuristic" / "explicit"), plus key/knobs/provenance context —
    # also emitted by gravity_tuning when N sits within 10% of its
    # step-function threshold (the near-cliff attribution note)
    "tuning": ("source",),
    # -- v6: block-timestep kind (sph/blockdt.py) -------------------------
    # per-window hierarchical block-dt record: ``pop`` = the (dt_bins,)
    # bin-occupancy histogram at the window's last substep, ``updates``/
    # ``updates_full`` = particle updates performed vs the global-dt cost
    # of the same substeps (the chip-free complexity proxy, docs/NEXT.md),
    # plus the drift-aware resort decision counters (resorts/keeps) and
    # the worst observed key-drift inversion count (drift_max)
    "dt_bins": ("it", "pop", "updates", "updates_full"),
    # -- v8: live-science-surface kind (observables/snapshot.py) ----------
    # one in-graph snapshot frame fetched at the check/flush boundary:
    # grid meta + per-field extrema inline (``fields``/``grid``/``axis``/
    # ``reduce``/``vmin``/``vmax``), pixels in the sidecar ``snapshots/``
    # .npz ring with ``path`` as the pointer (null when no ring dir is
    # configured) — rendered by ``sphexa-telemetry serve``
    "snapshot": ("it", "fields", "grid"),
}

#: first schema version each kind appeared in (an older-versioned event
#: carrying a newer kind is writer confusion, not forward compatibility)
_V2_ONLY = frozenset({"exchange", "shard_load", "memory", "imbalance"})
_V3_ONLY = frozenset({"physics", "numerics", "drift", "field_health"})
_V4_ONLY = frozenset({"phase_attr", "crash"})
_V5_ONLY = frozenset({"sweep", "tuning"})
_V6_ONLY = frozenset({"dt_bins"})
_V8_ONLY = frozenset({"snapshot"})
KIND_SINCE: Dict[str, int] = {
    k: 8 if k in _V8_ONLY else 6 if k in _V6_ONLY else 5 if k in _V5_ONLY
    else 4 if k in _V4_ONLY else 3 if k in _V3_ONLY
    else 2 if k in _V2_ONLY else 1
    for k in EVENT_KINDS
}

#: kinds that already existed in schema v1 (kept for introspection)
V1_KINDS = frozenset(k for k, v in KIND_SINCE.items() if v == 1)


def _jsonable(v):
    """Coerce numpy scalars/arrays so sinks can json.dumps payloads
    directly (per-shard metrics arrive as small (P,) arrays)."""
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def validate_event(e: dict) -> List[str]:
    """Schema problems with one event dict ([] = valid). Any supported
    version validates (v3 readers accept v1/v2 files). An UNKNOWN kind
    is deliberately NOT a problem here — unknownness is the
    forward-compat dimension the reader reports separately (summary's
    ``unknown_kinds`` counts, strict exit code), and flagging it twice
    would render every future-schema event as schema-invalid noise. A
    newer-only kind claiming an older ``v`` IS a problem (writer
    confusion, not forward compat)."""
    problems = []
    if not isinstance(e, dict):
        return ["event is not an object"]
    if e.get("v") not in SUPPORTED_VERSIONS:
        problems.append(f"bad schema version {e.get('v')!r}")
    kind = e.get("kind")
    if kind in EVENT_KINDS:
        since = KIND_SINCE[kind]
        if e.get("v") in SUPPORTED_VERSIONS and e["v"] < since:
            problems.append(
                f"v{since}-only kind {kind!r} on a v{e['v']} event")
        else:
            for field in EVENT_KINDS[kind]:
                if field not in e:
                    problems.append(f"{kind} event missing field {field!r}")
    for field in ("seq", "t"):
        if not isinstance(e.get(field), (int, float)):
            problems.append(f"missing/non-numeric envelope field {field!r}")
    return problems


class Telemetry:
    """Counters + gauges + phase timings + an event stream over sinks.

    With no sinks the registry still keeps its counters; ``event()``
    then costs one Counter bump — cheap enough for the hot loop.
    """

    def __init__(self, sinks=()):
        self.sinks = list(sinks)
        self.counters: Counter = Counter()
        self.gauges: Dict[str, float] = {}
        self.phase_totals: Dict[str, float] = defaultdict(float)
        self.phase_counts: Counter = Counter()
        self._seq = 0

    # -- scalar metrics ----------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def timing(self, name: str, seconds: float) -> None:
        """Accumulate one lap of a named phase (mean via timing_mean)."""
        self.phase_totals[name] += float(seconds)
        self.phase_counts[name] += 1

    def timing_mean(self, name: str) -> float:
        n = self.phase_counts[name]
        return self.phase_totals[name] / n if n else float("nan")

    # -- event stream ------------------------------------------------------
    def event(self, kind: str, **payload) -> None:
        """Emit one typed event to every sink (and count it regardless)."""
        self.counters[f"events.{kind}"] += 1
        if not self.sinks:
            return
        e = {
            "v": SCHEMA_VERSION,
            "seq": self._seq,
            "t": round(time.time(), 6),
            "kind": kind,
            **{k: _jsonable(v) for k, v in payload.items()},
        }
        self._seq += 1
        for s in self.sinks:
            s.emit(e)

    def phases(self, it: int, laps: Dict[str, float]) -> None:
        """Per-iteration host phase laps (the Timer's pop) as one event;
        each lap also feeds the registry's phase accumulators."""
        for k, v in laps.items():
            self.timing(k, v)
        self.event("phases", it=int(it), **{k: round(float(v), 6) for k, v in laps.items()})

    # -- profiler hooks ----------------------------------------------------
    def annotate(self, name: str):
        """Named scope for torch.profiler traces (``record_function``)
        around launch/flush/reconfigure/rebuild while a profiler runs; a
        no-op context otherwise (a record_function costs about 10 us)."""
        if profiling():
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # -- console routing ---------------------------------------------------
    def console_printer(self, fallback: Callable = print) -> Callable:
        """The first console sink's line writer, else ``fallback`` —
        Simulation.run routes its per-iteration report through this."""
        for s in self.sinks:
            w = getattr(s, "write_line", None)
            if w is not None:
                return w
        return fallback

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# ---------------------------------------------------------------------------
# lap timing and the per-iteration series (util/timer.py's implementations,
# on the registry so that every consumer shares one accumulation)
# ---------------------------------------------------------------------------


class LapTimer:
    """Accumulates named wall-clock laps within one iteration
    (timer.hpp:46 semantics); each lap also feeds ``telemetry.timing``."""

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry
        self.laps: Dict[str, float] = {}
        self._t = time.perf_counter()

    def start(self) -> None:
        self._t = time.perf_counter()

    def lap(self, name: str) -> float:
        """Record the time since the last mark under ``name``."""
        now = time.perf_counter()
        elapsed = now - self._t
        self.laps[name] = self.laps.get(name, 0.0) + elapsed
        self._t = now
        if self.telemetry is not None:
            self.telemetry.timing(name, elapsed)
        return elapsed

    # the reference's name (util/timer.hpp's Timer::step)
    step = lap

    def pop(self) -> Dict[str, float]:
        out = self.laps
        self.laps = {}
        return out


class StepSeries:
    """Per-iteration timing and metric rows, saved as an npz series
    (ipropagator.hpp:83-87 writes the analogous HDF5 series). With a
    registry attached, every row also goes out as a ``phases`` event."""

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry
        self.rows: List[Dict[str, float]] = []

    def record(self, iteration: int, laps: Dict[str, float], **metrics):
        self.rows.append({"iteration": float(iteration), **laps, **metrics})
        if self.telemetry is not None:
            self.telemetry.phases(iteration, {**laps, **metrics})

    def save(self, path: str, substeps=None) -> bool:
        """Write the series (and a one-shot substep breakdown as
        ``substep_<name>`` scalars). Returns whether a file was written:
        with no rows and no substeps nothing is."""
        if not self.rows and not substeps:
            return False
        keys = sorted({k for row in self.rows for k in row})
        # a metric recorded on some iterations only is NaN-padded, so that
        # every column is one dense array
        arrays = {k: np.array([row.get(k, np.nan) for row in self.rows]) for k in keys}
        for k, v in (substeps or {}).items():
            arrays[f"substep_{k}"] = np.float64(v)
        np.savez(path, **arrays)
        return True

    def summary(self) -> Dict[str, float]:
        """Mean seconds per iteration of each recorded phase."""
        if not self.rows:
            return {}
        keys = {k for row in self.rows for k in row} - {"iteration"}
        return {k: float(np.nanmean([row.get(k, np.nan) for row in self.rows]))
                for k in sorted(keys)}
