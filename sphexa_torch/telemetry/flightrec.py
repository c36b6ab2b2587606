"""Crash flight recorder (sphexa_tpu/telemetry/flightrec.py): a bounded
in-memory event tail and abnormal-exit hooks that write ``blackbox.json``.

The recorder keeps the last K events in a ring buffer (one more sink on
the registry: no device access) and installs ``sys.excepthook``,
``atexit`` and SIGTERM-class signal handlers plus ``faulthandler``; on an
abnormal exit it writes ``<run-dir>/blackbox.json`` (reason, traceback,
the buffered event tail, watchdog counters, manifest) and appends one
``crash`` event to ``events.jsonl``, so that the JAX package's
``sphexa-telemetry summary`` explains a truncated run. A clean run never
writes a blackbox: ``close()`` disarms the hooks (the CLI calls it after
``run_end``), and so must every caller that installs one. A SIGKILL
leaves no window to run anything; ``faulthandler`` still covers hard
faults through ``fault.log``.
"""

import atexit
import datetime
import faulthandler
import json
import os
import signal
import sys
import time
import traceback
from collections import deque
from typing import Dict, Optional

from sphexa_torch.telemetry.registry import SCHEMA_VERSION

#: blackbox.json schema (independent of the event schema)
BLACKBOX_SCHEMA = 1

#: counters worth replaying in the blackbox: the watchdog/health state
#: at the moment of death (the question a crash report must answer
#: first: was the run already sick?)
WATCHDOG_COUNTERS = ("retraces", "rollbacks", "reconfigures", "halo_trips",
                     "imbalances", "drifts", "field_health")

#: signals that mean "this run is being terminated" (SIGKILL cannot be
#: caught; SIGINT raises KeyboardInterrupt and rides the excepthook)
_SIGNALS = ("SIGTERM", "SIGHUP", "SIGQUIT", "SIGABRT")


class RingSink:
    """Bounded event tail (newest last). A sink like any other — the
    registry emits fully-materialized dicts, so buffering K of them
    costs K small dicts and nothing else."""

    def __init__(self, capacity: int = 200):
        self.events = deque(maxlen=int(capacity))

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class FlightRecorder:
    """Owns the ring sink + the abnormal-exit hooks for one run dir.

    Usage (app/main.py wiring)::

        rec = FlightRecorder(run_dir, telemetry=tel, manifest=manifest)
        tel.sinks.append(rec.sink)
        rec.install()
        ...  # the run
        rec.close()   # clean exit: disarm, no blackbox
    """

    def __init__(self, run_dir: str, capacity: int = 200,
                 telemetry=None, manifest: Optional[Dict] = None):
        self.run_dir = run_dir
        self.sink = RingSink(capacity)
        self.telemetry = telemetry
        self.manifest = manifest
        self._installed = False
        self._closed = False
        self._dumped = False
        self._prev_excepthook = None
        self._prev_signals: Dict[int, object] = {}
        self._fault_file = None

    # -- hook management ---------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Arm excepthook + atexit + signal handlers + faulthandler.
        Idempotent; safe to call in processes that already hook signals
        (previous handlers are chained, not clobbered)."""
        if self._installed:
            return self
        self._installed = True
        os.makedirs(self.run_dir, exist_ok=True)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        atexit.register(self._on_atexit)
        for name in _SIGNALS:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                # a deliberately-ignored signal (nohup's SIGHUP) stays
                # ignored: hooking it would fabricate a crash record in
                # a run that then survives and finishes clean
                if signal.getsignal(sig) is signal.SIG_IGN:
                    continue
                self._prev_signals[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # non-main thread / exotic host
                continue
        try:
            self._fault_file = open(
                os.path.join(self.run_dir, "fault.log"), "w")
            faulthandler.enable(self._fault_file)
        except (OSError, ValueError):
            self._fault_file = None
        return self

    def close(self) -> None:
        """Clean shutdown: disarm every hook; no blackbox is written.
        An already-written blackbox (a caught signal the run survived)
        is left in place — it happened, the record stands."""
        self._closed = True
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        atexit.unregister(self._on_atexit)
        for sig, prev in self._prev_signals.items():
            try:
                # None = the previous handler lived at the C level;
                # SIG_DFL is the closest restorable state
                signal.signal(sig, signal.SIG_DFL if prev is None else prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_signals.clear()
        if self._fault_file is not None:
            try:
                faulthandler.disable()
                self._fault_file.close()
                # nothing faulted: don't leave an empty fault.log in
                # every clean run dir
                path = os.path.join(self.run_dir, "fault.log")
                if os.path.exists(path) and os.path.getsize(path) == 0:
                    os.remove(path)
            except (OSError, ValueError):
                pass
            self._fault_file = None

    # -- hook bodies -------------------------------------------------------
    def _on_exception(self, exc_type, exc, tb) -> None:
        self.dump(
            reason=f"exception {exc_type.__name__}: {exc}",
            tb="".join(traceback.format_exception(exc_type, exc, tb)),
        )
        if self._prev_excepthook is not None:
            self._prev_excepthook(exc_type, exc, tb)

    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        stack = "".join(traceback.format_stack(frame)) if frame else ""
        self.dump(reason=f"signal {name} ({signum})", tb=stack)
        # restore + re-raise so the process dies with the conventional
        # 128+N status the caller (a job scheduler) keys on. A None
        # previous handler (installed at the C level — signal.signal
        # cannot restore it) maps to SIG_DFL: re-killing with OUR
        # handler still installed would loop forever
        prev = self._prev_signals.get(signum, signal.SIG_DFL)
        if prev is None:
            prev = signal.SIG_DFL
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError, TypeError):
            pass
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            os.kill(os.getpid(), signum)

    def _on_atexit(self) -> None:
        if not self._closed:
            # interpreter exiting without close(): sys.exit() from a
            # depth the run loop never unwound, or an exit path that
            # skipped the clean shutdown — record it
            self.dump(reason="abnormal-exit (no clean close before "
                             "interpreter shutdown)")

    # -- the dump ----------------------------------------------------------
    def dump(self, reason: str, tb: str = "") -> Optional[str]:
        """Write ``blackbox.json`` (once — the FIRST cause wins; a
        signal-then-atexit cascade must not overwrite the signal's
        record) and append one ``crash`` event to ``events.jsonl``."""
        if self._dumped:
            return None
        self._dumped = True
        counters = {}
        if self.telemetry is not None:
            counters = {k: int(self.telemetry.counters.get(k, 0))
                        for k in WATCHDOG_COUNTERS}
            counters["events_total"] = int(sum(
                n for k, n in self.telemetry.counters.items()
                if k.startswith("events.")))
        fault_log = os.path.join(self.run_dir, "fault.log")
        box = {
            "schema": BLACKBOX_SCHEMA,
            "created": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "reason": reason,
            "traceback": tb,
            "watchdogs": counters,
            "events": list(self.sink.events),
            "manifest": self.manifest,
            "fault_log": "fault.log" if os.path.exists(fault_log) else None,
        }
        path = os.path.join(self.run_dir, "blackbox.json")
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(box, f, indent=2, default=str)
                f.write("\n")
        except OSError:
            return None
        # the crash as a first-class event in the stream itself: append
        # directly (the JsonlSink's handle may be gone mid-teardown; a
        # line-append on our own fd is the crash-safe move)
        events_path = os.path.join(self.run_dir, "events.jsonl")
        if os.path.exists(events_path):
            try:
                # continue the run's real seq (monotone-per-run envelope
                # contract): the ring holds the newest events, so the
                # last buffered seq + 1 IS the next one the registry
                # would have assigned
                seq = (int(self.sink.events[-1].get("seq", -1)) + 1
                       if self.sink.events else 0)
                evt = {"v": SCHEMA_VERSION, "seq": seq,
                       "t": round(time.time(), 6),
                       "kind": "crash", "reason": reason}
                with open(events_path, "a") as f:
                    f.write(json.dumps(evt, separators=(",", ":")) + "\n")
            except OSError:
                pass
        return path


def read_blackbox(run_dir: str) -> Optional[Dict]:
    """The run's blackbox, or None. Unreadable/corrupt boxes (the dump
    itself was interrupted) degrade to a stub naming the problem — a
    crash report must never crash the reader."""
    path = os.path.join(run_dir, "blackbox.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return {"schema": None, "reason": f"unreadable blackbox ({e})",
                "traceback": "", "events": [], "watchdogs": {}}
