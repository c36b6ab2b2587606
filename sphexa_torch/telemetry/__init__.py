"""Telemetry of the port (sphexa_tpu/telemetry: the registry, sinks,
run manifest, crash flight recorder and memory events): one registry
(``Telemetry``) with pluggable sinks.

- ``JsonlSink``  — ``events.jsonl`` per run, in the JAX package's event
  schema (version 8), read by the port's own ``python -m
  sphexa_torch.telemetry`` (cli.py, history.py, serve.py; no device, no
  JAX) and by the JAX package's ``sphexa-telemetry``;
- ``MemorySink`` — in-memory event list for tests and chip_smoke.py;
- ``ConsoleSink``— human-readable notable-event lines;
- ``RingSink``   — the flight recorder's event tail (``FlightRecorder``
  writes ``blackbox.json`` on an abnormal exit).

A run directory (the CLI's ``--telemetry-dir``) holds ``manifest.json``
(``write_manifest``) beside ``events.jsonl``.

On a deferred check window (``Simulation(check_every > 1)``) the happy
path reads nothing from the card: telemetry only stamps launches on the
host and counts events, and the device time is attributed per window at
``flush()``, whose one batched read already exists.
"""

from sphexa_torch.telemetry.flightrec import FlightRecorder, RingSink, read_blackbox
from sphexa_torch.telemetry.manifest import (
    MANIFEST_SCHEMA,
    build_manifest,
    read_manifest,
    write_manifest,
)
from sphexa_torch.telemetry.memory import (
    device_memory_snapshot,
    emit_memory_event,
    save_memory_profile,
    start_memory_history,
)
from sphexa_torch.telemetry.registry import (
    EVENT_KINDS,
    SCHEMA_VERSION,
    Telemetry,
    validate_event,
)
from sphexa_torch.telemetry.sinks import ConsoleSink, JsonlSink, MemorySink

__all__ = [
    "Telemetry",
    "JsonlSink",
    "MemorySink",
    "ConsoleSink",
    "SCHEMA_VERSION",
    "EVENT_KINDS",
    "validate_event",
    "FlightRecorder",
    "RingSink",
    "read_blackbox",
    "MANIFEST_SCHEMA",
    "build_manifest",
    "read_manifest",
    "write_manifest",
    "device_memory_snapshot",
    "emit_memory_event",
    "save_memory_profile",
    "start_memory_history",
]
