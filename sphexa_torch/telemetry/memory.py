"""Device-memory accounting as telemetry (sphexa_tpu/telemetry/memory.py):
``memory`` events with the JAX package's keys, at three points:

- ``manifest``: right after the Simulation is made (the CLI): the state
  and constants resident before the first step;
- ``post-compile``: after the first verified step or window (the first
  step's workspace resident; the port compiles nothing at run time, the
  name is the JAX package's);
- ``flush``: at each deferred window's flush: the steady-state peak.

On the card the numbers are the caching allocator's host-side counters
(``torch.cuda.memory_stats``) and the card's total memory: no CUDA call
that waits on the stream, so a snapshot adds no host sync. On the CPU the
byte lists are empty, as the JAX package's are there.

``--memory-profile`` (``start_memory_history`` at the CLI's start,
``save_memory_profile`` at its end) dumps the caching allocator's
snapshot with its history, the port's form of the JAX package's pprof
device-memory profile.
"""

from typing import Dict, List, Optional

import torch

#: the snapshot's per-device byte lists, in event-field order
_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_snapshot(devices=None) -> Dict[str, List]:
    """``{"devices": [...], "bytes_in_use": [...], "peak_bytes_in_use":
    [...], "bytes_limit": [...]}``, lists parallel over ``devices`` (torch
    devices; default every CUDA device). The byte lists are empty when no
    device is a CUDA device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    out: Dict[str, List] = {"devices": [str(d.index if d.index is not None else d)
                                        for d in devices]}
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return {**out, **{k: [] for k in _STAT_KEYS}}
    stats = [torch.cuda.memory_stats(d) if d.type == "cuda" else {} for d in devices]
    out["bytes_in_use"] = [int(s.get("allocated_bytes.all.current", 0)) for s in stats]
    out["peak_bytes_in_use"] = [int(s.get("allocated_bytes.all.peak", 0)) for s in stats]
    out["bytes_limit"] = [torch.cuda.get_device_properties(d).total_memory
                          if d.type == "cuda" else 0 for d in devices]
    return out


def emit_memory_event(telemetry, point: str, devices=None,
                      **extra) -> Optional[Dict[str, List]]:
    """Snapshot and emit one ``memory`` event; skipped on a registry
    without sinks (the snapshot exists to be written). Returns the
    snapshot, or None when skipped."""
    if telemetry is None or not telemetry.sinks:
        return None
    snap = device_memory_snapshot(devices)
    telemetry.event("memory", point=point, **snap, **extra)
    return snap


def start_memory_history() -> bool:
    """Start recording the CUDA caching allocator's history (every
    allocation with its stack) for ``save_memory_profile``; the CLI calls
    it at start-up under ``--memory-profile``. Returns False where there
    is no CUDA device."""
    if not torch.cuda.is_available():
        return False
    try:
        torch.cuda.memory._record_memory_history(max_entries=100000)
        return True
    except Exception:
        return False


def save_memory_profile(path: str) -> bool:
    """The port's ``--memory-profile`` (the JAX package's pprof device
    memory profile): the caching allocator's snapshot (segments, blocks
    and the recorded history), pickled to ``path`` by
    ``torch.cuda.memory._dump_snapshot``, and stops the recording; it
    opens in PyTorch's memory viewer (pytorch.org/memory_viz). Returns
    whether a file was written: False where there is no CUDA device
    (callers report, never crash)."""
    if not torch.cuda.is_available():
        return False
    try:
        torch.cuda.memory._dump_snapshot(path)
        return True
    except Exception:
        return False
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
