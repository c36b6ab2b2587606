#!/usr/bin/env python
"""Regenerate tests/torch_trace_fixture: the committed CPU capture the
port's ``trace --predict`` tests pin against.

The fixture is one std Sedov side-6 step of the port on the CPU (the
kernels' plain versions), captured by ``torch.profiler`` (the CLI's
``--trace-dir`` form: a gzipped chrome trace whose ``sphexa/<phase>``
ranges ``telemetry/traceview.py`` reads back), after one untimed step.

The same program is exported as ``@entrypoint("trace_fixture")``, the
calibration target: ``calibration.json`` records, per phase, the
measured-us / statically-predicted-us ratio of this capture at the
cpu-smoke device model. ``python -m sphexa_torch.telemetry trace
tests/torch_trace_fixture --predict`` re-predicts (a tally of the same
step on the CPU, deterministic) and fails when a fresh ratio leaves the
recorded band: a cost rule drifting silently is what it catches.

Usage (from the repo root; writes tests/torch_trace_fixture/*):

    python scripts/make_torch_trace_fixture.py
"""

import gzip
import json
import os
import shutil
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # runnable as `python scripts/...` from anywhere
    sys.path.insert(0, _REPO)

from sphexa_torch.devtools.audit.core import entrypoint  # noqa: E402

_DEST = os.path.join(_REPO, "tests", "torch_trace_fixture")
#: repo-relative target recorded in calibration.json (resolved by the
#: audit CLI's _load_target, so --predict runs from the repo root)
_TARGET = "scripts/make_torch_trace_fixture.py::trace_fixture"
_DEVICE = "cpu-smoke"
_TOLERANCE = 2.0
_SIDE = 6
#: the capture's file, and the size it must stay under
_TRACE = "rank0.pt.trace.json.gz"
_MAX_BYTES = 200_000


def _sim():
    from sphexa_torch.init import init_sedov
    from sphexa_torch.simulation import Simulation

    state, box, const = init_sedov(_SIDE, device="cpu")
    return Simulation(state, box, const, prop="std", device="cpu")


@entrypoint("trace_fixture")
def trace_fixture():
    """One std Sedov side-6 step on the CPU (the audit registry's step
    form)."""
    from sphexa_torch.devtools.audit.registry import _step_case

    return _step_case(_sim())


def main() -> int:
    import torch

    from sphexa_torch.devtools.audit.costmodel import CALIBRATION_FILE, predict_for_target
    from sphexa_torch.telemetry.traceview import summarize_trace

    torch.set_num_threads(1)
    case = trace_fixture.build()
    case.fn(*case.args)  # the first step's set-up stays out of the capture
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt.trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            case.fn(*case.args)
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        # keep only the complete events the reader uses
        doc = {"traceEvents": [e for e in doc.get("traceEvents", [])
                               if isinstance(e, dict) and e.get("ph") == "X"]}
        os.makedirs(_DEST, exist_ok=True)
        with gzip.open(os.path.join(tmp, _TRACE), "wt") as f:
            json.dump(doc, f, separators=(",", ":"))
        shutil.copy(os.path.join(tmp, _TRACE), os.path.join(_DEST, _TRACE))
    size = os.path.getsize(os.path.join(_DEST, _TRACE))
    if size > _MAX_BYTES:
        raise SystemExit(f"capture {size} bytes, over {_MAX_BYTES}")

    s = summarize_trace(_DEST)
    print(f"capture: {s['device_op_events']} cpu ops, {s['total_device_us']:.1f}us, "
          f"coverage {s['coverage']:.4f}, {size} bytes")
    pred = predict_for_target(_TARGET, _DEVICE)
    doc = {"schema": 1, "target": _TARGET, "device": _DEVICE, "tolerance": _TOLERANCE,
           "phases": {}}
    for p in s["phases"]:
        row = pred.row(p["phase"])
        if row is None or row.ms <= 0 or p["us"] <= 0:
            continue
        ratio = p["us"] / (row.ms * 1e3)
        doc["phases"][p["phase"]] = {"ratio": round(ratio, 6)}
        print(f"  {p['phase']:18s} measured {p['us']:10.1f}us  predicted "
              f"{row.ms * 1e3:10.3f}us  ratio {ratio:.4g}")
    with open(os.path.join(_DEST, CALIBRATION_FILE), "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {_DEST}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
