"""``python -m sphexa_torch.devtools.audit cost``: the static roofline cost
gate of the port (the JAX package's ``sphexa-audit cost``).

    python -m sphexa_torch.devtools.audit cost [--entries ...] [--device h100]
        [--budget FILE] [--coverage-min F] [--json] [--cpu]

Runs every registered entry once under the tally (tally.py: every aten op
and every kernel launch charged to its ``sphexa/<phase>`` scope), on the
card unless ``--cpu`` is given, and classifies the per-phase FLOP / HBM /
link-byte totals against a device model into a predicted-ms roofline
table. On top of the table it runs the three cost rules: JXA301 (phase
coverage), JXA302 (predicted ms vs the committed ``COST_BUDGET_TORCH.json``
ceiling) and JXA303 (declared-compute-bound phase below the ridge point),
and lists every memory-bound phase.

Exit codes are the JAX CLI's: 0 = clean, 1 = findings or entry errors,
2 = usage error (an unknown device or entry, an unreadable target, no
CUDA device without ``--cpu``). Calibration against a real capture lives
in ``python -m sphexa_torch.telemetry trace <dir> --predict``.
"""

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

from sphexa_torch.devtools.common import Finding, render_table, render_text

_COST_RULES = ("JXA301", "JXA302", "JXA303")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit cost",
        description="static per-phase roofline cost model: per-op and per-kernel "
                    "FLOP/HBM accounting over one tallied run of each registered "
                    "entry, classified against a device model, gated by rules "
                    "JXA301-JXA303.",
    )
    ap.add_argument("targets", nargs="*", default=["sphexa_torch"],
                    help="registry modules (default: the package registry)")
    ap.add_argument("--device", default="h100", metavar="NAME",
                    help="device model to classify against "
                         "(devtools/audit/devices.py; default: h100)")
    ap.add_argument("--entries", metavar="NAMES",
                    help="comma-separated entry names (default: all)")
    ap.add_argument("--budget", metavar="FILE",
                    help="budget file for JXA302 "
                         "(default: COST_BUDGET_TORCH.json if present)")
    ap.add_argument("--coverage-min", type=float, metavar="F",
                    help="override the JXA301 phase-coverage floor")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable payload (per-entry "
                         "per-phase rows + findings) instead of the table")
    ap.add_argument("--cpu", action="store_true",
                    help="run the entries on the CPU (the kernels' plain "
                         "versions; the same tally as the card's)")
    return ap


def _fmt_flops(f: float) -> str:
    if f >= 1e9:
        return f"{f / 1e9:.2f}G"
    if f >= 1e6:
        return f"{f / 1e6:.2f}M"
    if f >= 1e3:
        return f"{f / 1e3:.1f}K"
    return f"{f:.0f}"


def entry_payload(name: str, pred) -> Dict[str, Any]:
    """One entry's JSON record (the JAX CLI's keys)."""
    return {
        "entry": name,
        "device": pred.device,
        "coverage": pred.coverage,
        "total_ms": pred.total_ms,
        "total_ms_upper": pred.total_ms_upper,
        "unknown_scopes": list(pred.unknown_scopes),
        "unattributed": pred.unattributed.as_dict(),
        "phases": [r.as_dict() for r in pred.rows],
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    prog = "sphexa-torch-audit cost"

    from sphexa_torch.devtools.audit.devices import device_names, get_device

    try:
        dev = get_device(args.device)
    except ValueError:
        print(f"{prog}: unknown device {args.device!r} "
              f"(known: {', '.join(device_names())})", file=sys.stderr)
        return 2
    from sphexa_torch.devtools.audit.cli import audit_device, load_entries

    device = audit_device(prog, args.cpu)
    if device is None:
        return 2

    from sphexa_torch.devtools.audit.core import (
        Auditor,
        audit_context,
        run_sharded,
        set_audit_context,
    )
    from sphexa_torch.devtools.audit.costmodel import (
        cost_report,
        memory_bound_phases,
        predict,
    )

    ctx = dataclasses.replace(
        audit_context(),
        cost_device=dev.name,
        device=device,
        **({"cost_budget_path": args.budget} if args.budget else {}),
        **({"phase_coverage_min": args.coverage_min}
           if args.coverage_min is not None else {}),
    )
    prev = set_audit_context(ctx)
    try:
        try:
            entries = load_entries(args.targets, args.entries)
        except (ImportError, OSError, SyntaxError, ValueError) as e:
            print(f"{prog}: {e}", file=sys.stderr)
            return 2

        auditor = Auditor(select=list(_COST_RULES))
        active: List[Finding] = []
        errors: List[Finding] = []
        skipped: List[str] = []
        rows: List[tuple] = []
        payload: List[Dict[str, Any]] = []
        mem_bound: List[str] = []
        # one tallied run per entry, shared by the table and the rules (the
        # sharded entries' in one spawn of the ranks, rank 0's record)
        run_sharded(entries)
        for entry in entries:
            trace = auditor.check_entry(entry, active, errors, skipped)
            if trace is None:
                continue
            try:
                pred = predict(cost_report(trace, ctx), dev)
            except Exception as e:  # noqa: BLE001 - reported as JXA000
                errors.append(Finding(
                    rule="JXA000", path=entry.path, line=entry.line, col=0,
                    message=f"[{entry.name}] cost model failed: "
                            f"{e.__class__.__name__}: {e}",
                ))
                continue
            payload.append(entry_payload(entry.name, pred))
            mem_bound += [f"{entry.name}/{r.phase}"
                          for r in memory_bound_phases(pred, dev)]
            for r in pred.rows:
                rows.append((entry.name, r.phase, r.dtype, _fmt_flops(r.flops),
                             f"{r.ai:.2f}", f"{r.ms:.6f}", r.bound))
            rows.append((entry.name, "= total", "-",
                         _fmt_flops(sum(r.flops for r in pred.rows)
                                    + pred.unattributed.flops),
                         "-", f"{pred.total_ms:.6f}", f"cov={pred.coverage:.3f}"))

        key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
        active.sort(key=key)
        errors.sort(key=key)

        for note in skipped:
            print(f"{prog}: skipped {note}", file=sys.stderr)

        if args.json:
            # "grandfathered" and "suppressed": the JAX payload's keys, empty
            # (the port has no baseline or suppression comment yet)
            print(json.dumps({
                "tool": "torchcost",
                "device": dev.name,
                "ridge_f32": dev.ridge("float32"),
                "entries": payload,
                "memory_bound": mem_bound,
                "findings": [f.to_json() for f in active],
                "grandfathered": [],
                "suppressed": [],
                "errors": [f.to_json() for f in errors],
                "skipped": skipped,
            }, indent=2, sort_keys=True))
            return 1 if (active or errors) else 0

        print(render_table(rows, headers=(
            "entry", "phase", "dtype", "flops", "AI", "ms", "bound")))
        print(f"device: {dev.name} (ridge {dev.ridge('float32'):.1f} "
              f"FLOP/B @ float32); predicted ms = max(compute, HBM-lower, link); "
              f"run on {ctx.device}")
        if mem_bound:
            print(f"memory-bound phases (AI < ridge): {', '.join(mem_bound)}")
        print(render_text(active, errors, "torchcost"))
        return 1 if (active or errors) else 0
    finally:
        set_audit_context(prev)


if __name__ == "__main__":
    sys.exit(main())
