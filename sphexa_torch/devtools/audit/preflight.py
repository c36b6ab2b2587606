"""``sphexa-torch-audit preflight``: the SPMD campaign gate of the port
(the JAX package's devtools/audit/preflight.py).

    python -m sphexa_torch.devtools.audit preflight [targets] [--mesh P]
        [--n N] [--devices D] [--hbm-budget BYTES] [--format text|json]
        [--json] [--entries NAMES] [--cpu]

Runs every registered entry, the sharded ones on ``--mesh`` P ranks
(core.run_sharded: one spawn for all of them; gloo with ``--cpu``, NCCL
where the machine has P cards, else gloo ranks sharing the card), and the
SPMD rules over their records: JXA201 (the same collectives in the same
order on every rank), JXA202 (a rank's static peak memory, recorded and
rescaled to the campaign, against the budget), JXA203 (particle fields
replicated onto every rank, exchange volume against the analytic budget)
and JXA204 (the growth probe, where an entry has one). It prints a row an
entry: the collectives of rank 0, the order check, the peak a rank at the
recorded size and at the campaign's, the replicated bytes at campaign N,
and the bytes a rank's collectives ship.

The defaults are the port's, not the JAX CLI's: ``--devices 8`` is one
8-card H100 node, NCCL rank r on ``cuda:r`` (the JAX default of 16 names a
v5e-16), and ``--hbm-budget`` is the card's memory (devices.py's h100, 80
GB; the JAX default of 16 GiB is a v5e's). The JAX baseline flags are not
ported: no finding of the port is grandfathered.

Exit codes are the JAX CLI's: 0 = clean, 1 = findings or entry errors,
2 = usage error (``--mesh`` below 2 among them).
"""

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from sphexa_torch.devtools.common import Finding, finish_cli, render_table

PREFLIGHT_RULES = ("JXA201", "JXA202", "JXA203", "JXA204")


def build_parser() -> argparse.ArgumentParser:
    from sphexa_torch.devtools.audit.devices import get_device

    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit preflight",
        description="SPMD preflight: collective order across the ranks, a rank's static "
                    "peak memory against the card's, replicated particle rows and exchange "
                    "volume, over the registered entries, the sharded ones on --mesh ranks.",
    )
    ap.add_argument("targets", nargs="*", default=["sphexa_torch"],
                    help="registry modules (default: the package registry)")
    ap.add_argument("--mesh", type=int, default=4, metavar="P",
                    help="the ranks the sharded entries run on (default: 4)")
    ap.add_argument("--n", type=int, default=64_000_000, metavar="N",
                    help="campaign particle count for the JXA202 rescale (default: 64M)")
    ap.add_argument("--devices", type=int, default=8, metavar="D",
                    help="campaign ranks, one a card (default: 8, one H100 node)")
    ap.add_argument("--hbm-budget", type=int, default=get_device("h100").memory_bytes,
                    metavar="BYTES",
                    help="a rank's memory budget in bytes (default: the H100's 80 GB)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable payload (per-entry rows, the "
                         "campaign and the findings) instead of the table; supersedes "
                         "--format")
    ap.add_argument("--entries", metavar="NAMES",
                    help="comma-separated entry names (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the entries on the CPU (gloo ranks, the kernels' plain "
                         "versions)")
    return ap


def _row(name: str, rep) -> tuple:
    from sphexa_torch.devtools.audit.spmd import format_bytes

    order = "ok" if not rep.order_problems else f"MISMATCH({len(rep.order_problems)})"
    repl = sum(r.campaign_bytes for r in rep.replicated)
    return (name, len(rep.collectives), order, format_bytes(rep.toy_peak_bytes),
            format_bytes(rep.campaign_peak_bytes),
            format_bytes(repl) if rep.replicated else "-",
            format_bytes(rep.collective_out_bytes) if rep.collectives else "-")


def entry_payload(name: str, rep, trace) -> dict:
    """One entry's row of the ``--json`` payload: the JAX payload's keys
    (``chain`` and ``unordered_pairs`` carry the order check) and each
    rank's numbers."""
    return {
        "entry": name,
        "mesh_size": rep.mesh_size,
        "collectives": len(rep.collectives),
        "chain": "ok" if not rep.order_problems else "mismatch",
        "unordered_pairs": len(rep.order_problems),
        "order_problems": list(rep.order_problems),
        "toy_peak_bytes": rep.toy_peak_bytes,
        "campaign_peak_bytes": rep.campaign_peak_bytes,
        "toy_slab_rows": rep.toy_slab_rows,
        "campaign_ratio": rep.campaign_ratio,
        "n_global": rep.n_global,
        "replicated_campaign_bytes": sum(r.campaign_bytes for r in rep.replicated),
        "exchange_bytes": rep.collective_out_bytes,
        "exchange_budget_bytes": trace.case.exchange_budget_bytes,
        "sort_bytes": trace.case.sort_bytes,
        "ranks": [{"rank": r.rank, "collectives": len(r.collectives),
                   "toy_peak_bytes": r.toy_peak_bytes,
                   "campaign_peak_bytes": r.campaign_peak_bytes,
                   "exchange_bytes": r.exchange_bytes, "max_allocated": r.max_allocated}
                  for r in rep.ranks],
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    prog = "sphexa-torch-audit preflight"
    if args.mesh < 2:
        print(f"{prog}: --mesh must be >= 2", file=sys.stderr)
        return 2
    from sphexa_torch.devtools.audit.cli import audit_device, load_entries
    from sphexa_torch.devtools.audit.core import (
        Auditor,
        audit_context,
        run_sharded,
        set_audit_context,
    )
    from sphexa_torch.devtools.audit.spmd import spmd_report

    try:
        entries = load_entries(args.targets, args.entries)
    except (ImportError, OSError, SyntaxError, ValueError) as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 2
    device = audit_device(prog, args.cpu)
    if device is None:
        return 2
    ctx = dataclasses.replace(audit_context(), device=device, mesh_size=args.mesh,
                              campaign_n=args.n, campaign_devices=args.devices,
                              hbm_budget_bytes=args.hbm_budget)
    prev = set_audit_context(ctx)
    try:
        auditor = Auditor(select=list(PREFLIGHT_RULES))
        active: List[Finding] = []
        errors: List[Finding] = []
        skipped: List[str] = []
        rows, payload = [], []
        run_sharded(entries)
        for entry in entries:
            trace = auditor.check_entry(entry, active, errors, skipped)
            if trace is None:
                continue
            rep = spmd_report(trace, ctx)
            rows.append(_row(entry.name, rep))
            payload.append(entry_payload(entry.name, rep, trace))
        key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
        active.sort(key=key)
        errors.sort(key=key)
        for note in skipped:
            print(f"{prog}: skipped {note}", file=sys.stderr)
        if args.json:
            print(json.dumps({
                "tool": "torchaudit-preflight",
                "campaign": {"n": args.n, "devices": args.devices,
                             "hbm_budget_bytes": args.hbm_budget, "traced_mesh": args.mesh,
                             "device": device},
                "entries": payload,
                "findings": [f.to_json() for f in active],
                "grandfathered": [],
                "suppressed": [],
                "errors": [f.to_json() for f in errors],
                "skipped": skipped,
            }, indent=2, sort_keys=True))
            return 1 if (active or errors) else 0
        if args.format == "text":
            print(render_table(rows, headers=(
                "entry", "coll", "order", "peak/dev", f"peak/dev@{args.n}/{args.devices}",
                "replicated", "exchange")))
            print(f"campaign: N={args.n} P={args.devices} budget={args.hbm_budget} B/device; "
                  f"ranks P={args.mesh} on {device}")
        return finish_cli("torchaudit preflight", args.format, active, errors)
    finally:
        set_audit_context(prev)


if __name__ == "__main__":
    sys.exit(main())
