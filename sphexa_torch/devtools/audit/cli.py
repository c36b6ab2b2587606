"""``python -m sphexa_torch.devtools.audit`` (``sphexa-torch-audit``): the
port's audit CLI (the JAX package's ``sphexa-audit``).

    python -m sphexa_torch.devtools.audit [targets] [--cpu] [--select IDS]
        [--entries NAMES] [--format text|json]
    python -m sphexa_torch.devtools.audit lowering [--cpu] [--write] ...
    python -m sphexa_torch.devtools.audit schema [--cpu] [--write] [--vmap] ...
    python -m sphexa_torch.devtools.audit cost [--cpu] [--device h100] ...
    python -m sphexa_torch.devtools.audit preflight [--cpu] [--mesh P] ...
    python -m sphexa_torch.devtools.audit --list-rules
    python -m sphexa_torch.devtools.audit --list-entries [targets...]

The default mode runs every registered rule on one recorded run of each
registry entry (tally.py's record), the sharded entries on two ranks (one
spawn for all of them, core.run_sharded): the trace rules JXA101 (64-bit
values), JXA104 (host syncs), JXA105 (constants) and JXA106 (collective
groups), the SPMD rules JXA201-JXA204 (collective order, peak memory,
replication and exchange volume, tree growth), the cost rules
JXA301-JXA303, JXA401 (order-dependent float accumulates and reducing
collectives), JXA402 (knob inertness), JXA501 (schema drift) and JXA503
(carry closure); JXA502 runs under ``schema --vmap`` only. ``lowering``
checks the committed LOWERING_LOCK_TORCH.json (lowerdiff.py), ``schema``
the committed STATE_SCHEMA_TORCH.json (statecheck.py), ``cost`` the
roofline budget (costcli.py), ``preflight`` the SPMD rules at a campaign
(preflight.py, ``--mesh`` ranks). Every mode runs the entries on the card,
and exits 2 on a machine without one unless ``--cpu`` asks for the CPU
(the kernels' plain versions on gloo ranks: the same record).

Exit codes are the JAX CLI's: 0 = clean, 1 = findings or entry errors,
2 = usage error.
"""

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path
from typing import List, Optional

_DEFAULT_TARGET = "sphexa_torch"
_PACKAGE_REGISTRY = "sphexa_torch.devtools.audit.registry"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit",
        description="the port's audit: every registered rule (JXA101, JXA104-JXA106, "
                    "JXA201-JXA204, JXA301-JXA303, JXA401-JXA402, JXA501, JXA503) over "
                    "one recorded run of each registered entry point, the sharded ones "
                    "on two ranks. 'lowering --help' for the run-fingerprint lock, "
                    "'schema --help' for the state-schema lock and the vmap report, "
                    "'cost --help' for the roofline gate, 'preflight --help' for the "
                    "SPMD campaign gate.",
    )
    ap.add_argument("targets", nargs="*", default=[_DEFAULT_TARGET],
                    help="registry modules: 'sphexa_torch' (the package registry), "
                         "a dotted module name, or a .py file defining "
                         "@entrypoint builders (default: sphexa_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", metavar="IDS",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--entries", metavar="NAMES",
                    help="comma-separated entry names to audit (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the entries on the CPU (the kernels' plain versions)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--list-entries", action="store_true",
                    help="print the registered entry points and exit")
    return ap


def _load_target(target: str):
    """Import a registry target: the package alias, a module, or a file."""
    if target == _DEFAULT_TARGET:
        target = _PACKAGE_REGISTRY
    p = Path(target)
    if p.suffix == ".py" and p.exists():
        spec = importlib.util.spec_from_file_location(p.stem, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(target)


def load_entries(targets, names: Optional[str]):
    """The entries of ``targets`` (registry modules), narrowed to the
    comma-separated ``names``; raises ValueError on an unknown name."""
    from sphexa_torch.devtools.audit.core import entries_from_namespace

    entries = []
    for target in targets:
        entries += entries_from_namespace(vars(_load_target(target)))
    if names:
        want = {s.strip() for s in names.split(",") if s.strip()}
        unknown = want - {e.name for e in entries}
        if unknown:
            raise ValueError(f"unknown entry name(s): {sorted(unknown)}")
        entries = [e for e in entries if e.name in want]
    return entries


def audit_device(prog: str, cpu: bool) -> Optional[str]:
    """The device a mode runs its entries on: "cpu" when asked, else the
    card; None (after saying so) when there is no card."""
    if cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (the entries run on the card; --cpu runs them on "
              f"the CPU)", file=sys.stderr)
        return None
    return "cuda"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "cost":
        from sphexa_torch.devtools.audit.costcli import main as cost_main

        return cost_main(argv[1:])
    if argv and argv[0] == "lowering":
        from sphexa_torch.devtools.audit.lowerdiff import main as lowering_main

        return lowering_main(argv[1:])
    if argv and argv[0] == "schema":
        from sphexa_torch.devtools.audit.statecheck import main as schema_main

        return schema_main(argv[1:])
    if argv and argv[0] == "preflight":
        from sphexa_torch.devtools.audit.preflight import main as preflight_main

        return preflight_main(argv[1:])
    args = build_parser().parse_args(argv)
    prog = "sphexa-torch-audit"

    import dataclasses

    from sphexa_torch.devtools.audit.core import (
        Auditor,
        all_rules,
        audit_context,
        set_audit_context,
    )
    from sphexa_torch.devtools.common import finish_cli

    if args.list_rules:
        for rule in all_rules().values():
            print(f"{rule.id}  {rule.name}: {rule.description}")
        return 0
    try:
        entries = load_entries(args.targets, args.entries)
    except (ImportError, OSError, SyntaxError, ValueError) as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 2
    if args.list_entries:
        for e in entries:
            mesh = f"  mesh_axes={e.mesh_axes}" if e.mesh_axes else ""
            print(f"{e.name}  ({e.path}:{e.line}){mesh}")
        return 0
    select = [s.strip() for s in args.select.split(",") if s.strip()] if args.select else None
    try:
        auditor = Auditor(select=select)
    except ValueError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 2
    device = audit_device(prog, args.cpu)
    if device is None:
        return 2
    prev = set_audit_context(dataclasses.replace(audit_context(), device=device))
    try:
        active, errors, skipped = auditor.run_entries(entries)
    finally:
        set_audit_context(prev)
    for note in skipped:
        print(f"{prog}: skipped {note}", file=sys.stderr)
    return finish_cli("torchaudit", args.format, active, errors)


if __name__ == "__main__":
    sys.exit(main())
