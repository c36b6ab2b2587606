"""``python -m sphexa_torch.devtools.audit`` (``sphexa-torch-audit``): the
port's audit CLI (the JAX package's ``sphexa-audit``).

    python -m sphexa_torch.devtools.audit cost [--device h100] [--cpu] ...
    python -m sphexa_torch.devtools.audit --list-rules
    python -m sphexa_torch.devtools.audit --list-entries [targets...]

The port has the JAX audit's cost layer (``cost``: rules JXA301-JXA303,
costcli.py). Its other modes, the trace-rule audit (JXA101-JXA106),
``preflight`` (the SPMD checks JXA201-JXA204), ``lowering`` (JXA401-402)
and ``schema`` (statecheck JXA501-503), are not ported yet (ROADMAP
Queue 1) and exit 2 saying so. Exit codes are the JAX CLI's: 0 = clean,
1 = findings or entry errors, 2 = usage error.
"""

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path
from typing import List, Optional

_DEFAULT_TARGET = "sphexa_torch"
_PACKAGE_REGISTRY = "sphexa_torch.devtools.audit.registry"

#: the JAX CLI's modes the port lacks, and what they check
_NOT_PORTED = {
    "preflight": "the SPMD checks JXA201-JXA204 and the campaign preflight",
    "lowering": "the lowering lock JXA401-JXA402",
    "schema": "statecheck JXA501-JXA503",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit",
        description="the port's audit: 'cost' runs the static roofline cost gate "
                    "(rules JXA301-JXA303) over the registered entry points; "
                    "'sphexa-torch-audit cost --help' for its options.",
    )
    ap.add_argument("targets", nargs="*", default=[_DEFAULT_TARGET],
                    help="registry modules: 'sphexa_torch' (the package registry), "
                         "a dotted module name, or a .py file defining "
                         "@entrypoint builders (default: sphexa_torch)")
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


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "cost":
        from sphexa_torch.devtools.audit.costcli import main as cost_main

        return cost_main(argv[1:])
    if argv and argv[0] in _NOT_PORTED:
        print(f"sphexa-torch-audit: '{argv[0]}' ({_NOT_PORTED[argv[0]]}) is not ported "
              f"yet: ROADMAP.md Queue 1 lists it; 'cost' is available", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)

    from sphexa_torch.devtools.audit.core import all_rules, entries_from_namespace

    if args.list_rules:
        for rule in all_rules().values():
            print(f"{rule.id}  {rule.name}: {rule.description}")
        return 0
    if args.list_entries:
        for target in args.targets:
            try:
                mod = _load_target(target)
            except (ImportError, OSError, SyntaxError) as e:
                print(f"sphexa-torch-audit: cannot load target {target!r}: {e}",
                      file=sys.stderr)
                return 2
            for e in entries_from_namespace(vars(mod)):
                print(f"{e.name}  ({e.path}:{e.line})")
        return 0
    print("sphexa-torch-audit: the trace-rule audit (JXA101-JXA106) is not ported yet: "
          "ROADMAP.md Queue 1 lists it; 'cost' is available", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
