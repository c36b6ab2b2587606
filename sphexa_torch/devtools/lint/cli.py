"""torchlint's CLI.

    python -m sphexa_torch.devtools.lint [paths]    (default: sphexa_torch)
    sphexa-torch-lint sphexa_torch --format json --show-suppressed
    sphexa-torch-lint --select JXL002 sphexa_torch/propagator.py

Exit status: 0 clean, 1 findings or errors (a file that does not parse,
a suppression with no reason), 2 usage. No finding is grandfathered: the
port has no baseline. The lint imports none of the code it scans, so it
runs on a machine with no card and no JAX.
"""

import argparse
import sys
from typing import List, Optional

from sphexa_torch.devtools.common import finish_cli
from sphexa_torch.devtools.lint.core import Analyzer, all_rules


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-lint",
        description="torchlint: AST lint of the PyTorch port (rules JXL001, JXL002, "
                    "JXL003, JXL006).")
    ap.add_argument("paths", nargs="*", default=["sphexa_torch"],
                    help="files or directories to scan (default: sphexa_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", metavar="IDS",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list the inline-suppressed findings")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in all_rules().values():
            print(f"{rule.id}  {rule.name}: {rule.description}")
        return 0
    select = [s.strip() for s in args.select.split(",") if s.strip()] if args.select else None
    try:
        analyzer = Analyzer(select=select)
    except ValueError as e:
        print(f"sphexa-torch-lint: {e}", file=sys.stderr)
        return 2
    active, suppressed, errors = analyzer.run_paths(args.paths)
    return finish_cli("torchlint", args.format, active, errors, suppressed,
                      args.show_suppressed)


if __name__ == "__main__":
    sys.exit(main())
