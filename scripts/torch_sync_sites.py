#!/usr/bin/env python3
"""The host syncs of each audit registry entry on one NVIDIA card, for the
``sphexa_torch`` of a checkout (default: this one).

    python3 scripts/torch_sync_sites.py [ROOT]

Each entry of ``sphexa_torch/devtools/audit/registry.py`` (and the
list-mode cases of ``kernels/cost_checks.py`` where a checkout keeps them
there) is built on the card and run once untallied, then run once more
under ``torch.cuda.set_sync_debug_mode`` (``kernels/deferred_checks
.sync_sites``): every synchronizing call, by the repository line that made
it. Run it on a `git archive` of another commit beside this tree to see
which syncs a change added or removed. Prints one JSON line with the
card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose sphexa_torch to run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_sync_sites: no CUDA device", file=sys.stderr)
        return 2
    from sphexa_torch.devtools.audit import registry
    from sphexa_torch.devtools.audit.core import (
        audit_context,
        entries_from_namespace,
        set_audit_context,
    )
    from sphexa_torch.kernels import cost_checks
    from sphexa_torch.kernels.deferred_checks import sync_sites

    set_audit_context(dataclasses.replace(audit_context(), device="cuda"))
    entries = entries_from_namespace(vars(registry))
    names = {e.name for e in entries}
    entries += [e for e in getattr(cost_checks, "LIST_ENTRIES", ()) if e.name not in names]
    out = {}
    for entry in entries:
        case = entry.build()
        if case.warmup:
            case.fn(*case.args)
        torch.cuda.synchronize()
        out[entry.name] = dict(sync_sites(lambda: case.fn(*case.args)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi.strip(),
                      "sync_sites": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
