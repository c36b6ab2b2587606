#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since this script
started (one decimal), flushing each line: the per-phase wall time of a
run that prints one line a phase, as chip_smoke.py does.

    python3 -u chip_smoke.py | python3 scripts/stamp_lines.py > smoke.log

With ``--phases A.log B.log ...``, read such stamped logs instead and
print each phase's seconds in each (the time since the previous JSON
line with a "phase" key, summed over the phase's lines) beside the
difference of each log from the first, and the last stamp of each:

    python3 scripts/stamp_lines.py --phases parent.log change.log
"""

import json
import re
import sys
import time

_STAMPED = re.compile(r"\s*([0-9.]+) (.*)")


def phase_seconds(path: str):
    """({phase: seconds}, in order of first appearance; the last stamp)."""
    out, prev, last = {}, 0.0, 0.0
    with open(path, errors="replace") as f:
        for line in f:
            m = _STAMPED.match(line)
            if not m:
                continue
            last = float(m.group(1))
            try:
                rec = json.loads(m.group(2))
            except ValueError:
                continue
            if isinstance(rec, dict) and "phase" in rec:
                out[rec["phase"]] = out.get(rec["phase"], 0.0) + last - prev
                prev = last
    return out, last


def phases_table(paths) -> str:
    runs = [phase_seconds(p) for p in paths]
    names = list(dict.fromkeys(k for r, _ in runs for k in r))
    head = ["phase"] + list(paths) + [f"{p} - {paths[0]}" for p in paths[1:]]
    rows = [head]
    for k in names + ["(last stamp)"]:
        v = [r.get(k, 0.0) for r, _ in runs] if k in names else [t for _, t in runs]
        rows.append([k] + [f"{x:.1f}" for x in v] + [f"{x - v[0]:+.1f}" for x in v[1:]])
    return "\n".join("\t".join(r) for r in rows)


def main() -> int:
    if sys.argv[1:2] == ["--phases"]:
        if len(sys.argv) < 3:
            print("usage: stamp_lines.py --phases A.log [B.log ...]", file=sys.stderr)
            return 2
        print(phases_table(sys.argv[2:]))
        return 0
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
