#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since this script
started (one decimal), flushing each line: the per-phase wall time of a
run that prints one line a phase, as chip_smoke.py does.

    python3 -u chip_smoke.py | python3 scripts/stamp_lines.py > smoke.log
"""

import sys
import time


def main() -> int:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
