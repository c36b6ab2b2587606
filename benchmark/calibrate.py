"""The readings that the limits of ``limits/<config>.json`` are set from,
on the card at the cell's own size: for each seed, one run of the cell
(a short window) gives the program's readings, and on the seeds of
``--control-seeds`` the control, the reference in bfloat16 put in the
program's place, is read on the same two steps' inputs (the harness's
initial state, and the input the program held at the window's last
step).

    python3 benchmark/calibrate.py --workload evrard-ve-125.grav --seeds 11,12,13 \\
        --seconds 5 --control-seeds 11 --out chiprun_out/calibrate.jsonl

Each seed writes one JSON line: {"seed", "program": {"first": {...},
"last": {...}}, "control": {...}}. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", default="",
                   help="comma-separated seeds of --seeds to read the bfloat16 control on")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.reference import check

    if not torch.cuda.is_available():
        print("calibrate.py reads the card; none is present", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False, "cuda", t0,
                          log=lambda s: None, keep=keep)
        line = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                "program": keep["readings"]}
        if seed in control_seeds:
            line["control"] = {}
            for tag, state in keep["inputs"].items():
                if state is not None:
                    line["control"][tag] = check.readings(state, None, None, keep["cfg"],
                                                          keep["box"], seed, "cuda",
                                                          control=True)
            torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
