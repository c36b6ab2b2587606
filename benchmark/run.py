"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload sedov-std-100.lists --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the NVIDIA cards the cell
asks for (it refuses to run without them). The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(and breakdown with --trace 1), then checks: each number compared with
the reference beside its limit, which also close standard error. With
--trace 0 the metrics are the cell's end-to-end metrics, with --trace 1
its per-layer metrics, from a torch.profiler capture of the window's
first steps.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

# every compiler cache at a fixed place inside the checkout (the port's
# own nvcc build lives in sphexa_torch/_build)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(BENCH, ".cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    _, entry, _, _ = harness.resolve(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s), {have} present",
              file=sys.stderr)
        return 2

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         T_START, log=log)
    # the last thing before the result: whatever the run loaded, the
    # reference's modules and the metrics' readers included
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}; no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
