"""Small sizes of the two configurations for CPU runs of the harness."""

import time

from benchmark import harness

#: (workload, the side the tests run it at)
SMALL = {"sedov-std-100.lists": 12, "evrard-ve-125.grav": 16}


def run_small(workload: str, seed: int, seconds: float = 2.0, trace: bool = False,
              fault=None, steps: int = 2):
    """``harness.run`` on the CPU at the workload's small side."""
    ov = {"config": {"side": SMALL[workload]},
          "traffic": {"warmup_steps": steps, "trace_steps": 2}}
    return harness.run(workload, seed, seconds, trace, "cpu", time.perf_counter(),
                       overrides=ov, fault=fault, log=lambda s: None)
