#!/usr/bin/env python3
"""The std main path's step on one NVIDIA card, for the ``sphexa_torch``
of a checkout (default: this one), as that checkout's chip_smoke.py
drives it (``drive``, ``count_syncs``, ``profile_steps``).

    python3 scripts/torch_driver_ab.py [ROOT]

Sedov 100^3 std in list mode, one step checked at a time: one warm-up
and 30 timed steps (a list rebuild falls among them), the step wall of
each (host clock, ending in the step's read of the card) and its
median, the host syncs of one step, and four profiled steps (device
time per step, kernel events, busy share against the timed median).
Where the checkout has the step driver (``ObservableSpec``), the
science ledger rides the steps and the deferred path follows
(``check_every=8`` to step 100, ``chip_smoke.deferred_run``). Run it on
a `git archive` of another commit beside this tree, in one call and in
turns (other, this, this, other), to compare the two. Prints one JSON line with the card's name
and power limit."""

import argparse
import json
import os
import statistics
import subprocess
import sys

STEPS = 30


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_driver_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke  # the checkout's own
    from sphexa_torch.init import init_sedov
    from sphexa_torch.simulation import Simulation

    try:
        from sphexa_torch.observables import ObservableSpec
        kw = {"obs_spec": ObservableSpec()}
    except ImportError:  # before the driver: the step summed its energies itself
        kw = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    state, box, const = init_sedov(100, device="cuda")
    run = chip_smoke.drive(
        lambda: Simulation(state, box, const, prop="std", device="cuda", **(kw or {})),
        steps=STEPS, label="main_path")
    sim, rep = run["sim"], run["report"]
    if sim.lists is None:
        raise AssertionError("the std main path streamed: no persistent lists")
    out = {"phase": "driver_ab", "root": root, "card": smi, "steps": STEPS,
           "step_ms": rep["step_ms"], "step_ms_median": statistics.median(rep["step_ms"]),
           "wall_ms_per_step": run["step_ms_median"],
           "particle_updates_per_s": rep["particle_updates_per_s"],
           "rebuilds": sim.rebuilds, "energy_drift": rep["energy_drift"],
           "host_syncs": chip_smoke.count_syncs(sim)["per_step"],
           "profile": chip_smoke.profile_steps(sim, 4, statistics.median(rep["step_ms"]))}
    if kw is not None:
        state, box, const = init_sedov(100, device="cuda")
        out["deferred"] = chip_smoke.deferred_run(lambda tel: Simulation(
            state, box, const, prop="std", device="cuda", check_every=8, telemetry=tel,
            science_rows=True, **kw), to_step=100)["report"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
