"""Command-line front end of the port, restricted to its ported slices:

    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 [--device cpu]
    python -m sphexa_torch.app.main --init noh -n 50 -s 20
    python -m sphexa_torch.app.main --init gresho-chan -n 50 -s 20 --prop ve [--avclean]
    python -m sphexa_torch.app.main --init evrard -n 125 -s 5 --prop ve
    python -m sphexa_torch.app.main --init sedov -n 100 -s 100 --check-every 8 \\
        -o out --telemetry-dir out/tel

Flag names follow the JAX package's CLI (sphexa_tpu/app/main.py). ``-s``
is a number of iterations when it is an integer, else a simulated time;
under ``--check-every N`` the iteration count applies at every step and
a simulated time only at check boundaries (reading the time would read
the card mid-window). ``--prop`` is std or ve; other --init / --prop
values raise "not ported yet". Steps run on persistent neighbour lists
wherever the grid allows them, as in the JAX CLI, which has no flag for
it. A case with a gravitational constant (Evrard) runs self-gravity,
whose steps sort every time. Every step's science ledger lands in
``<outDir>/constants.txt`` (one row per step, also under deferral);
``--telemetry-dir`` writes the driver's events to ``events.jsonl``
there, which the JAX package's ``sphexa-telemetry summary --strict``
reads. Runs on the CUDA device unless ``--device cpu`` is given, and
raises without one.
"""

import argparse
import os
import sys
import time
from typing import List, Optional

from sphexa_torch.init import init_evrard, init_gresho_chan, init_noh, init_sedov
from sphexa_torch.observables import ConstantsWriter, make_observable, make_observable_spec
from sphexa_torch.simulation import Simulation
from sphexa_torch.telemetry import JsonlSink, Telemetry

_INITS = {"sedov": init_sedov, "noh": init_noh, "gresho-chan": init_gresho_chan,
          "evrard": init_evrard}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphexa-torch",
        description="SPH on an NVIDIA GPU (PyTorch/CUDA port; std and VE SPH, self-gravity)",
    )
    p.add_argument("--init", default="sedov",
                   help="test case name (sedov, noh, gresho-chan, evrard)")
    p.add_argument("-n", type=int, default=50, dest="side",
                   help="particles per cube side (N = n^3)")
    p.add_argument("-s", type=float, default=10, dest="stop",
                   help="integer: number of iterations; float: simulated time")
    p.add_argument("-o", "--outDir", default=".", dest="out_dir",
                   help="output directory (constants.txt)")
    p.add_argument("--prop", default="std", help="propagator (std, ve)")
    p.add_argument("--avclean", action="store_true",
                   help="VE: the velocity-gradient correction of the viscosity")
    p.add_argument("--check-every", type=int, default=1, dest="check_every",
                   help="deferred check window: launch N steps with no read of the "
                        "card, check their diagnostics in one read at the window's "
                        "end, roll back and replay on an overflow (default 1: every "
                        "step checked)")
    p.add_argument("--drift-budget", type=float, default=None, dest="drift_budget",
                   help="conservation-drift watchdog: relative total-energy budget "
                        "|etot-etot0|/|etot0| (telemetry 'drift' events; default: "
                        "report only)")
    p.add_argument("--telemetry-dir", default=None, dest="telemetry_dir",
                   help="write the run's telemetry events to <dir>/events.jsonl")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (plain PyTorch versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.init not in _INITS:
        raise NotImplementedError(f"--init {args.init!r}: not ported yet")
    nan = float("nan")

    def log(line: str) -> None:
        if not args.quiet:
            print(line, flush=True)

    state, box, const = _INITS[args.init](args.side, device=args.device)
    # the observable names the constants.txt columns; the values come
    # from the step's ledger (the matching ObservableSpec)
    observable = make_observable(args.init)
    sinks = []
    if args.telemetry_dir:
        sinks.append(JsonlSink(os.path.join(args.telemetry_dir, "events.jsonl")))
    telemetry = Telemetry(sinks=sinks)
    sim = Simulation(state, box, const, prop=args.prop, device=args.device,
                     av_clean=args.avclean, check_every=args.check_every,
                     obs_spec=make_observable_spec(args.init), telemetry=telemetry,
                     science_rows=True, drift_budget=args.drift_budget)
    num_steps = int(args.stop) if float(args.stop).is_integer() else None
    target_time = None if num_steps is not None else float(args.stop)

    os.makedirs(args.out_dir, exist_ok=True)
    constants_path = os.path.join(args.out_dir, "constants.txt")
    if os.path.exists(constants_path):
        os.remove(constants_path)
    constants = ConstantsWriter(constants_path, observable)

    def write_science_rows():
        """The verified ledger rows into constants.txt, one per step (a
        deferred window's land whole at its flush): host I/O only."""
        rows = sim.drain_science()
        for r in rows:
            constants.write_row([r["it"], r["t"], r["dt"], r["etot"], r["ecin"], r["eint"],
                                 r["egrav"]] + ([r["extra"]] if "extra" in r else []))
        return rows

    t0 = time.time()
    while True:
        d = sim.step()
        it = sim.iteration
        if d.get("deferred"):
            # mid-window: nothing may read the card here, so only the
            # iteration count ends the run before the window's flush
            log(f"it {it:5d}  (deferred check)")
            if num_steps is not None and it >= num_steps:
                break
            continue
        rows = write_science_rows()
        r = rows[-1] if rows else {}
        drift = sim.energy_drift if sim.energy_drift is not None else nan
        log(f"it {it:5d}  t={r.get('t', nan):.6g}  dt={d.get('dt', nan):.4g}  "
            f"nc~{d.get('nc_mean', nan):.1f} (max {d.get('nc_max', nan):.0f})  "
            f"etot={r.get('etot', nan):.8g} ecin={r.get('ecin', nan):.6g} "
            f"eint={r.get('eint', nan):.8g} egrav={r.get('egrav', nan):.8g}  "
            f"drift={drift:.3e}")
        if num_steps is not None and it >= num_steps:
            break
        if target_time is not None and float(sim.state.ttot) >= target_time:
            break
    # the last open window is verified, and its rows land, before the report
    sim.flush()
    write_science_rows()
    wall = time.time() - t0
    telemetry.event("run_end", iterations=sim.iteration, wall_s=round(wall, 3))
    telemetry.close()
    log(f"# {sim.iteration} steps on {sim.device}, {state.n} particles, "
        f"lists {'on' if sim.lists is not None else 'off'} "
        f"({sim.rebuilds} builds), reconfigures {sim.reconfigures}, "
        f"rollbacks {sim.rollbacks}, energy drift {sim.energy_drift}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
