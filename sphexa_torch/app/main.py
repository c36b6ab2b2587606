"""Command-line front end of the port, restricted to its ported slices:

    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 [--device cpu]
    python -m sphexa_torch.app.main --init noh -n 50 -s 20
    python -m sphexa_torch.app.main --init gresho-chan -n 50 -s 20 --prop ve [--avclean]
    python -m sphexa_torch.app.main --init evrard -n 125 -s 5 --prop ve

Flag names follow the JAX package's CLI (sphexa_tpu/app/main.py). ``-s``
is a number of iterations when it is an integer, else a simulated time.
``--prop`` is std or ve; other --init / --prop values raise "not ported
yet". Steps run on persistent neighbour lists wherever the grid allows
them, as in the JAX CLI, which has no flag for it. A case with a
gravitational constant (Evrard) runs self-gravity, whose steps sort
every time. Runs on the CUDA device unless ``--device cpu`` is given,
and raises without one.
"""

import argparse
import sys
from typing import List, Optional

from sphexa_torch.init import init_evrard, init_gresho_chan, init_noh, init_sedov
from sphexa_torch.simulation import Simulation

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
    p.add_argument("--prop", default="std", help="propagator (std, ve)")
    p.add_argument("--avclean", action="store_true",
                   help="VE: the velocity-gradient correction of the viscosity")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (plain PyTorch versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def _report(it: int, d: dict) -> None:
    print(f"it {it:5d}  t={d['ttot']:.6g}  dt={d['dt']:.4g}  "
          f"nc~{d['nc_mean']:.1f} (max {d['nc_max']:.0f})  "
          f"etot={d['etot']:.8g} ecin={d['ecin']:.6g} eint={d['eint']:.8g} "
          f"egrav={d['egrav']:.8g}  "
          f"drift={d['energy_drift']:.3e}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.init not in _INITS:
        raise NotImplementedError(f"--init {args.init!r}: not ported yet")
    state, box, const = _INITS[args.init](args.side, device=args.device)
    sim = Simulation(state, box, const, prop=args.prop, device=args.device,
                     av_clean=args.avclean)
    by_steps = float(args.stop).is_integer()
    while (sim.iteration < int(args.stop)) if by_steps else \
            (float(sim.state.ttot) < args.stop):
        d = sim.step()
        d["ttot"] = float(sim.state.ttot)
        if not args.quiet:
            _report(sim.iteration, d)
    if not args.quiet:
        print(f"# {sim.iteration} steps on {sim.device}, {state.n} particles, "
              f"lists {'on' if sim.lists is not None else 'off'} "
              f"({sim.rebuilds} builds), reconfigures {sim.reconfigures}, "
              f"energy drift {sim.energy_drift}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
