"""Command-line front end of the port, restricted to its ported slices:

    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 [--device cpu]
    python -m sphexa_torch.app.main --init noh -n 50 -s 20
    python -m sphexa_torch.app.main --init gresho-chan -n 50 -s 20 --prop ve [--avclean]
    python -m sphexa_torch.app.main --init evrard -n 125 -s 5 --prop ve
    python -m sphexa_torch.app.main --init evrard -n 125 -s 5 --prop nbody
    python -m sphexa_torch.app.main --init turbulence -n 100 -s 10 --prop turb-ve [--avclean]
    python -m sphexa_torch.app.main --init evrard-cooling -n 125 -s 5 --prop std-cooling \\
        [--evolve-chem]
    python -m sphexa_torch.app.main --init kelvin-helmholtz -n 100 -s 5 [--glass tpl.h5]
    python -m sphexa_torch.app.main --init wind-shock -n 64 -s 5
    python -m sphexa_torch.app.main --init isobaric-cube -n 100 -s 5 [--kernel wendland-c6]
    python -m sphexa_torch.app.main --init sedov -n 100 -s 16 --dt-bins 4 \\
        [--bin-sync-every 1] [--bin-resort-drift 0.01]
    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 --G 0.5
    python -m sphexa_torch.app.main --init sedov -n 100 -s 100 --check-every 8 \\
        -o out --telemetry-dir out/tel
    python -m sphexa_torch.app.main --init sedov -n 12 -s 4 -w 2 -o out
    python -m sphexa_torch.app.main --init out/dump_sedov.h5:0 -s 6 -o out
    python -m sphexa_torch.app.main --init sedov -n 12 -s 3 --devices 2 --device cpu
    python -m sphexa_torch.app.main --init evrard -n 16 -s 3 --prop ve --devices 2 --device cpu
    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 --devices 4 [--halo-mode windowed]
    python -m sphexa_torch.app.main --init turbulence -n 16 -s 3 --prop turb-ve --devices 2 \
        --device cpu
    python -m sphexa_torch.app.main --init evrard -n 12 -s 3 --prop nbody --devices 2 --device cpu
    python -m sphexa_torch.app.main --init sedov -n 10 -s 8 --dt-bins 4 --devices 2 --device cpu

Flag names follow the JAX package's CLI (sphexa_tpu/app/main.py). ``-s``
is a number of iterations when it is an integer, else a simulated time;
under ``--check-every N`` the iteration count applies at every step and
a simulated time only at check boundaries (reading the time would read
the card mid-window). ``--prop`` is std, ve, turb-ve (VE with the OU
turbulence stirring; ``--avclean`` applies to it and to ve only), std-cooling
(std with radiative cooling; ``--evolve-chem`` evolves the primordial
network in place of the CIE table) or nbody (gravity alone: the case
needs a gravitational constant); another name is a usage error. Every
case of the JAX package runs (sedov, noh, gresho-chan, evrard,
isobaric-cube, kelvin-helmholtz, wind-shock, turbulence,
evrard-cooling); a name that is no case raises "unknown test case".
``--glass`` tiles a glass template (HDF5, e.g. from
``scripts/make_glass.py``) into every lattice of the case; ``--kernel``
(sinc, sinc-n1-n2, wendland-c6) and ``--sincIndex`` choose the SPH
kernel, its normalization recomputed. ``--dt-bins B`` (std and ve) runs
hierarchical block time steps with B power-of-two dt bins, each
iteration a substep; ``--bin-sync-every`` and ``--bin-resort-drift`` set
the re-bin cadence and the sort's keep threshold. Steps run on persistent
neighbour lists wherever the grid allows them, as in the JAX CLI, which
has no flag for it. A case with a gravitational constant (Evrard, or
``--G``) runs self-gravity, whose steps sort every time: open boxes
Barnes-Hut, fully periodic cubic boxes (Sedov with ``--G``) Ewald;
``--theta`` sets the opening angle and ``--m2p-cap-margin`` the margin
of the sampled M2P list cap. Every step's science ledger
lands in ``<outDir>/constants.txt`` (one row per step, also under
deferral).

Dumps: ``-w`` (an integer: every N iterations; a float: every simulated
time interval) and ``--wextra`` (one-shot iterations or times) append a
restartable ``Step#n`` to ``<outDir>/dump_<case>.h5`` (h5py needed, as in
the JAX CLI), with the output fields (rho, p, u, vel, c, r; ``-f`` picks
some) recomputed by the pair engine, and the turb-ve stirring state
(``turb_*``) or the std-cooling chemistry (``chem_*``) in the JAX
package's names and dtypes; ``--ascii`` writes text columns
instead (not restartable). ``--duration`` ends the run after that many
wall seconds, with a final dump when dumps are on. ``--init
<dump>[:step]`` restarts from a dump (the JAX package's too, ``.h5`` or
``.npz``; a dump's stirring state or chemistry resumes with its
propagator): the iteration count continues (an integer ``-s`` is the end
iteration), the case and its settings come from the dump, dumps append
to the case's file and ``constants.txt`` loses its rows past the
restart point. ``--init <dump>,N`` up-samples a dump N-fold, ``--init
case:settings.json`` overrides a case's settings.

``--telemetry-dir`` writes the run directory the JAX package's
``sphexa-telemetry`` reads: ``manifest.json``, ``events.jsonl`` (the
driver's events and the memory events), and on an abnormal end
``blackbox.json`` (the flight recorder). Runs on the CUDA device unless
``--device cpu`` is given, and raises without one.

``--devices N`` (every propagator and ``--dt-bins``, with self-gravity
too: the evrard inits, ``--G`` on a periodic box) runs N ranks, each a
process of its own holding one Hilbert-key slab (sphexa_torch/parallel):
``--device cpu`` runs them on gloo, otherwise NCCL puts rank r on card r
and refuses fewer cards than ranks. A count that does not divide by N
loses its trailing rows. ``--halo-mode`` picks the halo exchange (sparse
per-distance caps, or one window per peer), ``--imbalance-ratio`` the
threshold of the ``imbalance`` events. Rank 0 alone prints, writes
``constants.txt`` and the telemetry; ``-w`` and ``--wextra`` write one
part file a rank (``dump_<case>.part<k>of<N>.h5``, the JAX package's
sharded dumps) with its rows' conserved and derived fields (computed
across the ranks, never gathered; the stirring state in part 0), which a
restart reads with any N; ``--ascii`` gathers the columns to rank 0,
which writes one file in global row order; ``--duration`` is decided on
rank 0's clock at a check boundary and broadcast, so that every rank
stops at the same iteration with the same final dump.
"""

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from sphexa_torch.analysis.compare import output_fields
from sphexa_torch.init import CASES, make_initializer, split_case_spec
from sphexa_torch.init.file_init import looks_like_file, parse_file_spec
from sphexa_torch.init.glass import set_glass_template
from sphexa_torch.io import read_snapshot_full, write_ascii, write_snapshot
from sphexa_torch.io.snapshot import CONSERVED_FIELDS, _find_parts, write_snapshot_sharded
from sphexa_torch.observables import ConstantsWriter, make_observable, make_observable_spec
from sphexa_torch.parallel.mesh import broadcast_flag, gather_rows
from sphexa_torch.physics.cooling import (
    CoolingConfig, chemistry_from_fields, chemistry_to_fields,
)
from sphexa_torch.simulation import _STEPS, Simulation
from sphexa_torch.sph.hydro_turb import (
    turbulence_state_from_fields, turbulence_state_to_fields,
)
from sphexa_torch.sph.kernels import KERNEL_CHOICES
from sphexa_torch.telemetry import (
    FlightRecorder, JsonlSink, Telemetry, emit_memory_event, write_manifest,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphexa-torch",
        description="SPH on an NVIDIA GPU (PyTorch/CUDA port; std and VE SPH, "
                    "turbulence stirring, radiative cooling, self-gravity, N-body, "
                    "block time steps)",
    )
    p.add_argument("--init", default="sedov",
                   help="test case name (sedov, noh, gresho-chan, evrard, isobaric-cube, "
                        "kelvin-helmholtz, wind-shock, turbulence, evrard-cooling), "
                        "case:settings.json, a dump to restart from (path[:step]) "
                        "or path,N to up-sample one")
    p.add_argument("-n", type=int, default=50, dest="side",
                   help="particles per cube side (N = n^3)")
    p.add_argument("-s", type=float, default=10, dest="stop",
                   help="integer: number of iterations (on restart: the end "
                        "iteration); float: simulated time")
    p.add_argument("-w", type=float, default=-1, dest="write_every",
                   help="integer: dump every N iterations; float: every t interval")
    p.add_argument("-f", default="", dest="out_fields",
                   help="output fields to dump besides the conserved ones "
                        "(comma-separated; default all)")
    p.add_argument("-o", "--outDir", default=".", dest="out_dir",
                   help="output directory (constants.txt, dumps)")
    p.add_argument("--prop", default="std",
                   help="propagator: std | ve | turb-ve | std-cooling | nbody")
    p.add_argument("--avclean", action="store_true",
                   help="ve, turb-ve: the velocity-gradient correction of the viscosity")
    p.add_argument("--evolve-chem", action="store_true", dest="evolve_chem",
                   help="std-cooling: evolve the 6-species primordial network (species "
                        "ODEs and composition-resolved cooling) in place of the CIE table")
    p.add_argument("--theta", type=float, default=0.5,
                   help="gravity MAC accuracy parameter [0.5]")
    p.add_argument("--G", type=float, default=None, dest="grav_constant",
                   help="gravitational constant override (enables gravity)")
    p.add_argument("--m2p-cap-margin", type=float, default=None, dest="m2p_cap_margin",
                   help="gravity M2P interaction-list cap margin [1.3]; the M2P cost is "
                        "linear in the cap, an overflow is caught and re-sized")
    p.add_argument("--sym-pairs", default=None, choices=("on", "off"), dest="sym_pairs",
                   help="momentum/energy pair-cutoff convention: on = min-h symmetric "
                        "(default), off = the reference's one-sided; overrides the "
                        "snapshot's symPairs attribute")
    p.add_argument("--glass", default=None,
                   help="glass template HDF5 file, tiled into every lattice-based IC "
                        "(init/utils.hpp glass blocks); without it a procedural jittered "
                        "lattice is used")
    p.add_argument("--kernel", default=None,
                   help="SPH kernel family: sinc | sinc-n1-n2 | wendland-c6 "
                        "(sph_kernel_tables.hpp SphKernelType)")
    p.add_argument("--sincIndex", type=float, default=None, dest="sinc_index",
                   help="sinc kernel exponent n (default: case setting)")
    p.add_argument("--dt-bins", type=int, default=None, dest="dt_bins",
                   help="hierarchical block time steps: number of power-of-two "
                        "per-particle dt bins (std/ve propagators; unset = the global dt, "
                        "1 = the global step)")
    p.add_argument("--bin-sync-every", type=int, default=1, dest="bin_sync_every",
                   help="cycles between bin reassignments at the sync substep (block-dt "
                        "mode; default 1)")
    p.add_argument("--bin-resort-drift", type=float, default=0.0, dest="bin_resort_drift",
                   help="keep the particle order while folded-key inversions stay under "
                        "this fraction of n (block-dt mode; default 0 = resort on any "
                        "inversion)")
    p.add_argument("--wextra", default="",
                   help="comma-separated extra output triggers: integers = "
                        "iterations, floats = simulation times")
    p.add_argument("--ascii", action="store_true",
                   help="dump ASCII columns instead of HDF5 (not restartable)")
    p.add_argument("--duration", type=float, default=None,
                   help="maximum wall-clock run time in seconds; dumps a final "
                        "snapshot before exiting if dumps are on")
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
                   help="write the run directory (manifest.json, events.jsonl, and "
                        "blackbox.json on an abnormal end) to this directory")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (plain PyTorch versions)")
    p.add_argument("--devices", type=int, default=None,
                   help="run N ranks, one SFC slab each (gloo with --device cpu, else NCCL "
                        "on N cards; default: one device)")
    p.add_argument("--halo-mode", default="sparse", choices=("sparse", "windowed"),
                   dest="halo_mode",
                   help="the ranks' halo exchange: per-distance cell-granular caps "
                        "(default) or one contiguous window per peer")
    p.add_argument("--imbalance-ratio", type=float, default=1.5, dest="imbalance_ratio",
                   help="imbalance-watchdog threshold on max/mean of the per-rank load "
                        "and exchange metrics ('imbalance' events) [1.5]")
    p.add_argument("--quiet", action="store_true")
    return p


def _rank_main(mesh, argv: List[str]) -> int:
    """One rank of a ``--devices`` run: the CLI inside the process group."""
    return main(argv)


def _spawn_ranks(args, argv: List[str]) -> int:
    """Start the ``--devices`` ranks (parallel/mesh.py ``spawn``; the
    rendezvous in a temporary directory) and return rank 0's exit code."""
    import shutil
    import tempfile

    from sphexa_torch.parallel.mesh import spawn

    if args.device is None and torch.cuda.device_count() < args.devices:
        print(f"--devices {args.devices}: NCCL needs one card per rank, "
              f"{torch.cuda.device_count()} present (--device cpu runs gloo ranks)",
              file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="sphexa-ranks-")
    try:
        # CPU ranks share the cores
        threads = max(1, (os.cpu_count() or 1) // args.devices) if args.device == "cpu" \
            else None
        return spawn(_rank_main, args.devices, args=(argv,), workdir=workdir,
                     device=args.device, threads=threads, timeout=float("inf"))[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.prop not in _STEPS:
        print(f"unknown --prop {args.prop!r}; available: {sorted(_STEPS)}", file=sys.stderr)
        return 2
    if args.avclean and args.prop not in ("ve", "turb-ve"):
        print("--avclean only applies to --prop ve | turb-ve; ignoring", file=sys.stderr)
    nan = float("nan")
    ranks = args.devices if args.devices and args.devices > 1 else None
    rank = 0
    if ranks is not None:
        import torch.distributed as dist

        if not dist.is_initialized():
            return _spawn_ranks(args, argv)
        rank = dist.get_rank()

    def log(line: str) -> None:
        if not args.quiet and rank == 0:
            print(line, flush=True)

    # 'case:settings.json' selects the case with overrides; observables key
    # on the bare case name, with the overrides applied to their thresholds
    case_name, settings_path = split_case_spec(args.init)
    case_overrides = None
    if settings_path is not None:
        try:
            with open(settings_path) as f:
                case_overrides = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read settings file {settings_path}: {e}", file=sys.stderr)
            return 2
        if not isinstance(case_overrides, dict):
            print(f"{settings_path} must hold a JSON object", file=sys.stderr)
            return 2
    # built-in case names take precedence over same-named files, as in
    # make_initializer; a restart reads the snapshot once
    is_restart = args.init not in CASES and looks_like_file(args.init)
    restart_iteration = 0
    turb_state, turb_cfg, chem = None, None, None
    if is_restart:
        state, box, const, extra, attrs = read_snapshot_full(
            *parse_file_spec(args.init), device=args.device)
        restart_iteration = int(attrs.get("iteration", 0))
        case_name = np.asarray(attrs["initCase"]).item().decode() if "initCase" in attrs else ""
        if case_overrides is None and "caseSettings" in attrs:
            # threshold-bearing observables see the original run's overrides
            case_overrides = json.loads(np.asarray(attrs["caseSettings"]).item().decode())
        # the propagator's aux state resumes: the chemistry, or the OU
        # stirring's phases, key and config (turb_ve.hpp:88-97)
        if args.prop == "std-cooling" and "chem_hi" in extra:
            chem = chemistry_from_fields(extra, device=state.x.device)
        if args.prop == "turb-ve" and "turb_phases" in extra:
            turb_state, turb_cfg = turbulence_state_from_fields(extra, device=state.x.device)
    else:
        if args.glass:
            # installed for this initializer only, cleared after it
            try:
                set_glass_template(args.glass)
            except (OSError, RuntimeError) as e:
                print(f"cannot read glass template {args.glass}: {e}", file=sys.stderr)
                return 2
            log(f"# tiling glass template {args.glass}")
        try:
            initializer = make_initializer(args.init)
            state, box, const = initializer(args.side, device=args.device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        finally:
            set_glass_template(None)
    if ranks is not None and state.n % ranks:
        # equal slabs: the trailing rows go (cases whose counts are no
        # lattice, sphere cuts, already end at an arbitrary row)
        keep = state.n // ranks * ranks
        if rank == 0:
            print(f"# trimming {state.n - keep} trailing particles for an even "
                  f"{ranks}-way slab decomposition", file=sys.stderr)
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[:keep] for f in dataclasses.fields(state)
            if getattr(state, f.name).dim() >= 1})
    if args.grav_constant is not None:
        const = dataclasses.replace(const, g=args.grav_constant)
    if args.sym_pairs is not None:
        const = dataclasses.replace(const, sym_pairs=(args.sym_pairs == "on"))
    if args.kernel is not None or args.sinc_index is not None:
        kind = args.kernel or const.kernel_choice
        if kind not in KERNEL_CHOICES:
            print(f"unknown --kernel {kind!r}; choices: {KERNEL_CHOICES}", file=sys.stderr)
            return 2
        const = const.with_kernel(kind, args.sinc_index)
    cooling_cfg = None
    if args.prop == "std-cooling" and args.evolve_chem:
        cooling_cfg = CoolingConfig(gamma=const.gamma, evolve_species=True)

    # the observable names the constants.txt columns; the values come
    # from the step's ledger (the matching ObservableSpec)
    observable = make_observable(case_name, overrides=case_overrides)
    sinks, recorder = [], None
    tel_dir = args.telemetry_dir if rank == 0 else None
    if tel_dir:
        sinks.append(JsonlSink(os.path.join(tel_dir, "events.jsonl")))
    telemetry = Telemetry(sinks=sinks)
    if tel_dir:
        # the flight recorder explains a run whose events end early
        recorder = FlightRecorder(args.telemetry_dir, telemetry=telemetry)
        telemetry.sinks.append(recorder.sink)
        recorder.install()
    try:
        sim = Simulation(state, box, const, prop=args.prop, device=args.device,
                         av_clean=args.avclean and args.prop in ("ve", "turb-ve"),
                         turb_state=turb_state, turb_cfg=turb_cfg, chem=chem,
                         cooling_cfg=cooling_cfg, check_every=args.check_every,
                         obs_spec=make_observable_spec(case_name, overrides=case_overrides),
                         telemetry=telemetry, science_rows=True,
                         drift_budget=args.drift_budget, theta=args.theta,
                         m2p_cap_margin=args.m2p_cap_margin, dt_bins=args.dt_bins,
                         bin_sync_every=args.bin_sync_every,
                         bin_resort_drift=args.bin_resort_drift, num_devices=ranks,
                         halo_mode=args.halo_mode, imbalance_ratio=args.imbalance_ratio)
    except (NotImplementedError, ValueError) as e:
        print(str(e), file=sys.stderr)
        if recorder is not None:
            # a run that cannot even start ends abnormally: a blackbox names the cause
            recorder.dump(reason=f"simulation construction failed: {e}")
            recorder.close()
        return 2
    if tel_dir:
        recorder.manifest = write_manifest(
            args.telemetry_dir,
            config={k: v for k, v in vars(args).items()
                    if isinstance(v, (str, int, float, bool, type(None)))},
            particles=state.n, device=sim.device,
            extra={"case": case_name or args.init, "prop": args.prop})
        # the baseline the post-compile and flush snapshots are read against
        emit_memory_event(telemetry, "manifest", devices=[sim.device])
        log(f"# telemetry -> {args.telemetry_dir}")
    if is_restart:
        # the iteration numbering continues; an integer -s is the end iteration
        sim.iteration = restart_iteration
        log(f"# restart from iteration {sim.iteration}, t={float(state.ttot):.6g}"
            + (f" (case {case_name})" if case_name else ""))
    num_steps = int(args.stop) if float(args.stop).is_integer() else None
    target_time = None if num_steps is not None else float(args.stop)

    os.makedirs(args.out_dir, exist_ok=True)
    dump_path = None
    w = args.write_every
    w_steps = int(w) if w > 0 and float(w).is_integer() else None
    w_time = w if w > 0 and w_steps is None else None
    next_dump_time = [float(state.ttot) + w_time] if w_time else None
    if w > 0 or args.wextra:
        # a restart keeps dumping under the original case's name (Step#n
        # groups appended to the restarted file)
        tag_src = case_name if (is_restart and case_name) else args.init
        case_tag = "".join(c if c.isalnum() else "_" for c in tag_src)
        dump_path = f"{args.out_dir}/dump_{case_tag}.{'txt' if args.ascii else 'h5'}"
        # a previous run's leftovers would interleave their steps with ours
        if args.ascii:
            stale = glob.glob(f"{args.out_dir}/dump_{case_tag}_it*.txt")
        elif not is_restart:
            stale = ([dump_path] if os.path.exists(dump_path) else []) + _find_parts(dump_path)
        else:
            stale = []
        if rank != 0:
            stale = []
        for f in stale:
            print(f"# removing stale {f}", file=sys.stderr)
            os.remove(f)
    want_fields = [f for f in args.out_fields.split(",") if f]

    # --wextra: one-shot triggers, integers = iterations, floats = times
    wextra_steps, wextra_times = set(), []
    for tok in (t for t in args.wextra.split(",") if t):
        try:
            val = float(tok)
        except ValueError:
            print(f"--wextra: cannot parse {tok!r} (expected comma-separated "
                  "integers or floats)", file=sys.stderr)
            if recorder is not None:
                recorder.close()  # a usage error, not a crash: no blackbox
            return 2
        if val.is_integer() and "." not in tok:
            wextra_steps.add(int(val))
        else:
            wextra_times.append(val)
    wextra_times.sort()

    constants_path = os.path.join(args.out_dir, "constants.txt")
    if rank == 0 and not is_restart and os.path.exists(constants_path):
        os.remove(constants_path)
    constants = ConstantsWriter(constants_path, observable,
                                restart_iteration=restart_iteration if is_restart else None) \
        if rank == 0 else None

    def write_science_rows():
        """The verified ledger rows into constants.txt, one per step (a
        deferred window's land whole at its flush): host I/O only, on
        rank 0 (every rank holds the same rows)."""
        rows = sim.drain_science()
        for r in rows if constants is not None else ():
            constants.write_row([r["it"], r["t"], r["dt"], r["etot"], r["ecin"], r["eint"],
                                 r["egrav"]] + ([r["extra"]] if "extra" in r else []))
        return rows

    last_dump_iteration = [None]

    def dump_now(it):
        """One output: a restartable snapshot, or text columns with
        --ascii; the derived fields recomputed by the propagator's own
        density estimator. On ranks each writes its part (the derived
        fields of its rows, the stirring state in part 0), and --ascii
        gathers the columns to rank 0, which writes one file in global
        row order."""
        last_dump_iteration[0] = it
        extra = output_fields(sim.state, sim.box, sim.cfg,
                              pipeline="ve" if args.prop in ("ve", "turb-ve") else "std")
        if want_fields:
            unknown = [f for f in want_fields if f not in extra]
            if unknown and rank == 0:
                print(f"# -f fields not available, skipped: {unknown}", file=sys.stderr)
            extra = {k: v for k, v in extra.items() if k in want_fields}
        if args.ascii:
            cols = {f: getattr(sim.state, f) for f in CONSERVED_FIELDS}
            cols.update(extra)
            path = dump_path.replace(".txt", f"_it{it}.txt")
            if ranks is not None:
                whole = gather_rows(sim.mesh, torch.stack(list(cols.values()), dim=1))
                if whole is None:
                    return
                cols = dict(zip(cols, whole.unbind(1)))
            write_ascii(path, cols)
            log(f"# wrote ASCII dump -> {path} (not restartable)")
            return
        tables = {}
        if sim.turb_state is not None:
            tables = turbulence_state_to_fields(sim.turb_state, sim.turb_cfg)
        if sim.chem is not None:
            extra = {**extra, **chemistry_to_fields(sim.chem)}
        if ranks is not None:
            # one part file a rank: its rows, the global tables in part 0
            step = write_snapshot_sharded(
                dump_path, sim.state, sim.box, sim.const, iteration=it, case=case_name,
                case_settings=case_overrides, mesh=sim.mesh, extra_fields=extra,
                global_fields=tables)
            log(f"# wrote Step#{step} -> {ranks} parts of {dump_path}")
            return
        step = write_snapshot(dump_path, sim.state, sim.box, sim.const, iteration=it,
                              extra_fields={**extra, **tables}, case=case_name,
                              case_settings=case_overrides)
        log(f"# wrote Step#{step} -> {dump_path}")

    def maybe_dump(it):
        """The -w schedule and the --wextra triggers."""
        if dump_path is None:
            return
        t_now = float(sim.state.ttot)
        due = (w_steps is not None and it % w_steps == 0) or (
            next_dump_time is not None and t_now >= next_dump_time[0])
        if it in wextra_steps:
            due = True
        while wextra_times and t_now >= wextra_times[0]:
            wextra_times.pop(0)
            due = True
        if not due:
            return
        if next_dump_time is not None:
            # one dump for a step that crosses several intervals
            while t_now >= next_dump_time[0]:
                next_dump_time[0] += w_time
        dump_now(it)

    t0 = time.time()
    it0 = sim.iteration

    def out_of_time() -> bool:
        """The --duration decision; on ranks rank 0's clock, broadcast, so
        that every rank stops at the same iteration."""
        late = time.time() - t0 >= args.duration
        return late if ranks is None else broadcast_flag(sim.mesh, late)

    while True:
        d = sim.step()
        it = sim.iteration
        if d.get("deferred"):
            # mid-window: nothing may read the card here, so only the
            # iteration count and the wall clock end the run before the
            # window's flush
            log(f"it {it:5d}  (deferred check)")
            if num_steps is not None and it >= num_steps:
                break
            # ranks decide on rank 0's clock at check boundaries only
            if ranks is None and args.duration is not None \
                    and time.time() - t0 >= args.duration:
                log(f"# wall-clock limit {args.duration}s reached at iteration {it}")
                sim.flush()  # verify the window and land its rows
                write_science_rows()
                if dump_path is not None and last_dump_iteration[0] != it:
                    dump_now(it)
                break
            continue
        rows = write_science_rows()
        maybe_dump(it)
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
        if args.duration is not None and out_of_time():
            # the wall-clock cutoff leaves a final restartable dump
            log(f"# wall-clock limit {args.duration}s reached at iteration {it}")
            if dump_path is not None and last_dump_iteration[0] != it:
                dump_now(it)
            break
    # the last open window is verified, and its rows land, before the report
    sim.flush()
    write_science_rows()
    wall = time.time() - t0
    n_done = sim.iteration - it0
    telemetry.event("run_end", iterations=n_done, wall_s=round(wall, 3))
    telemetry.close()
    if recorder is not None:
        recorder.close()  # a clean exit: the hooks disarmed, no blackbox
    log(f"# {n_done} steps on {sim.device}, {state.n} particles, "
        f"lists {'on' if sim.lists is not None else 'off'} "
        f"({sim.rebuilds} builds), reconfigures {sim.reconfigures}, "
        f"rollbacks {sim.rollbacks}, energy drift {sim.energy_drift}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
