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
    python -m sphexa_torch.app.main --init sedov -n 100 -s 8 --check-every 4 --snap rho,temp \
        --insitu projection --snap-every 4 -o out --telemetry-dir out/tel
    python -m sphexa_torch.app.main --init sedov -n 100 -s 5 --profile --trace-dir out/trace \
        --memory-profile out/mem.pickle -o out
    python -m sphexa_torch.app.main --init sedov -n 30 -s 3 --debug-checks
    python -m sphexa_torch.app.main --init noh -n 14 -s 3 --backend xla --device cpu

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

The app shell: ``--snap rho,temp`` deposits a field grid in every step
(``--snap-grid`` G, a G x G column projection; observables/snapshot.py),
read with the step's scalars, and writes every ``--snap-every``-th
iteration's frame into a ring of ``.npz`` files (``--snap-keep``) under
``<telemetry-dir>/snapshots`` (else ``<outDir>/snapshots``) with a
``snapshot`` event; ``--insitu slice|projection`` renders those frames
as PNGs into ``<outDir>`` every ``--insitu-every`` iterations (without
``--snap`` it deposits rho; the mode names the frames). Every checked
iteration emits a ``phases`` event of its host laps (step, observables,
output); ``--profile`` writes them to ``<outDir>/profile.npz`` with the
split execution of the last state's stages (util/substep_profile.py,
the pair ops K1's streaming kernels on the card). ``--trace-dir``
captures the loop with torch.profiler (CPU activity, and the card's with
a card) into ``<trace-dir>/rank<r>.pt.trace.json`` and attributes its
device time to the step's phases (a ``phase_attr`` event and the ``#
phase attribution`` line, from rank 0's trace). ``--memory-profile
PATH`` records the CUDA caching allocator's history from the start and
dumps its snapshot to PATH at the end (rank 0's). ``--debug-checks``
checks every step for NaN/Inf outputs by phase and out-of-range kernel
index tables (slow, every step checked, lists off; one device only) and
prints the first failure of a step to stderr.

``--backend`` takes the JAX CLI's names: ``pallas`` the pair engine (the
CUDA kernels on the card, their plain versions on the CPU), ``xla`` the
gather path (each particle's first ngmax neighbours, the reference's
truncation, in plain PyTorch on either device; lists off; with
``--devices N`` each rank searches its slab's global groups against a
halo of their whole window cells, every row keeping its one-device
lists), ``auto`` (the default) the engine on every device, where the JAX
CLI's ``auto`` is its gather path off a TPU.
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
from sphexa_torch.observables.snapshot import SnapshotSpec
from sphexa_torch.telemetry import (
    FlightRecorder, JsonlSink, Telemetry, emit_memory_event, save_memory_profile,
    start_memory_history, write_manifest,
)
from sphexa_torch.telemetry.traceview import phase_attr_digest, summarize_trace
from sphexa_torch.util.substep_profile import substep_breakdown
from sphexa_torch.util.timer import ProfileRecorder, Timer
from sphexa_torch.viz import InsituViz


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
    p.add_argument("--profile", action="store_true",
                   help="save a per-iteration timing series to profile.npz")
    p.add_argument("--trace-dir", default=None, dest="trace_dir",
                   help="capture a torch.profiler trace of the run into this directory "
                        "(the step's phases are sphexa/<phase> ranges; a phase_attr event "
                        "attributes the device time); view in Perfetto or chrome://tracing")
    p.add_argument("--memory-profile", default=None, dest="memory_profile",
                   help="write the CUDA caching allocator's snapshot (with its history "
                        "from the start) to this path at the end of the run")
    p.add_argument("--insitu", default=None,
                   help="in-situ rendering: slice | projection (the Ascent/Catalyst "
                        "adaptor role, ascent_adaptor.h). Frames render from the snapshot "
                        "ring at the check/flush boundary, with no read of the card of "
                        "their own")
    p.add_argument("--insitu-every", type=int, default=1, dest="insitu_every",
                   help="render every N iterations (default 1)")
    p.add_argument("--snap", default=None,
                   help="field snapshots deposited in the step and read at the flush "
                        "boundary: comma-separated field list (e.g. 'rho' or 'rho,temp'; "
                        "observables/snapshot.py). Emits snapshot events and a snapshots/ "
                        ".npz ring next to events.jsonl (or --outDir)")
    p.add_argument("--snap-grid", type=int, default=16, dest="snap_grid",
                   help="snapshot grid side G (G x G projection) [16]")
    p.add_argument("--snap-every", type=int, default=None, dest="snap_every",
                   help="emit a snapshot frame every N iterations [--insitu-every when "
                        "--insitu is on, else 1]")
    p.add_argument("--snap-keep", type=int, default=32, dest="snap_keep",
                   help="snapshot ring capacity in .npz frames (0 = unbounded) [32]")
    p.add_argument("--debug-checks", action="store_true", dest="debug_checks",
                   help="check every step for NaN/Inf outputs by phase and out-of-range "
                        "kernel index tables; the first failed check of a step is "
                        "reported per iteration (slow; single-device)")
    p.add_argument("--backend", default="auto", choices=("auto", "pallas", "xla"),
                   help="the force stages' backend: pallas = the pair engine (CUDA kernels), "
                        "xla = the gather path (each particle's first ngmax neighbours, plain "
                        "PyTorch; with --devices the same lists on every rank's slab), "
                        "auto = pallas on every device (unlike the JAX CLI, whose auto is "
                        "xla off a TPU)")
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


def _finish_trace(profiler, trace_dir: str, rank: int, telemetry, log) -> None:
    """Stop the --trace-dir capture, export this rank's chrome trace and,
    on rank 0, attribute its device time to the step's phases: a
    ``phase_attr`` event and the ``# phase attribution`` line. A failed
    parse is reported and never fails the run."""
    profiler.stop()
    path = os.path.join(trace_dir, f"rank{rank}.pt.trace.json")
    profiler.export_chrome_trace(path)
    log(f"# profiler trace -> {trace_dir}")
    if rank != 0:
        return
    try:
        s = summarize_trace(path, top=3)
        telemetry.event("phase_attr", dir=trace_dir, **phase_attr_digest(s))
        log("# phase attribution: "
            + " ".join(f"{p['phase']}={p['share']:.0%}" for p in s["phases"][:5])
            + f" (coverage {s['coverage']:.0%})")
    except Exception as e:
        print(f"# trace attribution failed: {e}", file=sys.stderr)


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

        if args.debug_checks:
            print("debug_checks is single-device; drop --devices or the flag",
                  file=sys.stderr)
            return 2
        if not dist.is_initialized():
            return _spawn_ranks(args, argv)
        rank = dist.get_rank()
    if args.memory_profile and rank == 0:
        # the allocator's history from the start, for the dump at the end
        start_memory_history()

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
    # --snap: field grids deposited in the step, read at the flush
    # boundary; --insitu without --snap deposits rho, so that the renderer
    # reads the ring rather than the particles
    snap_spec = snap_every = snap_dir = None
    snap_fields = None
    if args.snap:
        snap_fields = tuple(f.strip() for f in args.snap.split(",") if f.strip())
    elif args.insitu:
        snap_fields = ("rho",)
    if snap_fields:
        try:
            snap_spec = SnapshotSpec(fields=snap_fields, grid=args.snap_grid)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            if recorder is not None:
                recorder.close()  # a usage error, not a crash: no blackbox
            return 2
        snap_every = args.snap_every or (args.insitu_every if args.insitu else 1)
        snap_dir = os.path.join(args.telemetry_dir or args.out_dir, "snapshots")
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
                         halo_mode=args.halo_mode, imbalance_ratio=args.imbalance_ratio,
                         snap_spec=snap_spec, snap_every=snap_every,
                         snap_keep=args.snap_keep, snap_dir=snap_dir,
                         debug_checks=args.debug_checks, backend=args.backend)
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

    timer = Timer(telemetry=telemetry)
    # the in-situ adaptor: init before the loop, execute per frame,
    # finalize after (sphexa.cpp:141-142,172,179 hook points)
    insitu = None
    if args.insitu:
        try:
            insitu = InsituViz(args.out_dir, mode=args.insitu, every=args.insitu_every)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            if recorder is not None:
                recorder.close()  # a usage error, not a crash: no blackbox
            return 2
        insitu.init()

    def consume_snapshots():
        """The ring's new frames into the renderer: host pixel work on
        frames read at a check or flush boundary, no read of the card."""
        for fit, fpath in sim.drain_snapshots():
            if insitu is None:
                continue
            try:
                with np.load(fpath, allow_pickle=False) as f:
                    grid = np.asarray(f["grid"])
            except (OSError, ValueError, KeyError):
                continue  # pruned from the ring, or a partial write
            insitu.execute_grid(grid, fit)

    profile = ProfileRecorder()
    t0 = time.time()
    it0 = sim.iteration
    profiler = None
    if args.trace_dir:
        # the whole loop, the step's sphexa/<phase> ranges inside
        os.makedirs(args.trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if sim.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        telemetry.event("trace", dir=args.trace_dir)

    def out_of_time() -> bool:
        """The --duration decision; on ranks rank 0's clock, broadcast, so
        that every rank stops at the same iteration."""
        late = time.time() - t0 >= args.duration
        return late if ranks is None else broadcast_flag(sim.mesh, late)

    try:
        while True:
            timer.start()
            d = sim.step()
            timer.step("step")
            it = sim.iteration
            if args.debug_checks and d.get("check_error"):
                print(f"# debug-checks it {it}: {d['check_error']}", file=sys.stderr)
            if d.get("deferred"):
                # mid-window: nothing may read the card here, so only the
                # iteration count and the wall clock end the run before the
                # window's flush
                timer.pop()
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
            timer.step("observables")
            maybe_dump(it)
            consume_snapshots()  # the ring's frames into PNGs (--insitu)
            timer.step("output")
            laps = timer.pop()
            telemetry.event("phases", it=it, **{k: round(v, 6) for k, v in laps.items()})
            if args.profile:
                profile.record(it, laps, dt=float(d.get("dt", nan)),
                               nc_mean=float(d.get("nc_mean", nan)))
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
    finally:
        if profiler is not None:
            _finish_trace(profiler, args.trace_dir, rank, telemetry, log)
    # the last open window is verified, and its rows land, before the report
    sim.flush()
    write_science_rows()
    consume_snapshots()  # the frames the trailing flush landed
    wall = time.time() - t0
    n_done = sim.iteration - it0
    if args.profile:
        # the stages of the last state, split and timed (the reference's
        # per-phase Timer print); a series only where iterations were
        # recorded
        sub = substep_breakdown(sim, telemetry=telemetry) if profile.rows else {}
        if sub:
            log("# substeps (s, split-execution upper bound): "
                + " ".join(f"{k}={v:.4f}" for k, v in sub.items()))
        if rank == 0:
            profile_path = os.path.join(args.out_dir, "profile.npz")
            if profile.save(profile_path, substeps=sub):
                means = profile.summary()
                log("# profile (mean s/iter): " + " ".join(
                    f"{k}={v:.4f}" for k, v in means.items()
                    if k in ("step", "observables", "output")))
                log(f"# timing series -> {profile_path}")
            else:
                print("# --profile: no iterations recorded, profile.npz not written",
                      file=sys.stderr)
    if insitu is not None:
        log(f"# insitu: {insitu.finalize()} frames -> {args.out_dir}")
    if args.memory_profile and rank == 0:
        if save_memory_profile(args.memory_profile):
            log(f"# device-memory profile -> {args.memory_profile}")
        else:
            print("# --memory-profile: profiler unavailable, no dump written",
                  file=sys.stderr)
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
