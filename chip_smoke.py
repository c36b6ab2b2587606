#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sphexa_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile the hand-written CUDA kernels from sphexa_torch/csrc;
3. kernels vs plain: every pair-engine kernel, std and VE (both forms of
   divv/curlv and of VE momentum), against its plain PyTorch version on
   the card, on the sorted Sedov state at side 24 with cell_target=16
   (per-run shift path) and side 12 (min-image fold path), the lattice
   jittered from a seed so that every term of each pair body is non-zero;
   whole steps on the card against the same steps on the CPU, std and VE,
   streaming and in list mode (two steps each), and one step of VE
   Gresho-Chan side 20 (a fold-mode grid: it streams);
4. lists vs plain: the list build (K5: merge, mark and prune in one
   kernel, bit for bit, also at a slot budget of 2 that overflows) and the
   list walk of every SPH op (density, IAD, grad-h, both forms of
   divv/curlv, the AV switches, both momentum ops) against their plain
   versions, and list mode against the streaming kernels with fresh runs,
   on the jittered Sedov side 30, Noh 16 (open box) and mixed-box
   (Sedov 24 stretched in z, periodic x, open y and z) states; K5 also on
   synthetic cells that hold every edge of the run merge
   (``checks.synthetic_cull``);
5. std main path: Sedov 100^3 (10^6 particles) through
   Simulation(prop="std") on the card, which runs persistent neighbour
   lists: one warm-up step (the first list build) and ten timed steps,
   with the launch counters reset just before the Simulation is made and
   read just after (in list mode every SPH op launches the list walk once
   per step attempt and the streaming engine never); then one step with
   torch's CUDA sync debug mode on,
   to count the host syncs per step and where they come from, two more
   steps under torch.profiler for the device time per step and the device
   busy share, and one list rebuild split into its parts by CUDA events
   (sort, cull, K5, word offsets and buffer; the whole; the plain
   composition of the build);
6. the std streaming path: the same through Simulation(use_lists=False),
   one warm-up and five timed steps, counters reset just before and read
   just after, its host syncs and profile;
7. the VE path: Sedov 100^3 through Simulation(prop="ve") in list mode,
   one warm-up and ten timed steps, launches, host syncs and profile;
   then two short VE paths that launch the VE entry points the list mode
   leaves out: streaming (use_lists=False) and av_clean in list mode, one
   warm-up and three timed steps each;
8. kernels vs plain again at the paths' shapes (the evolved side-100
   states of phases 5-7), with each kernel's time (the list walk in the
   mask mode its path runs it in, and running its own mask), its plain
   version's time, the sort/prologue times and each kernel's least
   possible time (bound; for the list walk also the bound of the
   streaming engine over the lists' pruned runs, list mode's form before
   the walk carried every op; K5 also alone, its entry point launched
   back to back);
9. the std main path's Simulation on to step 100: list rebuilds, replays
   and the mean and median step time, the rebuilds included; then the
   deferred path, std Sedov 100^3 in list mode as bench.py drives the JAX
   package's (``check_every=8``, the science ledger in the step, its
   events to a MemorySink), from step 0 to 100, and the same with
   ``check_every`` 4 and 1 (the rollback cadence): windows, rollbacks by
   reason, replays, rebuilds, the per-step wall over steps 14-100 (a
   window's calls over its steps), 100 science rows, the drift and the
   launch contract; a second check_every-8 run from step 0 to 100 whose
   windows are counted for host syncs (one in a window without a rollback,
   plus two per list build; asserted) or, until one without a build or a
   rollback is found, profiled (its device busy share); then the deferred
   windows' checks
   (``kernels/deferred_checks.py``): the cap forced to 8 (Sedov 30) and h
   x 4 before a window (Sedov 32) roll back and replay to a clean run, a
   deferred streaming run equals the checked one bit for bit (Sedov 30),
   and a VE list-mode window on stale lists replays (Sedov 30); then
   ``io_restart``: std Sedov 100^3 in list mode to step 20, dumped (.npz
   with the output fields, K1's density op) and read back bit for bit,
   restarted beside the unbroken run to step 40 (its first step within
   dt rel 1e-6 and x 1e-7, every field at step 40 within
   ``io_checks.RESTART_BOUND`` of its scale; launch counts reset just
   before and read just after), the output fields against their plain
   versions (std; VE: xmass and grad-h) with one call's time, the
   reference CI's configurations (std and VE Sedov, Noh; side 50, 200
   steps) inside tests/test_l1_reference.py's L1 windows, and the CLI
   restarted from the dump in a process of its own (constants.txt rows,
   manifest, events, memory events, no blackbox);
10. gravity vs plain: the list compaction (K13) on the JAX package's
   random cases and the widths its tiles cut, exactly; the near field
   (K12) on Evrard 20's leaf ranges, every block, in the open-box form and
   in an image's (a target shift), with the self pair kept and dropped;
   whole gravity solves on the card against the CPU on Evrard 30, in the
   sort and the bitmask-with-superblocks compactions; std and VE Evrard
   20 steps with gravity on the card against the CPU;
11. the Evrard path: VE Evrard side 125 (1,022,790 particles) through
   Simulation(prop="ve"), self-gravity on: one warm-up and two timed
   steps, counters reset just before and read just after (K12 once and
   K13 twice per step attempt, the six VE kernels once each), its host
   syncs and profile, the tree build at configure and the gravity phases
   by CUDA events (multipoles, MAC with K13, M2P, the near-field
   prologue (the leaf ranges), K12), the tree's forces against
   direct summation on 4,096 sampled targets, K12 against its plain
   version on 256 target blocks and K13 on the solve's own packed arrays,
   each kernel's time (K13's also per launch; for both also the kernels'
   own device time, its entry point launched back to back with the
   arguments built once, and for K12 the SM clock that nvidia-smi reads
   under that load), its plain version's, its bound and (K13) the time of
   torch.sort of the same rows; the near field's candidates per block
   (mean, 99th percentile, max) and K13's shapes;

12. spherical multipoles: open-box solves at the Evrard path's state with
   the cartesian quadrupole and orders 4 and 6, each timed and held
   against direct summation (order 4 closer than the quadrupole);
13. the N-body path: Simulation(prop="nbody") on the 10^6-particle
   Plummer sphere and on Evrard 125, one warm-up and one timed step
   each (counts reset just before, read just after: K12 once and K13
   twice per step attempt), host syncs, gravity phases, forces against
   direct summation, K12 and K13 against their plain versions at the
   state; the CLI's ``--init evrard -n 125 --prop nbody``;
14. Ewald periodic gravity: std Sedov 100^3 with G = 0.5, one timed step
   and no warm-up (the SPH ops once, K12 27 times and K13 54 times per
   step attempt), the solve's split (the 27 replica passes, the real-space
   and k-space corrections) and the corrections' peak memory, K12 with a
   shift and the self pair against its plain version, Sedov 16 with G =
   0.5 stepped on the card against the CPU, and one periodic solve card
   vs CPU on 4,096 random particles (``checks.ewald_vs_cpu``);
15. the turb-ve path: the turbulence case at side 100 (10^6 particles,
   112 stirring modes) through Simulation(prop="turb-ve") in list mode,
   one warm-up and ten timed steps (counts reset just before, read just
   after: the six VE walks once per step attempt, K5 per build), machRMS
   over the steps, host syncs (no more than the VE path's) and kernel
   events a step beside the VE path's, the stirring's parts by CUDA
   events, the host draw's time, TF32 off, the OU draw that reached the
   card and the run's key bit for bit the host's key chain;
16. the std-cooling path: evrard-cooling at side 125 (1,022,790
   particles, self-gravity) through Simulation(prop="std-cooling"), CIE,
   one warm-up and two timed steps, then one step with the evolved
   primordial network, each counted (K1's three std ops and K12 once, K13
   twice per step attempt), dt_cool and whether it set the step, the
   cooling stage CIE and evolved by CUDA events, host syncs;
17. ``turb_cooling_vs_cpu`` (``kernels/aux_checks.py``): three steps card
   vs CPU of turb-ve (turbulence 20, list mode) and std-cooling
   (evrard-cooling 16, CIE and evolved); ``turb_cli``: the CLI's
   ``--init turbulence -n 30 -s 4 --prop turb-ve`` against the library's
   run, and the restart from its step-2 dump (the library's ``.npz``:
   the card machine has no h5py), the first restarted step to the
   restart contract and the stirring key bit for bit, the CLI restarted
   in a process of its own;

18. ``inits_path``: the Kelvin-Helmholtz slab (side 100), the isobaric
   cube (side 100) and the wind shock (side 64), each about 10^6
   particles, through Simulation(prop="std"), one warm-up and five timed
   steps each (the slab one: its steps stream at 7.6 s; counts reset
   just before, read just after: each std op
   once per step attempt, streaming or walking lists), steps/s, updates/s,
   lists, the neighbour counts' extremes, the drift, the case's
   observable column; then each at a small side card vs CPU;
19. ``glass``: ``generate_glass_template(side=8, relax_steps=8)`` on the
   card against the CPU's, tiled into the Sedov box;
20. ``kernel_family``: every K1 and K6 op with wendland-c6 (the
   20-coefficient form, timed, with its bounds) and with sinc at index 5
   against its plain version at the side-100 states of phase 8; the
   wendland-c6 paths (Sedov 100^3, std and VE, lists and streaming, each
   op's 20-coefficient form counted); the CLI's ``--kernel wendland-c6``
   and a wendland-c6 dump restarted by the CLI;
21. ``blockdt_path``: std and VE Sedov 100^3 at dt_bins 4, 8 substeps
   (std also at bin_resort_drift 0.01), counts reset just before and read
   just after (the streaming ops and K13's one-row form once per substep
   attempt), the substep time, the updates against the global dt's,
   resorts and keeps; K13's one-row form at the due row against its plain
   version with its times, bound and torch.argsort's; dt_bins 1 against the
   global streaming step bit for bit; substeps card vs CPU on Sedov 16 and
   Evrard 20;

22. ``sharded_path``: the card count (and whether NCCL ran: it needs two
   cards or more); std and VE Sedov 100^3 over two gloo ranks sharing
   the card (``Simulation(num_devices=2)``; the collectives copy through
   pinned host buffers), one warm-up and three timed steps each, counts
   reset just before and read just after on each rank (K1's ops, jdata
   form, once per step attempt), the step ms per rank, the halo's caps,
   rows and bytes a step, the step's collective parts (sort, halo stage,
   one serve) by the host's clock; the slabs gathered (for the check only) and
   held to the one-card streaming step from the same state (x rtol 1e-5
   atol 1e-7, temp rtol 1e-4, dt rtol 1e-5, h and the neighbour total
   exact); every K1 jdata launch of a force stage against its plain
   version on each rank, with its one-call time, its plain version's and
   its bound, one rank at a time on the card; with two cards or more the
   same over NCCL ranks, one a card;
23. ``sharded_gravity_path``: VE Evrard 125 (1,022,790 particles, theta
   0.5) with self-gravity over two gloo ranks sharing the card, the
   sparse gravity serve, one warm-up and one timed step, counts reset
   just before and read just after (K1's VE ops, K12 once and K13 twice
   per step attempt), the step ms per rank and its split (sort, SPH halo,
   upsweep, MAC, M2P, near-field prologue, gravity serve, K12), the caps
   (the essential set's too), the gravity serve's rows and bytes a step;
   the slabs held to the one-card VE step from the same state (vx rtol
   1e-2 atol 5e-4, egrav rtol 1e-4); K12's jdata form on each rank's
   j-buffer against its plain version, timed one rank at a time (one
   call, back to back, alone) with its bound; ``sharded_ewald``: the
   sharded Ewald solve on ``checks.periodic_random_case`` against the
   one-card solve; ``sharded_cooling``: std-cooling on evrard-cooling 125,
   one warm-up and one step;

24. ``sharded_props_path``: over two gloo ranks sharing the card, turb-ve
   on the turbulence case at side 100 (one warm-up, two timed steps),
   std Sedov 100^3 at dt_bins 4 with bin_resort_drift 0 and 0.01 (one
   warm-up, one cycle of eight substeps) and N-body Evrard 125 (theta
   0.5; one warm-up, one timed step), counts reset just before and read
   just after on each rank (the six VE ops once per step attempt; the std
   ops and K13's one-row form once per substep attempt; K12 once and K13
   twice per N-body step attempt), the step ms per rank, the halo caps and
   bytes; each path's last step held to the one-card step from the
   gathered input (``sharded_checks.props_vs_one_device``: turb-ve vx rtol
   1e-4 atol 1e-6, the key equal, the OU phases rtol 1e-6; the block time
   steps' bins, substep, dt_min, counts and work equal, x rtol 1e-5, temp
   rtol 1e-4; N-body vx rtol 5e-4 atol 1e-3 max|vx|, egrav rtol 1e-4; dt
   rtol 1e-5); K13's one-row form on each rank's due masks against its
   plain version, exact, timed one rank at a time with its bound and
   torch.argsort's time; ``sharded_cli``: the CLI's ``--devices 2`` on two
   gloo ranks sharing the card with turb-ve, N-body and ``--dt-bins 4`` at
   side 30, ``-w`` with ``--ascii``;

25. ``app_shell``: the CLI's ``--devices 2 --snap m,temp`` at Sedov 30 on
   two gloo ranks sharing the card (rank 0's frame against the one-card
   deposit of the same particles, the ranks' ``--ascii`` dump: rtol
   1e-6); ``--debug-checks`` (Sedov 30: a clean step "", a NaN seeded in
   temp reported with its phase; the checked step's ms at Sedov 100^3);
   the substep split of the main and VE paths' states (each stage's ms,
   K1's streaming op 1 + 3 launches a stage: the kernels line's
   ``app_shell_substeps_*`` paths); the CLI's ``--insitu projection`` (two
   PNG frames, a snapshot event each) with ``--memory-profile`` (the
   allocator's snapshot) and a 5-step ``--trace-dir`` capture (coverage >=
   0.8, the phases' device time), both at Sedov 100^3; then std Sedov
   100^3 in list mode at check_every 8 with and without a (rho, temp) G 64
   deposit (``app_checks.deposit_vs_plain``: sums within 1e-5 of the grid's
   max, "max" exact, against numpy on the host; its time and bound; the
   step medians; the launch contract; a window's host syncs equal; a
   checked step's device events without snapshots the main path
   Simulation's);
26. ``gather_path``: the gather backend (``backend="xla"``, no kernel):
   ``find_neighbors`` of a jittered Sedov 24 at ngmax 40 card vs CPU bit
   for bit, the gather density rtol 1e-6; one gather force stage against
   the engine's from Sedov 100^3 (the largest count below ngmax 150: rho,
   a, du within the slice's tolerances); std Sedov 100^3 at ngmax 150,
   one warm-up and one timed step, counts reset just before and read
   just after (every count 0), updates/s, the drift, the peak allocated
   memory, the ledger's truncated-row count, every field on the card; the
   split of a step (sort, search, density, EOS, IAD, momentum/energy) and
   the row blocks taken from the free memory;
27. ``sharded_gather_path``: the gather backend over two ranks (gloo ranks
   sharing this card; NCCL ranks where the machine has two cards), no
   kernel: the lists of a jittered Sedov 24 trimmed to slabs that end in
   partial groups, at ngmax 40 (every row truncated), as global rows bit
   for bit the one-card ``find_neighbors``'s; std Sedov 100^3 at ngmax
   150 through ``Simulation(backend="xla", num_devices=2)``, one warm-up
   and one timed step, counts reset just before and read just after
   (every count 0 on every rank), the last step's h bit for bit and its
   nc sums, occupancy and truncated-row count equal to the one-card
   gather step's from the gathered input, the fields within the slice's
   tolerances; step ms a rank, the search and the serve split, the rows a
   serve ships against the engine's sparse serve at the same state, the
   peak allocated memory a rank, updates/s and the drift;
28. ``tuning_path``: every kernel shape the tuning registry reaches held
   to its plain version (``kernels/tuning_checks.py``: K1's std ops at
   group 32 / 64 / 128 and run_cap 1024 / 2048 x gap 128 / 512, K5 bit for
   bit and K6 at the three groups and list_skin_rel 0.1 / 0.3 on the
   jittered Sedov 40; K12 and K13 at target_block 128 / 256 x super_factor
   0 / 4 / 16 on the tuned VE Evrard 30's solves); a budgeted sweep
   (``run_sweep(measure_candidate)``, 5 candidates over group, cell_target,
   gap and list_skin_rel, 6 steps and one warm-up window each) on std
   Sedov 100^3 in list mode, each candidate's knobs, status and per-step
   ms, the launches over the sweep; the CLI with ``--tuned`` on the
   sweep's table (Sedov 100^3, 8 steps, ``--check-every 4``, a run dir and
   a ``--trace-dir`` capture, in this process, its launches counted), then
   the port's reader: ``summary --strict`` and ``tuning`` (source "table")
   exit 0, the trace's coverage >= 0.8; the sweep over ranks
   (``tuning_ranks``: ``sweep_on_ranks`` on std Sedov 100^3, two gloo
   ranks sharing the card, NCCL with two cards; 3 candidates of
   cell_target): every rank's history equal, each agreed value the slowest
   rank's, each rank's K1 jdata launches 3 a step attempt, a p = 2 entry;
29. ``cost_path``, the static roofline cost layer (devtools/audit): (a)
   ``python -m sphexa_torch.devtools.audit cost --device h100`` over the
   registry on the card exits 0 against COST_BUDGET_TORCH.json, and each
   entry's per-phase FLOPs and both byte counts, and those of two
   list-mode cases (Noh 12, std and VE: K5 and the K6 walks), equal its
   CPU tally, its kernel charges its launches (``kernels/cost_checks.py``); (b) the phase
   roofline of the main path: ``COST_STEPS`` steps of std Sedov 100^3 in
   list mode captured by the CLI's ``--trace-dir``, the same steps from
   the same state tallied (``cost_main_path``, the calibration target),
   per phase measured us, predicted us on ``h100``, their ratio and the
   bound class; ``calibration.json`` written beside the capture, ``trace
   --predict`` exits 0, and 1 with the momentum body's rule scaled by 10;
   (c) the main path's device events a step after the tallies as before
   this layer (``MAIN_PATH_EVENTS``), a step's outputs and launches the
   same before a tally, under it and after it;
30. ``audit_path``, the audit's trace rules, lowering lock and statecheck
   (``kernels/audit_checks.py``), on ``cost_path``'s records: every
   registry entry's findings (zero), run fingerprint, launch map and
   schema rows equal on the card and on the CPU and to the committed
   LOWERING_LOCK_TORCH.json and STATE_SCHEMA_TORCH.json, the launch map
   equal to the wrappers' counters, JXA104's host-sync sites equal to the
   card's sync debug mode's over one more run, the knob probes equal on
   both devices; ``python -m sphexa_torch.devtools.audit``, ``lowering``
   and ``schema`` exit 0 on the card; the nine sharded entries on two
   ranks sharing the card (gloo) and two gloo ranks on the CPU: each
   rank's findings (zero), fingerprint (its collectives counted), launch
   map, schema row and collective sequence equal on the two devices and
   to the committed files, each rank's static toy peak (JXA202) beside
   the card's ``max_memory_allocated`` over the same run (reset before it);
   ``preflight`` exits 0 on the card at ``--mesh 2`` and ``--mesh 4``
   (``audit_checks.sharded_card_vs_cpu_audit``, ``preflight_on_card``);
31. ``tree_path``, the cornerstone tree: on the keys of std Sedov 100^3
   and VE Evrard 125 the device pyramid equal to ``compute_octree`` bit
   for bit (buckets 64 and 16), ``build_gravity_tree`` equal to the Evrard
   Simulation's tree, the Evrard profile's continuum tree with the decode
   on the card equal to the CPU's, each time beside the card;
32. ``lint_path``: ``python -m sphexa_torch.devtools.lint sphexa_torch`` in
   a subprocess (no JAX on this machine) exits 0, no finding, the
   suppressions those committed in tests/test_torch_lint.py;

then the engines line (every instantiation of the streaming engine K1 and
the list walk K6: registers, spills, shared memory, resident warps per
SM, and on the side-100 states its times and the body-pass efficiency of
the union rule against per-lane windows; K12's the same at Evrard 125,
K5's at side 100; every K1 and K6 instantiation's wendland-c6 form's
static facts),
the {"kernels": [...]} line (K12's and K13's launches on every gravity
path beside the Evrard path's; every entry's launches on the turb-ve,
std-cooling, inits and block-dt paths; the wendland-c6 form of each K1
and K6 op, ``name:wendland-c6``, with its own count's launches on every
path; K13's one-row form, ``compact_class_lists:row``; K1's jdata form of
each std and VE op on the sharded paths, ``name:jdata``, their launches
on every sharded path; K12's jdata form on the sharded gravity and N-body
paths, ``gravity_p2p:jdata``; K13's one-row form on a rank's slab,
``compact_class_lists:row:slab``; the tuning sweep's and the tuned CLI's
launches, ``tuning_sweep`` and ``tuning_cli``; the cost layer's,
``cost_registry`` and ``cost_main_path``), the nvidia-smi
line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero and prints no result; without a CUDA device, or
without the rest of the repository beside it, it fails the same way.
"""

import ast
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the kernels' bound formulas (the static cost layer charges the same rules)
from sphexa_torch.devtools.audit.core import EntryCase, entrypoint  # noqa: E402
from sphexa_torch.kernels.costs import (  # noqa: E402
    PEAK_FP32_FLOPS, SYM_BODIES, body_of, COMPACT_ROW_OPS, PEAK_INT32_OPS,
    GRAV_MASK_OPS, GRAV_BODY_OPS, _bound, bounds, list_bounds, gravity_bounds,
    p2p_jdata_bound,
)
from sphexa_torch.sph.pair_engine import momentum_pair_counts  # noqa: E402

# the TPU kernel each entry point replaces: the op's wrapper (whose
# pallas_call runs K1, sph/pallas_pairs.py:816, or in list mode the list
# walk K6, :1080, or for density, IAD, grad-h and plain divv/curlv K1's
# skip_slots form over the pruned runs)
TPU_KERNEL = {
    "density": "sphexa_tpu/sph/pallas_pairs.py:1121",
    "density_lists": "sphexa_tpu/sph/pallas_pairs.py:1121",
    "iad": "sphexa_tpu/sph/pallas_pairs.py:1185",
    "iad_lists": "sphexa_tpu/sph/pallas_pairs.py:1185",
    "momentum_energy_std": "sphexa_tpu/sph/pallas_pairs.py:1275",
    "momentum_energy_std_lists": "sphexa_tpu/sph/pallas_pairs.py:1080",
    "mark": "sphexa_tpu/sph/pair_lists.py:231",
    "ve_def_gradh": "sphexa_tpu/sph/pallas_pairs.py:1435",
    "ve_def_gradh_lists": "sphexa_tpu/sph/pallas_pairs.py:1435",
    "iad_divv_curlv": "sphexa_tpu/sph/pallas_pairs.py:1507",
    "iad_divv_curlv_lists": "sphexa_tpu/sph/pallas_pairs.py:1602",
    "av_switches": "sphexa_tpu/sph/pallas_pairs.py:1632",
    "av_switches_lists": "sphexa_tpu/sph/pallas_pairs.py:1720",
    "momentum_energy_ve": "sphexa_tpu/sph/pallas_pairs.py:1747",
    "momentum_energy_ve_lists": "sphexa_tpu/sph/pallas_pairs.py:1924",
}
SOURCE = {op: "sphexa_torch/csrc/pair_lists.cu" if op == "mark" or op.endswith("_lists")
          else "sphexa_torch/csrc/pair_engine.cu" for op in TPU_KERNEL}
# windows (candidates) at which the body-pass counter compares per-lane
# windows with the union rule; the engines are built for one
# (csrc/engine_window.cuh WINDOW, 256)
PASS_WINDOWS = (128, 256, 512)
# the VE ops' list walks: every VE list-mode step attempt launches each once
VE_WALK = ("density_lists", "ve_def_gradh_lists", "iad_lists", "iad_divv_curlv_lists",
           "av_switches_lists", "momentum_energy_ve_lists")
# the gravity kernels
TPU_KERNEL.update({"gravity_p2p": "sphexa_tpu/gravity/traversal.py:454",
                   "compact_class_lists": "sphexa_tpu/gravity/pallas_compact.py:155"})
SOURCE.update({"gravity_p2p": "sphexa_torch/csrc/gravity_p2p.cu",
               "compact_class_lists": "sphexa_torch/csrc/gravity_compact.cu"})


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median over ``reps`` runs of fn's device time, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_time_batched_ms(fn, n: int = 20) -> float:
    """Mean device time of fn over ``n`` calls back to back between two
    CUDA events (after one warm-up call): the host's per-call work overlaps
    the previous call's kernels, so this is the kernel's own time where the
    single-call median of ``cuda_time_ms`` also counts the wrapper's
    host-side argument building."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def sorted_case(side: int, cell_target=None, state=None, cfg=None):
    """Sorted Sedov state, its config and candidate runs on the card;
    without ``state``, the side^3 lattice jittered from the seed ``side``."""
    from sphexa_torch.convert import state_from_numpy, state_to_numpy
    from sphexa_torch.init import init_sedov, jitter_sedov
    from sphexa_torch.propagator import _force_stage_prologue
    from sphexa_torch.simulation import make_propagator_config
    from sphexa_torch.sph import pair_engine as pe

    if state is None:
        fields, box, const = state_to_numpy(*init_sedov(side, device="cpu"))
        state, box, const = state_from_numpy(jitter_sedov(fields, side, seed=side),
                                             box, const, device="cuda")
    else:
        state, box, const = state
    if cfg is None:
        cfg = make_propagator_config(state, box, const, cell_target=cell_target)
    ss, box, keys, _ = _force_stage_prologue(state, box, cfg)
    ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr)
    return ss, box, const, cfg, keys, ranges


def compare_ops(name, ss, box, const, cfg, keys, ranges, timing=False):
    """Run each kernel and its plain version on the same inputs and hold
    them to the JAX package's tolerances (tests/test_pallas_interpret.py).
    Returns per-op results; with ``timing`` also device times."""
    import torch

    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.sph.hydro_std import compute_eos_std

    nbr = cfg.nbr
    res = {}
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m

    def dens_k():
        return pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)

    def dens_p():
        return pe.density_plain(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)

    rho_k, nc_k, _ = dens_k()
    rho_p, nc_p, _ = dens_p()
    if not torch.equal(nc_k, nc_p):
        raise AssertionError(f"{name}: density nc differs at "
                             f"{int((nc_k != nc_p).sum())} targets")
    torch.testing.assert_close(rho_k, rho_p, rtol=1e-5, atol=0.0)
    res["density"] = {"max_abs_err": float((rho_k - rho_p).abs().max()),
                      "nc_equal": True, "nb_pairs": int(nc_p.sum())}

    rho = rho_k
    p, c = compute_eos_std(ss.temp, rho, const)
    vol = m / rho

    def iad_k():
        return pe.pallas_iad(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)

    def iad_p():
        return pe.iad_plain(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)

    cs_k, _ = iad_k()
    cs_p, _ = iad_p()
    scale = float(cs_p[0].abs().max())
    err = 0.0
    for a, b in zip(cs_k, cs_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)
        err = max(err, float((a - b).abs().max()))
    res["iad"] = {"max_abs_err": err}

    margs = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho, p, c, *cs_k, keys, box,
             const, nbr)

    def mom_k():
        return pe.pallas_momentum_energy_std(*margs, ranges=ranges)

    def mom_p():
        return pe.momentum_energy_std_plain(*margs, ranges=ranges)

    out_k = mom_k()
    out_p = mom_p()
    err = 0.0
    for nm, a, b in zip(("ax", "ay", "az", "du"), out_k[:4], out_p[:4]):
        s = float(b.abs().max()) + 1e-12
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-6 * s, msg=f"{name}: {nm}")
        err = max(err, float((a - b).abs().max()))
    dk, dp = float(out_k[4]), float(out_p[4])
    if abs(dk - dp) > 1e-5 * abs(dp):
        raise AssertionError(f"{name}: min dt {dk} vs plain {dp}")
    res["momentum_energy_std"] = {"max_abs_err": err, "min_dt_rel_err": abs(dk - dp) / abs(dp)}

    if timing:
        # the engine alone (kernel vs plain) on the op's precombined fields
        fields = {
            "density": pe.density_fields(x, y, z, h, m),
            "iad": pe.iad_fields(x, y, z, h, vol),
            "momentum_energy_std": pe.momentum_fields(*margs[:17]),
        }
        specs = {"density": pe.DENSITY, "iad": pe.IAD,
                 "momentum_energy_std": pe.momentum_spec(const)}
        fold = pe.engine_fold(box, nbr)
        consts = pe.op_consts(const)
        for op, spec in specs.items():
            res[op].update(time_k1(spec, ranges, *fields[op], fold, nbr.group, consts))
        res["momentum_energy_std"]["pairs"] = momentum_pair_counts(
            specs["momentum_energy_std"], fields["momentum_energy_std"], consts, nbr.group,
            runs=ranges, fold=fold)
    return res


def compare_ve(name, ss, box, const, nbr, av_clean, keys=None, ranges=None, lists=None,
               timing=False):
    """The VE ops' kernels against their plain versions on the kernel
    chain's inputs (``sphexa_torch.kernels.checks.ve_chain_vs_plain``, the
    JAX package's streaming tolerances); with ``lists`` the list walk for
    every op. Returns per-entry-point results (keys as in
    LAUNCHES, "xmass" for the density kernel's VE use); with ``timing``
    also each engine call's device time and its plain version's, and the
    momentum op's pair counts (``momentum_pair_counts``)."""
    from sphexa_torch.kernels.checks import ve_chain_vs_plain
    from sphexa_torch.sph import pair_engine as pe

    res, ch = ve_chain_vs_plain(name, ss, box, const, nbr, av_clean, keys=keys,
                                ranges=ranges, lists=lists)
    if timing:
        # each engine call alone (kernel vs plain) on the op's precombined fields
        x, y, z, h, m, vel = ss.x, ss.y, ss.z, ss.h, ss.m, (ss.vx, ss.vy, ss.vz)
        walk = lists is not None
        consts, group = pe.op_consts(const), nbr.group
        runs = None if walk else ranges
        fold = not walk and pe.engine_fold(box, nbr)

        def engine(spec, fields, cst=consts):
            if walk:
                return lambda: time_walk(spec, lists, *fields, group, cst)
            return lambda: time_k1(spec, runs, *fields, fold, group, cst)

        sfx = "_lists" if walk else ""
        mkey = "momentum_energy_ve" + sfx
        mspec = pe.momentum_ve_spec(const, av_clean)
        mfields = pe.momentum_ve_fields(x, y, z, *vel, h, m, ch.prho, ch.c, ch.kx, ch.xm,
                                        ch.alpha, *ch.cs, nc=ch.nc, gradv=ch.gradv)
        calls = {
            "ve_def_gradh" + sfx: engine(pe.VE_DEF_GRADH,
                                         pe.ve_def_gradh_fields(x, y, z, h, m, ch.xm)),
            "iad_divv_curlv" + sfx: engine(
                pe.IAD_DIVV_CURLV_GRADV if av_clean else pe.IAD_DIVV_CURLV,
                pe.divv_curlv_fields(x, y, z, *vel, h, ch.kx, ch.xm, *ch.cs, const)),
            "av_switches" + sfx: engine(pe.AV_SWITCHES, pe.av_switches_fields(
                x, y, z, *vel, h, ch.c, ch.kx, ch.xm, ch.dv[0], ss.alpha, *ch.cs, const),
                {**consts, "dt": ss.min_dt}),
            mkey: engine(mspec, mfields),
        }
        for op, timed in calls.items():
            res[op].update(timed())
        res[mkey]["pairs"] = momentum_pair_counts(mspec, mfields, consts, group, runs=runs,
                                                  fold=fold, lists=lists)
    return res


def list_case(init, side: int, jitter: bool, state=None, cfg=None, **sizing):
    """A list-mode state on the card: the frozen sorted state, its config
    (``sizing``: make_propagator_config's keywords) and lists (the
    list-build kernel builds them), the keys of the frozen order and the
    list build's input, the culled window cells at the skin (start, lens,
    keep, shifts). Without ``state``, the case's initial state, jittered
    from the seed ``side`` if asked."""
    from sphexa_torch.convert import state_from_numpy, state_to_numpy
    from sphexa_torch.init import jitter_sedov
    from sphexa_torch.propagator import rebuild_pair_lists
    from sphexa_torch.sfc.keys import compute_sfc_keys
    from sphexa_torch.simulation import make_propagator_config
    from sphexa_torch.sph import pair_engine as pe

    if state is None:
        st, box, const = init(side, device="cpu")
        if jitter:
            fields, b, c = state_to_numpy(st, box, const)
            st, box, const = state_from_numpy(jitter_sedov(fields, side, seed=side), b, c,
                                              device="cpu")
        st, box = st.to("cuda"), box.to("cuda")
    else:
        st, box, const = state
    if cfg is None:
        cfg = make_propagator_config(st, box, const, use_lists=True, **sizing)
    if cfg.list_slot_cap <= 0 or pe.engine_fold(box, cfg.nbr):
        raise AssertionError(f"side {side}: no lists (slot cap {cfg.list_slot_cap})")
    st, box, lists = rebuild_pair_lists(st, box, cfg)
    if int(lists.overflow):
        raise AssertionError(f"side {side}: slot cap overflow")
    keys = compute_sfc_keys(st.x, st.y, st.z, box, curve=cfg.curve)
    cull = pe.window_cells_culled(st.x, st.y, st.z, st.h, keys, box, cfg.nbr,
                                  radius_pad=lists.skin)[:4]
    return st, box, const, cfg, keys, lists, cull


def compare_lists(name, ss, box, const, cfg, keys, lists, cull, timing=False):
    """K5 and K6 against their plain versions, and list mode (the walk for
    density, IAD and momentum) against the streaming kernels with fresh
    runs on the same frozen-order state, with the JAX package's
    list-vs-streaming tolerances (tests/test_pair_lists.py:82-119). K5 (the
    list build, on the culled cells ``cull``) is held bit for bit to its
    plain version and to the lists the rebuild made. Returns per-kernel
    results; with ``timing`` also device times (the walk's, and K1's over
    the lists' pruned runs for density and IAD, the form of list mode
    before the walk carried every op; K5's one call, its entry point
    launched back to back, ``kernel_ms``, and the plain composition's)."""
    import torch

    from sphexa_torch.kernels import checks
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.sph import pair_lists as pl
    from sphexa_torch.sph.hydro_std import compute_eos_std

    nbr, scap = cfg.nbr, cfg.list_slot_cap
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    res = {}

    # K5: the pruned run tables, words, counts and chunk totals, kernel vs
    # plain, and the lists the rebuild made
    bargs = (cull, x, y, z, h, lists.skin, scap, nbr)
    mark = checks.list_build_vs_plain(name, *bargs)
    tables, bits, cnt, total = mark.pop("outputs")
    for f, a in zip(pl.RUN_TABLES, tables):
        if not torch.equal(a, getattr(lists.ranges, f)):
            raise AssertionError(f"{name}: the list build's {f} differs from the rebuild's")
    if not (torch.equal(bits, lists.bits) and torch.equal(cnt, lists.cnt)):
        raise AssertionError(f"{name}: the list build's words differ from the rebuild's")
    ovf = checks.list_build_vs_plain(f"{name}, 2 slots", *bargs[:6], 2, nbr)["outputs"][3]
    mark.update(overflow_checked=int(ovf.max()) > 2, w3=int(cull[0].shape[1]),
                max_total=int(total.max()))
    res["mark"] = mark

    # list mode: kernels vs plain, and against the streaming kernels
    ranges = pe.group_cell_ranges(x, y, z, h, keys, box, nbr)
    rho_s, nc_s, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    # as the force stage runs them: density keeps its mask, the walks after
    # it read it
    rho_k, nc_k, _ = pe.pallas_density(x, y, z, h, m, None, box, const, nbr, lists=lists,
                                       mask="write")
    rho_p, nc_p, _ = pe.density_plain(x, y, z, h, m, None, box, const, nbr, lists=lists)
    if not (torch.equal(nc_k, nc_p) and torch.equal(nc_k, nc_s)):
        raise AssertionError(f"{name}: list-mode density nc differs")
    torch.testing.assert_close(rho_k, rho_p, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(rho_k, rho_s, rtol=2e-6, atol=0.0)
    res["density_lists"] = {"max_abs_err": float((rho_k - rho_p).abs().max()),
                            "vs_streaming_max_abs_err": float((rho_k - rho_s).abs().max()),
                            "nc_equal": True, "nb_pairs": int(nc_k.to(torch.int64).sum())}

    p, c = compute_eos_std(ss.temp, rho_s, const)
    vol = m / rho_s
    cs_s, _ = pe.pallas_iad(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)
    cs_k, _ = pe.pallas_iad(x, y, z, h, vol, None, box, const, nbr, lists=lists, mask="read")
    cs_p, _ = pe.iad_plain(x, y, z, h, vol, None, box, const, nbr, lists=lists)
    csc = max(float(a.abs().max()) for a in cs_s)
    err = 0.0
    for a, b, s_ in zip(cs_k, cs_p, cs_s):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * csc)
        torch.testing.assert_close(a, s_, rtol=2e-5, atol=1e-6 * csc)
        err = max(err, float((a - b).abs().max()))
    res["iad_lists"] = {"max_abs_err": err}

    margs = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho_s, p, c, *cs_s, keys, box, const, nbr)
    out_s = pe.pallas_momentum_energy_std(*margs, ranges=ranges)
    out_k = pe.pallas_momentum_energy_std(*margs, lists=lists, mask="read")
    out_p = pe.momentum_energy_std_plain(*margs, lists=lists)
    scale = float(out_s[0].abs().max())
    dus = float(out_s[3].abs().max())
    err = 0.0
    for nm, a, b, s_ in zip(("ax", "ay", "az", "du"), out_k[:4], out_p[:4], out_s[:4]):
        sc = float(b.abs().max()) + 1e-12
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-6 * sc, msg=f"{name}: {nm}")
        atol = 1e-6 * dus if nm == "du" else 1e-5 * scale
        torch.testing.assert_close(a, s_, rtol=1e-4, atol=atol, msg=f"{name}: {nm} vs streaming")
        err = max(err, float((a - b).abs().max()))
    for ref in (out_p, out_s):
        if abs(float(out_k[4]) - float(ref[4])) > 1e-5 * abs(float(ref[4])):
            raise AssertionError(f"{name}: list-mode min dt {float(out_k[4])} vs {float(ref[4])}")
    res["momentum_energy_std_lists"] = {"max_abs_err": err}

    if timing:
        consts = pe.op_consts(const)
        group = nbr.group
        walk = {"density_lists": (pe.DENSITY, pe.density_fields(x, y, z, h, m)),
                "iad_lists": (pe.IAD, pe.iad_fields(x, y, z, h, vol)),
                "momentum_energy_std_lists": (pe.momentum_spec(const),
                                              pe.momentum_fields(*margs[:17]))}
        for op, (spec, (i_f, j_f)) in walk.items():
            res[op].update(time_walk(spec, lists, i_f, j_f, group, consts))
        for op in ("density_lists", "iad_lists"):
            spec, (i_f, j_f) = walk[op]
            res[op]["k1_pruned_ms"] = cuda_time_ms(lambda: pe.engine_kernel(
                spec, lists.ranges, i_f, j_f, False, group, consts), reps=7)
        res["mark"]["ms"] = cuda_time_ms(lambda: pl.build_lists_kernel(*bargs), reps=7)
        res["mark"]["kernel_ms"] = launch_loop_ms(pl.build_lists_launcher(*bargs)[0], 50)
        res["mark"]["plain_ms"] = cuda_time_ms(lambda: pl.build_lists_plain(*bargs), reps=2)
        spec, fields = walk["momentum_energy_std_lists"]
        res["momentum_energy_std_lists"]["pairs"] = momentum_pair_counts(
            spec, fields, consts, group, lists=lists)
    return res


def rebuild_split(sim, reps: int = 5) -> dict:
    """A list rebuild of ``sim``'s state in its parts, by CUDA events
    (median of ``reps``, after a warm-up): the box regrow with the keys,
    argsort and row gather (``sort``), the culled window cells (``cull``),
    K5 (``build``, one call), the word offsets with the mask-word buffer
    and its host sync (``words``), their sum and the whole
    ``rebuild_pair_lists``; and the plain composition of the build
    (``plain``: merge, mark, prune, gathers) on the same card tensors, the
    list build before K5 carried it."""
    import torch

    from sphexa_torch.propagator import _sort_by_keys, rebuild_pair_lists
    from sphexa_torch.sfc.box import make_global_box
    from sphexa_torch.sfc.keys import compute_sfc_keys
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.sph import pair_lists as pl

    cfg = sim.cfg
    nbr, scap = cfg.nbr, cfg.list_slot_cap
    st, box, lists = rebuild_pair_lists(sim.state, sim.box, cfg)
    x, y, z, h, skin = st.x, st.y, st.z, st.h, lists.skin
    keys = compute_sfc_keys(x, y, z, box, curve=cfg.curve)  # sorted: the rebuild's order
    cull = pe.window_cells_culled(x, y, z, h, keys, box, nbr, radius_pad=skin)[:4]
    bargs = (cull, x, y, z, h, skin, scap, nbr)

    def words():
        off = pe.mask_word_offsets(lists.cnt)
        return torch.empty(int(off[-1]) * nbr.group, dtype=torch.int32, device=x.device)

    out = {"sort": cuda_time_ms(lambda: _sort_by_keys(st, make_global_box(x, y, z, box),
                                                      cfg.curve), reps),
           "cull": cuda_time_ms(lambda: pe.window_cells_culled(x, y, z, h, keys, box, nbr,
                                                               radius_pad=skin), reps),
           "build": cuda_time_ms(lambda: pl.build_lists_kernel(*bargs), reps),
           "words": cuda_time_ms(words, reps)}
    out["parts_sum"] = sum(out.values())
    out["whole"] = cuda_time_ms(lambda: rebuild_pair_lists(st, box, cfg), reps)
    out["plain"] = cuda_time_ms(lambda: pl.build_lists_plain(*bargs), 2)
    return out


def walk_mask(spec) -> str:
    """The mask mode a force stage runs a list-walk op in: density keeps
    its mask ("write"), every later walk reads it."""
    return "write" if spec.want_nc else "read"


#: an engine op's plain version timed by one call: the comparison before
#: it has just run the same plain version at the same sizes, so nothing is
#: cold
PLAIN_TIMING = {"reps": 1, "warmup": 0}


def time_walk(spec, lists, i_f, j_f, group, consts) -> dict:
    """A list-walk entry point's device time in the mask mode of its path
    (``walk_mask``; a "read" walk reads the words that a density walk on
    the same positions kept before): ``ms``, one call at a time;
    ``batched_ms``, calls back to back; ``mask_ms``, one call that runs
    its own mask phase; and its plain version's."""
    from sphexa_torch.sph import pair_engine as pe

    def kern(mask=walk_mask(spec)):
        return pe.engine_lists_kernel(spec, lists, i_f, j_f, group, consts, mask=mask)

    out = {"ms": cuda_time_ms(kern, reps=7), "batched_ms": cuda_time_batched_ms(kern),
           "mask_ms": cuda_time_ms(lambda: kern("own"), reps=7)}
    out["plain_ms"] = cuda_time_ms(lambda: pe.engine_lists_plain(
        spec, lists, i_f, j_f, group, consts), **PLAIN_TIMING)
    return out


def time_k1(spec, runs, i_f, j_f, fold, group, consts) -> dict:
    """A streaming-engine entry point's device time (``ms``, one call at a
    time; ``batched_ms``, calls back to back) and its plain version's."""
    from sphexa_torch.sph import pair_engine as pe

    def kern():
        return pe.engine_kernel(spec, runs, i_f, j_f, fold, group, consts)

    out = {"ms": cuda_time_ms(kern, reps=7), "batched_ms": cuda_time_batched_ms(kern)}
    out["plain_ms"] = cuda_time_ms(lambda: pe.engine_plain(
        spec, runs, i_f, j_f, fold, group, consts), **PLAIN_TIMING)
    return out


def slice_vs_cpu(side: int, cell_target, steps: int, use_lists: bool, prop: str = "std",
                 case: str = "sedov", overrides=None) -> dict:
    """Simulation steps on the card against the same steps on the CPU (the
    pair ops' plain versions there), every step from the same input; the
    accelerations' tolerance (rtol 1e-4, the VE ops' 2e-4; atol 5e-6
    max|.|) carried through the integrator, neighbour counts (the max and
    the exact total) equal. In
    list mode each side builds its own lists on the first step (equal bit
    for bit: the same sorted state) and both freeze the same order."""
    import torch

    from sphexa_torch.init import CASES
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph.pair_engine import engine_fold

    init = CASES[case]
    rtol = 1e-4 if prop == "std" else 2e-4
    kw = {"cell_target": cell_target, "use_lists": use_lists, "prop": prop,
          "obs_spec": ObservableSpec()}
    gpu = Simulation(*init(side, overrides=overrides, device="cuda"), device="cuda", **kw)
    cpu = Simulation(*init(side, overrides=overrides, device="cpu"), device="cpu", **kw)
    worst = 0.0
    for it in range(steps):
        cpu.state, cpu.box = gpu.state.to("cpu"), gpu.box.to("cpu")
        dg, dc = gpu.step(), cpu.step()
        for k in ("nc_max", "nc_sum", "occupancy", "use_lists"):
            if dg[k] != dc[k]:
                raise AssertionError(f"side {side} step {it}: {k} {dg[k]} vs cpu {dc[k]}")
        # with gravity, egrav within the near field's relative tolerance
        if gpu.gravity_on and abs(dg["egrav"] - dc["egrav"]) > 1e-4 * abs(dc["egrav"]):
            raise AssertionError(f"side {side} step {it}: egrav {dg['egrav']} vs cpu "
                                 f"{dc['egrav']}")
        for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "du", "alpha"):
            a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=rtol, atol=5e-6 * scale,
                                       msg=f"{prop} {case} {side} step {it}: {f}")
            worst = max(worst, float((a - b).abs().max()) / (scale or 1.0))
    fold = engine_fold(gpu.box, gpu.cfg.nbr)
    if use_lists and not fold and (gpu.lists is None or dg["use_lists"] != 1.0):
        raise AssertionError(f"side {side}: the list-mode run streamed")
    return {"phase": "slice_vs_cpu", "prop": prop, "case": case, "side": side,
            "n": gpu.state.n, "cell_target": cell_target, "use_lists": use_lists,
            "fold": fold, "rebuilds": [gpu.rebuilds, cpu.rebuilds],
            "steps": steps, "max_abs_err_over_scale": worst,
            "energy_drift_gpu": gpu.energy_drift, "energy_drift_cpu": cpu.energy_drift,
            "ewald": gpu.ewald_on, "overrides": overrides,
            **({"m2p_max": [dg["m2p_max"], dc["m2p_max"]],
                "p2p_max": [dg["p2p_max"], dc["p2p_max"]]} if gpu.gravity_on else {})}


def gravity_checks() -> dict:
    """K13 and K12 against their plain versions and whole gravity solves
    on the card against the CPU (sphexa_torch/kernels/checks.py, shared
    with tests/test_torch_gpu.py)."""
    from sphexa_torch.kernels import checks

    out = {"phase": "gravity_vs_plain", "compact": checks.compact_random_cases("cuda")}
    sim, ss, box, keys = checks.gravity_case(20, "cuda")
    g, meta = sim.cfg.gravity, sim.cfg.grav_meta
    starts, lens, _ = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                               meta, g)
    p2p = (ss.x, ss.y, ss.z, ss.m, ss.h, g, starts, lens)
    out["p2p_evrard20"] = checks.p2p_vs_plain("Evrard 20", *p2p)
    out["p2p_evrard20_image_self"] = checks.p2p_vs_plain(
        "Evrard 20 image", *p2p, shift=checks.IMAGE_SHIFT, allow_self=True)
    # the self pair is a real pair at a shift: the kernel's self test drops it
    out["p2p_evrard20_image_noself"] = checks.p2p_vs_plain(
        "Evrard 20 image without the self pair", *p2p, shift=checks.IMAGE_SHIFT,
        allow_self=False)
    sim, ss, box, keys = checks.gravity_case(30, "cuda")
    g, meta = sim.cfg.gravity, sim.cfg.grav_meta
    if g.compaction != "sort":
        raise AssertionError(f"Evrard 30: expected the sort compaction, got {g.compaction}")
    out["solves_evrard30"] = {
        mode: checks.gravity_vs_cpu(f"Evrard 30 {mode}", ss.x, ss.y, ss.z, ss.m, ss.h, keys,
                                    box, sim.gtree, meta, cfg)
        for mode, cfg in (("sort", g),
                          ("bitmask_sf8", dataclasses.replace(
                              g, compaction="bitmask", super_factor=8,
                              super_cap=meta.num_nodes)))}
    return out


def near_field_load(lens, group: int) -> dict:
    """How the near field's work spreads over the target blocks: each
    block's candidates (the sum of its leaf lengths; x ``group`` targets
    for its pairs), their mean, 99th percentile and max, and max / mean."""
    import torch

    per = lens.to(torch.int64).sum(dim=1).to(torch.float64)
    mean = float(per.mean())
    return {"blocks": int(per.shape[0]), "target_block": group,
            "cand_per_block_mean": mean, "cand_per_block_p50": float(per.median()),
            "cand_per_block_p99": float(torch.quantile(per, 0.99)),
            "cand_per_block_max": float(per.max()), "cand_per_block_min": float(per.min()),
            "max_over_mean": float(per.max()) / max(mean, 1.0),
            "live_slots_mean": float((lens > 0).sum(dim=1).double().mean()),
            "slots": int(lens.shape[1])}


def gravity_phase_times(sim, reps: int = 3) -> dict:
    """One gravity solve on the path's current sorted state, its phases
    timed by CUDA events (median of ``reps`` solves): multipoles, MAC with
    the K13 compactions, M2P, the near-field prologue (the leaf ranges),
    K12; an Ewald solve's phases summed over its replica passes, then its
    real-space and k-space corrections."""
    import torch

    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.gravity.ewald import compute_gravity_ewald
    from sphexa_torch.propagator import _force_stage_prologue

    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    cfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g)
    args = (ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree, sim.cfg.grav_meta, cfg)
    runs, out = [], None
    for _ in range(reps):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        mark("start")
        if sim.cfg.ewald is not None:
            out = compute_gravity_ewald(*args, sim.cfg.ewald, timer=mark)
        else:
            out = gt.compute_gravity(*args, timer=mark)
        torch.cuda.synchronize()
        run = collections.defaultdict(float)
        for i in range(1, len(marks)):
            run[marks[i][0]] += marks[i - 1][1].elapsed_time(marks[i][1])
        runs.append(run)
    ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return {"ms": ms, "solve_ms": sum(ms.values())}, (ss, box, keys, cfg, out)


def gravity_accuracy(ss, cfg, out, samples: int = 4096) -> dict:
    """The tree's accelerations against direct summation over all sources
    for ``samples`` targets drawn from a seeded generator, held to
    tests/test_gravity.py's theta-0.5 bounds: rms relative error < 0.01,
    99th percentile < 0.05."""
    import torch

    from sphexa_torch.gravity.direct import direct_gravity

    n = ss.x.shape[0]
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(125))[:samples]
    idx = idx.to(ss.x.device)
    dax, day, daz, _ = direct_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, G=cfg.G, targets=idx)
    ax, ay, az = (a[idx] for a in out[:3])
    err = torch.sqrt((ax - dax) ** 2 + (ay - day) ** 2 + (az - daz) ** 2)
    rel = err / torch.clamp_min(torch.sqrt(dax * dax + day * day + daz * daz), 1e-6)
    rms = float(torch.sqrt(torch.mean(rel * rel)))
    p99 = float(torch.quantile(rel, 0.99))
    if not (rms < 0.01 and p99 < 0.05):
        raise AssertionError(f"tree vs direct: rms {rms}, 99th percentile {p99}")
    return {"samples": samples, "rms_rel_err": rms, "p99_rel_err": p99,
            "max_rel_err": float(rel.max())}


def count_syncs(sim) -> dict:
    """Host syncs of one main-path step, by the line that made each
    (``deferred_checks.sync_sites``)."""
    from sphexa_torch.kernels.deferred_checks import sync_sites

    sites = sync_sites(sim.step)
    return {"phase": "host_syncs", "per_step": sum(sites.values()),
            "sites": dict(sites.most_common())}


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def launch_loop_ms(launch, n: int) -> float:
    """A kernel's own device time: the mean over ``n`` launches back to
    back between two CUDA events, after one warm-up. ``launch`` is its
    entry point with the arguments built once (a ``*_launcher``), so each
    launch costs the host one ctypes call and the wrapper's argument
    building, which a CUDA-event time around one short call also counts,
    stays out of the loop."""
    import torch

    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def sm_clocks() -> dict:
    """nvidia-smi's reading, now, of the SM clock, its maximum and the
    power draw."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    sm, sm_max, power = (float(v) for v in out.strip().splitlines()[0].split(","))
    return {"sm_mhz": sm, "max_sm_mhz": sm_max, "power_w": power}


def clocks_under_load(launch, ms_each: float) -> dict:
    """``sm_clocks`` read while launches of a kernel of about ``ms_each``
    keep the card busy: enough of them are queued to last three times as
    long as one idle reading took, and four times as many again whenever
    the card ran dry before the reading came back (a reading under load
    can take longer than an idle one). Raises if it ran dry three times."""
    import torch

    t0 = time.perf_counter()
    idle = sm_clocks()
    latency_s = time.perf_counter() - t0
    n = max(20, int(3e3 * latency_s / ms_each) + 1)
    for _ in range(3):
        torch.cuda.synchronize()
        for _ in range(n):
            launch()
        drained = torch.cuda.Event()
        drained.record()
        busy = sm_clocks()
        if not drained.query():
            drained.synchronize()
            return {**busy, "launches": n, "idle_sm_mhz": idle["sm_mhz"],
                    "reading_s": latency_s}
        n *= 4
    raise AssertionError(f"the card ran dry before nvidia-smi read its clock "
                         f"({n // 4} launches of {ms_each:.3f} ms, one idle reading "
                         f"{latency_s:.3f} s)")


def profile_steps(sim, steps: int, step_ms_unprofiled: float) -> dict:
    """Device time per main-path step from a torch.profiler trace of
    ``steps`` steps: the union of the device-side events (kernels, copies,
    fills; the host-side aten ops are left out, as their kernels already
    stand for them). The busy share divides it by the unprofiled step
    time, since the profiler's own host cost stretches the profiled one.
    Also the host's time blocked in synchronizing CUDA runtime calls.
    Reports null where the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sim.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_ms = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev]) / 1e3 / steps
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += e["dur"] / 1e3 / steps
        by_name[e["name"]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    # host time spent waiting on the device inside synchronizing runtime calls
    waits = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and ("Synchronize" in e["name"] or e["name"] == "cudaMemcpy")]
    return {"phase": "profile", "steps": steps, "profiled_wall_ms_per_step": 1e3 * wall / steps,
            "device_events_per_step": len(dev) / steps,
            "device_ms_per_step": busy_ms if dev else None,
            "step_ms_unprofiled": step_ms_unprofiled,
            "device_busy_share": busy_ms / step_ms_unprofiled if dev else None,
            "host_wait_ms_per_step": sum(e["dur"] for e in waits) / 1e3 / steps,
            "host_waits_per_step": len(waits) / steps,
            "top_device_ms_per_step": [[k[:60], v[0], v[1] / steps] for k, v in top]}


def drive(make_sim, steps: int, label: str, drift_bound=1e-3, warmup: bool = True) -> dict:
    """Drive one path of the port through its entry points: the launch
    counts are set to 0 just before the Simulation is made, then one
    warm-up step (on the list path: the first list build; none with
    ``warmup`` False, for a path whose first step builds nothing) and
    ``steps`` timed steps, and the counts are read just after. Checks that
    the run conserves energy (drift < ``drift_bound``; None: a finite
    drift) and stays finite."""
    import torch

    from sphexa_torch.sph import pair_engine as pe

    torch.cuda.synchronize()
    pe.reset_launches()
    sim = make_sim()
    t0 = time.perf_counter()
    d0 = sim.step() if warmup else None
    first_s = time.perf_counter() - t0
    replays0 = sim.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diags, step_ms = [], []
    for _ in range(steps):
        diags.append(sim.step())
        step_ms.append(1e3 * sim.last_step_seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pe.LAUNCHES)
    attempts = int(warmup) + steps + sim.replays
    d0 = d0 or diags[0]
    drift = sim.energy_drift
    if drift is None or not drift == drift or (drift_bound is not None
                                                 and abs(drift) >= drift_bound):
        raise AssertionError(f"{label}: energy drift {drift}")
    last = diags[-1]
    for k in ("dt", "nc_mean", "rho_max", "h_max", "obs_etot"):
        if not abs(last[k]) < float("inf"):
            raise AssertionError(f"{label}: non-finite {k}: {last[k]}")
    n = sim.state.n
    for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha"):
        a = getattr(sim.state, f)
        if a.shape != (n,) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: state field {f} is not finite of shape ({n},)")
    report = {
        "phase": label, "n": n, "steps": steps,
        "wall_s": wall, "particle_updates_per_s": n * steps / wall,
        "step_ms": step_ms, "energy_drift": drift,
        "nc_mean": last["nc_mean"], "nc_max": last["nc_max"],
        "occupancy": last["occupancy"], "cap": sim.cfg.nbr.cap,
        "nbr": dataclasses.asdict(sim.cfg.nbr), "reconfigures": sim.reconfigures,
        "replays": sim.replays, "replays_timed": sim.replays - replays0,
        "launches": launches, "step_attempts": attempts,
        "dt": [d["dt"] for d in diags], "warmup_dt": d0["dt"],
        "warmup_s": first_s, "use_lists": [d["use_lists"] for d in diags]}
    return {"sim": sim, "report": report, "launches": launches, "attempts": attempts,
            "rebuilds": sim.rebuilds, "diags": diags, "first_build_s": first_s,
            "step_ms_median": 1e3 * wall / steps}


def deferred_run(make_sim, to_step: int, from_step: int = 14) -> dict:
    """Drive a Simulation to ``to_step`` (its last window flushed), each
    ``step()`` call timed on the host: a window's per-step wall is the sum
    of its calls' walls (the launches, the flush's read, and a rebuild or
    a rollback's replay made at the flush) over its steps, and each step
    of the window gets it (with ``check_every`` 1 each step its own call).
    The launch counts are set to 0 just before the Simulation is made and
    read at ``to_step``. Reports windows, rollbacks by reason, replays,
    rebuilds, the per-step wall over steps ``from_step``..``to_step``
    (mean and median), the science rows and the drift."""
    import torch

    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.telemetry import MemorySink, Telemetry

    torch.cuda.synchronize()
    pe.reset_launches()
    sink = MemorySink()
    sim = make_sim(Telemetry(sinks=[sink]))
    per_step, acc, it0 = {}, 0.0, 0
    while sim.iteration < to_step or sim._pending:
        t0 = time.perf_counter()
        sim.step() if sim.iteration < to_step else sim.flush()
        acc += time.perf_counter() - t0
        if not sim._pending:  # a window (or a checked step) ended
            for it in range(it0 + 1, sim.iteration + 1):
                per_step[it] = 1e3 * acc / (sim.iteration - it0)
            acc, it0 = 0.0, sim.iteration
    launches = dict(pe.LAUNCHES)
    rows = sim.drain_science()
    if [r["it"] for r in rows] != list(range(1, to_step + 1)):
        raise AssertionError(f"check_every {sim.check_every}: science rows of "
                             f"{[r['it'] for r in rows][:5]}..., expected 1..{to_step}")
    drift = sim.energy_drift
    if drift is None or not abs(drift) < 1e-3:
        raise AssertionError(f"check_every {sim.check_every}: energy drift {drift}")
    ms = [per_step[it] for it in range(from_step, to_step + 1)]
    report = {
        "check_every": sim.check_every, "to_step": sim.iteration,
        "windows": len(sink.of_kind("window")), "checked_steps": len(sink.of_kind("step")),
        "rollbacks": dict(collections.Counter(e["reason"] for e in sink.of_kind("rollback"))),
        "replays": sim.replays, "rebuilds": sim.rebuilds, "reconfigures": sim.reconfigures,
        "step_ms_mean": statistics.mean(ms), "step_ms_median": statistics.median(ms),
        "step_ms_max": max(ms), "science_rows": len(rows), "energy_drift": drift,
        "window_per_step_ms_median": statistics.median(
            [1e3 * e["per_step_s"] for e in sink.of_kind("window")]) if sink.of_kind("window")
        else None}
    return {"sim": sim, "sink": sink, "report": report, "launches": launches,
            "attempts": sim.iteration + sim.replays, "per_step": per_step}


def deferred_windows(sim, happy_ms: float, to_step: int = 100) -> dict:
    """Whole deferred windows of ``sim`` (made at step 0) up to ``to_step``,
    each either counted (``deferred_checks.window_syncs``: host syncs by
    site, list builds, rollbacks) or, every other window until one without
    a list build or a rollback is found, profiled (``profile_steps`` over
    the window's steps against ``happy_ms``, the unprofiled per-step wall
    of the timed run's happy windows). Asserts that every counted window
    without a rollback makes one host sync plus two per list build (its
    overflow flag and its word total) and that one such window has no
    build."""
    from sphexa_torch.kernels import deferred_checks

    counted, profiled, k = [], None, 0
    while sim.iteration < to_step:
        b0, r0 = sim.rebuilds, sim.rollbacks
        if profiled is None and k % 2 == 1:
            prof = profile_steps(sim, sim.check_every, happy_ms)
            if sim.rebuilds == b0 and sim.rollbacks == r0:
                profiled = {**prof, "window_end": sim.iteration}
        else:
            counted.append({**deferred_checks.window_syncs(sim), "window_end": sim.iteration})
        k += 1
    bad = [w for w in counted if not w["rollbacks"] and w["syncs"] != 1 + 2 * w["rebuilds"]]
    if bad or not any(not w["rollbacks"] and not w["rebuilds"] for w in counted):
        raise AssertionError(f"deferred windows: host syncs {counted}")
    return {"window_syncs": counted, "happy_window_profile": profiled}


def pass_counts(ss, group: int, consts: dict, lists=None, ranges=None, fold=False) -> dict:
    """Body-pass counts of the engines' candidates on one state
    (``pair_engine.body_pass_counts``), for the mask of the ops without the
    symmetric cutoff ("nonsym": density, IAD, grad-h, divv/curlv, the AV
    switches) and with it ("sym": the momentum ops)."""
    from sphexa_torch.sph import pair_engine as pe

    i_f = [ss.x, ss.y, ss.z, ss.h]
    j_f = [ss.x, ss.y, ss.z, 1.0 / (ss.h * ss.h)]
    return {key: pe.body_pass_counts(spec, i_f, j_f, group, consts, PASS_WINDOWS, ranges=ranges,
                                     fold=fold, lists=lists)
            for key, spec in (("nonsym", pe.DENSITY),
                              ("sym", dataclasses.replace(pe.DENSITY, sym_j=3)))}


# the C++ op struct behind each OpSpec name (its template form by variant)
OP_STRUCT = {"density": "DensityOp", "iad": "IadOp", "momentum_energy_std": "MomentumEnergyStdOp",
             "ve_def_gradh": "VeDefGradhOp", "iad_divv_curlv": "DivvCurlvOp",
             "av_switches": "AvSwitchesOp", "momentum_energy_ve": "MomentumEnergyVeOp"}


def ptxas_report(log: str) -> dict:
    """ptxas's -v report per kernel entry (mangled name): registers, stack
    frame and spill bytes."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def ptxas_of(report: dict, spec, walk: bool, fold: bool, ncoef: int = 14):
    """ptxas's entry for one engine instantiation, found by its mangled
    name (pair_engine<Op, FOLD, SYM> or list_walk<Op, SYM>, the op of
    ``ncoef`` polynomial coefficients), or None."""
    cls = OP_STRUCT[spec.name]
    variant = (f"Lb{int(spec.variant)}E"
               if spec.name in ("iad_divv_curlv", "momentum_energy_ve") else "")
    op = f"{len(cls)}{cls}I{variant}Li{ncoef}EE"
    sym = int(spec.sym_j is not None)
    key = (f"9list_walkI{op}Lb{sym}EE" if walk
           else f"11pair_engineI{op}Lb{int(fold)}ELb{sym}EE")
    hits = [v for k, v in report.items() if key in k]
    return hits[0] if len(hits) == 1 else None


def p2p_entry(report: dict, blk: int, res: dict) -> dict:
    """The engines line's entry of K12 (csrc/gravity_p2p.cu) at blocks of
    ``blk`` targets: its static facts (``traversal.p2p_kernel_info``:
    registers, local bytes, shared bytes, resident blocks and warps per
    SM, the staged tile, the targets a thread), ptxas's report and its
    times at Evrard 125."""
    from sphexa_torch.gravity import traversal as gt

    info = gt.p2p_kernel_info(blk)
    key = f"18gravity_p2p_kernelILi{info['targets_per_thread']}EE"
    hits = [v for k, v in report.items() if key in k]
    return {"engine": "K12", "instantiation": "gravity_p2p", "source": SOURCE["gravity_p2p"],
            "fold": False, **info,
            "ptxas": hits[0] if len(hits) == 1 else None, "state": "evrard_125",
            "ms": res["ms"], "batched_ms": res["batched_ms"]}


def mark_entry(report: dict, res: dict, slot_cap: int) -> dict:
    """The engines line's entry of K5 (csrc/pair_lists.cu list_build_kernel)
    at the std main path's sizes: its static facts
    (``pair_lists.list_build_info``: registers, local bytes, shared bytes,
    resident blocks and warps per SM; "window" is the chunk's lanes),
    ptxas's report and its times at side 100."""
    from sphexa_torch.sph import pair_lists as pl

    hits = [v for k, v in report.items() if "17list_build_kernel" in k]
    return {"engine": "K5", "instantiation": "list_build", "source": SOURCE["mark"],
            "fold": False, **pl.list_build_info(res["w3"], slot_cap),
            "ptxas": hits[0] if len(hits) == 1 else None, "state": "std_lists",
            "ms": res["ms"], "kernel_ms": res["kernel_ms"]}


def engine_entries(specs: dict, at: dict, passes: dict, report: dict, engine: str,
                   group: int, folds=(False,), ncoef: int = 14) -> list:
    """The engines line's entries of one engine ("K1" streaming, "K6" list
    walk): for each instantiation its static facts (``kernel_info``:
    registers, local bytes, shared bytes, resident blocks and warps per SM,
    the window), ptxas's spill report, and where a side-100 path ran it,
    its times and the body-pass efficiency of the old union rule and of
    the per-lane windows on that path's state."""
    from sphexa_torch.sph import pair_engine as pe

    walk = engine == "K6"
    out = []
    for key, spec in specs.items():
        for fold in folds:
            info = pe.kernel_info(spec, group, walk, fold=fold, ncoef=ncoef)
            entry = {"engine": engine, "instantiation": key, "fold": fold, **info,
                     "ptxas": ptxas_of(report, spec, walk, fold, ncoef)}
            if key in at and not fold:
                res, state, rkey = at[key]
                entry.update(state=state, ms=res[rkey]["ms"],
                             batched_ms=res[rkey].get("batched_ms"),
                             mask_ms=res[rkey].get("mask_ms"))
                if state in passes:
                    c = passes[state]["sym" if spec.sym_j is not None else "nonsym"]
                    entry.update(
                        pairs=c["pairs"], lane_passes_union=c["union"],
                        lane_passes_windows=c["windows"],
                        efficiency_union=c["pairs"] / max(c["union"], 1),
                        efficiency_windows={w: c["pairs"] / max(v, 1)
                                            for w, v in c["windows"].items()})
            out.append(entry)
    return out


def check_launches(label: str, launches: dict, attempts: int, on_path, rebuilds: int = 0,
                   compactions: int = 0, passes: int = 1) -> None:
    """The launch contract of a driven path: each pair-engine entry point
    of ``on_path`` once per step attempt and every other one never (in
    list mode every SPH op runs the list walk, K1 not at all), the mark
    pass once per list build; the gravity near field K12 once per solve
    pass (``passes`` per attempt: an Ewald solve's replicas) and the
    compaction ``compactions`` times per pass."""
    want = {k: 0 for k in launches}
    want.update({k: attempts for k in on_path})
    if "gravity_p2p" in on_path:
        want["gravity_p2p"] = passes * attempts
    want["mark"] = rebuilds
    want["compact_class_lists"] = compactions * passes * attempts
    if launches != want or (rebuilds == 0 and any(k.split(":")[0].endswith("_lists")
                                                  for k in on_path)):
        raise AssertionError(f"{label}: launches {launches} in {attempts} step attempts with "
                             f"{rebuilds} list builds; expected {want}")


def io_restart(spec) -> dict:
    """Phase ``io_restart`` (``kernels/io_checks.py``): std Sedov 100^3 in
    list mode, checked every step, to step 20, dumped (.npz, the output
    fields through K1's density op) and read back bit for bit; restarted
    beside the unbroken run to step 40 (and beside a run made from the
    unbroken state in memory, which splits the difference between the
    list rebuild and the reset two-sum carry). The launch counts are set
    to 0 just before and read just after: K1's density op once (the
    output fields), K5 at each list build, the three std walks of K6 at
    every step, no other K1 op. Then the output fields against their
    plain versions at the step-20 state (std; VE: xmass and grad-h) with
    one call's time; the reference CI's three configurations (side 50,
    200 steps, check_every 10) with their L1 windows, counted the same
    way; the CLI restarted from the dump to step 30 in a process of its
    own. Returns the report; raises on a failed check, an L1 miss after
    the report is printed."""
    import shutil

    import torch

    from sphexa_torch.analysis import output_fields
    from sphexa_torch.kernels import io_checks
    from sphexa_torch.sph import pair_engine as pe

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="io_restart_")
    try:
        torch.cuda.synchronize()
        pe.reset_launches()
        r = io_checks.restart_vs_unbroken("sedov", 100, "cuda", tmp, spec=spec)
        launches = dict(pe.LAUNCHES)
        walk = ("density_lists", "iad_lists", "momentum_energy_std_lists")
        streaming = [k for k in launches if not k.endswith("_lists") and k not in (
            "density", "mark")]
        if (launches["density"] != 1 or launches["mark"] < 3
                or any(launches[k] < 3 * (r["to_step"] - r["dump_at"]) for k in walk)
                or any(launches[k] for k in streaming)):
            raise AssertionError(f"io_restart: launches {launches}")
        state, box, cfg = r.pop("restored")
        fields = {}
        for pipeline in ("std", "ve"):
            fields[pipeline] = {
                "max_abs_err": io_checks.output_fields_vs_plain(
                    "Sedov 100 step 20", state, box, cfg, pipeline),
                "ms": cuda_time_ms(lambda: output_fields(state, box, cfg, pipeline), reps=5),
                "plain_ms": cuda_time_ms(
                    lambda: output_fields(state, box, cfg, pipeline, ops="plain"), reps=1)}
        torch.cuda.synchronize()
        pe.reset_launches()
        l1 = [io_checks.l1_reference(case, prop, 50, 200, "cuda")
              for case, prop in (("sedov", "std"), ("sedov", "ve"), ("noh", "std"))]
        l1_launches = dict(pe.LAUNCHES)
        # the output fields: K1's density op in each run (twice in the VE
        # run: the std estimator and xmass), grad-h once
        if l1_launches["density"] < 4 or l1_launches["ve_def_gradh"] < 1:
            raise AssertionError(f"io_restart L1 runs: launches {l1_launches}")
        cli = io_checks.cli_restart(r["path"], os.path.join(tmp, "cli"), to_step=30,
                                    device="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for res in l1:
        res["misses"] = io_checks.l1_misses(res)
    r.pop("path")
    report = {"phase": "io_restart", **r, "launches": launches,
              "output_fields": fields, "l1_reference": l1, "l1_launches": l1_launches,
              "cli": cli, "seconds": time.perf_counter() - t_phase}
    emit(report)
    misses = [(x["case"], x["prop"], x["misses"]) for x in l1 if x["misses"]]
    if misses:
        raise AssertionError(f"io_restart: reference configurations outside their L1 "
                             f"windows: {misses}")
    return report


def path_gravity_kernels(label: str, ss, keys, box, sim, cfg, shift=None,
                         allow_self: bool = False) -> dict:
    """K12 and K13 at a gravity path's sorted state (one solve pass; with
    ``shift`` a replica pass of Ewald's, its targets shifted and the self
    pair as ``allow_self``), each against its plain version: K12 on 256
    target blocks spread over those with near-field work, K13 on both of
    the pass's packed arrays, exactly; each kernel's one-call time and its
    own time launched back to back (the launches made here count in no
    path)."""
    import torch

    from sphexa_torch.gravity import pallas_compact as pcmp
    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.kernels import checks

    meta = sim.cfg.grav_meta
    starts, lens, cls = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                                 meta, cfg, keep_packed=True, shift=shift)
    busy = torch.nonzero(lens.sum(dim=1) > 0).flatten()
    if busy.numel() == 0:
        raise AssertionError(f"{label}: no target block has near-field work")
    pick = torch.linspace(0, busy.numel() - 1, min(256, busy.numel()), device=busy.device)
    groups = busy[pick.round().long()]
    sh = None if shift is None else tuple(float(v) for v in shift)
    p2p = checks.p2p_vs_plain(label, ss.x, ss.y, ss.z, ss.m, ss.h, cfg, starts, lens,
                              groups=groups, shift=sh, allow_self=allow_self)
    z3 = shift if shift is not None else torch.zeros(3, device="cuda")
    args = (ss.x, ss.y, ss.z, ss.m, ss.h, z3, allow_self, cfg, starts, lens)
    p2p["ms"] = cuda_time_ms(lambda: gt._pallas_p2p(*args), reps=5)
    p2p["kernel_ms"] = launch_loop_ms(gt.p2p_launcher(*args)[0], 10)
    p2p["busy_blocks"] = int(busy.numel())
    packed = cls["packed"]
    comp = {"checks": [checks.compact_vs_plain(f"{label} compaction {i}", *pk)
                       for i, pk in enumerate(packed)],
            "shapes": [list(pk[0].shape) + [pk[1], pk[2]] for pk in packed]}
    comp["max_abs_err"] = max(c["max_abs_err"] for c in comp["checks"])
    comp["ms"] = cuda_time_ms(lambda: [pcmp.compact_class_lists(*pk) for pk in packed], reps=5)
    comp["kernel_ms"] = [launch_loop_ms(pcmp.compact_launcher(*pk)[0], 50) for pk in packed]
    return {"gravity_p2p": p2p, "compact_class_lists": comp,
            "near_field_load": near_field_load(lens, cfg.target_block),
            "m2p_n_mean": float(cls["m2p_n"].float().mean())}


def gravity_report(run, sim) -> dict:
    """A driven gravity path's report: its solver config and tree, the
    tree build, each timed step's gravity diagnostics and dt limiter, the
    launches per step attempt and the peak memory."""
    import torch

    gkeys = ("m2p_max", "p2p_max", "leaf_occ", "c_max", "compact_width", "egrav")
    return {**run["report"], "gravity": dataclasses.asdict(sim.cfg.gravity),
            "ewald": None if sim.cfg.ewald is None else dataclasses.asdict(sim.cfg.ewald),
            "tree": {"leaves": sim.cfg.grav_meta.num_leaves,
                     "nodes": sim.cfg.grav_meta.num_nodes},
            "tree_build_configure_s": sim.grav_configure_seconds,
            "gravity_diags": [{k: d[k] for k in gkeys if k in d} for d in run["diags"]],
            "dt_limiter": [d["dt_limiter"] for d in run["diags"]],
            "launches_per_attempt": {k: v / run["attempts"] for k, v in run["launches"].items()
                                     if v},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def nbody_path(spec, smi) -> dict:
    """The N-body propagator at full width: Simulation(prop="nbody") on
    the 10^6-particle Plummer sphere of the JAX package's gravity
    benchmark and on Evrard 125 (1,022,790 particles), each one warm-up
    and one timed step with the counts reset just before and read just
    after (K12 once and K13 twice per step attempt, nothing else), its
    host syncs, gravity phases, forces against direct summation on 4,096
    targets (rms < 0.01, p99 < 0.05) and K12 / K13 against their plain
    versions at its state; then the CLI ``--init evrard -n 125 --prop
    nbody`` for three steps (constants.txt rows, launches). Returns each
    driven run's launches."""
    import torch

    from sphexa_torch.app import main as app
    from sphexa_torch.init import init_evrard
    from sphexa_torch.init.plummer import plummer_state
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    launches = {}
    for label, make in (("plummer", lambda: plummer_state(1_000_000, device="cuda")),
                        ("evrard", lambda: init_evrard(125, device="cuda"))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state, box, const = make()
        run = drive(lambda: Simulation(state, box, const, prop="nbody", device="cuda",
                                       obs_spec=spec), steps=1, label=f"nbody_{label}")
        sim = run["sim"]
        check_launches(f"nbody {label}", run["launches"], run["attempts"], ("gravity_p2p",),
                       compactions=2)
        syncs = count_syncs(sim)
        if syncs["per_step"] != 1:
            raise AssertionError(f"nbody {label}: {syncs['per_step']} host syncs per step")
        gphases, (ss, gbox, keys, gcfg, gout) = gravity_phase_times(sim, reps=2)
        emit({**gravity_report(run, sim), "phase": "nbody_path", "case": label, "card": smi,
              "host_syncs_per_step": syncs["per_step"], "gravity_phases": gphases,
              "gravity_accuracy": gravity_accuracy(ss, gcfg, gout),
              "kernels": path_gravity_kernels(f"nbody {label}", ss, keys, gbox, sim, gcfg),
              "seconds": time.perf_counter() - t0})
        launches[f"nbody_{label}"] = run["launches"]
        del run, sim, ss, gout
    # the CLI's N-body run, counted from just before it to just after
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        pe.reset_launches()
        rc = app.main(["--init", "evrard", "-n", "125", "-s", "3", "--prop", "nbody",
                       "-o", out, "--quiet"])
        cli_launches = dict(pe.LAUNCHES)
        rows = [ln.split() for ln in open(os.path.join(out, "constants.txt"))
                if not ln.startswith("#")]
    if rc != 0 or len(rows) != 3:
        raise AssertionError(f"nbody CLI: exit {rc}, {len(rows)} constants.txt rows")
    vals = [[float(v) for v in r] for r in rows]
    if not all(v == v and abs(v) < float("inf") for r in vals for v in r) or \
            not all(r[6] < 0.0 for r in vals):
        raise AssertionError(f"nbody CLI: constants.txt rows {vals}")
    if cli_launches.get("gravity_p2p", 0) < 3 or set(
            k for k, v in cli_launches.items() if v) - {"gravity_p2p", "compact_class_lists"}:
        raise AssertionError(f"nbody CLI: launches {cli_launches}")
    emit({"phase": "nbody_cli", "argv": "--init evrard -n 125 -s 3 --prop nbody",
          "rows": vals, "launches": cli_launches, "seconds": time.perf_counter() - t0})
    return launches


def ewald_path(spec, smi) -> dict:
    """Periodic self-gravity: std Sedov 100^3 with G = 0.5 (the JAX
    README's ``--init sedov --G 0.5``) through Simulation(prop="std"),
    Ewald on: one timed step and no warm-up (its steps stream and build
    nothing: the tree is built at configuration; 1 + 2 until the block-dt
    and kernel-family phases needed the time, 1 + 1 until the app shell
    did) with the counts reset just
    before and read just after (the three streaming SPH ops once, K12 27
    times and K13 54 times per step attempt); the solve's parts by CUDA
    events (the replica passes' phases summed, the real-space and k-space
    corrections), each correction's peak memory; K12 against its plain
    version in a shifted replica pass with the self pair, and K13, at the
    path's state; then Sedov 16 with G = 0.5, one step on the card against
    the same step on the CPU, and one solve card vs CPU on 4,096 particles
    uniform in a periodic box (``checks.ewald_vs_cpu``). The energy drift
    is reported, not bounded: the periodic egrav follows the softening's
    h and its constant is a convention (tests/test_ewald.py:181-185); the
    card-vs-CPU step and solve and the finite fields are the checks.
    Returns the run's launches."""
    import torch

    from sphexa_torch.gravity import ewald as ew
    from sphexa_torch.init import init_sedov
    from sphexa_torch.kernels import checks
    from sphexa_torch.simulation import Simulation

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, box, const = init_sedov(100, overrides={"gravConstant": 0.5}, device="cuda")
    run = drive(lambda: Simulation(state, box, const, prop="std", device="cuda",
                                   obs_spec=spec), steps=1, label="ewald_path",
                drift_bound=None, warmup=False)
    sim = run["sim"]
    if not sim.ewald_on:
        raise AssertionError("Ewald path: the periodic box did not take the Ewald solve")
    passes = len(ew.replica_shells(sim.cfg.ewald))
    check_launches("Ewald", run["launches"], run["attempts"],
                   ("density", "iad", "momentum_energy_std", "gravity_p2p"),
                   compactions=2, passes=passes)
    report = gravity_report(run, sim)
    gphases, (ss, gbox, keys, gcfg, gout) = gravity_phase_times(sim, reps=1)
    ms = gphases["ms"]
    split = {"replica_passes_ms": sum(v for k, v in ms.items()
                                      if k not in ("real_space", "k_space")),
             "real_space_ms": ms["real_space"], "k_space_ms": ms["k_space"],
             "m2p_ms": ms["m2p"], "mac_ms": ms["mac"], "p2p_ms": ms["p2p"]}
    # the corrections alone: their peak memory above what is allocated
    node_mass, node_com, node_q, _ = ew.compute_multipoles(ss.x, ss.y, ss.z, ss.m, keys,
                                                           sim.gtree, sim.cfg.grav_meta)
    dr = torch.stack([ss.x, ss.y, ss.z], dim=1) - node_com[0][None, :]
    peaks = {}
    for name, fn in (("real_space", ew._real_space_correction),
                     ("k_space", ew._k_space_correction)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(dr, node_mass[0], node_q[0], gbox.lengths[0], sim.cfg.ewald)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # K12 in a replica pass: targets shifted one box length along x, the
    # self pair kept (as 26 of the 27 passes run it)
    shift = torch.tensor([1.0, 0.0, 0.0], device="cuda") * gbox.lengths[0]
    kern = path_gravity_kernels("Ewald replica (1, 0, 0)", ss, keys, gbox, sim, gcfg,
                                shift=shift, allow_self=True)
    base_kern = path_gravity_kernels("Ewald base pass", ss, keys, gbox, sim, gcfg)
    emit({"phase": "ewald_path", "card": smi, **report, "passes": passes,
          "egrav": [d["egrav"] for d in run["diags"]], "solve_split_ms": split,
          "gravity_phases": gphases, "corrections_peak_memory_gb": peaks,
          "kernels_replica": kern, "kernels_base": base_kern,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    small = slice_vs_cpu(16, None, steps=1, use_lists=False, prop="std", case="sedov",
                         overrides={"gravConstant": 0.5})
    if not small["ewald"]:
        raise AssertionError("Sedov 16 with G: expected the Ewald solve")
    # Sedov's lattice cancels its periodic forces to about 1e-3 of the
    # near field's terms, and its first dt (1e-6) hardly moves the state:
    # the solve itself is held card vs CPU where the forces do not cancel
    small["solve_random_4096"] = checks.ewald_vs_cpu("periodic random 4096")
    emit({**small, "seconds": time.perf_counter() - t0})
    return run["launches"]


def spherical_solves(sim, ss, box, keys, cfg) -> dict:
    """Open-box solves at the Evrard path's sorted state with the
    cartesian quadrupole and spherical multipoles of order 4 and 6 (their
    own upsweep included), each timed by CUDA events (one call) and held
    against direct summation on 4,096 targets; order 4 must come closer
    than the quadrupole (tests/test_spherical.py's knob)."""
    import torch

    from sphexa_torch.gravity import traversal as gt

    out = {}
    for order in (0, 4, 6):
        c = dataclasses.replace(cfg, multipole_order=order)
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = cuda_time_ms(lambda: res.append(gt.compute_gravity(
            ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree, sim.cfg.grav_meta, c)),
            reps=1, warmup=0)
        wall = time.perf_counter() - t0
        acc = gravity_accuracy(ss, c, res[-1])
        out[f"order_{order}"] = {"solve_ms": ms, "wall_s": wall, **acc,
                                 "egrav": float(res[-1][3]),
                                 "m2p_max": int(res[-1][4]["m2p_max"])}
        del res
    if not out["order_4"]["rms_rel_err"] < out["order_0"]["rms_rel_err"]:
        raise AssertionError(f"spherical order 4 rms {out['order_4']['rms_rel_err']} not "
                             f"below the quadrupole's {out['order_0']['rms_rel_err']}")
    return {"phase": "spherical", "side": 125, "n": ss.x.shape[0], "theta": cfg.theta,
            "results": out}


def turb_path(smi, ve_syncs: int, ve_events: float) -> dict:
    """The turb-ve propagator at full width: Simulation(prop="turb-ve") on
    the turbulence case at side 100 (10^6 particles, 112 stirring modes,
    periodic box, gamma 1.001, ng0 100) in list mode, one warm-up and ten
    timed steps with the counts reset just before and read just after
    (the six VE walks of K6 once per step attempt, K5 at each list build,
    K1 never); machRMS (the case's observable, in the step's ledger) over
    the steps; its host syncs and kernel events a step against the VE
    path's (``ve_syncs``, ``ve_events``: no more syncs); the stirring's
    parts by CUDA events at the path's state (the OU update with the
    host draw and its one copy, the projection, the (N, M) @ (M, 3)
    accelerations) and the host draw's own time; TF32 off (the flag read
    back); the OU draw that reached the card bit for bit the host's, and
    the run's key the key chain replayed on the host. Returns the run's
    launches."""
    import numpy as np
    import torch

    from sphexa_torch.init import init_turbulence
    from sphexa_torch.observables import make_observable_spec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import hydro_turb as ht
    from sphexa_torch.sph import threefry

    t0 = time.perf_counter()
    state, box, const = init_turbulence(100, device="cuda")
    run = drive(lambda: Simulation(state, box, const, prop="turb-ve", device="cuda",
                                   obs_spec=make_observable_spec("turbulence")),
                steps=10, label="turb_path")
    sim = run["sim"]
    if sim.lists is None:
        raise AssertionError("turb_path: the run streamed: no persistent lists")
    check_launches("turb-ve list mode", run["launches"], run["attempts"], VE_WALK,
                   run["rebuilds"])
    syncs = count_syncs(sim)
    if syncs["per_step"] > ve_syncs:
        raise AssertionError(f"turb_path: {syncs['per_step']} host syncs a step, the VE "
                             f"path {ve_syncs}")
    prof = profile_steps(sim, 2, run["step_ms_median"])
    # the stirring at the path's state, its parts by CUDA events
    s, turb, cfg = sim.state, sim.turb_state, sim.turb_cfg
    dt = s.min_dt
    zero = torch.zeros_like(s.x)
    parts = {
        "update_noise": cuda_time_ms(lambda: ht.update_noise(turb, dt, cfg), reps=7),
        "compute_phases": cuda_time_ms(lambda: ht.compute_phases(turb, cfg), reps=7),
        "st_calc_accel": cuda_time_ms(lambda: ht.st_calc_accel(
            s.x, s.y, s.z, turb, cfg, *ht.compute_phases(turb, cfg)), reps=7),
        "drive_turbulence": cuda_time_ms(lambda: ht.drive_turbulence(
            s.x, s.y, s.z, zero, zero, zero, dt, turb, cfg), reps=7)}
    key, sub = threefry.split(turb.key)
    t1 = time.perf_counter()
    z_host = threefry.normal(sub, tuple(turb.phases.shape))
    draw_ms = 1e3 * (time.perf_counter() - t1)
    z_card = ht._to_device(z_host, s.x.device).cpu().numpy()
    if z_card.view(np.uint32).tolist() != z_host.view(np.uint32).tolist():
        raise AssertionError("turb_path: the OU draw on the card differs from the host's")
    chain = ht.create_stirring_modes(1.0, device="cpu")[1].key
    for _ in range(sim.iteration):
        chain = threefry.split(chain)[0]
    if not np.array_equal(chain, turb.key):
        raise AssertionError(f"turb_path: key {turb.key} after {sim.iteration} steps, the "
                             f"host chain {chain}")
    mach = [d["obs_extra"] for d in run["diags"]]
    if not all(0.0 < m < 1.0 for m in mach) or mach[-1] <= mach[0]:
        raise AssertionError(f"turb_path: machRMS {mach}")
    emit({**run["report"], "card": smi, "modes": cfg.num_modes, "mach_rms": mach,
          "rebuilds": sim.rebuilds, "list_slot_cap": sim.cfg.list_slot_cap,
          "host_syncs_per_step": syncs["per_step"], "ve_host_syncs_per_step": ve_syncs,
          "device_events_per_step": prof["device_events_per_step"],
          "ve_device_events_per_step": ve_events, "profile": prof,
          "stirring_ms": parts, "host_draw_ms": draw_ms, "draw_bitwise": True,
          "key_chain_bitwise": True, "tf32": torch.backends.cuda.matmul.allow_tf32,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    return run["launches"]


def cooling_path(smi) -> dict:
    """The std-cooling propagator at full width: Simulation(prop=
    "std-cooling") on evrard-cooling at side 125 (1,022,790 particles,
    self-gravity: streaming; the reference case's units), CIE: one
    warm-up and two timed steps with the counts reset just before and read
    just after (the three std ops of K1 and K12 once, K13 twice per step
    attempt); then one step with the evolved network
    (``CoolingConfig(evolve_species=True)``) counted the same way; each
    step's dt_cool and whether it set the step (``dt_limiter`` 3); the
    cooling stage (its time step and source, CIE and evolved) by CUDA
    events at the path's state; host syncs a step. The drift is reported,
    not bounded: cooling takes energy out. Returns the runs' launches."""
    import torch

    from sphexa_torch.analysis import output_fields
    from sphexa_torch.init import init_evrard_cooling
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.physics.cooling import CoolingConfig, cool_step, cool_timestep
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    t0 = time.perf_counter()
    state, box, const = init_evrard_cooling(125, device="cuda")
    run = drive(lambda: Simulation(state, box, const, prop="std-cooling", device="cuda",
                                   obs_spec=ObservableSpec()),
                steps=2, label="cooling_path", drift_bound=None)
    sim = run["sim"]
    std_k1 = ("density", "iad", "momentum_energy_std", "gravity_p2p")
    check_launches("std-cooling Evrard", run["launches"], run["attempts"], std_k1,
                   compactions=2)
    if sim.lists is not None:
        raise AssertionError("cooling_path: lists on under self-gravity")
    syncs = count_syncs(sim)
    if syncs["per_step"] != 1:
        raise AssertionError(f"cooling_path: {syncs['per_step']} host syncs a step")
    evolved = CoolingConfig(gamma=const.gamma, evolve_species=True)
    sim.cooling_cfg = evolved
    torch.cuda.synchronize()
    pe.reset_launches()
    replays0 = sim.replays
    d_ev = sim.step()
    ev_launches = dict(pe.LAUNCHES)
    check_launches("std-cooling Evrard evolved", ev_launches, 1 + sim.replays - replays0,
                   std_k1, compactions=2)
    for k in ("dt", "dt_cool", "du_cool_min", "obs_etot"):
        if not abs(d_ev[k]) < float("inf"):
            raise AssertionError(f"cooling_path evolved: non-finite {k}")
    # the cooling stage at the path's state: rho from the density op
    s = sim.state
    rho = output_fields(s, sim.box, sim.cfg)["rho"]
    u = const.cv * s.temp
    stage = {}
    for name, ccfg in (("cie", CoolingConfig(gamma=const.gamma)), ("evolved", evolved)):
        stage[name] = {
            "timestep_ms": cuda_time_ms(lambda: cool_timestep(rho, u, sim.chem, ccfg), reps=5),
            "source_ms": cuda_time_ms(lambda: cool_step(s.min_dt, rho, u, sim.chem, ccfg),
                                      reps=5)}
    diags = run["diags"] + [d_ev]
    emit({**run["report"], "card": smi, "host_syncs_per_step": syncs["per_step"],
          "dt_cool": [d["dt_cool"] for d in diags],
          "du_cool_min": [d["du_cool_min"] for d in diags],
          "cool_set_dt": [d["dt_limiter"] == 3.0 for d in diags],
          "dt_limiter": [d["dt_limiter"] for d in diags],
          "egrav": [d["egrav"] for d in diags],
          "evolved_step_ms": 1e3 * sim.last_step_seconds, "evolved_launches": ev_launches,
          "cooling_stage_ms": stage,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    return {"cie": run["launches"], "evolved": ev_launches}


def turb_cooling_checks(smi) -> None:
    """Phase ``turb_cooling_vs_cpu`` (``kernels/aux_checks.py``): three
    steps card against CPU for turb-ve (turbulence side 20, ng0 20 and
    cell_target 16: list mode) and for std-cooling (evrard-cooling 16,
    self-gravity, CIE and evolved); then phase ``turb_cli``: the CLI's
    ``--init turbulence -n 30 -s 4 --prop turb-ve`` against the library's
    run, and the restart from its step-2 dump (``aux_checks.turb_restart``:
    the dump read back bit for bit, the first restarted step to the
    restart contract, the stirring key bit for bit; the CLI restarted in
    a process of its own). The card machine has no h5py, so the CLI's own
    ``-w`` dump cannot run there: the dump is the library's ``.npz`` of
    the fields the CLI writes."""
    import shutil

    from sphexa_torch.app import main as app
    from sphexa_torch.kernels import aux_checks

    t0 = time.perf_counter()
    emit({**aux_checks.aux_slice_vs_cpu("turb-ve", "turbulence", 20, 3, device="cuda",
                                        overrides={"ng0": 20, "ngmax": 70}, cell_target=16),
          "seconds": time.perf_counter() - t0})
    for evolve in (False, True):
        t0 = time.perf_counter()
        emit({**aux_checks.aux_slice_vs_cpu("std-cooling", "evrard-cooling", 16, 3,
                                            device="cuda", evolve=evolve),
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="turb_cli_")
    try:
        r = aux_checks.turb_restart(30, "cuda", tmp, dump_at=2, to_step=4)
        out = os.path.join(tmp, "fresh")
        rc = app.main(["--init", "turbulence", "-n", "30", "-s", "4", "--prop", "turb-ve",
                       "-o", out, "--quiet"])
        with open(os.path.join(out, "constants.txt")) as f:
            f.readline()
            rows = [[float(v) for v in ln.split()] for ln in f]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = r.pop("rows")
    worst = max(abs(a - b) / max(abs(b), 1e-30) for row, w in zip(rows, want)
                for a, b in zip(row, [w["it"], w["t"], w["dt"], w["etot"], w["ecin"],
                                      w["eint"], w["egrav"], w["extra"]]) if abs(b) > 1e-12)
    if rc != 0 or len(rows) != 4 or worst > 1e-6:
        raise AssertionError(f"turb CLI: exit {rc}, {len(rows)} rows, rel {worst} off the "
                             "library's run")
    emit({"phase": "turb_cli", "card": smi, "argv": "--init turbulence -n 30 -s 4 --prop turb-ve",
          "rows": rows, "rows_rel_err_vs_library": worst, "restart": r,
          "seconds": time.perf_counter() - t0})


#: the new inits' paths at full width: (case, side, timed steps, the
#: small side it runs card vs CPU at), about 10^6 particles each; the
#: Kelvin-Helmholtz slab's grid takes its cells from the 0.0625 thickness
#: (2 h must fit a cell edge), so a cell holds up to 28,352 candidates and
#: a step streams for 7.6 s: two timed steps there
INIT_PATHS = (("kelvin-helmholtz", 100, 1, 20), ("isobaric-cube", 100, 5, 20),
              ("wind-shock", 64, 5, 10))
STD_OPS = ("density", "iad", "momentum_energy_std")


def check_either_launches(label: str, launches: dict, attempts: int, ops,
                          rebuilds: int, extra=None) -> None:
    """The launch contract of a path whose steps may stream or walk lists
    (a re-size can move its grid in or out of fold mode): each op of
    ``ops`` once per step attempt, as K1 or as the list walk, the mark
    pass once per list build, ``extra`` (name -> count) as given, every
    other entry point never."""
    want_zero = {k for k in launches
                 if k not in ops and k[:-len("_lists")] not in ops and k != "mark"}
    bad = [op for op in ops if launches[op] + launches[op + "_lists"] != attempts]
    bad += [k for k in want_zero if launches[k] != (extra or {}).get(k, 0)]
    if bad or launches["mark"] != rebuilds:
        raise AssertionError(f"{label}: launches {launches} in {attempts} step attempts with "
                             f"{rebuilds} list builds (off: {bad})")


def inits_path(smi) -> dict:
    """Phase ``inits_path``: the Kelvin-Helmholtz slab (side 100: 1 x 1 x
    0.0625, a 2x density band), the isobaric cube (side 100, 8x centre)
    and the wind shock (side 64: 8r x 2r x 2r, a 10x cloud), each about
    10^6 particles, through Simulation(prop="std") on the card: one
    warm-up and five timed steps (the slab one, ``INIT_PATHS``), the
    counts reset just before and read
    just after (each std op once per step attempt, streaming or walking
    lists); steps/s and updates/s, whether lists ran, the neighbour counts'
    extremes at the last state, the drift, the case's observable column
    (the KH growth rate, the wind bubble's surviving fraction); then each
    case at a small side stepped on the card against the CPU. Returns
    each path's launches."""
    import torch

    from sphexa_torch.init import CASES
    from sphexa_torch.observables import make_observable_spec
    from sphexa_torch.propagator import _force_stage_prologue
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    out = {}
    for case, side, steps, _ in INIT_PATHS:
        t0 = time.perf_counter()
        state, box, const = CASES[case](side, device="cuda")
        run = drive(lambda: Simulation(state, box, const, device="cuda",
                                       obs_spec=make_observable_spec(case)),
                    steps=steps, label="inits_path")
        sim = run["sim"]
        check_either_launches(f"inits_path {case}", run["launches"], run["attempts"],
                              STD_OPS, run["rebuilds"])
        # the neighbour counts at the path's last state, by the density kernel
        ss, sbox, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
        ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, sbox, sim.cfg.nbr)
        nc = pe.pallas_density(ss.x, ss.y, ss.z, ss.h, ss.m, keys, sbox, sim.cfg.const,
                               sim.cfg.nbr, ranges=ranges)[1]
        ms = run["report"]["step_ms"]
        extra = [d.get("obs_extra") for d in run["diags"]]
        emit({**run["report"], "case": case, "side": side, "card": smi,
              "box_lengths": sim.box.lengths.tolist(), "steps_per_s": 1e3 / statistics.median(ms),
              "use_lists_any": any(run["report"]["use_lists"]), "rebuilds": sim.rebuilds,
              "nc_min": int(nc.min()) + 1, "nc_max_state": int(nc.max()) + 1,
              "observable": extra if extra[0] is not None else None,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - t0})
        out[case] = run["launches"]
    for case, _, _, small in INIT_PATHS:
        emit(slice_vs_cpu(small, None, steps=2, use_lists=True, prop="std", case=case))
    return out


def glass_phase(smi) -> None:
    """Phase ``glass``: ``generate_glass_template(side=8, relax_steps=8)``
    on the card against the same relaxation on the CPU (within 1e-5 of the
    box length), tiled by ``assemble_glass_cuboid`` into the Sedov box at
    64^3 (the card machine has no h5py: no template file is written)."""
    import numpy as np

    from sphexa_torch.init import glass

    t0 = time.perf_counter()
    tpl = glass.generate_glass_template(side=8, relax_steps=8, device="cuda")
    card_s = time.perf_counter() - t0
    ref = glass.generate_glass_template(side=8, relax_steps=8, device="cpu")
    err = 0.0
    for a, b in zip(tpl, ref):
        d = np.abs(a - b)
        err = max(err, float(np.minimum(d, 1.0 - d).max()))
    if err > 1e-5:
        raise AssertionError(f"glass: the card's template {err} off the CPU's")
    x, y, z = glass.assemble_glass_cuboid(tpl, (-0.5,) * 3, (0.5,) * 3, (64, 64, 64))
    inside = all(bool(((a >= -0.5) & (a < 0.5)).all()) for a in (x, y, z))
    if x.shape != (512 * 8**3,) or not inside:
        raise AssertionError(f"glass: tiled {x.shape} particles, inside the box {inside}")
    emit({"phase": "glass", "card": smi, "template": 512, "relax_steps": 8,
          "card_seconds": card_s, "max_err_vs_cpu": err, "tiled": int(x.shape[0]),
          "seconds": time.perf_counter() - t0})


#: the kernel families chip_smoke holds (kernel_choice, sinc index, timed)
FAMILIES = (("wendland-c6", 6.0, True), ("sinc", 5.0, False))
#: the wendland-c6 paths (label, prop, lists): each K1 and K6 op's 20-
#: coefficient form launched by a driven Simulation
WENDLAND_PATHS = (("wendland_std_lists", "std", True), ("wendland_std_streaming", "std", False),
                  ("wendland_ve_lists", "ve", True), ("wendland_ve_streaming", "ve", False))


def kernel_family(std_list, std_stream, ve_cases) -> dict:
    """Phase ``kernel_family``: every K1 and K6 op with wendland-c6 (the
    20-coefficient form) and with sinc at index 5 against its plain
    version at the side-100 states of phases 5-8 (the lists are geometric:
    the same lists serve every kernel), with today's tolerances and nc
    exact; wendland-c6's ops timed with their bounds. ``std_list`` and
    ``std_stream``: phase 8's std list and streaming cases; ``ve_cases``:
    label -> (sorted state, box, cfg, keys, lists or runs, av_clean).
    Returns, by family, the results and the bounds."""
    from sphexa_torch.sph import pair_engine as pe

    t0 = time.perf_counter()
    out = {}
    for kind, idx, timing in FAMILIES:
        ss, lbox, const, lcfg, lkeys, lists, lcull = std_list
        fc = const.with_kernel(kind, idx)
        ncoef = len(pe.op_consts(fc)["coeffs"])
        lres = compare_lists(f"{kind} lists side 100", ss, lbox, fc, lcfg, lkeys, lists, lcull,
                             timing=timing)
        ss2, box2, _, cfg2, keys2, ranges2 = std_stream
        res = compare_ops(f"{kind} side 100", ss2, box2, fc, cfg2, keys2, ranges2,
                          timing=timing)
        lbnd = bnd = None
        if timing:  # the bounds take the momentum ops' pair counts, which timing counts
            lbnd = list_bounds(lists, ss.n, lcfg.nbr.group, lres["density_lists"]["nb_pairs"],
                               pairs={op: r["pairs"] for op, r in lres.items() if "pairs" in r},
                               ncoef=ncoef)
            bnd = bounds(ranges2, ss2.n, cfg2.nbr.group, res["density"]["nb_pairs"],
                         pairs={op: r["pairs"] for op, r in res.items() if "pairs" in r},
                         ncoef=ncoef)
        ve = {}
        for label, (vs, vbox, vcfg, vkeys, table, av_clean) in ve_cases.items():
            walk = label != "ve_streaming"
            kw = {"lists": table} if walk else {"keys": vkeys, "ranges": table}
            vres = compare_ve(f"{kind} {label} side 100", vs, vbox, fc, vcfg.nbr, av_clean,
                              timing=timing, **kw)
            pairs = {op: r["pairs"] for op, r in vres.items() if "pairs" in r}
            if not timing:
                vbnd = None
            elif walk:
                vbnd = list_bounds(table, vs.n, vcfg.nbr.group, vres["xmass"]["nb_pairs"],
                                   walk_ops=("ve_def_gradh_lists", "iad_divv_curlv_lists",
                                             "av_switches_lists", "momentum_energy_ve_lists"),
                                   av_clean=av_clean, pairs=pairs, ncoef=ncoef)
            else:
                vbnd = bounds(table, vs.n, vcfg.nbr.group, vres["xmass"]["nb_pairs"],
                              ops=("ve_def_gradh", "iad_divv_curlv", "av_switches",
                                   "momentum_energy_ve"), pairs=pairs, ncoef=ncoef)
            ve[label] = (vres, vbnd)
        out[kind] = {"std_lists": (lres, lbnd), "std_streaming": (res, bnd), **ve,
                     "ncoef": ncoef}
        emit({"phase": "kernel_family", "kernel": kind, "sinc_index": idx, "ncoef": ncoef,
              "std_lists": {"results": lres, "bounds": lbnd},
              "std_streaming": {"results": res, "bounds": bnd},
              **{k: {"results": r, "bounds": b} for k, (r, b) in ve.items()}})
    out["seconds"] = time.perf_counter() - t0
    return out


def wendland_paths(spec, smi) -> dict:
    """The wendland-c6 paths: Sedov 100^3 with ``--kernel wendland-c6``'s
    constants through Simulation, std and VE, in list mode and streaming,
    one warm-up and two timed steps each, the counts reset just before and
    read just after (every op's 20-coefficient form once per step attempt,
    as its path runs it); then the CLI's ``--init sedov -n 50 -s 3 --kernel
    wendland-c6`` in this process (only 20-coefficient forms launched) and
    a wendland-c6 dump (the library's ``.npz`` at step 2,
    Sedov 50) read back with its kernel and restarted by the CLI (the JAX
    package's dumps carry ``kernelChoice``). Returns each path's launches."""
    import torch

    from sphexa_torch.app import main as app
    from sphexa_torch.init import init_sedov
    from sphexa_torch.io import read_snapshot_full, write_snapshot
    from sphexa_torch.kernels import io_checks
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    out = {}
    for label, prop, lists in WENDLAND_PATHS:
        state, box, const = init_sedov(100, device="cuda")
        const = const.with_kernel("wendland-c6")
        run = drive(lambda: Simulation(state, box, const, prop=prop, device="cuda",
                                       use_lists=lists, obs_spec=spec), steps=2, label=label)
        ops = STD_OPS if prop == "std" else tuple(
            op[:-len("_lists")] for op in VE_WALK)
        # the 20-coefficient form counts apart: no sinc launch of an op here
        on_path = tuple(f"{op}{'_lists' if lists else ''}:wendland-c6" for op in ops)
        check_launches(label, run["launches"], run["attempts"], on_path,
                       run["rebuilds"] if lists else 0)
        emit({**run["report"], "kernel": "wendland-c6", "card": smi})
        out[label] = run["launches"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the CLI in this process, counted from just before it to just after:
        # only the 20-coefficient forms of the pair ops (and K5) launch
        torch.cuda.synchronize()
        pe.reset_launches()
        rc = app.main(["--init", "sedov", "-n", "50", "-s", "3", "--kernel", "wendland-c6",
                       "-o", os.path.join(tmp, "cli"), "--quiet"])
        cli_launches = {k: v for k, v in pe.LAUNCHES.items() if v}
        with open(os.path.join(tmp, "cli", "constants.txt")) as f:
            rows = [ln for ln in f if not ln.startswith("#")]
        pair = [k for k in cli_launches if k != "mark"]
        if rc != 0 or len(rows) != 3 or not pair or \
                not all(k.endswith(":wendland-c6") for k in pair):
            raise AssertionError(f"--kernel wendland-c6 CLI: exit {rc}, {len(rows)} rows, "
                                 f"launches {cli_launches}")
        state, box, const = init_sedov(50, device="cuda")
        sim = Simulation(state, box, const.with_kernel("wendland-c6"), device="cuda")
        sim.step()
        sim.step()
        dump = os.path.join(tmp, "dump_sedov.npz")
        write_snapshot(dump, sim.state, sim.box, sim.const, iteration=2, case="sedov")
        _, _, rconst, _, _ = read_snapshot_full(dump, device="cuda")
        if (rconst.kernel_choice, rconst.kernel_norm) != ("wendland-c6", sim.const.kernel_norm):
            raise AssertionError(f"wendland dump: read back {rconst.kernel_choice}")
        restart = io_checks.cli_restart(dump, os.path.join(tmp, "restart"), 4, "cuda",
                                        check_every=1)
    emit({"phase": "kernel_family_cli", "card": smi, "cli_rows": 3,
          "cli_launches": cli_launches, "restart": restart,
          "seconds": time.perf_counter() - t0})
    return out


def blockdt_path(spec, smi) -> dict:
    """Phase ``blockdt_path``: std and VE Sedov 100^3 at dt_bins 4 through
    Simulation, one warm-up and 7 timed substeps (one cycle), the counts
    reset just before and read just after (the streaming std or VE ops
    and K13's one-row form once per substep attempt); the substep time,
    the updates against the global dt's, the bin populations, resorts and
    keeps (std also at bin_resort_drift 0.01); K13's one-row form at the
    std path's due row against its plain version, its time (one call by
    CUDA events; alone, ``launch_loop_ms``), its bound and torch.argsort's
    time for the same row; dt_bins 1 against the global streaming step bit
    for bit (three steps); block substeps card vs CPU on Sedov 16 (std,
    VE) and Evrard 20 (std, self-gravity) at dt_bins 3. Returns (each
    path's launches, the K13 one-row entry)."""
    import torch

    from sphexa_torch.gravity import pallas_compact as pcmp
    from sphexa_torch.init import init_sedov
    from sphexa_torch.kernels import checks
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import blockdt as bdt

    out, row = {}, None
    for label, prop, drift in (("blockdt_std", "std", 0.0), ("blockdt_ve", "ve", 0.0),
                               ("blockdt_std_keep", "std", 0.01)):
        t0 = time.perf_counter()
        state, box, const = init_sedov(100, device="cuda")
        run = drive(lambda: Simulation(state, box, const, prop=prop, device="cuda",
                                       dt_bins=4, bin_resort_drift=drift, obs_spec=spec),
                    steps=7, label="blockdt_path")
        sim = run["sim"]
        ops = STD_OPS if prop == "std" else ("density", "ve_def_gradh", "iad",
                                             "iad_divv_curlv", "av_switches",
                                             "momentum_energy_ve")
        check_launches(label, run["launches"], run["attempts"], (*ops, "compact_row"))
        diags = run["diags"]
        emit({**run["report"], "path": label, "card": smi, "dt_bins": 4,
              "bin_resort_drift": drift, "substep_ms_median": statistics.median(
                  run["report"]["step_ms"]),
              "updates": sim.bdt_updates, "updates_full": sim.bdt_updates_full,
              "update_factor": sim.bdt_updates_full / max(sim.bdt_updates, 1),
              "resorts": sim.bdt_resorts, "keeps": sim.bdt_keeps,
              "active": [d["bdt_active"] for d in diags],
              "pop_last": [diags[-1][f"bdt_pop[{k}]"] for k in range(4)],
              "drift_max": max(d["bdt_drift"] for d in diags),
              "compact_row_per_substep": run["launches"]["compact_row"] / run["attempts"],
              "seconds": time.perf_counter() - t0})
        out[label] = run["launches"]
        if label == "blockdt_std":
            # K13's one-row form at the path's state: the next substep's due row
            b = sim.bdt_state
            due = bdt.due_mask(b.bins, b.substep)
            n = due.shape[0]
            chk = checks.compact_row_vs_plain("blockdt_std due row", due)
            due8 = due.to(torch.uint8)
            row = {"name": "compact_class_lists:row", "due": chk["due"], "n": n,
                   "max_abs_err": chk["max_abs_err"],
                   "ms": cuda_time_ms(lambda: bdt.compact_active(due), reps=7),
                   "kernel_ms": launch_loop_ms(pcmp.compact_row_launcher(due)[0], 200),
                   "plain_ms": cuda_time_ms(lambda: pcmp.compact_row_plain(due), reps=3),
                   # one call: the due rows first in row order, then the others
                   "library_ms": cuda_time_ms(lambda: torch.argsort(
                       due8, descending=True, stable=True), reps=7),
                   # the flags read once, the positions and the count written once
                   **_bound(COMPACT_ROW_OPS * n * PEAK_FP32_FLOPS / PEAK_INT32_OPS, 5 * n + 4),
                   "cases": checks.compact_row_cases("cuda")}
            emit({"phase": "compact_row", "card": smi, **row})
    t0 = time.perf_counter()
    pins = {}
    for prop in ("std", "ve"):
        state, box, const = init_sedov(100, device="cuda")
        glob = Simulation(state, box, const, prop=prop, device="cuda", use_lists=False,
                          obs_spec=spec)
        one = Simulation(state, box, const, prop=prop, device="cuda", dt_bins=1,
                         obs_spec=spec)
        for _ in range(3):
            dg, d1 = glob.step(), one.step()
            if dg["dt"] != d1["dt"] or dg["obs_etot"] != d1["obs_etot"]:
                raise AssertionError(f"dt_bins 1 {prop}: dt {d1['dt']} etot {d1['obs_etot']} "
                                     f"vs global {dg['dt']} {dg['obs_etot']}")
        diff = [f for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "temp_lo", "du",
                            "du_m1", "alpha", "ttot", "min_dt")
                if not torch.equal(getattr(glob.state, f), getattr(one.state, f))]
        if diff:
            raise AssertionError(f"dt_bins 1 {prop}: {diff} differ from the global step's")
        pins[prop] = {"steps": 3, "bitwise": True}
    vs_cpu = [checks.blockdt_vs_cpu("sedov", 16, 5, prop="std"),
              checks.blockdt_vs_cpu("sedov", 16, 5, prop="ve"),
              checks.blockdt_vs_cpu("evrard", 20, 4, prop="std")]
    emit({"phase": "blockdt_checks", "card": smi, "dt_bins_1_vs_global": pins,
          "vs_cpu": vs_cpu, "seconds": time.perf_counter() - t0})
    return out, row


#: the K1 entry points a sharded step attempt launches once each (the VE
#: path's density is its xmass)
SHARDED_OPS = {"std": STD_OPS, "ve": ("density", "ve_def_gradh", "iad", "iad_divv_curlv",
                                      "av_switches", "momentum_energy_ve")}
#: the ranks' steps timed on each sharded path after one warm-up
SHARDED_STEPS = 3


def jdata_bounds(keep: dict, stage: dict, const, group: int) -> dict:
    """Least device time of each K1 jdata launch of a rank's stage
    (``bounds``: the mask over its runs' candidates, the bodies on its
    neighbour pairs, each momentum op's own pairs under the symmetric
    cutoff), its bytes adding the halo rows' j-fields once each."""
    from sphexa_torch.sph import pair_engine as pe

    consts = pe.op_consts(const)
    S, nj = stage["slab_rows"], stage["jbuf_rows"]
    out = {}
    for key, (spec, i_f, j_f) in keep["fields"].items():
        op = "density" if key == "xmass" else key
        pairs = None
        if body_of(op) in SYM_BODIES:
            pairs = {op: momentum_pair_counts(spec, (i_f, j_f), consts, group,
                                              runs=keep["ranges"], fold=keep["fold"])}
        b = bounds(keep["ranges"], S, group, stage["nb_pairs"], ops=(op,), pairs=pairs)[op]
        out[key] = {**b, **_bound(b["ops"], b["bytes"] + 4 * (nj - S) * spec.num_j),
                    "halo_rows": nj - S}
    return out


def sharded_split(mesh, sim, sync, reps: int = 3) -> dict:
    """A sharded step's collective parts on this rank, host wall ms (the
    card synchronised; every rank runs them together, their collectives
    wait on each other), medians of ``reps``: the box regrow and the
    distributed sort (the prologue), the halo stage (the global cell
    table, the runs, their localization and the negotiation), and one
    serve of the std momentum's 13 fields (the widest)."""
    from sphexa_torch.propagator import _force_stage_prologue, _halo_stage

    def wall(fn):
        ts = []
        for _ in range(reps):
            sync(mesh.device)
            t0 = time.perf_counter()
            out = fn()
            sync(mesh.device)
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts), out

    cfg = sim.cfg
    sort_ms, (ss, box, keys, _) = wall(lambda: _force_stage_prologue(sim.state, sim.box, cfg))
    stage_ms, st = wall(lambda: _halo_stage(cfg, ss.n, ss.x, ss.y, ss.z, ss.h, keys, box))
    serve = st[1]
    fields = (ss.h, ss.vx, ss.vy, ss.vz, ss.m, ss.temp, ss.alpha) + (ss.x,) * 6
    serve_ms, _ = wall(lambda: serve(fields))
    return {"sort": sort_ms, "halo_stage": stage_ms, "serve_13_fields": serve_ms}


def sharded_rank(mesh, side: int, steps: int, timed: bool) -> dict:
    """One rank of the ``sharded_path`` phase (parallel/mesh.py ``spawn``):
    std, then VE Sedov ``side``^3 through Simulation(num_devices=P) on this
    rank's card, one warm-up and ``steps`` steps, the launch counts reset
    just before and read just after; the slabs gathered (for the check
    only) before the last step and after it, and rank 0 holds the result
    against the one-card streaming step from the gathered state; then
    every K1 jdata launch of a force stage at the path's state against its
    plain version on every rank (``sharded_checks.jdata_vs_plain``) and,
    with ``timed``, one rank at a time on the card, each one's one-call
    time, its plain version's and its bound."""
    import torch

    from sphexa_torch.init import init_sedov
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.parallel.mesh import all_gather
    from sphexa_torch.propagator import _step_hydro_std, _step_hydro_ve
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "device": str(dev)}

    def sync(d):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    state, box, const = init_sedov(side, device=dev)
    for prop in ("std", "ve"):
        t_path = time.perf_counter()
        sim = Simulation(state, box, const, prop=prop, device=dev, num_devices=mesh.size,
                         obs_spec=ObservableSpec())
        t_conf = time.perf_counter() - t_path
        sim.step()  # warm-up
        pe.reset_launches()
        replays0 = sim.replays
        ms, diags = [], []
        for i in range(steps):
            if i == steps - 1:
                prev, prev_box = sc.gather_state(mesh, sim.state), sim.box
            sync(dev)
            t0 = time.perf_counter()
            diags.append(sim.step())
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = dict(pe.LAUNCHES)
        attempts = steps + sim.replays - replays0
        new = sc.gather_state(mesh, sim.state)
        d = diags[-1]
        P = mesh.size
        r = {"configure_s": t_conf, "step_ms": ms, "launches": launches, "attempts": attempts,
             "halo": sim.halo_info, "n": new.n, "slab": sim.state.n,
             "shard_rows": [int(d[f"shard_rows[{k}]"]) for k in range(P)],
             "shard_occ": [d[f"shard_occ[{k}]"] for k in range(P)],
             "shard_work": [d[f"shard_work[{k}]"] for k in range(P)],
             "dt": d["dt"], "nc_sum": d["nc_sum"], "energy_drift": sim.energy_drift}
        if mesh.rank == 0:
            # the one-card streaming step from the same (gathered) state
            cfg1 = dataclasses.replace(sim.cfg, mesh=None, halo_cells=(), halo_window=0)
            fn = _step_hydro_std if prop == "std" else _step_hydro_ve
            s1, _, d1 = fn(prev, prev_box, cfg1)
            r["vs_one_card"] = {
                "x_max_abs_err": float((new.x - s1.x).abs().max()),
                "temp_max_rel_err": float(((new.temp - s1.temp).abs() / s1.temp.abs()).max()),
                "dt_rel_err": abs(d["dt"] - float(d1["dt"])) / float(d1["dt"]),
                "h_equal": bool(torch.equal(new.h, s1.h)),
                "nc_sum": [d["nc_sum"], float(d1["nc_sum"])]}
            torch.testing.assert_close(new.x, s1.x, rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(new.temp, s1.temp, rtol=1e-4, atol=0.0)
            if not (r["vs_one_card"]["h_equal"] and d["nc_sum"] == float(d1["nc_sum"])
                    and r["vs_one_card"]["dt_rel_err"] <= 1e-5):
                raise AssertionError(f"sharded {prop}: against the one-card step "
                                     f"{r['vs_one_card']}")
            del s1, prev
        r["split_ms"] = sharded_split(mesh, sim, sync)
        keep = {}
        chk = sc.jdata_vs_plain(f"rank {mesh.rank} {prop}", mesh, sim.state, sim.box, sim.cfg,
                                prop, keep=keep)
        for turn in range(P):
            if timed and turn == mesh.rank:
                for key, (kern, plain) in keep["calls"].items():
                    chk[key]["ms"] = cuda_time_ms(kern, reps=5)
                    chk[key]["plain_ms"] = cuda_time_ms(plain, reps=1)
                chk["bounds"] = jdata_bounds(keep, chk["stage"], const, sim.cfg.nbr.group)
            all_gather(mesh, torch.zeros(1, device=dev))  # the card to one rank at a time
        r["jdata"] = chk
        r["seconds"] = time.perf_counter() - t_path
        out[prop] = r
        del sim, keep, new
    return out


def sharded_path(smi) -> tuple:
    """Phase ``sharded_path``: std and VE Sedov 100^3 over two gloo ranks
    sharing this card (``sharded_rank``), their launches held to the
    contract (each K1 op once per step attempt, jdata form); with two
    cards or more also NCCL ranks, one a card (P = min(4, cards)).
    Returns (rank 0's results of the gloo run, its launches by path)."""
    import torch

    from sphexa_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    emit({"phase": "sharded_devices", "count": count,
          "nccl": (f"P = {min(4, count)}" if count >= 2
                   else "not run: one card (NCCL needs a card per rank)")})
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    runs = [("gloo", 2, True)] + ([("nccl", min(4, count), False)] if count >= 2 else [])
    first = None
    with tempfile.TemporaryDirectory() as wd:
        for backend, P, timed in runs:
            t1 = time.perf_counter()
            res = spawn(sharded_rank, P, args=(100, SHARDED_STEPS, timed), workdir=wd,
                        backend=backend, timeout=900)
            for prop in ("std", "ve"):
                for rk in res:
                    rr = rk[prop]
                    check_launches(f"sharded {backend} {prop} rank {rk['rank']}",
                                   rr["launches"], rr["attempts"], SHARDED_OPS[prop])
                r0 = res[0][prop]
                emit({"phase": "sharded_path", "card": smi, "backend": backend, "ranks": P,
                      "prop": prop, "n": r0["n"], "slab": r0["slab"], "halo": r0["halo"],
                      "step_ms": {rk["rank"]: rk[prop]["step_ms"] for rk in res},
                      "configure_s": [rk[prop]["configure_s"] for rk in res],
                      "exchange_rows": r0["shard_rows"], "exchange_occ": r0["shard_occ"],
                      "exchange_bytes_per_step": r0["halo"]["bytes_per_step"],
                      "shard_work": r0["shard_work"], "vs_one_card": r0["vs_one_card"],
                      "split_ms": {rk["rank"]: rk[prop]["split_ms"] for rk in res},
                      "jdata": {rk["rank"]: rk[prop]["jdata"] for rk in res},
                      "launches_per_step": {op: r0["launches"][op] / r0["attempts"]
                                            for op in SHARDED_OPS[prop]},
                      "seconds": time.perf_counter() - t1})
            if first is None:
                first = res[0]
    emit({"phase": "sharded_done", "seconds": time.perf_counter() - t0})
    return first, {f"sharded_{prop}": first[prop]["launches"] for prop in ("std", "ve")}


#: the sharded gravity path's timed steps after its warm-up
SHARDED_GRAV_STEPS = 1


def sharded_gravity_split(mesh, sim, sync, reps: int = 1) -> dict:
    """A sharded gravity step's parts on this rank, host wall ms with the
    card synchronised at each boundary (every rank runs them together;
    their collectives wait on each other), medians of ``reps``: the box
    regrow and the distributed sort, the SPH halo stage, the sharded
    upsweep, and one gravity solve's MAC classification (K13 included),
    M2P, near-field prologue, gravity serve (localization and the halo's
    x, y, z, m, h) and K12."""
    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.propagator import _force_stage_prologue, _halo_stage

    dev = mesh.device

    def wall(fn):
        ts, out = [], None
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts), out

    cfg = sim.cfg
    sort_ms, (ss, box, keys, _) = wall(lambda: _force_stage_prologue(sim.state, sim.box, cfg))
    halo_ms, _ = wall(lambda: _halo_stage(cfg, ss.n, ss.x, ss.y, ss.z, ss.h, keys, box))
    meta = cfg.grav_meta
    up_ms, mps = wall(lambda: gt.compute_multipoles_sharded(mesh, ss.x, ss.y, ss.z, ss.m, keys,
                                                            sim.gtree, meta))
    gcfg = dataclasses.replace(cfg.gravity, G=cfg.const.g)
    win = tuple(min(c, ss.n) for c in cfg.grav_cells) or ss.n
    names = ("mac", "m2p", "p2p_prologue", "serve", "p2p")
    per = {k: [] for k in names}
    for _ in range(reps):
        stamps = []

        def mark(name):
            sync(dev)
            stamps.append((name, time.perf_counter()))

        gt.compute_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree, meta, gcfg,
                           multipoles=mps, shard=(mesh, win), timer=mark)
        for (_, t0), (name, t1) in zip(stamps, stamps[1:]):
            per[name].append(1e3 * (t1 - t0))
    split = {k: statistics.median(v) for k, v in per.items()}
    return {"sort": sort_ms, "sph_halo_stage": halo_ms, "upsweep": up_ms,
            "mac": split["mac"], "m2p": split["m2p"], "p2p_prologue": split["p2p_prologue"],
            "gravity_serve": split["serve"], "k12": split["p2p"]}


def sharded_gravity_rank(mesh, side: int, steps: int) -> dict:
    """One rank of the ``sharded_gravity_path`` phase: VE Evrard ``side``
    with self-gravity through Simulation(num_devices=P) on this rank's
    card (the sparse gravity serve), one warm-up and ``steps`` steps, the
    launch counts reset just before and read just after; the slabs
    gathered (for the check only) before the last step and after it, rank
    0 holding the result to the one-card VE step from the gathered state;
    the step's split; K12's jdata form on this rank's j-buffer against its
    plain version, then timed one rank at a time; the sharded Ewald solve
    against the one-card one (``checks.periodic_random_case``); std-cooling
    on evrard-cooling ``side``, one warm-up and one step."""
    import torch

    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.init import init_evrard, make_initializer
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.parallel.mesh import all_gather
    from sphexa_torch.propagator import _force_stage_prologue, _step_hydro_ve
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    dev, P = mesh.device, mesh.size
    out = {"rank": mesh.rank, "size": P, "backend": mesh.backend, "device": str(dev)}

    def sync(d):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    def barrier():
        all_gather(mesh, torch.zeros(1, device=dev))

    def trimmed(state):
        n = state.n // P * P
        return dataclasses.replace(state, **{f.name: getattr(state, f.name)[:n]
                                             for f in dataclasses.fields(state)
                                             if getattr(state, f.name).dim() == 1})

    t_path = time.perf_counter()
    state, box, const = init_evrard(side, device=dev)
    state = trimmed(state)
    sim = Simulation(state, box, const, prop="ve", device=dev, num_devices=P,
                     obs_spec=ObservableSpec())
    r = {"configure_s": time.perf_counter() - t_path, "grav_configure_s":
         sim.grav_configure_seconds}
    del state
    sim.step()  # warm-up
    pe.reset_launches()
    replays0 = sim.replays
    ms, diags = [], []
    for i in range(steps):
        if i == steps - 1:
            prev, prev_box = sc.gather_state(mesh, sim.state), sim.box
        sync(dev)
        t0 = time.perf_counter()
        diags.append(sim.step())
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(pe.LAUNCHES)
    attempts = steps + sim.replays - replays0
    new = sc.gather_state(mesh, sim.state)
    d = diags[-1]
    gkeys = ("m2p_max", "p2p_max", "leaf_occ", "c_max", "let_max", "compact_width",
             "mac_work_ratio", "egrav")
    r.update({"step_ms": ms, "launches": launches, "attempts": attempts,
              "n": new.n, "slab": sim.state.n, "halo": sim.halo_info,
              "grav_halo": sim.grav_halo_info,
              "gravity": dataclasses.asdict(sim.cfg.gravity),
              "tree": {"leaves": sim.cfg.grav_meta.num_leaves,
                       "nodes": sim.cfg.grav_meta.num_nodes},
              "gravity_diags": [{k: dd[k] for k in gkeys} for dd in diags],
              "gshard_rows": [int(d[f"gshard_rows[{k}]"]) for k in range(P)],
              "gshard_occ": [d[f"gshard_occ[{k}]"] for k in range(P)],
              "shard_rows": [int(d[f"shard_rows[{k}]"]) for k in range(P)],
              "dt": d["dt"], "energy_drift": sim.energy_drift,
              "replays": sim.replays, "reconfigures": sim.reconfigures})
    g = sim.cfg.gravity
    for dd in diags:
        if dd["m2p_max"] > g.m2p_cap or dd["p2p_max"] > g.p2p_cap or \
                not 0 < dd["let_max"] <= g.let_cap:
            raise AssertionError(f"sharded gravity: a high-water mark past its cap {dd}")
    if mesh.rank == 0:
        # the one-card VE step from the same (gathered) state
        cfg1 = dataclasses.replace(sim.cfg, mesh=None, halo_cells=(), halo_window=0,
                                   grav_cells=())
        s1, _, d1 = _step_hydro_ve(prev, prev_box, cfg1, sim.gtree)
        vs = {"vx_max_abs_err": float((new.vx - s1.vx).abs().max()),
              "vx_scale": float(s1.vx.abs().max()),
              "egrav_rel_err": abs(d["egrav"] - float(d1["egrav"])) / abs(float(d1["egrav"])),
              "dt_rel_err": abs(d["dt"] - float(d1["dt"])) / float(d1["dt"]),
              "x_max_abs_err": float((new.x - s1.x).abs().max()),
              "nc_sum": [d["nc_sum"], float(d1["nc_sum"])]}
        r["vs_one_card"] = vs
        torch.testing.assert_close(new.vx, s1.vx, rtol=1e-2, atol=5e-4)
        if vs["egrav_rel_err"] > 1e-4:
            raise AssertionError(f"sharded gravity: against the one-card step {vs}")
        del s1
    del prev, new
    barrier()
    r["split_ms"] = sharded_gravity_split(mesh, sim, sync)

    # K12's jdata form on this rank's j-buffer at the path's state
    ss, sbox, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    gcfg = dataclasses.replace(g, G=const.g)
    xyzmh = (ss.x, ss.y, ss.z, ss.m, ss.h)
    win = tuple(min(c, ss.n) for c in sim.cfg.grav_cells) or ss.n
    xyzmh, starts, lens, jd = sc.p2p_jdata_case(mesh, xyzmh, keys, sbox, sim.gtree,
                                                sim.cfg.grav_meta, gcfg, win)
    groups = torch.linspace(0, lens.shape[0] - 1, 256, device=dev).round().long()
    chk = sc.p2p_jdata_vs_plain(f"rank {mesh.rank} K12 jdata", xyzmh, gcfg, starts, lens, jd,
                                groups=groups)
    z3 = torch.zeros(3, device=dev)
    args = (*xyzmh, z3, False, gcfg, starts, lens)
    for turn in range(P):
        if turn == mesh.rank:
            chk["ms"] = cuda_time_ms(lambda: gt._pallas_p2p(*args, jdata=jd), reps=7)
            chk["batched_ms"] = cuda_time_batched_ms(lambda: gt._pallas_p2p(*args, jdata=jd))
            chk["kernel_ms"] = launch_loop_ms(gt.p2p_launcher(*args, jdata=jd)[0], 20)
            chk["plain_ms"] = cuda_time_ms(lambda: gt._pallas_p2p_plain(*args, jdata=jd),
                                           reps=1)
            chk["bound"] = p2p_jdata_bound(lens, xyzmh[0].shape[0], jd[0].shape[0],
                                          gcfg.target_block)
            chk["near_field_load"] = near_field_load(lens, gcfg.target_block)
        barrier()  # the card to one rank at a time
    r["k12_jdata"] = chk
    r["seconds"] = time.perf_counter() - t_path
    out["ve"] = r
    del sim, ss, xyzmh, jd, starts, lens, keys, args
    torch.cuda.empty_cache()

    # Ewald on a mesh
    t0 = time.perf_counter()
    out["ewald"] = {**sc.ewald_mesh_vs_one_device(mesh), "seconds": time.perf_counter() - t0}

    # std-cooling on evrard-cooling, self-gravity
    t0 = time.perf_counter()
    cstate, cbox, cconst = make_initializer("evrard-cooling")(side, device=dev)
    csim = Simulation(trimmed(cstate), cbox, cconst, prop="std-cooling", device=dev,
                      num_devices=P, obs_spec=ObservableSpec())
    del cstate
    csim.step()  # warm-up
    pe.reset_launches()
    replays0 = csim.replays
    sync(dev)
    t1 = time.perf_counter()
    cd = csim.step()
    sync(dev)
    c_ms = 1e3 * (time.perf_counter() - t1)
    out["cooling"] = {"launches": dict(pe.LAUNCHES), "attempts": 1 + csim.replays - replays0,
                      "step_ms": c_ms, "dt": cd["dt"], "dt_cool": cd["dt_cool"],
                      "egrav": cd["egrav"], "n": csim.state.n * P,
                      "grav_halo": csim.grav_halo_info,
                      "finite": bool(torch.isfinite(csim.state.temp).all()
                                     and torch.isfinite(csim.chem.hi).all()),
                      "seconds": time.perf_counter() - t0}
    if not out["cooling"]["finite"]:
        raise AssertionError("sharded std-cooling: non-finite temperature or chemistry")
    return out


def sharded_gravity_path(smi) -> tuple:
    """Phase ``sharded_gravity_path``: VE Evrard 125 with self-gravity over
    two gloo ranks sharing this card (``sharded_gravity_rank``), their
    launches held to the contract (each K1 op once, K12 once and K13
    twice per step attempt), then the sharded Ewald solve and std-cooling
    on evrard-cooling 125. Returns (rank 0's results, its launches)."""
    import torch

    from sphexa_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as wd:
        res = spawn(sharded_gravity_rank, 2, args=(125, SHARDED_GRAV_STEPS), workdir=wd,
                    backend="gloo", timeout=900)
    ve_ops = SHARDED_OPS["ve"] + ("gravity_p2p",)
    for rk in res:
        check_launches(f"sharded gravity VE rank {rk['rank']}", rk["ve"]["launches"],
                       rk["ve"]["attempts"], ve_ops, compactions=2)
        check_launches(f"sharded std-cooling rank {rk['rank']}", rk["cooling"]["launches"],
                       rk["cooling"]["attempts"], STD_OPS + ("gravity_p2p",), compactions=2)
    r0 = res[0]["ve"]
    emit({"phase": "sharded_gravity_path", "card": smi, "backend": "gloo", "ranks": 2,
          "prop": "ve", "case": "evrard", "side": 125, "n": r0["n"], "slab": r0["slab"],
          "step_ms": {rk["rank"]: rk["ve"]["step_ms"] for rk in res},
          "configure_s": [rk["ve"]["configure_s"] for rk in res],
          "grav_configure_s": [rk["ve"]["grav_configure_s"] for rk in res],
          "split_ms": {rk["rank"]: rk["ve"]["split_ms"] for rk in res},
          "gravity": r0["gravity"], "tree": r0["tree"], "gravity_diags": r0["gravity_diags"],
          "grav_halo": r0["grav_halo"], "gshard_rows": r0["gshard_rows"],
          "gshard_occ": r0["gshard_occ"], "halo": r0["halo"], "shard_rows": r0["shard_rows"],
          "grav_bytes_per_step": r0["grav_halo"]["bytes_per_step"],
          "sph_bytes_per_step": r0["halo"]["bytes_per_step"],
          "vs_one_card": r0["vs_one_card"], "replays": r0["replays"],
          "launches_per_step": {op: r0["launches"][op] / r0["attempts"]
                                for op in ve_ops + ("compact_class_lists",)},
          "k12_jdata": {rk["rank"]: rk["ve"]["k12_jdata"] for rk in res},
          "seconds": [rk["ve"]["seconds"] for rk in res]})
    emit({"phase": "sharded_ewald", "card": smi, "ranks": 2,
          "results": {rk["rank"]: rk["ewald"] for rk in res}})
    emit({"phase": "sharded_cooling", "card": smi, "ranks": 2, "case": "evrard-cooling",
          "side": 125, "results": {rk["rank"]: rk["cooling"] for rk in res}})
    emit({"phase": "sharded_gravity_done", "seconds": time.perf_counter() - t0})
    return res[0], {"sharded_gravity_ve": r0["launches"],
                    "sharded_std_cooling": res[0]["cooling"]["launches"]}


#: the sharded turb-ve and N-body paths' timed steps after their warm-up
#: (the block-dt paths time one cycle)
SHARDED_PROPS_STEPS = {"turb-ve": 2, "nbody": 1}


def sharded_props_rank(mesh) -> dict:
    """One rank of the ``sharded_props_path`` phase: turb-ve on the
    turbulence case at side 100, std Sedov 100^3 at dt_bins 4 with
    bin_resort_drift 0 and 0.01 (one cycle after the warm-up) and N-body
    Evrard 125 (theta 0.5), each through Simulation(num_devices=P) on this
    rank's card (``sharded_checks.props_path``: the launch counts reset
    just before and read just after, the step ms, the last step held to
    the one-card step from the gathered input on rank 0); on the block-dt
    path K13's one-row form on this rank's due masks against its plain
    version, exact, then timed one rank at a time on the card (one call
    by CUDA events, alone, its plain version, torch.argsort of the mask)
    with its bound."""
    import torch

    from sphexa_torch.gravity import pallas_compact as pcmp
    from sphexa_torch.init import init_evrard, init_sedov, init_turbulence
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.parallel.mesh import all_gather
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import blockdt as bdt

    dev, P = mesh.device, mesh.size
    spec = ObservableSpec()
    out = {"rank": mesh.rank, "size": P, "backend": mesh.backend, "device": str(dev)}

    def path(label, kind, steps, init, side, **kw):
        t0 = time.perf_counter()
        state, box, const = init(side, device=dev)
        sim, rec = sc.props_path(f"{label} rank {mesh.rank}", mesh, lambda: Simulation(
            state, box, const, device=dev, num_devices=P, obs_spec=spec, **kw), kind, steps)
        rec["seconds"] = time.perf_counter() - t0
        return sim, rec

    sim, out["turb_ve"] = path("sharded turb-ve", "turb-ve", SHARDED_PROPS_STEPS["turb-ve"],
                               init_turbulence, 100, prop="turb-ve")
    out["turb_ve"]["modes"] = int(sim.turb_cfg.num_modes)
    del sim
    torch.cuda.empty_cache()
    for label, drift in (("blockdt", 0.0), ("blockdt_keep", 0.01)):
        sim, rec = path(f"sharded {label}", "blockdt", bdt.cycle_length(4), init_sedov, 100,
                        prop="std", dt_bins=4, bin_resort_drift=drift)
        rec.update(updates=sim.bdt_updates, updates_full=sim.bdt_updates_full,
                   resorts=sim.bdt_resorts, keeps=sim.bdt_keeps)
        if label == "blockdt":
            rows = sc.compact_row_slab("sharded blockdt", mesh, sim.bdt_state, 4)
            rec["compact_row"] = [r for r, _ in rows]
            due = rows[0][1]
            n = due.shape[0]
            for turn in range(P):
                if turn == mesh.rank:
                    due8 = due.to(torch.uint8)
                    rec["compact_row_timed"] = {
                        "due": rows[0][0]["due"], "n": n,
                        "ms": cuda_time_ms(lambda: bdt.compact_active(due), reps=7),
                        "kernel_ms": launch_loop_ms(pcmp.compact_row_launcher(due)[0], 200),
                        "plain_ms": cuda_time_ms(lambda: pcmp.compact_row_plain(due), reps=3),
                        "library_ms": cuda_time_ms(lambda: torch.argsort(
                            due8, descending=True, stable=True), reps=7),
                        **_bound(COMPACT_ROW_OPS * n * PEAK_FP32_FLOPS / PEAK_INT32_OPS,
                                 5 * n + 4)}
                all_gather(mesh, torch.zeros(1, device=dev))  # the card to one rank at a time
        out[label] = rec
        del sim
        torch.cuda.empty_cache()
    sim, out["nbody"] = path("sharded nbody", "nbody", SHARDED_PROPS_STEPS["nbody"],
                             init_evrard, 125, prop="nbody")
    out["nbody"]["gravity"] = dataclasses.asdict(sim.cfg.gravity)
    del sim
    torch.cuda.empty_cache()
    return out


#: the CLI's --devices runs on the card: two gloo ranks sharing it, ASCII
#: dumps (the card machine has no h5py)
SHARDED_CLI = {"turb-ve": ["--init", "turbulence", "-n", "30", "-s", "2", "-w", "1",
                           "--prop", "turb-ve"],
               "nbody": ["--init", "evrard", "-n", "30", "-s", "2", "-w", "1",
                         "--prop", "nbody"],
               "dt-bins": ["--init", "sedov", "-n", "30", "-s", "4", "-w", "2",
                           "--dt-bins", "4"]}


def sharded_cli(smi) -> dict:
    """The CLI's ``--devices 2`` with each of turb-ve, N-body and
    --dt-bins 4 at side 30, ``-w`` with ``--ascii``, on two gloo ranks
    sharing this card (``spawn`` of the CLI's rank entry, so that it
    finds its process group; the three runs side by side): each exits 0
    on every rank, writes one constants.txt row a step and one ASCII file
    a dump, gathered to rank 0 in global row order with the derived
    fields, finite."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sphexa_torch.app import main as app
    from sphexa_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as wd, ThreadPoolExecutor(len(SHARDED_CLI)) as pool:
        jobs = {}
        for name, args in SHARDED_CLI.items():
            od = os.path.join(wd, name)
            argv = [*args, "--devices", "2", "--ascii", "--quiet", "-o", od]
            jobs[name] = (od, pool.submit(spawn, app._rank_main, 2, args=(argv,),
                                          workdir=os.path.join(wd, f"ranks-{name}"),
                                          backend="gloo", timeout=300))
        for name, (od, job) in jobs.items():
            codes = job.result()
            if codes != [0, 0]:
                raise AssertionError(f"CLI --devices 2 {name}: exit codes {codes}")
            steps = int(SHARDED_CLI[name][5])
            rows = np.loadtxt(os.path.join(od, "constants.txt"), ndmin=2)
            dumps = sorted(f for f in os.listdir(od) if f.endswith(".txt") and "_it" in f)
            with open(os.path.join(od, dumps[-1])) as f:
                names = f.readline().split()[1:]
            data = np.loadtxt(os.path.join(od, dumps[-1]))
            if rows.shape[0] != steps or "rho" not in names or not np.isfinite(data).all():
                raise AssertionError(f"CLI --devices 2 {name}: {rows.shape[0]} rows, "
                                     f"columns {names}, finite {np.isfinite(data).all()}")
            out[name] = {"rows": rows.shape[0], "dumps": dumps, "n": data.shape[0],
                         "columns": names, "etot_last": float(rows[-1, 3])}
    emit({"phase": "sharded_cli", "card": smi, "runs": out,
          "seconds": time.perf_counter() - t0})
    return out


def _events_per_step(sim, steps: int = 3, tries: int = 6) -> dict:
    """Device events (kernels, copies, fills) of one checked step of
    ``sim`` from a torch.profiler trace: ``steps`` steps, each inside a
    range of its own, and the last one counted (the profiler may miss the
    start of its first), by the correlation ids of the CUDA calls made
    inside its range; the first run of ``tries`` that builds no lists (a
    build adds its own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(tries):
        b0 = sim.rebuilds
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                with record_function(f"app_shell_step{i}"):
                    sim.step()
            torch.cuda.synchronize()
        if sim.rebuilds == b0:
            break
    else:
        raise AssertionError(f"{tries} profiled runs of {steps} steps each built lists")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
              if e.get("ph") == "X"]
    (last,) = [e for e in events if e.get("name") == f"app_shell_step{steps - 1}"
               and e.get("cat") == "user_annotation"]
    t0, t1 = last["ts"], last["ts"] + last["dur"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in
            e.get("args", {}) and e.get("tid") == last.get("tid") and t0 <= e["ts"] <= t1}
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    own = [e["ts"] for e in dev if e.get("args", {}).get("correlation") in corr]
    # one stream runs the step in order: its work lies between its first
    # and last launch matched by id (a launch the trace lacks still counts)
    dev = [e for e in dev if own and min(own) <= e["ts"] <= max(own)]
    return {"events": len(dev), "names": collections.Counter(e["name"][:48] for e in dev)}


def app_shell(spec, smi, main_sim, ve_sim) -> dict:
    """Phase 25, the app shell on the card: (g) the CLI's ``--devices 2
    --snap m,temp`` on two gloo ranks sharing the card (started first, in
    a thread, while the rest runs): rank 0's frame against the one-card
    deposit of the same particles (the ranks' ``--ascii`` dump), rtol 1e-6;
    (f) the debug checks (Sedov 30: a clean step "", a NaN seeded in temp
    reported with its phase; the checked step's ms at Sedov 100^3); (c)
    the substep split of the main path's and the VE path's Sedov 100^3
    states, each stage's ms and K1's launches (1 + 3 per op); (b, e) the
    CLI's ``--insitu projection --snap-every 4 --check-every 4`` at Sedov
    100^3, 8 steps, with ``--memory-profile``: two PNG frames, a snapshot
    event each, the allocator's snapshot file; (d) a 5-step ``--trace-dir``
    capture of the CLI at Sedov 100^3 (list mode): coverage >= 0.8 and the
    top phases; (a) std Sedov 100^3 in list mode at check_every 8 with and
    without ``SnapshotSpec(("rho", "temp"), grid=64)``: one warm-up window
    and three timed ones each (the launch contract; the step medians), the
    host syncs of a whole window equal (``window_syncs``), the deposit
    against its plain numpy version on the host (sums within 1e-5 of the
    grid's max, a "max" grid exact) with its time by CUDA events and its
    bound, and the device events of a checked step without snapshots equal
    to the main path Simulation's. Returns the substep launches."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sphexa_torch.app import main as app
    from sphexa_torch.init import init_sedov
    from sphexa_torch.kernels import app_checks as ac
    from sphexa_torch.kernels.deferred_checks import window_syncs
    from sphexa_torch.observables.snapshot import SnapshotSpec, snapshot_diagnostics
    from sphexa_torch.parallel.mesh import spawn
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.telemetry import MemorySink, Telemetry

    t_phase = time.perf_counter()
    side = 100
    with tempfile.TemporaryDirectory() as wd, ThreadPoolExecutor(1) as pool:
        # (g) two gloo ranks of the CLI, side by side with (f)-(d)
        od_g, td_g = os.path.join(wd, "ranks"), os.path.join(wd, "ranks-tel")
        argv = ["--init", "sedov", "-n", "30", "-s", "2", "-w", "2", "--check-every", "2",
                "--snap", "m,temp", "--snap-grid", "15", "--ascii", "--devices", "2",
                "--quiet", "-o", od_g, "--telemetry-dir", td_g]
        ranks = pool.submit(spawn, app._rank_main, 2, args=(argv,),
                            workdir=os.path.join(wd, "spawn"), backend="gloo", timeout=300)

        # (f) the debug checks
        t0 = time.perf_counter()
        dbg = ac.debug_checks_case(30, "cuda")
        dsim = Simulation(*init_sedov(side, device="cuda"), device="cuda", debug_checks=True)
        dsim.step()
        dms = []
        for _ in range(3):
            d = dsim.step()
            dms.append(1e3 * dsim.last_step_seconds)
            if d["check_error"]:
                raise AssertionError(f"debug checks, Sedov 100^3: {d['check_error']}")
        del dsim
        emit({"phase": "app_shell", "part": "debug_checks", "card": smi, **dbg,
              "checked_step_ms_sedov100": dms, "seconds": time.perf_counter() - t0})

        # (c) the substep split at the main and VE paths' states
        t0 = time.perf_counter()
        subs = {"std": ac.substep_launches(main_sim), "ve": ac.substep_launches(ve_sim)}
        emit({"phase": "app_shell", "part": "substeps", "card": smi, "side": side, **subs,
              "seconds": time.perf_counter() - t0})

        # (b, e) the CLI's --insitu frames and --memory-profile
        t0 = time.perf_counter()
        od, td, mp = (os.path.join(wd, p) for p in ("insitu", "insitu-tel", "mem.pickle"))
        rc = app.main(["--init", "sedov", "-n", str(side), "-s", "8", "--check-every", "4",
                       "--insitu", "projection", "--snap-every", "4", "--memory-profile", mp,
                       "--quiet", "-o", od, "--telemetry-dir", td])
        pngs = sorted(f for f in os.listdir(od) if f.endswith(".png"))
        with open(os.path.join(td, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        snaps = [e["it"] for e in events if e["kind"] == "snapshot"]
        if rc != 0 or pngs != ["insitu_projection_000004.png", "insitu_projection_000008.png"] \
                or snaps != [4, 8] or not os.path.getsize(mp):
            raise AssertionError(f"CLI --insitu: rc {rc}, frames {pngs}, snapshot events "
                                 f"{snaps}, memory profile {os.path.exists(mp)}")
        emit({"phase": "app_shell", "part": "cli_insitu", "card": smi, "frames": pngs,
              "png_bytes": [os.path.getsize(os.path.join(od, p)) for p in pngs],
              "snapshot_events": snaps, "memory_profile_bytes": os.path.getsize(mp),
              "seconds": time.perf_counter() - t0})

        # (d) a 5-step trace of the CLI in list mode
        t0 = time.perf_counter()
        od, td, trd = (os.path.join(wd, p) for p in ("trace-out", "trace-tel", "trace"))
        rc = app.main(["--init", "sedov", "-n", str(side), "-s", "5", "--quiet", "-o", od,
                       "--telemetry-dir", td, "--trace-dir", trd])
        with open(os.path.join(td, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        attr = [e for e in events if e["kind"] == "phase_attr"]
        if rc != 0 or len(attr) != 1 or attr[0]["coverage"] < 0.8:
            raise AssertionError(f"CLI --trace-dir: rc {rc}, phase_attr {attr}")
        top = sorted(attr[0]["phases"].items(), key=lambda kv: -kv[1])
        emit({"phase": "app_shell", "part": "trace", "card": smi, "steps": 5,
              "coverage": attr[0]["coverage"], "total_device_us": attr[0]["total_device_us"],
              "phases_us": dict(top), "trace_bytes": os.path.getsize(
                  os.path.join(trd, "rank0.pt.trace.json")),
              "seconds": time.perf_counter() - t0})

        # (g) the ranks' frames
        t0 = time.perf_counter()
        codes = ranks.result()
        if codes != [0, 0]:
            raise AssertionError(f"CLI --devices 2 --snap: exit codes {codes}")
        g = ac.grid_vs_dump("two ranks, Sedov 30", os.path.join(td_g, "snapshots",
                                                                 "snap_000002.npz"),
                            os.path.join(od_g, "dump_sedov_it2.txt"),
                            SnapshotSpec(fields=("m", "temp"), grid=15), "cuda")
        frames = sorted(os.listdir(os.path.join(td_g, "snapshots")))
        if frames != ["snap_000001.npz", "snap_000002.npz"]:
            raise AssertionError(f"CLI --devices 2 --snap: frames {frames}")
        emit({"phase": "app_shell", "part": "ranks", "card": smi, "side": 30, "frames": frames,
              **g, "seconds": time.perf_counter() - t0})

        # (a) the deposit in the main path's steps
        t0 = time.perf_counter()
        walk = ("density_lists", "iad_lists", "momentum_energy_std_lists")
        snap = SnapshotSpec(fields=("rho", "temp"), grid=64)
        runs = {}
        for label, s in (("without", None), ("with", snap)):
            state, box, const = init_sedov(side, device="cuda")
            torch.cuda.synchronize()
            pe.reset_launches()
            sink = MemorySink()
            sim = Simulation(state, box, const, prop="std", device="cuda", check_every=8,
                             obs_spec=spec, snap_spec=s, snap_every=8,
                             snap_dir=os.path.join(wd, "ring"), telemetry=Telemetry(sinks=[sink]))
            per_step = []
            for _ in range(4):  # a warm-up window (the first list build), three timed
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(8):
                    sim.step()
                per_step.append(1e3 * (time.perf_counter() - t1) / 8)
            launches, attempts = dict(pe.LAUNCHES), sim.iteration + sim.replays
            check_launches(f"app_shell {label} snapshots", launches, attempts, walk,
                           sim.rebuilds)
            if sim.lists is None:
                raise AssertionError(f"app_shell {label} snapshots: no lists")
            runs[label] = {"sim": sim, "sink": sink, "attempts": attempts,
                           "launches": {op: launches[op] for op in (*walk, "mark")},
                           "window_step_ms": per_step[1:], "syncs": window_syncs(sim)}
        if runs["with"]["syncs"]["syncs"] != runs["without"]["syncs"]["syncs"]:
            raise AssertionError(f"app_shell: window syncs {runs['with']['syncs']} with "
                                 f"snapshots, {runs['without']['syncs']} without")
        its = [e["it"] for e in runs["with"]["sink"].of_kind("snapshot")]
        if its != [8, 16, 24, 32, 40]:
            raise AssertionError(f"app_shell: snapshot events at {its}")
        ssim = runs["with"]["sim"]
        st = ssim.state
        rho = st.m / (st.h * st.h * st.h)  # a density proxy: the deposit is held here
        dep = {f"sum_axis{ax}": ac.deposit_vs_plain(
            f"Sedov 100 axis {ax}", st, rho, ssim.box, dataclasses.replace(snap, axis=ax))
            for ax in (0, 1, 2)}
        dep["max"] = ac.deposit_vs_plain("Sedov 100 max", st, rho, ssim.box,
                                         dataclasses.replace(snap, reduce="max"))
        dep_ms = cuda_time_ms(lambda: snapshot_diagnostics(st, rho, ssim.box, snap), reps=20)
        # the "sum" deposit sums each cell's segment in a fixed order: the
        # same bits in two runs (audit rule JXA401)
        twice = [snapshot_diagnostics(st, rho, ssim.box, snap)["snap_grid"] for _ in range(2)]
        if not torch.equal(*twice):
            raise AssertionError("app_shell: two runs of the deposit differ "
                                 f"by {float((twice[0] - twice[1]).abs().max())}")
        n, F, G = st.n, len(snap.fields), snap.grid
        nbytes = 4 * n * (3 + F) + 4 * F * G * G
        dep_bound = _bound(n * (9 + F), nbytes)
        # a checked step's device events: without snapshots the main path's
        ev = {}
        for label, sim in (("main_path", main_sim), ("without", runs["without"]["sim"]),
                           ("with", ssim)):
            sim.check_every = 1  # its window queue is empty: the next steps are checked
            ev[label] = _events_per_step(sim)
        if ev["without"]["events"] != ev["main_path"]["events"]:
            raise AssertionError(f"app_shell: {ev['without']['events']} device events a step "
                                 f"without snapshots, {ev['main_path']['events']} on the main "
                                 f"path")
        extra = ev["with"]["names"] - ev["without"]["names"]
        emit({"phase": "app_shell", "part": "deposit", "card": smi, "side": side,
              "spec": dataclasses.asdict(snap), "vs_plain": dep, "deposit_ms": dep_ms,
              "deposit_bits_equal_two_runs": True,
              "deposit_bound_ms": dep_bound["bound_ms"], "deposit_bound_by":
              dep_bound["bound_by"],
              "step_ms_median_without": statistics.median(runs["without"]["window_step_ms"]),
              "step_ms_median_with": statistics.median(runs["with"]["window_step_ms"]),
              "window_step_ms": {k: r["window_step_ms"] for k, r in runs.items()},
              "window_syncs": {k: r["syncs"] for k, r in runs.items()},
              "launches": {k: r["launches"] for k, r in runs.items()},
              "step_attempts": {k: r["attempts"] for k, r in runs.items()},
              "device_events_per_step": {k: v["events"] for k, v in ev.items()},
              "deposit_events": dict(extra), "seconds": time.perf_counter() - t0})
        del runs, ssim
    emit({"phase": "app_shell", "card": smi, "seconds": time.perf_counter() - t_phase})
    return {"app_shell_substeps_std": subs["std"]["launches"],
            "app_shell_substeps_ve": subs["ve"]["launches"]}


def sharded_props_path(smi) -> tuple:
    """Phase ``sharded_props_path``: turb-ve, block time steps and N-body
    over two gloo ranks sharing this card (``sharded_props_rank``), their
    launches held to the contract (the six VE ops once per step attempt;
    the std ops and K13's one-row form once per substep attempt; K12 once
    and K13 twice per N-body step attempt); then the CLI
    (``sharded_cli``). Returns (rank 0's results, its launches by path)."""
    import torch

    from sphexa_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as wd:
        res = spawn(sharded_props_rank, 2, workdir=wd, backend="gloo", timeout=900)
    contract = {"turb_ve": (SHARDED_OPS["ve"], 0), "blockdt": (STD_OPS + ("compact_row",), 0),
                "blockdt_keep": (STD_OPS + ("compact_row",), 0),
                "nbody": (("gravity_p2p",), 2)}
    for rk in res:
        for label, (ops, comp) in contract.items():
            r = rk[label]
            check_launches(f"sharded {label} rank {rk['rank']}", r["launches"], r["attempts"],
                           ops, compactions=comp)
        for c in rk["blockdt"]["compact_row"]:
            if c["max_abs_err"] != 0.0:
                raise AssertionError(f"sharded blockdt: K13's one-row form {c}")
    for label in contract:
        r0 = res[0][label]
        emit({"phase": "sharded_props_path", "path": label, "card": smi, "backend": "gloo",
              "ranks": 2, "n": r0["n"], "slab": r0["slab"],
              "step_ms": {rk["rank"]: rk[label]["step_ms"] for rk in res},
              "configure_s": [rk[label]["configure_s"] for rk in res],
              "halo": r0["halo"], "grav_halo": r0["grav_halo"],
              **{k: r0[k] for k in ("shard_rows", "shard_occ", "gshard_rows", "gshard_occ")
                 if k in r0},
              "vs_one_card": r0["vs_one_device"], "replays": r0["replays"],
              "diags": r0["diags"], "energy_drift": r0["energy_drift"],
              "launches_per_step": {op: r0["launches"][op] / r0["attempts"]
                                    for op, v in r0["launches"].items() if v},
              **{k: r0[k] for k in ("updates", "updates_full", "resorts", "keeps", "modes",
                                    "compact_row", "compact_row_timed") if k in r0},
              "seconds": [rk[label]["seconds"] for rk in res]})
    cli = sharded_cli(smi)
    emit({"phase": "sharded_props_done", "seconds": time.perf_counter() - t0})
    return res[0], {f"sharded_{label}": res[0][label]["launches"] for label in contract}, cli


def gather_path(spec, smi) -> dict:
    """Phase 26, the gather backend (``Simulation(backend="xla")``, the JAX
    package's XLA path: find_neighbors' (N, ngmax) lists and the masked
    j-reductions, plain PyTorch) on the card: (a) the search of a
    jittered Sedov 24 at ngmax 40 (every row truncated) card vs CPU, nidx,
    nmask and nc bit for bit, the density rtol 1e-6; (b) one gather force
    stage against the engine's (K1) from Sedov 100^3's initial state, whose
    largest count is below ngmax 150 (printed): rho, a and du within the
    slice's tolerances; (c) std Sedov 100^3 at ngmax 150, one warm-up and
    one timed step: updates/s, the drift, the peak allocated memory, the
    ledger's truncated-row count a step, and zero launches of K1-K13
    (every count 0: a failure raises); (d) the split of a step's stages
    on the path's last state and the row blocks chosen from the free
    memory. Returns the path's launch counts (all zero)."""
    import torch

    from sphexa_torch.init import init_sedov
    from sphexa_torch.kernels import gather_checks as gc
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph.particles import PARTICLE_FIELDS

    t0 = time.perf_counter()
    emit({"phase": "gather_card_vs_cpu", **gc.card_vs_cpu(24, 40),
          "seconds": time.perf_counter() - t0})
    state, box, const = init_sedov(100, device="cuda")
    emit({"phase": "gather_vs_engine", **gc.vs_engine(state, box, const)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive(lambda: Simulation(state, box, const, prop="std", device="cuda", backend="xla",
                                   obs_spec=spec), steps=1, label="gather_path")
    peak = torch.cuda.max_memory_allocated()
    sim = run["sim"]
    check_launches("gather path", run["launches"], run["attempts"], ())
    if sim.cfg.backend != "xla" or sim.lists is not None:
        raise AssertionError(f"gather path: backend {sim.cfg.backend}, lists {sim.lists}")
    for f in PARTICLE_FIELDS:
        if getattr(sim.state, f).device.type != "cuda":
            raise AssertionError(f"gather path: {f} left the card")
    emit({**run["report"], "card": smi, "peak_memory_gb": peak / 1e9,
          "truncated_rows": [d["n_nc_clip"] for d in run["diags"]],
          "ngmax": sim.cfg.nbr.ngmax, "split_ms": gc.split_ms(sim, reps=1),
          "blocks": gc.block_sizes(sim.cfg, sim.device),
          "seconds": time.perf_counter() - t0})
    return run["launches"]


#: the sharded gather path's timed steps after its warm-up
SHARDED_GATHER_STEPS = 1


def sharded_gather_path(smi) -> dict:
    """Phase 27, the gather backend across ranks
    (``sharded_gather_checks.rank_gather_card`` on two ranks: gloo ranks
    sharing this card, NCCL ranks with a card each where there are two):
    the truncating search's lists bit for bit, then std Sedov 100^3 at
    ngmax 150 with zero launches of K1-K13 on every rank, its last step
    held to the one-card gather step (a failure raises). Returns rank 0's
    launch counts (all zero)."""
    import torch

    from sphexa_torch.kernels import sharded_gather_checks as sgc
    from sphexa_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    with tempfile.TemporaryDirectory() as wd:
        res = spawn(sgc.rank_gather_card, 2, args=(100, SHARDED_GATHER_STEPS), workdir=wd,
                    backend=backend, timeout=900)
    for rk in res:
        r = rk["path"]
        check_launches(f"sharded gather rank {rk['rank']}", r["launches"], r["attempts"], ())
    r0 = res[0]["path"]
    emit({"phase": "sharded_gather_truncation", "card": smi, **res[0]["truncation"]})
    step_s = statistics.median([ms for rk in res for ms in rk["path"]["step_ms"]]) / 1e3
    emit({"phase": "sharded_gather_path", "card": smi, "backend": backend, "ranks": 2,
          "n": r0["n"], "slab": r0["slab"], "nbr": r0["nbr"], "halo": r0["halo"],
          "engine_sparse": r0["engine_sparse"],
          "step_ms": {rk["rank"]: rk["path"]["step_ms"] for rk in res},
          "configure_s": [rk["path"]["configure_s"] for rk in res],
          "split_ms": {rk["rank"]: rk["path"]["split_ms"] for rk in res},
          "peak_allocated_gb": {rk["rank"]: rk["path"]["peak_allocated_gb"] for rk in res},
          "updates_per_s": r0["n"] / step_s, "energy_drift": r0["energy_drift"],
          "truncated_rows": r0["truncated_rows"], "shard_rows": r0.get("shard_rows"),
          "shard_occ": r0.get("shard_occ"), "vs_one_card": r0["vs_one_device"],
          "replays": r0["replays"], "seconds": time.perf_counter() - t0})
    return r0["launches"]


#: the tuning path's sweep: the knobs, the candidate budget, the measured
#: steps and the warm-up windows of each candidate
TUNING_SWEEP = {"knobs": ("group", "cell_target", "gap", "list_skin_rel"), "budget": 8,
                "steps": 6, "warmup": 1}
#: the sweep over ranks (``tuning.replay.sweep_on_ranks``): std Sedov 100^3
#: on two ranks (gloo sharing this card; NCCL with two cards), lists off
TUNING_RANKS = {"knobs": ("cell_target",), "budget": 3, "steps": 6, "warmup": 1, "ranks": 2}


def tuning_ranks(smi) -> dict:
    """The sweep over ranks of ``tuning_path`` (d): ``sweep_on_ranks`` on
    std Sedov 100^3 (``TUNING_RANKS``), one spawn: every rank's history
    equal (knobs, statuses, agreed values, each rank's value), each agreed
    value the maximum of the ranks' own, each rank's K1 jdata launches 3 a
    step attempt (density, IAD, std momentum; nothing else), the table
    entry keyed by p = 2. Returns rank 0's launches."""
    import torch

    from sphexa_torch.tuning import ReplaySpec, domains_for, make_entry, validate_table
    from sphexa_torch.tuning.replay import sweep_on_ranks
    from sphexa_torch.tuning.table import new_table, upsert_entry

    t0 = time.perf_counter()
    P = TUNING_RANKS["ranks"]
    nccl = torch.cuda.device_count() >= P
    spec = ReplaySpec(case="sedov", side=100, devices=P)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    ranks = sweep_on_ranks(spec, domains_for(TUNING_RANKS["knobs"]), TUNING_RANKS["budget"],
                           steps=TUNING_RANKS["steps"], warmup=TUNING_RANKS["warmup"],
                           launch={"device": None, "backend": "nccl" if nccl else "gloo",
                                   "threads": None}, timeout=900)

    def agreed(r):
        return [(h["candidate"], h["knobs"], h["status"], h["value"], h["rank_values"])
                for h in r["history"]]

    if any(agreed(r) != agreed(ranks[0]) for r in ranks) or \
            len(ranks[0]["history"]) != TUNING_RANKS["budget"]:
        raise AssertionError(f"tuning ranks: histories differ: {[agreed(r) for r in ranks]}")
    for i, h in enumerate(ranks[0]["history"]):
        own = [r["history"][i]["own"].get("value") for r in ranks]
        if h["status"] != "ok" or h["rank_values"] != own or h["value"] != max(own):
            raise AssertionError(f"tuning ranks: candidate {i} {h} against own {own}")
    for r in ranks:
        attempts = sum(h.get("attempts", 0) for h in r["history"])
        check_launches(f"tuning ranks rank {r['rank']}", r["launches"], attempts, STD_OPS)
    best = ranks[0]["best"]["knobs"] or ranks[0]["history"][1]["knobs"]
    table = new_table()
    upsert_entry(table, make_entry("sedov", spec.n, P, "pallas", best, {
        "source_run": "chip_smoke.py tuning_ranks", "created": time.strftime("%Y-%m-%d"),
        "objective": "per_step_s", "device": smi}))
    if validate_table(table) or table["entries"][0]["p"] != P:
        raise AssertionError(f"tuning ranks table: {table}")
    emit({"phase": "tuning_ranks", "card": smi, "backend": ranks[0]["backend"],
          "ranks": P, "case": "sedov", "side": 100, **TUNING_RANKS,
          "candidates": [{"knobs": h["knobs"], "status": h["status"],
                          "agreed_ms": 1e3 * h["value"],
                          "rank_ms": [1e3 * v for v in h["rank_values"]],
                          "attempts": [r["history"][i].get("attempts") for r in ranks]}
                         for i, h in enumerate(ranks[0]["history"])],
          "best": ranks[0]["best"], "table_entry": table["entries"][0],
          "launches": {r["rank"]: {k: v for k, v in r["launches"].items() if v}
                       for r in ranks},
          "seconds": time.perf_counter() - t0})
    return ranks[0]["launches"]


def tuning_path(spec, smi) -> dict:
    """Phase 28, the tuning package and ``--tuned``: (a) every kernel shape
    the knob registry reaches held to its plain version
    (``kernels/tuning_checks.py``: K1 at group 32 / 64 / 128 and run_cap
    1024 / 2048 x gap 128 / 512, K5 and K6 at the three groups and
    list_skin_rel 0.1 / 0.3 on the jittered Sedov 40; K12 and K13 at
    target_block 128 / 256 x super_factor 0 / 4 / 16 on VE Evrard 30); (b)
    a budgeted sweep at full width, ``run_sweep(measure_candidate)`` on std
    Sedov 100^3 in list mode (``TUNING_SWEEP``), each candidate's knobs,
    status and per-step ms beside the card's name and power limit, the
    launches counted over the sweep; (c) the CLI with ``--tuned`` on the
    sweep's table (its best committed, ``--commit best``'s rule) at the
    sweep's workload key (std Sedov 100^3: the table is keyed by the
    particle count's decade), ``--check-every 4``, ``--telemetry-dir`` and
    ``--trace-dir``, in this process (its launches counted), then the
    port's own reader: ``summary --strict`` and ``tuning`` (source
    "table") exit 0, ``trace`` covers >= 0.8; (d) the sweep over two ranks
    (``tuning_ranks``). Returns the sweep's, the CLI's and rank 0's launch
    counts of the sweep over ranks."""
    import contextlib
    import io

    from sphexa_torch.app import main as app
    from sphexa_torch.kernels import tuning_checks
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.telemetry import cli as tcli
    from sphexa_torch.tuning import (
        ReplaySpec, domains_for, make_entry, measure_candidate, new_table, run_sweep,
        save_table, upsert_entry, validate_table,
    )
    from sphexa_torch.tuning.cli import card_label

    t0 = time.perf_counter()
    eng = tuning_checks.engine_shapes("cuda")
    grav = tuning_checks.gravity_shapes("cuda")
    emit({"phase": "tuning_shapes", "card": smi, "engine": eng, "gravity": grav,
          "seconds": time.perf_counter() - t0})

    t1 = time.perf_counter()
    sweep = ReplaySpec(case="sedov", side=100, device="cuda")
    pe.reset_launches()
    result = run_sweep(lambda k: measure_candidate(sweep, k, steps=TUNING_SWEEP["steps"],
                                                   warmup=TUNING_SWEEP["warmup"]),
                       domains_for(TUNING_SWEEP["knobs"]), TUNING_SWEEP["budget"])
    sweep_launches = dict(pe.LAUNCHES)
    for op in ("density_lists", "iad_lists", "momentum_energy_std_lists", "mark"):
        if not sweep_launches.get(op):
            raise AssertionError(f"tuning sweep: {op} never launched ({sweep_launches})")
    rows = [{"candidate": r["candidate"], "knobs": r["knobs"], "status": r["status"],
             "per_step_ms": 1e3 * r["per_step_s"] if "per_step_s" in r else None,
             "rollbacks": r.get("rollbacks"), "config": r.get("config"),
             "error": r.get("error")}
            for r in result["history"]]
    ok = [r for r in result["history"] if r["status"] == "ok"]
    if len(result["history"]) != TUNING_SWEEP["budget"] or not ok:
        raise AssertionError(f"tuning sweep: {rows}")
    emit({"phase": "tuning_sweep", "card": smi, "case": "sedov", "side": 100,
          **TUNING_SWEEP, "candidates": rows, "improved": result["improved"],
          "best": result["best"], "launches": sweep_launches,
          "seconds": time.perf_counter() - t1})

    t2 = time.perf_counter()
    commit = result["best"]["knobs"] or min(
        (r for r in ok if r["knobs"]), key=lambda r: r["value"])["knobs"]
    cand = next(r for r in result["history"] if r["knobs"] == commit)
    table = new_table()
    upsert_entry(table, make_entry("sedov", sweep.n, 1, "pallas", commit, {
        "source_run": "chip_smoke.py tuning_path", "created": time.strftime("%Y-%m-%d"),
        "objective": "per_step_s", "baseline": result["baseline"].get("value"),
        "best": cand["value"], "device": card_label("cuda")}))
    if validate_table(table):
        raise AssertionError(f"tuning table: {validate_table(table)}")

    def reader(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tcli.main(argv)
        return rc, buf.getvalue()

    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, "table.json")
        save_table(path, table)
        tel, trace = os.path.join(wd, "tel"), os.path.join(wd, "trace")
        pe.reset_launches()
        rc = app.main(["--init", "sedov", "-n", "100", "-s", "8", "--check-every", "4",
                       "--tuned", path, "--telemetry-dir", tel, "--trace-dir", trace,
                       "-o", os.path.join(wd, "out"), "--quiet"])
        cli_launches = dict(pe.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"tuned CLI: exit {rc}")
        s_rc, _ = reader(["summary", "--strict", tel])
        t_rc, t_out = reader(["tuning", tel, "--format", "json"])
        c_rc, c_out = reader(["trace", trace, "--min-coverage", "0.8", "--format", "json"])
    stamp = json.loads(t_out)["manifest_tuning"] if t_out.strip() else None
    tr = json.loads(c_out) if c_out.strip() else {}
    if s_rc or t_rc or c_rc or not stamp or stamp.get("source") != "table" \
            or stamp.get("knobs") != commit:
        raise AssertionError(f"tuned CLI reader: summary {s_rc}, tuning {t_rc} {stamp}, "
                             f"trace {c_rc} {tr.get('coverage')}")
    for op in ("density_lists", "iad_lists", "momentum_energy_std_lists", "mark"):
        if not cli_launches.get(op):
            raise AssertionError(f"tuned CLI: {op} never launched ({cli_launches})")
    emit({"phase": "tuning_cli", "card": smi, "table_entry": table["entries"][0],
          "manifest_tuning": stamp, "summary_strict_rc": s_rc, "tuning_rc": t_rc,
          "trace_rc": c_rc, "trace_coverage": tr.get("coverage"),
          "trace_phases": {p["phase"]: p["us"] for p in tr.get("phases", [])},
          "launches": cli_launches, "seconds": time.perf_counter() - t2,
          "phase_seconds": time.perf_counter() - t0})
    return {"tuning_sweep": sweep_launches, "tuning_cli": cli_launches,
            "tuning_ranks": tuning_ranks(smi)}


#: the steps of the main path the cost layer captures and tallies
COST_STEPS = 5
#: the main path's device events a checked step (PRs 8-19, the profile
#: phase): the scopes and the charges, inactive, add none
MAIN_PATH_EVENTS = 223


@entrypoint("cost_main_path")
def cost_main_path():
    """The calibration target of ``cost_path`` (b): the CLI's std Sedov
    100^3 Simulation (app/main.py's construction for ``--init sedov -n
    100``: the case's observables, the science rows), fresh from its
    initial state, and its first ``COST_STEPS`` steps, the lists built
    and rebuilt as the CLI's run builds them."""
    from sphexa_torch.init import init_sedov
    from sphexa_torch.observables import make_observable_spec
    from sphexa_torch.simulation import Simulation

    state, box, const = init_sedov(100, device="cuda")
    sim = Simulation(state, box, const, device="cuda", obs_spec=make_observable_spec("sedov"),
                     science_rows=True)

    def run():
        for _ in range(COST_STEPS):
            sim.step()

    return EntryCase(fn=run, warmup=False)


def cost_path(smi, main_sim) -> dict:
    """Phase 29, the static roofline cost layer: (a) the cost CLI over the
    audit registry on the card against COST_BUDGET_TORCH.json (exit 0), and
    each entry's tally, and that of the two list-mode cases (K5 and the K6
    walks), on the card equal to its CPU tally, its kernel charges equal
    to its launches (``cost_checks.registry_card_vs_cpu``);
    (b) the main path's phase roofline: the CLI's ``--trace-dir`` capture
    of ``COST_STEPS`` steps of std Sedov 100^3 in list mode against the
    tally of the same steps (``cost_main_path``), per phase measured and
    predicted us, ratio and bound class, a ``calibration.json`` beside the
    capture and ``trace --predict`` on it (exit 0; exit 1 with the
    momentum body's rule scaled by 10), the CLI's and the reader's mains
    run in this process; (c) the main path's device events a step after
    the tallies equal to ``MAIN_PATH_EVENTS``, and one step's outputs and
    launches untallied, tallied and untallied again, equal. Returns the
    registry's and the tallied steps' launch counts."""
    import contextlib
    import io

    import torch

    from sphexa_torch.app import main as app
    from sphexa_torch.devtools.audit import costcli
    from sphexa_torch.devtools.audit.core import EntryTrace
    from sphexa_torch.devtools.audit.costmodel import CALIBRATION_FILE, cost_report, predict
    from sphexa_torch.devtools.audit.tally import tallying
    from sphexa_torch.kernels import cost_checks
    from sphexa_torch.kernels import costs as kc
    from sphexa_torch.propagator import step_sim_state
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.telemetry import cli as tcli
    from sphexa_torch.telemetry.traceview import summarize_trace

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()

    def quiet(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        return rc, buf.getvalue()

    # (a) the registry on the card: the CLI's gate, then card vs CPU; the
    # sharded entries' ranks first, on the card and the CPU at once
    from sphexa_torch.kernels import audit_checks

    sharded_s = audit_checks.record_sharded()
    pe.reset_launches()
    rc, table = quiet(costcli.main, ["--device", "h100", "--budget",
                                     os.path.join(here, "COST_BUDGET_TORCH.json")])
    if rc != 0:
        raise AssertionError(f"cost_path: the cost CLI exited {rc}:\n{table[-3000:]}")
    cli_s = time.perf_counter() - t0
    reg = cost_checks.registry_card_vs_cpu()
    reg_launches = dict(pe.LAUNCHES)
    for op in ("density", "iad", "momentum_energy_std", "ve_def_gradh", "iad_divv_curlv",
               "av_switches", "momentum_energy_ve", "gravity_p2p", "compact_class_lists",
               "compact_row", *set().union(*cost_checks.LIST_KERNELS.values())):
        if not reg_launches.get(op):
            raise AssertionError(f"cost_path: the registry never launched {op}")
    emit({"phase": "cost_registry", "card": smi, "entries": reg, "launches": reg_launches,
          "cli_s": cli_s, "sharded_spawns_s": sharded_s, "seconds": time.perf_counter() - t0})

    # (b) the main path: the CLI's capture, the same steps tallied
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        trace = os.path.join(wd, "trace")
        rc, _ = quiet(app.main, ["--init", "sedov", "-n", "100", "-s", str(COST_STEPS),
                                 "--trace-dir", trace, "-o", os.path.join(wd, "out"),
                                 "--quiet"])
        if rc != 0:
            raise AssertionError(f"cost_path: the CLI's capture exited {rc}")
        summary = summarize_trace(trace)
        t2 = time.perf_counter()
        pe.reset_launches()
        tr = EntryTrace(cost_main_path, cost_main_path.build())
        report = cost_report(tr)
        main_launches = dict(pe.LAUNCHES)
        if dict(report.kernels) != tr.launches:
            raise AssertionError(f"cost_path: kernel charges {dict(report.kernels)} != "
                                 f"launches {tr.launches}")
        pred = predict(report, "h100")
        tally_s = time.perf_counter() - t2
        measured = {p["phase"]: p["us"] for p in summary["phases"]}
        rows, calib = [], {}
        for r in pred.rows:
            mus = measured.get(r.phase)
            ratio = mus / (r.ms * 1e3) if mus and r.ms > 0 else None
            rows.append({"phase": r.phase, "measured_us": mus, "predicted_us": r.ms * 1e3,
                         "ratio": ratio, "bound": r.bound, "ai": r.ai, "flops": r.flops,
                         "hbm_lower": r.hbm_lower, "hbm_upper": r.hbm_upper,
                         "compute_us": r.compute_ms * 1e3, "hbm_us": r.hbm_ms * 1e3})
            if ratio is not None:
                calib[r.phase] = {"ratio": ratio}
        for r in rows:
            print(f"# cost_path {r['phase']:16s} measured {r['measured_us'] or 0:11.1f} us  "
                  f"predicted {r['predicted_us']:10.2f} us  ratio "
                  f"{r['ratio'] if r['ratio'] is not None else float('nan'):8.2f}  {r['bound']}",
                  file=sys.stderr)
        target = f"{os.path.relpath(__file__, here)}::cost_main_path"
        with open(os.path.join(trace, CALIBRATION_FILE), "w") as f:
            json.dump({"schema": 1, "target": target, "device": "h100",
                       "tolerance": 2.0, "phases": calib}, f, indent=2)
        cwd = os.getcwd()
        os.chdir(here)  # the target is resolved from the repo's root
        try:
            t3 = time.perf_counter()
            rc_ok, out_ok = quiet(tcli.main, ["trace", trace, "--predict", "--format", "json"])
            predict_s = time.perf_counter() - t3
            saved = dict(kc.BODY_OPS)
            kc.BODY_OPS["momentum_energy_std"] *= 10
            try:
                rc_bad, out_bad = quiet(tcli.main, ["trace", trace, "--predict", "--format",
                                                    "json"])
            finally:
                kc.BODY_OPS.clear()
                kc.BODY_OPS.update(saved)
        finally:
            os.chdir(cwd)
    joined = json.loads(out_ok).get("calibration") if out_ok.strip() else None
    bad = json.loads(out_bad).get("calibration") if out_bad.strip() else None
    if rc_ok != 0 or rc_bad != 1:
        raise AssertionError(f"cost_path: trace --predict exited {rc_ok} (want 0), with the "
                             f"momentum rule x10 {rc_bad} (want 1): {joined} / {bad}")
    emit({"phase": "cost_main_path", "card": smi, "case": "sedov", "side": 100,
          "steps": COST_STEPS, "device_model": "h100", "rows": rows,
          "total_measured_us": summary["total_device_us"], "coverage": summary["coverage"],
          "total_predicted_us": pred.total_ms * 1e3, "tally_coverage": pred.coverage,
          "kernels": dict(report.kernels), "launches": main_launches,
          "kernel_charges": [list(k[:4]) for k in tr.tally.kernel_log],
          "predict_rc": rc_ok, "scaled_rule_rc": rc_bad,
          "scaled_rule_violations": (bad or {}).get("violations"),
          "capture_s": t2 - t1, "tally_s": tally_s, "predict_s": predict_s,
          "seconds": time.perf_counter() - t1})

    # (c) inert: the main path's events a step after the tallies, and one
    # step's outputs and launches untallied, tallied and untallied again
    t4 = time.perf_counter()
    events_after = _events_per_step(main_sim)["events"]
    if events_after != MAIN_PATH_EVENTS:
        raise AssertionError(f"cost_path: {events_after} device events a main-path step "
                             f"after the tallies, {MAIN_PATH_EVENTS} before this layer")
    carry, lists = main_sim.sim_state, main_sim.lists

    def one():
        pe.reset_launches()
        out, diag = step_sim_state(main_sim._step_fn, carry, main_sim.cfg, main_sim.gtree,
                                   main_sim._aux_cfg, lists=lists)
        torch.cuda.synchronize()
        return out.particles, dict(pe.LAUNCHES)

    a, la = one()
    with tallying("cuda"):
        b, lb = one()
    c, lc = one()
    fields = [f.name for f in dataclasses.fields(a) if torch.is_tensor(getattr(a, f.name))]
    for other, label in ((b, "tallied"), (c, "after the tally")):
        diff = [f for f in fields if not torch.equal(getattr(a, f), getattr(other, f))]
        if diff:
            raise AssertionError(f"cost_path: a main-path step {label} differs in {diff}")
    if not la == lb == lc:
        raise AssertionError(f"cost_path: launches {la} / {lb} / {lc}")
    emit({"phase": "cost_inert", "card": smi, "device_events_per_step": events_after,
          "step_launches": la, "fields_equal": fields, "seconds": time.perf_counter() - t4,
          "phase_seconds": time.perf_counter() - t0})
    return {"cost_registry": reg_launches, "cost_main_path": main_launches}


def audit_path(smi) -> None:
    """Phase 30, the audit's trace rules, lowering lock and statecheck
    (``kernels/audit_checks.py``), on the records ``cost_path`` made: every
    registry entry's findings, run fingerprint (its launch map among it)
    and schema rows equal on the card and on the CPU and to the committed
    LOWERING_LOCK_TORCH.json and STATE_SCHEMA_TORCH.json, the launch map
    equal to the wrappers' counters, JXA104's host-sync sites equal to
    those the card's sync debug mode reports over one more run, the knob
    probes equal on both devices; then the CLI's default mode,
    ``lowering`` and ``schema`` on the card (exit 0 each)."""
    from sphexa_torch.kernels import audit_checks

    t0 = time.perf_counter()
    entries = audit_checks.registry_card_vs_cpu_audit()
    t1 = time.perf_counter()
    rcs = audit_checks.audit_cli_on_card()
    emit({"phase": "audit_path", "card": smi, "entries": entries, "cli_rcs": rcs,
          "registry_s": t1 - t0, "cli_s": time.perf_counter() - t1,
          "phase_seconds": time.perf_counter() - t0})
    # the sharded entries on two ranks, card vs CPU vs the locks; preflight
    t2 = time.perf_counter()
    sharded = audit_checks.sharded_card_vs_cpu_audit()
    t3 = time.perf_counter()
    pre = audit_checks.preflight_on_card()
    for name, r in sharded.items():
        for rank, rr in enumerate(r["ranks"]):
            print(f"# audit {name:28s} rank {rank}: static peak {rr['static_peak']:>10d} B, "
                  f"max_memory_allocated {rr['max_memory_allocated']:>10d} B (resident "
                  f"before {rr['allocated_before']} B)")
    print(f"# audit h100 model memory {pre['model_memory']} B, the card's total_memory "
          f"{pre['total_memory']} B")
    emit({"phase": "audit_sharded", "card": smi, "entries": sharded, "preflight": pre,
          "sharded_s": t3 - t2, "preflight_s": time.perf_counter() - t3,
          "seconds": time.perf_counter() - t2})


def _evrard_rho(r: float):
    """The Evrard sphere's density profile (rho ~ 1/r inside radius ``r``),
    on float64 numpy coordinates."""
    import numpy as np

    def rho(x, y, z):
        d = np.sqrt(x * x + y * y + z * z)
        return np.where(d < r, 1.0 / np.maximum(d, 1e-6 * r), 0.0)

    return rho


def tree_path(smi) -> dict:
    """Phase 31, the cornerstone tree (``sphexa_torch/tree``,
    ``gravity/tree.build_gravity_tree``) at full width: the keys of std
    Sedov 100^3 and of VE Evrard 125 (the Simulation's own, at its box),
    sorted on the card; the device pyramid (``leaf_array_from_device_keys``
    on the card, unsorted keys) equal to ``compute_octree`` of the host
    keys bit for bit at GRAV_BUCKET (64) and 16; ``build_gravity_tree``'s
    leaves, linkage and geometry equal to the Evrard Simulation's; the
    continuum tree of the Evrard profile with the decode on the card equal
    to the same call on the CPU. Each time beside the card."""
    import numpy as np
    import torch

    from sphexa_torch.gravity.traversal import GRAV_BUCKET
    from sphexa_torch.gravity.tree import build_gravity_tree
    from sphexa_torch.init import init_evrard, init_sedov
    from sphexa_torch.init.evrard import evrard_constants
    from sphexa_torch.parallel.sizing import leaf_array_from_device_keys
    from sphexa_torch.sfc.keys import compute_sfc_keys
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.tree import compute_continuum_octree, compute_octree

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    t0 = time.perf_counter()
    out = {}
    for name in ("sedov", "evrard"):
        if name == "sedov":
            state, box, _ = init_sedov(100, device="cuda")
            sim, curve = None, "hilbert"
        else:
            state, box, const = init_evrard(125, device="cuda")
            sim = Simulation(state, box, const, prop="ve", device="cuda")
            state, box, curve = sim.state, sim.box, sim.curve
        keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=curve)
        skeys, sort_ms = timed(lambda: torch.sort(keys).values)
        host = skeys.cpu().numpy().astype(np.uint64)
        r = {"n": int(keys.numel()), "sort_ms": sort_ms}
        for bucket in (GRAV_BUCKET, 16):
            leaf, card_ms = timed(lambda: leaf_array_from_device_keys(keys, bucket))
            (ref, counts), host_ms = timed(lambda: compute_octree(host, bucket))
            if not np.array_equal(leaf, ref) or leaf.dtype != ref.dtype:
                raise AssertionError(f"tree {name} bucket {bucket}: the pyramid's "
                                     f"{len(leaf) - 1} leaves differ from compute_octree's "
                                     f"{len(ref) - 1}")
            r[f"bucket_{bucket}"] = {"leaves": len(ref) - 1, "max_count": int(counts.max()),
                                     "pyramid_ms": card_ms, "compute_octree_ms": host_ms}
        if sim is not None:
            (gtree, meta), build_ms = timed(lambda: build_gravity_tree(skeys, GRAV_BUCKET,
                                                                       curve=curve,
                                                                       device="cuda"))
            same = meta == sim.cfg.grav_meta and all(
                torch.equal(getattr(gtree, f), getattr(sim.gtree, f)) for f in (
                    "leaf_keys", "parent", "is_leaf", "leaf_of_node", "node_of_leaf",
                    "center_frac", "halfsize_frac"))
            if not same:
                raise AssertionError(f"tree {name}: build_gravity_tree differs from the "
                                     f"Simulation's tree ({meta} vs {sim.cfg.grav_meta})")
            r["build_gravity_tree"] = {"ms": build_ms, "nodes": meta.num_nodes,
                                       "levels": len(meta.level_ranges)}
            del sim
        out[name] = r
    rad = float(evrard_constants()["r"])
    args = (_evrard_rho(rad), (-rad,) * 3, (2 * rad,) * 3, out["evrard"]["n"], GRAV_BUCKET)
    (tc, cc), card_ms = timed(lambda: compute_continuum_octree(*args, device="cuda"))
    (tp, cp), cpu_ms = timed(lambda: compute_continuum_octree(*args, device="cpu"))
    if not (np.array_equal(tc, tp) and np.array_equal(cc, cp)):
        raise AssertionError("continuum tree: the card's decode and the CPU's differ")
    out["continuum_evrard"] = {"leaves": len(tc) - 1, "card_ms": card_ms, "cpu_ms": cpu_ms}
    emit({"phase": "tree_path", "card": smi, **out, "seconds": time.perf_counter() - t0})
    return out


def committed_suppressions(here: str) -> list:
    """tests/test_torch_lint.py's ``PACKAGE_SUPPRESSED`` (the package's
    inline suppressions, each a needed host read with its reason), read
    from the file's syntax tree: the test imports JAX, this script does
    not."""
    path = os.path.join(here, "tests", "test_torch_lint.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PACKAGE_SUPPRESSED" for t in node.targets):
            return sorted(tuple(x) for x in ast.literal_eval(node.value))
    raise AssertionError(f"{path}: no PACKAGE_SUPPRESSED")


def lint_path(smi) -> dict:
    """Phase 32, torchlint on this machine (no JAX): ``python -m
    sphexa_torch.devtools.lint sphexa_torch --format json --show-suppressed``
    in a subprocess exits 0 with no finding and no error (a suppression
    without its reason is an error), and its suppressed findings are the
    committed ones of tests/test_torch_lint.py (``committed_suppressions``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sphexa_torch.devtools.lint", "sphexa_torch",
                           "--format", "json", "--show-suppressed"], cwd=here,
                          capture_output=True, text=True, timeout=300)
    rep = json.loads(proc.stdout) if proc.stdout.strip() else {}
    sup = [f"{f['path']}:{f['line']} {f['rule']}" for f in rep.get("suppressed", [])]
    out = {"rc": proc.returncode, "findings": len(rep.get("findings", [None])),
           "errors": len(rep.get("errors", [None])), "suppressed": sup,
           "seconds": time.perf_counter() - t0}
    got = sorted((f["path"], f["rule"]) for f in rep.get("suppressed", []))
    if proc.returncode != 0 or out["findings"] or out["errors"] or \
            got != committed_suppressions(here):
        raise AssertionError(f"lint_path: {out} {proc.stderr[-2000:]}")
    emit({"phase": "lint_path", "card": smi, **out})
    return out


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sphexa_torch.init import init_noh, init_sedov
    from sphexa_torch.kernels import build as kbuild
    from sphexa_torch.kernels import checks
    from sphexa_torch.kernels import deferred_checks
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.propagator import _force_stage_prologue
    from sphexa_torch.sfc.keys import compute_sfc_keys
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_engine as pe

    spec = ObservableSpec()  # the science ledger in every driven path's steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    path = kbuild.build()
    kbuild.load_library()
    # ptxas's report per kernel: its entry function, registers and spills
    ptxas = [ln.strip() for ln in kbuild.build_log().splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, here), "ptxas": ptxas})

    # 3. kernels vs plain at the two small cases (both periodic-image paths)
    for side, ct, expect_fold in ((24, 16, False), (12, None, True)):
        ss, box, const, cfg, keys, ranges = sorted_case(side, ct)
        fold = pe.engine_fold(box, cfg.nbr)
        if fold != expect_fold:
            raise AssertionError(f"side {side}: engine_fold {fold}, expected {expect_fold}")
        res = compare_ops(f"side {side}", ss, box, const, cfg, keys, ranges)
        emit({"phase": "kernels_vs_plain", "side": side, "cell_target": ct,
              "fold": fold, "nbr": dataclasses.asdict(cfg.nbr), "results": res})
        for av_clean in (False, True):
            res = compare_ve(f"VE side {side} av_clean {av_clean}", ss, box, const, cfg.nbr,
                             av_clean, keys=keys, ranges=ranges)
            emit({"phase": "ve_kernels_vs_plain", "side": side, "cell_target": ct,
                  "fold": fold, "av_clean": av_clean, "results": res})

    # the whole step on the card against the CPU (plain versions) on small
    # inputs: both periodic-image paths streaming, and list mode; std and
    # VE; and VE Gresho-Chan, whose thin slab puts the grid in fold mode
    for prop in ("std", "ve"):
        # the streaming side 24 one step (was two: the depth cut paying for
        # audit_path); list mode two, its second on the first's lists
        for side, ct, use_lists, steps in ((24, 16, True, 2), (24, 16, False, 1),
                                           (12, None, False, 2)):
            emit(slice_vs_cpu(side, ct, steps=steps, use_lists=use_lists, prop=prop))
    gc = slice_vs_cpu(20, None, steps=1, use_lists=True, prop="ve", case="gresho-chan")
    if not gc["fold"]:
        raise AssertionError("Gresho-Chan 20: expected a fold-mode grid")
    emit(gc)

    # 4. the list kernels vs plain, and list mode vs streaming; K5 also on
    # the synthetic cells that hold every edge of the run merge
    (mstate, mbox, mconst), msizing = checks.mixed_box_case("cpu")
    for name, init, side, jitter, sizing in (
            ("sedov", init_sedov, 30, True, {}), ("noh", init_noh, 16, False, {}),
            ("mixed_box", lambda side, device: (mstate, mbox, mconst), 24, False, msizing)):
        ss, box, const, cfg, keys, lists, cull = list_case(init, side, jitter, **sizing)
        res = compare_lists(f"{name} {side}", ss, box, const, cfg, keys, lists, cull)
        emit({"phase": "lists_vs_plain", "case": name, "side": side, "jitter": jitter,
              "n": ss.n, "nbr": dataclasses.asdict(cfg.nbr), "boundaries": [
                  int(b) for b in box.boundaries],
              "slot_cap": cfg.list_slot_cap, "results": res})
        for av_clean in (False, True):
            res = compare_ve(f"VE lists {name} {side} av_clean {av_clean}", ss, box, const,
                             cfg.nbr, av_clean, lists=lists)
            emit({"phase": "ve_lists_vs_plain", "case": name, "side": side,
                  "av_clean": av_clean, "results": res})
    synth = {}
    for seed in (7, 11):
        cull, x, y, z, h, skin, scap, scfg = checks.synthetic_cull(seed, "cuda")
        for cap in (scap, 3):
            r = checks.list_build_vs_plain(f"synthetic {seed} slots {cap}", cull, x, y, z, h,
                                           skin, cap, scfg)
            synth[f"seed {seed} slots {cap}"] = {"bits_equal": True, "max_total": int(
                r["outputs"][3].max())}
    emit({"phase": "list_build_synthetic", "results": synth})

    # 5. the main path: Sedov 100^3 std on the card, in list mode
    side = 100
    state, box, const = init_sedov(side, device="cuda")
    n = state.n
    lst = drive(lambda: Simulation(state, box, const, prop="std", device="cuda",
                                   obs_spec=spec),
                steps=10, label="main_path")
    sim = lst["sim"]
    if sim.lists is None:
        raise AssertionError("the main path streamed: no persistent lists")
    la = lst["launches"]
    check_launches("std list mode", la, lst["attempts"],
                   ("density_lists", "iad_lists", "momentum_energy_std_lists"), lst["rebuilds"])
    ranges_now = pe.group_cell_ranges(
        sim.state.x, sim.state.y, sim.state.z, sim.state.h,
        compute_sfc_keys(sim.state.x, sim.state.y, sim.state.z, sim.box, curve=sim.cfg.curve),
        sim.box, sim.cfg.nbr)  # the state is in its frozen order: its keys are sorted
    lst["report"].update({
        "list_slot_cap": sim.cfg.list_slot_cap, "rebuilds": sim.rebuilds,
        "list_slack": [d["list_slack"] for d in lst["diags"]],
        "lanes_total": float(sim.lists.lanes_total),
        "pruned_run_candidates": int(sim.lists.ranges.lens.to(torch.int64).sum()),
        "streamed_candidates": int(ranges_now.lens.to(torch.int64).sum())})
    emit(lst["report"])
    emit({**count_syncs(sim), "path": "lists"})
    emit({**profile_steps(sim, 2, lst["step_ms_median"]), "path": "lists"})
    emit({"phase": "rebuild", "card": smi, "ms": rebuild_split(sim),
          "first_build_s": lst["first_build_s"]})

    # 6. the streaming path, driven the same way with fewer timed steps
    state, box, const = init_sedov(side, device="cuda")
    stm = drive(lambda: Simulation(state, box, const, prop="std", device="cuda",
                                   use_lists=False, obs_spec=spec), steps=5,
                label="streaming_path")
    ssim = stm["sim"]
    sa = stm["launches"]
    check_launches("std streaming", sa, stm["attempts"],
                   ("density", "iad", "momentum_energy_std"))
    emit(stm["report"])
    emit({**count_syncs(ssim), "path": "streaming"})
    emit({**profile_steps(ssim, 2, stm["step_ms_median"]), "path": "streaming"})

    # 7. the VE path: Sedov 100^3 VE on the card, in list mode
    state, box, const = init_sedov(side, device="cuda")
    ve = drive(lambda: Simulation(state, box, const, prop="ve", device="cuda",
                                   obs_spec=spec),
               steps=10, label="ve_path")
    vsim, va = ve["sim"], ve["launches"]
    if vsim.lists is None:
        raise AssertionError("the VE path streamed: no persistent lists")
    ve_walk = VE_WALK
    check_launches("VE list mode", va, ve["attempts"], ve_walk, ve["rebuilds"])
    ve["report"].update({
        "list_slot_cap": vsim.cfg.list_slot_cap, "rebuilds": vsim.rebuilds,
        "list_slack": [d["list_slack"] for d in ve["diags"]],
        "dt_limiter": [d["dt_limiter"] for d in ve["diags"]],
        "lanes_total": float(vsim.lists.lanes_total)})
    emit(ve["report"])
    ve_syncs = count_syncs(vsim)
    if ve_syncs["per_step"] != 1:
        raise AssertionError(f"VE path: {ve_syncs['per_step']} host syncs per step")
    emit({**ve_syncs, "path": "ve_lists"})
    ve_prof = profile_steps(vsim, 2, ve["step_ms_median"])
    emit({**ve_prof, "path": "ve_lists"})

    # the VE entry points the list mode leaves out: streaming (K1 forms of
    # the AV switches and momentum) and av_clean (the list walk of
    # divv/curlv with gradv), each a short path of its own
    state, box, const = init_sedov(side, device="cuda")
    vst = drive(lambda: Simulation(state, box, const, prop="ve", device="cuda",
                                   use_lists=False, obs_spec=spec), steps=3,
                label="ve_streaming_path")
    vsa = vst["launches"]
    check_launches("VE streaming", vsa, vst["attempts"], (
        "density", "ve_def_gradh", "iad", "iad_divv_curlv", "av_switches",
        "momentum_energy_ve"))
    emit(vst["report"])
    state, box, const = init_sedov(side, device="cuda")
    vac = drive(lambda: Simulation(state, box, const, prop="ve", device="cuda",
                                   av_clean=True, obs_spec=spec), steps=3,
                label="ve_avclean_path")
    vaa = vac["launches"]
    check_launches("VE av_clean", vaa, vac["attempts"], ve_walk, vac["rebuilds"])
    emit(vac["report"])

    # 8. kernels vs plain and phase times at the paths' shapes
    ss, lbox, const, lcfg, lkeys, lists, lcull = list_case(
        None, side, False, state=(sim.state, sim.box, const), cfg=sim.cfg)
    std_list = (ss, lbox, const, lcfg, lkeys, lists, lcull)
    lres = compare_lists("side 100", ss, lbox, const, lcfg, lkeys, lists, lcull, timing=True)
    lbnd = list_bounds(lists, n, lcfg.nbr.group, lres["density_lists"]["nb_pairs"],
                       mark=lres["mark"],
                       pairs={op: r["pairs"] for op, r in lres.items() if "pairs" in r})
    consts100 = pe.op_consts(const)
    passes = {"std_lists": pass_counts(ss, lcfg.nbr.group, consts100, lists=lists)}
    emit({"phase": "lists_vs_plain", "case": "sedov", "side": side, "results": lres,
          "bounds": lbnd, "slot_cap": lcfg.list_slot_cap,
          "lanes_total": float(lists.lanes_total), "nbr": dataclasses.asdict(lcfg.nbr)})

    st = (ssim.state, ssim.box, const)
    ss, box2, const, cfg, keys, ranges = sorted_case(side, state=st, cfg=ssim.cfg)
    std_stream = (ss, box2, const, cfg, keys, ranges)
    res = compare_ops("side 100", ss, box2, const, cfg, keys, ranges, timing=True)
    sort_ms = cuda_time_ms(lambda: _force_stage_prologue(ssim.state, ssim.box, cfg), reps=5)
    prologue_ms = cuda_time_ms(
        lambda: pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, box2, cfg.nbr), reps=5)
    start, lens, keep, shifts, _, _ = pe.window_cells_culled(
        ss.x, ss.y, ss.z, ss.h, keys, box2, cfg.nbr)
    merge_ms = cuda_time_ms(lambda: pe._merge_runs(
        start, lens, keep, shifts, cfg.nbr.run_cap, cfg.nbr.gap), reps=5)
    bnd = bounds(ranges, n, cfg.nbr.group, res["density"]["nb_pairs"],
                 pairs={op: r["pairs"] for op, r in res.items() if "pairs" in r})
    passes["std_streaming"] = pass_counts(ss, cfg.nbr.group, consts100, ranges=ranges,
                                          fold=pe.engine_fold(box2, cfg.nbr))
    emit({"phase": "kernels_vs_plain", "side": side, "path": "streaming",
          "fold": pe.engine_fold(box2, cfg.nbr), "results": res, "bounds": bnd,
          "sort_ms": sort_ms, "prologue_ms": prologue_ms, "merge_runs_ms": merge_ms,
          "nbr": dataclasses.asdict(cfg.nbr)})

    # the VE kernels at the VE paths' evolved side-100 states: list mode
    # (the main VE path), streaming, and the av_clean list walk
    vt, ve_cases = {}, {}
    for label, vs, walk, av_clean in (("ve_lists", vsim, True, False),
                                      ("ve_streaming", vst["sim"], False, False),
                                      ("ve_avclean", vac["sim"], True, True)):
        if walk:
            ss, vbox, const, vcfg, vkeys, vlists, _ = list_case(
                None, side, False, state=(vs.state, vs.box, const), cfg=vs.cfg)
            vres = compare_ve(f"{label} side 100", ss, vbox, const, vcfg.nbr, av_clean,
                              lists=vlists, timing=True)
            walks = ("ve_def_gradh_lists", "iad_divv_curlv_lists", "av_switches_lists",
                     "momentum_energy_ve_lists")
            vbnd = list_bounds(vlists, n, vcfg.nbr.group, vres["xmass"]["nb_pairs"],
                               walk_ops=walks, av_clean=av_clean,
                               pairs={op: r["pairs"] for op, r in vres.items() if "pairs" in r})
            extra = {"lanes_total": float(vlists.lanes_total)}
            passes[label] = pass_counts(ss, vcfg.nbr.group, consts100, lists=vlists)
        else:
            ss, vbox, const, vcfg, vkeys, vranges = sorted_case(
                side, state=(vs.state, vs.box, const), cfg=vs.cfg)
            vres = compare_ve(f"{label} side 100", ss, vbox, const, vcfg.nbr, av_clean,
                              keys=vkeys, ranges=vranges, timing=True)
            vbnd = bounds(vranges, n, vcfg.nbr.group, vres["xmass"]["nb_pairs"],
                          ops=("ve_def_gradh", "iad_divv_curlv", "av_switches",
                               "momentum_energy_ve"),
                          pairs={op: r["pairs"] for op, r in vres.items() if "pairs" in r})
            extra = {"fold": pe.engine_fold(vbox, vcfg.nbr)}
            passes[label] = pass_counts(ss, vcfg.nbr.group, consts100, ranges=vranges,
                                        fold=extra["fold"])
        emit({"phase": "ve_kernels_vs_plain", "side": side, "path": label,
              "av_clean": av_clean, "results": vres, "bounds": vbnd, **extra})
        vt[label] = (vres, vbnd)
        ve_cases[label] = (ss, vbox, vcfg, vkeys, vlists if walk else vranges, av_clean)

    # 9. the rebuild cadence: the main path's Simulation on to step 100
    b0, r0, it0 = sim.rebuilds, sim.replays, sim.iteration
    ms = []
    for _ in range(100 - sim.iteration):
        sim.step()
        ms.append(1e3 * sim.last_step_seconds)
    long_drift = sim.energy_drift
    if long_drift is None or not abs(long_drift) < 1e-3:
        raise AssertionError(f"long run: energy drift {long_drift}")
    long_mean, long_median = statistics.mean(ms), statistics.median(ms)
    emit({"phase": "long_run", "from_step": it0, "to_step": sim.iteration,
          "rebuilds": sim.rebuilds - b0, "replays": sim.replays - r0,
          "step_ms_mean": long_mean, "step_ms_median": long_median,
          "step_ms_max": max(ms), "energy_drift": long_drift,
          "list_slot_cap": sim.cfg.list_slot_cap, "reconfigures": sim.reconfigures})

    # 9b. the deferred path: the main path as bench.py drives the JAX one
    # (check_every 8, the ledger in the step, telemetry to a MemorySink),
    # to step 100; then check_every 1 and 4 the same way (the rollback
    # cadence); the host syncs of whole windows and the busy share of one.
    # Each of these phases reports its own wall (``seconds``, set-up included)
    walk = ("density_lists", "iad_lists", "momentum_energy_std_lists")
    cadence = {}
    for ce in (8, 4, 1):
        t0 = time.perf_counter()
        state, box, const = init_sedov(side, device="cuda")
        run = deferred_run(lambda tel: Simulation(
            state, box, const, prop="std", device="cuda", check_every=ce, obs_spec=spec,
            telemetry=tel, science_rows=True), to_step=100)
        check_launches(f"std deferred check_every {ce}", run["launches"], run["attempts"],
                       walk, run["report"]["rebuilds"])
        cadence[ce] = run
        emit({"phase": "deferred_cadence", **run["report"],
              "seconds": time.perf_counter() - t0})
    if cadence[8]["sim"].lists is None:
        raise AssertionError("the deferred path streamed: no persistent lists")
    t0 = time.perf_counter()
    state, box, const = init_sedov(side, device="cuda")
    windows = deferred_windows(Simulation(state, box, const, prop="std", device="cuda",
                                          check_every=8, obs_spec=spec),
                               cadence[8]["report"]["window_per_step_ms_median"])
    emit({"phase": "deferred_path", "card": smi, **cadence[8]["report"],
          "launches": cadence[8]["launches"], "step_attempts": cadence[8]["attempts"],
          **windows, "long_run": {"check_every": 1, "step_ms_mean": long_mean,
                                  "step_ms_median": long_median, "energy_drift": long_drift},
          "seconds": time.perf_counter() - t0})

    # 9c. the deferred windows' sabotage cases on the card: the cap forced
    # to 8 and h x 4 mid-window roll back and replay to a clean run; a
    # deferred streaming run equals the checked one bit for bit; a VE
    # list-mode window on stale lists rolls back and replays
    t0 = time.perf_counter()
    dchecks = {"cap_rollback": deferred_checks.cap_rollback(30, "cuda"),
               "h_growth": deferred_checks.h_growth_rollback(32, "cuda", window=4),
               "matches_sync": deferred_checks.matches_sync(30, "cuda"),
               "ve_list_expiry": deferred_checks.list_expiry_replay(30, "cuda", prop="ve")}
    emit({"phase": "deferred_checks", **dchecks, "seconds": time.perf_counter() - t0})

    # 9d. snapshots, restart and the analytic comparison (io_restart)
    io_restart(spec)

    # 10. gravity: K13 and K12 vs plain, solves and steps card vs CPU
    emit(gravity_checks())
    for prop in ("std", "ve"):
        # one step (was two: the depth cut paying for audit_path's sharded
        # entries and preflight)
        emit(slice_vs_cpu(20, None, steps=1, use_lists=False, prop=prop, case="evrard"))

    # 11. the Evrard path: VE Evrard side 125 with self-gravity
    from sphexa_torch.gravity import pallas_compact as pcmp
    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.init import init_evrard

    state, box, const = init_evrard(125, device="cuda")
    evr = drive(lambda: Simulation(state, box, const, prop="ve", device="cuda",
                                   obs_spec=spec), steps=2,
                label="evrard_path")
    esim, ea = evr["sim"], evr["launches"]
    check_launches("Evrard", ea, evr["attempts"], (
        "density", "ve_def_gradh", "iad", "iad_divv_curlv", "av_switches",
        "momentum_energy_ve", "gravity_p2p"), compactions=2)
    if esim.lists is not None:
        raise AssertionError("Evrard: lists on under self-gravity")
    gkeys = ("m2p_max", "p2p_max", "leaf_occ", "c_max", "compact_width", "mac_work_ratio",
             "egrav")
    evr["report"].update({
        "gravity": dataclasses.asdict(esim.cfg.gravity),
        "tree": {"leaves": esim.cfg.grav_meta.num_leaves,
                 "nodes": esim.cfg.grav_meta.num_nodes},
        "tree_build_configure_s": esim.grav_configure_seconds,
        "gravity_diags": [{k: d[k] for k in gkeys} for d in evr["diags"]],
        "dt_limiter": [d["dt_limiter"] for d in evr["diags"]],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit(evr["report"])
    syncs = count_syncs(esim)
    if syncs["per_step"] != 1:
        raise AssertionError(f"Evrard path: {syncs['per_step']} host syncs per step")
    emit({**syncs, "path": "evrard"})
    emit({**profile_steps(esim, 2, evr["step_ms_median"]), "path": "evrard"})
    gphases, (ess, ebox, ekeys, egcfg, eout) = gravity_phase_times(esim)
    emit({"phase": "gravity_phases", **gphases,
          "tree_build_configure_s": esim.grav_configure_seconds})
    emit({"phase": "gravity_accuracy", **gravity_accuracy(ess, egcfg, eout)})

    # K12 and K13 at the path's shapes: vs plain, times, bounds
    estarts, elens, ecls = checks.near_field_ranges(ess.x, ess.y, ess.z, ess.m, ekeys, ebox,
                                                    esim.gtree, esim.cfg.grav_meta, egcfg,
                                                    keep_packed=True)
    packed = ecls["packed"]
    if len(packed) != 2:
        raise AssertionError(f"Evrard 125: {len(packed)} compactions, expected 2")
    groups = torch.linspace(0, elens.shape[0] - 1, 256, device="cuda").round().long()
    gres = {
        "gravity_p2p": checks.p2p_vs_plain("Evrard 125", ess.x, ess.y, ess.z, ess.m, ess.h,
                                           egcfg, estarts, elens, groups=groups),
        "compact_class_lists": {"checks": [
            checks.compact_vs_plain(f"Evrard 125 compaction {i}", *pk)
            for i, pk in enumerate(packed)]}}
    z3 = torch.zeros(3, device="cuda")
    p2p_args = (ess.x, ess.y, ess.z, ess.m, ess.h, z3, False, egcfg, estarts, elens)
    gres["gravity_p2p"]["ms"] = cuda_time_ms(lambda: gt._pallas_p2p(*p2p_args), reps=7)
    gres["gravity_p2p"]["batched_ms"] = cuda_time_batched_ms(lambda: gt._pallas_p2p(*p2p_args))
    p2p_launch, _ = gt.p2p_launcher(*p2p_args)
    gres["gravity_p2p"]["kernel_ms"] = launch_loop_ms(p2p_launch, 20)
    gres["gravity_p2p"]["clocks"] = clocks_under_load(p2p_launch,
                                                      gres["gravity_p2p"]["kernel_ms"])
    gres["gravity_p2p"]["plain_ms"] = cuda_time_ms(lambda: gt._pallas_p2p_plain(*p2p_args),
                                                   reps=1)
    gres["gravity_p2p"]["library_ms"] = None
    cres = gres["compact_class_lists"]
    cres["max_abs_err"] = max(c["max_abs_err"] for c in cres["checks"])
    cres["ms"] = cuda_time_ms(lambda: [pcmp.compact_class_lists(*pk) for pk in packed],
                              reps=7)
    cres["per_launch_ms"] = [cuda_time_ms(lambda pk=pk: pcmp.compact_class_lists(*pk), reps=7)
                             for pk in packed]
    cres["kernel_ms"] = [launch_loop_ms(pcmp.compact_launcher(*pk)[0], 200) for pk in packed]
    cres["plain_ms"] = cuda_time_ms(
        lambda: [pcmp.compact_class_lists_plain(*pk) for pk in packed], reps=2)
    # the one PyTorch call that computes the same lists: the packed rows
    # sorted (candidate order is ascending node index), sliced at the caps
    cres["library_ms"] = cuda_time_ms(lambda: [torch.sort(pk[0], dim=1) for pk in packed],
                                      reps=7)
    eruns = gt.p2p_runs(estarts, elens, egcfg)  # the plain version's form, for the count
    gbnd = gravity_bounds(elens, ess.x.shape[0], egcfg.target_block, packed, runs=eruns)
    emit({"phase": "gravity_kernels", "side": 125, "n": ess.x.shape[0], "results": gres,
          "bounds": gbnd, "near_field_load": near_field_load(elens, egcfg.target_block),
          "runs_per_block_mean": float(eruns.ncells.float().mean()),
          "p2p_n_mean": float(ecls["p2p_n"].float().mean()),
          "m2p_n_mean": float(ecls["m2p_n"].float().mean())})

    # 12. spherical multipoles: open-box solves at the Evrard path's state
    t0 = time.perf_counter()
    emit({**spherical_solves(esim, ess, ebox, ekeys, egcfg), "seconds": time.perf_counter() - t0})
    del eout

    # 13. the N-body path: Plummer 10^6 and Evrard 125, and the CLI
    path_launches = {"evrard_ve": ea, **nbody_path(spec, smi)}
    # 14. Ewald periodic gravity: std Sedov 100^3 with G = 0.5
    path_launches["ewald_sedov"] = ewald_path(spec, smi)

    # 15. the turb-ve path (turbulence 10^6, list mode) and 16. the
    # std-cooling path (evrard-cooling 125, CIE and evolved); 17. their
    # steps card vs CPU, the CLI and its restart
    turb_launches = turb_path(smi, ve_syncs["per_step"], ve_prof["device_events_per_step"])
    cool_launches = cooling_path(smi)
    path_launches["cooling_evrard"] = cool_launches["cie"]
    turb_cooling_checks(smi)

    # 18. the new inits at full width (inits_path) and 19. the glass
    # template; 20. the kernel families (kernel_family: every K1 and K6 op
    # with wendland-c6 and sinc index 5 at the side-100 states, the
    # wendland-c6 paths and the CLI); 21. block time steps (blockdt_path)
    init_launches = inits_path(smi)
    glass_phase(smi)
    fam = kernel_family(std_list, std_stream, ve_cases)
    wend_launches = wendland_paths(spec, smi)
    bdt_launches, row = blockdt_path(spec, smi)
    # 22. the std and VE steps over ranks (sharded_path) and 23. self-gravity
    # and std-cooling over ranks (sharded_gravity_path)
    shard, shard_launches = sharded_path(smi)
    gshard, gshard_launches = sharded_gravity_path(smi)
    # 24. turb-ve, block time steps and N-body over ranks, and the CLI
    pshard, pshard_launches, _ = sharded_props_path(smi)
    # 25. the app shell: snapshots, --insitu, the substep split, --trace-dir,
    # --memory-profile, --debug-checks, --devices 2 --snap
    app_launches = app_shell(spec, smi, sim, vsim)
    # 26. the gather backend at full width (gather_path) and 27. across
    # ranks (sharded_gather_path)
    gather_path(spec, smi)
    sharded_gather_path(smi)
    # 28. the tuning package and --tuned: every knob shape held to the plain
    # versions, a sweep at full width, the tuned CLI and the port's reader
    tune_launches = tuning_path(spec, smi)
    rank_sweep = {"tuning_ranks": tune_launches.pop("tuning_ranks")}
    # 29. the static roofline cost layer: the registry card vs CPU, the main
    # path's phase roofline against its capture, the tally inert
    cost_launches = cost_path(smi, sim)
    # 30. the audit's trace rules, the lowering lock and statecheck: the
    # registry card vs CPU and the committed files, the syncs the card sees
    audit_path(smi)
    # 31. the cornerstone tree: the pyramid against compute_octree at full
    # width, build_gravity_tree against the Simulation's, the continuum
    # tree card vs CPU; 32. torchlint clean on this machine
    tree_path(smi)
    lint_path(smi)

    # the engines' evidence: every instantiation of K1 and K6, and K12
    specs = {"density": pe.DENSITY, "iad": pe.IAD, "momentum_energy_std": pe.momentum_spec(const),
             "ve_def_gradh": pe.VE_DEF_GRADH, "iad_divv_curlv": pe.IAD_DIVV_CURLV,
             "iad_divv_curlv:gradv": pe.IAD_DIVV_CURLV_GRADV, "av_switches": pe.AV_SWITCHES,
             "momentum_energy_ve": pe.MOMENTUM_ENERGY_VE,
             "momentum_energy_ve:av_clean": pe.MOMENTUM_ENERGY_VE_CLEAN}
    vl, vs_, va_ = vt["ve_lists"][0], vt["ve_streaming"][0], vt["ve_avclean"][0]
    walk_at = {"density": (lres, "std_lists", "density_lists"),
               "iad": (lres, "std_lists", "iad_lists"),
               "momentum_energy_std": (lres, "std_lists", "momentum_energy_std_lists"),
               "ve_def_gradh": (vl, "ve_lists", "ve_def_gradh_lists"),
               "iad_divv_curlv": (vl, "ve_lists", "iad_divv_curlv_lists"),
               "iad_divv_curlv:gradv": (va_, "ve_avclean", "iad_divv_curlv_lists"),
               "av_switches": (vl, "ve_lists", "av_switches_lists"),
               "momentum_energy_ve": (vl, "ve_lists", "momentum_energy_ve_lists"),
               "momentum_energy_ve:av_clean": (va_, "ve_avclean", "momentum_energy_ve_lists")}
    k1_at = {"density": (res, "std_streaming", "density"),
             "iad": (res, "std_streaming", "iad"),
             "momentum_energy_std": (res, "std_streaming", "momentum_energy_std"),
             **{op: (vs_, "ve_streaming", op) for op in (
                 "ve_def_gradh", "iad_divv_curlv", "av_switches", "momentum_energy_ve")}}
    report = ptxas_report(kbuild.build_log())
    group = lcfg.nbr.group
    engines = (engine_entries(specs, walk_at, passes, report, "K6", group)
               + engine_entries(specs, k1_at, passes, report, "K1", group, folds=(False, True))
               + [p2p_entry(report, egcfg.target_block, gres["gravity_p2p"]),
                  mark_entry(report, lres["mark"], lcfg.list_slot_cap)])
    # and the wendland-c6 form of every instantiation (static facts)
    wspecs = {f"{k}:wendland-c6": v for k, v in specs.items()}
    engines += (engine_entries(wspecs, {}, passes, report, "K6", group, ncoef=20)
                + engine_entries(wspecs, {}, passes, report, "K1", group, folds=(False, True),
                                 ncoef=20))
    emit({"phase": "engines", "card": smi, "pass_windows": list(PASS_WINDOWS),
          "engines": engines, "kernel_family_seconds": fam["seconds"]})
    short = [f"{e['engine']} {e['instantiation']} fold={e['fold']}: {e['warps_per_sm']}"
             for e in engines if e["warps_per_sm"] < 16 and e["engine"] in ("K1", "K6")]
    if short:
        print("# engines below 16 resident warps per SM: " + "; ".join(short), file=sys.stderr)

    # each entry point with the launches of the path that runs it and its
    # numbers at that path's side-100 state: the list walk of every std op
    # and the mark pass on the std main path (list mode), the streaming
    # kernels on the std streaming path; the VE ops' walk on the VE path
    # (list mode), with the gradv divv/curlv and the av_clean momentum on
    # the av_clean path, their streaming forms on the VE streaming path
    where = {"density": (res, bnd, sa, "density"), "iad": (res, bnd, sa, "iad"),
             "momentum_energy_std": (res, bnd, sa, "momentum_energy_std"),
             "density_lists": (lres, lbnd, la, "density_lists"),
             "iad_lists": (lres, lbnd, la, "iad_lists"),
             "momentum_energy_std_lists": (lres, lbnd, la, "momentum_energy_std_lists"),
             "mark": (lres, lbnd, la, "mark")}
    for op in ("ve_def_gradh", "iad_divv_curlv", "av_switches", "momentum_energy_ve"):
        where[op] = (*vt["ve_streaming"], vsa, op)
        where[f"{op}_lists"] = (*vt["ve_lists"], va, f"{op}_lists")
    where["iad_divv_curlv_lists:gradv"] = (*vt["ve_avclean"], vaa, "iad_divv_curlv_lists")
    where["momentum_energy_ve_lists:av_clean"] = (*vt["ve_avclean"], vaa,
                                                  "momentum_energy_ve_lists")
    # and beside them the launches of the turb-ve path (the six VE walks,
    # K5) and of the std-cooling path (K1's std ops, CIE and evolved);
    # neither runs an av_clean form (a "name:form" entry)
    new_paths = {"turb_ve": turb_launches, "std_cooling_cie": cool_launches["cie"],
                 "std_cooling_evolved": cool_launches["evolved"],
                 **{f"inits_{c}": la for c, la in init_launches.items()}, **bdt_launches,
                 **app_launches, **tune_launches, **cost_launches}
    kernels = []
    for name, (r, b, launches, op) in where.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[op],
            "replaces": TPU_KERNEL[op], "launches": launches[op],
            "max_abs_err": r[op]["max_abs_err"], "ms": r[op]["ms"],
            "plain_ms": r[op]["plain_ms"], "bound_ms": b[op]["bound_ms"],
            "bound_by": b[op]["bound_by"], "library_ms": None,
            "launches_by_path": {p: 0 if ":" in name else la.get(op, 0)
                                 for p, la in {**new_paths, **wend_launches}.items()},
        })
    # the wendland-c6 form of each std and VE op, K1 and K6: its numbers at
    # the side-100 states (kernel_family) and its own count's launches on
    # the wendland paths (and on the others, which run sinc), each op's
    # entry on the path that runs it
    wfam = fam["wendland-c6"]
    for name in [n for n in where if ":" not in n and n != "mark"]:
        walk = name.endswith("_lists")
        std = name[:-len("_lists")] if walk else name
        std = std in STD_OPS
        at = wfam[("std_" if std else "ve_") + ("lists" if walk else "streaming")]
        path = f"wendland_{'std' if std else 've'}_{'lists' if walk else 'streaming'}"
        r, b = at[0][name], at[1][name]
        wname = f"{name}:wendland-c6"
        kernels.append({
            "name": wname, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": wend_launches[path][wname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "launches_by_path": {p: la.get(wname, 0)
                                 for p, la in {**new_paths, **wend_launches}.items()},
        })
    # K13's one-row form: the std block-dt path's due row
    kernels.append({
        "name": row["name"], "route": "cuda", "source": SOURCE["compact_class_lists"],
        "replaces": "sphexa_tpu/sph/blockdt.py:172", "launches":
        bdt_launches["blockdt_std"]["compact_row"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "launches_by_path": {p: la["compact_row"] for p, la in
                             {**bdt_launches, **pshard_launches}.items()}})
    # K13's one-row form on a rank's slab (rank 0 of the two gloo ranks on
    # this card): the sharded std block-dt path's next due row
    prow = pshard["blockdt"]["compact_row_timed"]
    kernels.append({
        "name": "compact_class_lists:row:slab", "route": "cuda",
        "source": SOURCE["compact_class_lists"], "replaces": "sphexa_tpu/sph/blockdt.py:172",
        "launches": pshard["blockdt"]["launches"]["compact_row"],
        "max_abs_err": max(c["max_abs_err"] for c in pshard["blockdt"]["compact_row"]),
        "ms": prow["ms"], "plain_ms": prow["plain_ms"], "bound_ms": prow["bound_ms"],
        "bound_by": prow["bound_by"], "library_ms": prow["library_ms"],
        "launches_by_path": {p: la.get("compact_row", 0) for p, la in pshard_launches.items()}})
    # the gravity kernels on the Evrard path: K12's times per launch, K13's
    # per solve (its two launches, pre-pass and blocks); their launches on
    # every gravity path beside (each path's counts reset just before it)
    for op in ("gravity_p2p", "compact_class_lists"):
        by_path = {p: la.get(op, 0) for p, la in path_launches.items()}
        if not all(by_path.values()):
            raise AssertionError(f"{op}: not launched on every gravity path: {by_path}")
        kernels.append({
            "name": op, "route": "cuda", "source": SOURCE[op], "replaces": TPU_KERNEL[op],
            "launches": ea[op], "max_abs_err": gres[op]["max_abs_err"],
            "ms": gres[op]["ms"], "plain_ms": gres[op]["plain_ms"],
            "bound_ms": gbnd[op]["bound_ms"], "bound_by": gbnd[op]["bound_by"],
            "library_ms": gres[op]["library_ms"],
            "launches_by_path": {**by_path, "std_cooling_evolved": cool_launches["evolved"][op],
                                 **{p: la.get(op, 0) for p, la in
                                    {**gshard_launches, **pshard_launches}.items()}},
        })
    # K1's jdata form on the sharded paths (rank 0 of the two gloo ranks on
    # this card): each op at the path's state, its launches there
    for prop, ops in (("std", STD_OPS), ("ve", ("ve_def_gradh", "iad_divv_curlv",
                                               "av_switches", "momentum_energy_ve"))):
        jd = shard[prop]["jdata"]
        for op in ops:
            kernels.append({
                "name": f"{op}:jdata", "route": "cuda", "source": SOURCE[op],
                "replaces": TPU_KERNEL[op], "launches": shard[prop]["launches"][op],
                "max_abs_err": jd[op]["max_abs_err"], "ms": jd[op]["ms"],
                "plain_ms": jd[op]["plain_ms"], "bound_ms": jd["bounds"][op]["bound_ms"],
                "bound_by": jd["bounds"][op]["bound_by"], "library_ms": None,
                "launches_by_path": {p: la.get(op, 0) for p, la in
                                     {**shard_launches, **gshard_launches,
                                      **pshard_launches, **rank_sweep}.items()}})
    # K12's jdata form on the sharded gravity path (rank 0 of the two gloo
    # ranks on this card): at the path's state, its launches there
    kj = gshard["ve"]["k12_jdata"]
    kernels.append({
        "name": "gravity_p2p:jdata", "route": "cuda", "source": SOURCE["gravity_p2p"],
        "replaces": TPU_KERNEL["gravity_p2p"],
        "launches": gshard["ve"]["launches"]["gravity_p2p"],
        "max_abs_err": kj["max_abs_err"], "ms": kj["ms"], "plain_ms": kj["plain_ms"],
        "bound_ms": kj["bound"]["bound_ms"], "bound_by": kj["bound"]["bound_by"],
        "library_ms": None,
        "launches_by_path": {p: la.get("gravity_p2p", 0) for p, la in
                             {**gshard_launches, **pshard_launches}.items()}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(f"# chip_smoke total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
