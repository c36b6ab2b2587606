#!/usr/bin/env python3
"""The std main path's list rebuild split into its parts, on one NVIDIA
card, for the ``sphexa_torch`` of a checkout (default: this one).

    python3 scripts/torch_rebuild_split.py [ROOT] [--steps N]

Sedov 100^3 std runs N steps (default 14, the state chip_smoke.py's
phase 8 reads) through ``Simulation`` in list mode; then the rebuild of
that state is timed by CUDA events in its parts (median of 5, after a
warm-up), as the checkout builds its lists:

- the fused list build (K5 takes the culled cells and writes finished
  lists): the checkout's ``chip_smoke.rebuild_split`` (sort, cull, K5,
  words, the whole, the plain composition), and ``build_alone``, K5's
  entry point launched back to back with the arguments built once;
- the composition before it (``pair_lists.mark_kernel``): the box regrow
  with the keys, argsort and row gather (``sort``), the culled window
  cells (``cull``), the run merge (``merge``), the mark kernel (``mark``,
  one call, and ``mark_alone``), the prune with the gathers after it
  (``prune``), the word offsets with the mask-word buffer and its host
  sync (``words``), the whole rebuild and the plain composition
  (``plain``: merge, the plain mark pass, prune, gathers).

Run it on a `git archive` of another commit to compare that commit's
rebuild with this tree's chip_smoke.py ``rebuild`` phase in one call.
Prints one JSON line with the card's name and power limit."""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys


def event_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(launch, n: int = 50) -> float:
    """Mean device time of ``n`` launches back to back (one warm-up)."""
    import torch

    launch()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def composition_split(sim) -> dict:
    """The parts of a rebuild whose list build is merge -> mark kernel ->
    prune -> gathers."""
    import torch

    from sphexa_torch.kernels.build import load_library
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

    def merged_runs():
        s, ln, sh, nruns = pe._merge_runs(*cull, nbr.run_cap, nbr.gap)
        i32 = torch.int32
        return pe.GroupRanges(s.to(i32).contiguous(), ln.to(i32).contiguous(),
                              *(a.contiguous() for a in sh), nruns.to(i32).contiguous(),
                              None, None)

    def prune(runs, bits, cnt):
        perm = pl._prune_empty_chunks(runs, cnt, scap)[1]
        return cnt.gather(1, perm), bits.gather(1, perm[:, :, None].expand(-1, -1, 4))

    def plain():
        runs = merged_runs()
        bits, cnt, _ = pl.mark_plain(runs, x, y, z, h, skin, scap, nbr.group)
        return prune(runs, bits, cnt)

    def words():
        off = pe.mask_word_offsets(lists.cnt)
        return torch.empty(int(off[-1]) * nbr.group, dtype=torch.int32, device=x.device)

    runs = merged_runs()
    margs = (runs, x, y, z, h, skin, scap, nbr.group)
    bits, cnt, total = pl.mark_kernel(*margs)
    args = pl.MarkArgs()
    for nm in ("starts", "lens", "shift_x", "shift_y", "shift_z", "ncells"):
        setattr(args, nm, getattr(runs, nm).data_ptr())
    for nm, a in (("x", x), ("y", y), ("z", z), ("h", h), ("skin", skin),
                  ("bits", bits), ("cnt", cnt), ("total", total)):
        setattr(args, nm, a.data_ptr())
    args.n, args.num_groups, args.w3 = x.shape[0], *runs.starts.shape
    args.group, args.slot_cap = nbr.group, scap
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    return {"sort": event_ms(lambda: _sort_by_keys(st, make_global_box(x, y, z, box),
                                                   cfg.curve)),
            "cull": event_ms(lambda: pe.window_cells_culled(x, y, z, h, keys, box, nbr,
                                                            radius_pad=skin)),
            "merge": event_ms(lambda: pe._merge_runs(*cull, nbr.run_cap, nbr.gap)),
            "mark": event_ms(lambda: pl.mark_kernel(*margs)),
            "mark_alone": loop_ms(lambda: lib.launch_mark(ctypes.addressof(args), stream)),
            "prune": event_ms(lambda: prune(runs, bits, cnt)),
            "words": event_ms(words),
            "whole": event_ms(lambda: rebuild_pair_lists(st, box, cfg)),
            "plain": event_ms(plain, reps=3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=14)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_rebuild_split: no CUDA device", file=sys.stderr)
        return 2
    from sphexa_torch.init import init_sedov
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.sph import pair_lists as pl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    sim = Simulation(*init_sedov(100, device="cuda"), prop="std", device="cuda")
    for _ in range(args.steps):
        sim.step()
    if sim.lists is None:
        raise AssertionError("the std main path streamed: no persistent lists")
    if hasattr(pl, "build_lists_kernel"):
        import chip_smoke  # the checkout's own
        from sphexa_torch.propagator import rebuild_pair_lists
        from sphexa_torch.sfc.keys import compute_sfc_keys
        from sphexa_torch.sph import pair_engine as pe

        design, res = "fused", chip_smoke.rebuild_split(sim)
        st, box, lists = rebuild_pair_lists(sim.state, sim.box, sim.cfg)
        keys = compute_sfc_keys(st.x, st.y, st.z, box, curve=sim.cfg.curve)
        cull = pe.window_cells_culled(st.x, st.y, st.z, st.h, keys, box, sim.cfg.nbr,
                                      radius_pad=lists.skin)[:4]
        res["build_alone"] = loop_ms(pl.build_lists_launcher(
            cull, st.x, st.y, st.z, st.h, lists.skin, sim.cfg.list_slot_cap, sim.cfg.nbr)[0])
    else:
        design, res = "composition", composition_split(sim)
    print(json.dumps({"phase": "rebuild_split", "root": root, "design": design, "card": smi,
                      "steps": args.steps, "rebuilds": sim.rebuilds, "ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
