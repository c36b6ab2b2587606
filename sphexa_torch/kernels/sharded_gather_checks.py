"""Checks of the gather backend across ranks (``backend="xla"`` on a mesh),
shared by the CPU tests (gloo ranks, tests/test_torch_sharded_gather.py),
the card tests (tests/test_torch_gpu.py ``-k sharded_gather``) and
chip_smoke.py's ``sharded_gather_path`` phase. Each ``rank_*`` function
runs on one rank of ``parallel.mesh.spawn`` and returns numpy arrays and
Python numbers.

- ``slab_search``: the search of this rank's slab (the global groups that
  meet it against the gather halo, ``cell_list.search_slab``) in each
  halo mode, as global rows, with the sized neighbour config;
- ``rank_gather_fault``: one std step of ``make_sharded_step`` on an
  ``xla`` config and on the engine's config of the same state;
- ``rank_gather_suite``: the CPU suite in one spawn: the searches, the
  fault case, ``sharded_checks.run_props`` of every step run, and the
  launch counts (no kernel on this path);
- ``rank_gather_card``: the card's path: the truncating search's lists
  against the one-card ``find_neighbors`` bit for bit, then std Sedov at
  full width through ``Simulation(backend="xla", num_devices=P)``
  (``sharded_checks.props_path``: zero launches, the last step held to
  the one-card gather step), the split of a step's stages, the shipped
  rows against the engine's sparse serve at the same state.
"""

import dataclasses
import time
from typing import Dict, Sequence

import numpy as np
import torch

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.neighbors.cell_list import search_slab
from sphexa_torch.parallel import exchange as ex
from sphexa_torch.parallel import sizing
from sphexa_torch.parallel.mesh import Mesh, gather_rows, make_sharded_step, shard_state
from sphexa_torch.propagator import _force_stage_prologue, _step_hydro_std
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe

#: the halo modes of ``slab_search``: (exchange, sizing margin); "tight"
#: is the sparse exchange at margin 1, its caps the need rounded up
MODES = {"sparse": ("sparse", 1.4), "windowed": ("windowed", 1.4), "tight": ("sparse", 1.0)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sizes(kw: dict):
    """``halo_sizes``' keywords as ``gather_halo_stage``'s ``sizes``."""
    return tuple(kw["halo_cells"]) if "halo_cells" in kw else int(kw["halo_window"])


def slab_search(mesh: Mesh, flat, nbr_kw: Dict, modes: Sequence[str] = tuple(MODES)) -> dict:
    """The gather search of this rank's slab of the whole state ``flat``
    ((fields, box, const) numpy dicts), sorted and in the regrown box as
    the step sorts it, the config sized over every rank
    (``make_propagator_config(mesh=, backend="xla", **nbr_kw)``). Per halo
    mode (``MODES``): nidx as GLOBAL rows, nmask, nc, the rank's densest
    window cell and window verdict, whether any covered row escaped the
    caps, the sizes and the halo rows served. Also the config's fields
    and the slab's length."""
    state, box, const = state_from_numpy(*flat, device=mesh.device)
    slab = shard_state(state, mesh)
    cfg = make_propagator_config(slab, box, const, mesh=mesh, backend="xla", **nbr_kw)
    ss, sbox, keys, _ = _force_stage_prologue(slab, box, dataclasses.replace(cfg, mesh=mesh))
    S = ss.n
    out = {"nbr": dataclasses.asdict(cfg.nbr), "S": S}
    for mode in modes:
        kind, margin = MODES[mode]
        sizes = _sizes(sizing.halo_sizes(mesh, slab, box, cfg.nbr, kind, margin=margin,
                                         curve=cfg.curve, backend="xla"))
        st = ex.gather_halo_stage(mesh, ss.x, ss.y, ss.z, ss.h, keys, sbox, cfg.nbr, sizes)
        xyz = (ss.x, ss.y, ss.z)
        nidx, nmask, nc, _, unserved = search_slab(mesh, st.win, *xyz, ss.h,
                                                   ex.jbuf(xyz, st.serve(xyz)), st.g2l, sbox,
                                                   cfg.nbr)
        out[mode] = {"nidx": _np(nidx), "nmask": _np(nmask), "nc": _np(nc),
                     "occ": int(st.win.occ), "window_ok": bool(st.win.window_ok),
                     "escaped": bool(st.escaped | unserved), "sizes": sizes,
                     "served": int((st.g2l >= 0).sum()) - S}
    return out


def rank_gather_fault(mesh: Mesh, flat, ngmax: int) -> dict:
    """One std step of this rank's slab of ``flat`` through
    ``make_sharded_step``: on the ``xla`` config (the gather stages, the
    gather halo sized for it) and on the engine's config of the same state
    (K1's jdata form on the engine's halo, every pair within 2h). Returns
    each one's slab (x, vx, h, temp) and scalars."""
    state, box, const = state_from_numpy(*flat, device=mesh.device)
    slab = shard_state(state, mesh)
    out = {}
    for backend in ("xla", "pallas"):
        cfg = make_propagator_config(slab, box, const, ngmax=ngmax, mesh=mesh, backend=backend)
        kw = sizing.halo_sizes(mesh, slab, box, cfg.nbr, "sparse", curve=cfg.curve,
                               backend=backend)
        new, _, d = make_sharded_step(mesh, cfg, _step_hydro_std, **kw)(slab, box)
        out[backend] = {**{f: _np(getattr(new, f)) for f in ("x", "vx", "h", "temp")},
                        "diag": {k: float(v) for k, v in d.items() if v.numel() == 1},
                        "nbr": dataclasses.asdict(cfg.nbr)}
    return out


def rank_gather_suite(mesh: Mesh, search_cases: Sequence[tuple], fault_case: tuple,
                      runs: Sequence[tuple]) -> dict:
    """The CPU suite on this rank, one spawn: ``slab_search`` of each
    (flat, neighbour keywords), ``rank_gather_fault`` of (flat, ngmax),
    ``sharded_checks.run_props`` of each (flat, Simulation keywords,
    steps), and the kernel launches counted over all of it."""
    from sphexa_torch.kernels.sharded_checks import run_props

    pe.reset_launches()
    out = {"search": [slab_search(mesh, flat, kw) for flat, kw in search_cases],
           "fault": rank_gather_fault(mesh, *fault_case),
           "runs": [run_props(flat, kw, steps, mesh.device, mesh.size)
                    for flat, kw, steps in runs]}
    out["launches"] = {k: v for k, v in pe.LAUNCHES.items() if v}
    return out


def gather_split_ms(mesh: Mesh, sim, sync) -> dict:
    """The stages of one sharded gather step at ``sim``'s state, each
    timed on the host with the card synchronised (every rank runs them
    together: they hold collectives): the sort, the halo stage (the
    windows, the coverage, the layout), the first serve (x, y, z, m), the
    search and the localization. Also the rows served and the candidates
    the search streamed on this rank."""
    from sphexa_torch.propagator import _gather_stage

    cfg = sim.cfg

    def timed(fn):
        sync(mesh.device)
        t0 = time.perf_counter()
        r = fn()
        sync(mesh.device)
        return r, 1e3 * (time.perf_counter() - t0)

    (ss, box, keys, _), sort_ms = timed(lambda: _force_stage_prologue(sim.state, sim.box, cfg))
    sizes = tuple(cfg.halo_cells) if cfg.halo_cells else int(cfg.halo_window)
    xyzm = (ss.x, ss.y, ss.z, ss.m)
    st, halo_ms = timed(lambda: ex.gather_halo_stage(mesh, ss.x, ss.y, ss.z, ss.h, keys, box,
                                                     cfg.nbr, sizes))
    first, serve_ms = timed(lambda: st.serve(xyzm))
    jxyz = ex.jbuf(xyzm[:3], first[:3])
    (nidx, _, _, work, _), search_ms = timed(lambda: search_slab(
        mesh, st.win, ss.x, ss.y, ss.z, ss.h, jxyz, st.g2l, box, cfg.nbr))
    _, localize_ms = timed(lambda: ex.localize_rows(st.g2l, nidx))
    _, stage_ms = timed(lambda: _gather_stage(cfg, ss.x, ss.y, ss.z, ss.h, keys, box, xyzm))
    return {"sort": sort_ms, "halo_stage": halo_ms, "serve_xyzm": serve_ms,
            "search": search_ms, "localize": localize_ms, "stage_total": stage_ms,
            "served_rows": int((st.g2l >= 0).sum()) - ss.n, "search_candidates": float(work)}


def rank_gather_card(mesh: Mesh, side: int = 100, steps: int = 2, ngmax: int = 150,
                     trunc_side: int = 24, trunc_ngmax: int = 40) -> dict:
    """The gather backend over the ranks on the card: (a) the search of a
    jittered Sedov ``trunc_side`` trimmed so that its slabs end in partial
    groups, at ``trunc_ngmax`` (every row truncated): the ranks' lists as
    global rows, gathered to rank 0, against the one-card
    ``find_neighbors`` bit for bit; (b) std Sedov ``side``^3 at ``ngmax``
    through ``Simulation(backend="xla", num_devices=P)``, one warm-up and
    ``steps`` steps (``sharded_checks.props_path``, kind "gather": every
    launch count 0; rank 0 holds the last step to the one-card gather step
    from the gathered input), with the peak allocated memory, the split of
    a step's stages (``gather_split_ms``) and the rows the engine's sparse
    serve would ship at the same state. Returns the record."""
    from sphexa_torch.convert import state_to_numpy
    from sphexa_torch.init import init_sedov, jitter_sedov
    from sphexa_torch.kernels.sharded_checks import props_path
    from sphexa_torch.neighbors.cell_list import find_neighbors
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.propagator import _sort_by_keys
    from sphexa_torch.sfc.box import make_global_box
    from sphexa_torch.simulation import Simulation

    dev = mesh.device
    P = mesh.size

    def sync(d):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    out = {"rank": mesh.rank, "size": P, "backend": mesh.backend}
    # (a) the truncating search, global rows against the one-card search
    t0 = time.perf_counter()
    st, sb, sc = init_sedov(trunc_side, device="cpu")
    fields, b, c = state_to_numpy(st, sb, sc)
    fields = jitter_sedov(fields, trunc_side, 7)
    n = (trunc_side**3 // (64 * P)) * (64 * P) - 8 * P  # slabs end in partial groups
    fields = {k: (v[:n] if np.ndim(v) else v) for k, v in fields.items()}
    res = slab_search(mesh, (fields, b, c), {"ngmax": trunc_ngmax}, modes=("sparse",))
    got = {k: gather_rows(mesh, torch.as_tensor(res["sparse"][k], device=dev))
           for k in ("nidx", "nmask", "nc")}
    trunc = {"n": n, "slab": res["S"], "ngmax": trunc_ngmax, "sizes": res["sparse"]["sizes"],
             "served": res["sparse"]["served"]}
    if mesh.rank == 0:
        state, box, const = state_from_numpy(fields, b, c, device=dev)
        cfg = make_propagator_config(state, box, const, ngmax=trunc_ngmax, backend="xla")
        if dataclasses.asdict(cfg.nbr) != res["nbr"]:
            raise AssertionError(f"sharded gather search: config {res['nbr']} vs one card's "
                                 f"{dataclasses.asdict(cfg.nbr)}")
        gbox = make_global_box(state.x, state.y, state.z, box)
        ss, keys, _ = _sort_by_keys(state, gbox, cfg.curve)
        want = find_neighbors(ss.x, ss.y, ss.z, ss.h, keys, gbox, cfg.nbr)
        for k, w in zip(("nidx", "nmask", "nc"), want):
            if not torch.equal(got[k], w):
                raise AssertionError(f"sharded gather search side {trunc_side}: {k} differs "
                                     f"from one card's ({int((got[k] != w).sum())} entries)")
        trunc.update(bits_equal=True, truncated_rows=int((want[2] > trunc_ngmax).sum()),
                     nc_max=int(want[2].max()))
    trunc["seconds"] = time.perf_counter() - t0
    out["truncation"] = trunc
    del got, res

    # (b) the full-width path
    state, box, const = init_sedov(side, device=dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def make():
        return Simulation(state, box, const, prop="std", device=dev, num_devices=P,
                          backend="xla", ngmax=ngmax, obs_spec=ObservableSpec())

    t0 = time.perf_counter()
    sim, rec = props_path(f"sharded gather rank {mesh.rank}", mesh, make, "gather", steps)
    rec["peak_allocated_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                if dev.type == "cuda" else None)
    rec["split_ms"] = gather_split_ms(mesh, sim, sync)
    engine = make_propagator_config(sim.state, sim.box, const, mesh=mesh)
    caps = sizing.halo_sizes(mesh, sim.state, sim.box, engine.nbr, "sparse",
                             curve=engine.curve)["halo_cells"]
    rec["engine_sparse"] = {"caps": caps, "shipped_rows": sum(caps),
                            "nbr": dataclasses.asdict(engine.nbr)}
    rec["nbr"] = dataclasses.asdict(sim.cfg.nbr)
    rec["truncated_rows"] = [dd.get("n_nc_clip") for dd in rec["diags"]]
    rec["seconds"] = time.perf_counter() - t0
    out["path"] = rec
    return out
