"""Checks of the sharded steps (parallel/, the std and VE force stages on a
mesh), shared by the CPU tests (gloo ranks, the plain versions), the card
tests and chip_smoke.py's ``sharded_path`` phase. Each ``rank_*``
function runs on one rank of ``parallel.mesh.spawn`` and returns numpy
arrays and Python numbers, which the launcher hands back.

- ``rank_steps``: one sharded step per (prop, av_clean, halo mode) case
  from the same initial state, with the halo sized as the Simulation
  sizes it; the rank's slab of the result and the step's scalars;
- ``rank_exchange``: the exchange's pieces at the initial state (the
  global cell table, the coverage, the sizing's caps and window, the
  localized runs of both modes), for the exact comparison with the JAX
  package;
- ``rank_simulation``: ``Simulation(num_devices=P)`` runs, the science
  rows and the final slab;
- ``jdata_vs_plain`` (``rank_jdata`` on each rank): K1's jdata form of
  every op of a sharded force stage against its plain version on the same
  j-buffers (nc exact, the tolerances of ``checks.std_ops_vs_plain`` and
  ``ve_chain_vs_plain``);
- the gravity stage on a mesh (``rank_gravity_*``, ``p2p_jdata_*``,
  ``ewald_mesh_vs_one_device``);
- turb-ve, N-body and block time steps across ranks: ``run_props`` (one
  Simulation run, on one device or as a rank: each step's scalars and aux
  slots, the final fields, the counters; ``rank_props_suite`` with
  ``rank_folded_sort``, the folded distributed sort and the rows' return
  to their owners), and on the card
  ``props_path`` (a timed path whose last step ``props_vs_one_device``
  holds to the one-device step from the gathered input; the gather
  backend's std step too, kind "gather") with
  ``compact_row_slab`` (K13's one-row form on a rank's due masks against
  its plain version), ``rank_props_card``.
"""

import dataclasses
import time
from typing import Dict, Sequence

import numpy as np
import torch

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.kernels.checks import _close
from sphexa_torch.parallel import exchange as ex
from sphexa_torch.parallel import sizing
from sphexa_torch.parallel.mesh import Mesh, all_gather, make_sharded_step, shard_state
from sphexa_torch.propagator import (
    _force_stage_prologue, _halo_stage, _split_dvout, _step_hydro_std, _step_hydro_ve,
)
from sphexa_torch.sfc.box import make_global_box
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_ve import compute_eos_ve

#: the fields a rank returns of its slab after a step
SLAB_FIELDS = ("x", "y", "z", "h", "temp", "vx", "alpha")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def slab_start(mesh: Mesh, flat, cell_target=None):
    """This rank's slab of the whole state ``flat`` ((fields, box, const)
    numpy dicts, sphexa_torch.convert), the sharded neighbour config and
    the box. Returns (slab, box, const, cfg)."""
    state, box, const = state_from_numpy(*flat, device=mesh.device)
    slab = shard_state(state, mesh)
    cfg = make_propagator_config(slab, box, const, cell_target=cell_target, mesh=mesh)
    return slab, box, const, cfg


def rank_steps(mesh: Mesh, flat, cases: Sequence[tuple], cell_target=None,
               sizes: Dict = None) -> dict:
    """One sharded step per case (prop "std" or "ve", av_clean, halo mode)
    from the state ``flat``. ``sizes``: per mode the halo sizes to use in
    place of the sizing's (an undersized one trips the escape sentinel).
    Returns {"nbr": the config's fields, case: {the slab's SLAB_FIELDS,
    the step's scalars, the per-rank SHARD_DIAG_KEYS, the sizes}}."""
    slab, box, const, cfg = slab_start(mesh, flat, cell_target)
    out = {"nbr": dataclasses.asdict(cfg.nbr)}
    for prop, av_clean, mode in cases:
        kw = (sizes or {}).get(mode) or sizing.halo_sizes(mesh, slab, box, cfg.nbr, mode,
                                                          curve=cfg.curve)
        fn = _step_hydro_std if prop == "std" else _step_hydro_ve
        step = make_sharded_step(mesh, dataclasses.replace(cfg, av_clean=av_clean), fn, **kw)
        t0 = time.perf_counter()
        new, _, d = step(slab, box)
        res = {f: _np(getattr(new, f)) for f in SLAB_FIELDS}
        res.update({k: float(d[k]) for k in ("dt", "nc_sum", "nc_max", "occupancy", "h_max",
                                             "rho_max", "dt_limiter")})
        res.update({k: _np(d[k]) for k in ("shard_rows", "shard_occ", "shard_work",
                                           "shard_trips")})
        res["sizes"] = kw
        res["seconds"] = time.perf_counter() - t0
        out[(prop, av_clean, mode)] = res
    return out


def rank_exchange(mesh: Mesh, flat, cell_target=None) -> dict:
    """The exchange's pieces at the state ``flat`` after the step's box
    regrow and sort: the global cell table, this rank's coverage, the
    sparse caps and the window (margin 1.4, as sized), the need matrix,
    the localized runs of both modes (with their j-buffer offsets) and
    the sorted keys."""
    slab, box, const, cfg = slab_start(mesh, flat, cell_target)
    out = {"sizes": {m: sizing.halo_sizes(mesh, slab, box, cfg.nbr, m, curve=cfg.curve)
                     for m in ("sparse", "windowed")},
           "tight": sizing.halo_sizes(mesh, slab, box, cfg.nbr, "sparse", margin=1.0,
                                      curve=cfg.curve)}
    gbox = make_global_box(slab.x, slab.y, slab.z, box, mesh=mesh)
    keys = compute_sfc_keys(slab.x, slab.y, slab.z, gbox, curve=cfg.curve)
    out["need"] = _np(sizing.sparse_need_matrix(mesh, slab.x, slab.y, slab.z, slab.h, keys,
                                                gbox, ex.slab_nbr(cfg.nbr, slab.n)))
    scfg = dataclasses.replace(cfg, mesh=mesh)
    ss, box2, skeys, _ = _force_stage_prologue(slab, box, scfg)
    S = ss.n
    nbr = ex.slab_nbr(cfg.nbr, S)
    table = ex.global_cell_table(mesh, skeys, nbr.level)
    granges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, None, box2, nbr, table=table)
    out.update(keys=_np(skeys), table=_np(table), nbr=dataclasses.asdict(nbr))
    hmax = tuple(min(c, S) for c in out["sizes"]["sparse"]["halo_cells"])
    r, covered_all, esc, covered = ex.localize_ranges_sparse(mesh, granges, table, S, hmax)
    out["sparse"] = _ranges_np(r) | {"escaped": bool(esc), "covered": _np(covered),
                                     "covered_all": _np(covered_all)}
    wmax = min(out["sizes"]["windowed"]["halo_window"], S) or S
    r, bounds, esc = ex.localize_ranges(mesh, granges, S, wmax)
    out["windowed"] = _ranges_np(r) | {"escaped": bool(esc), "bounds": _np(bounds)}
    return out


def _ranges_np(r) -> dict:
    return {k: _np(getattr(r, k)) for k in ("starts", "lens", "shift_x", "shift_y", "shift_z",
                                            "ncells")}


def rank_simulation(mesh: Mesh, runs: Sequence[tuple]) -> list:
    """For each run (flat, Simulation keywords, steps): ``Simulation(
    num_devices=P, **keywords)`` from the state ``flat`` for ``steps``
    steps (``halo_margin`` among the keywords sets the halo sizing's
    starting margin: below 1 it undersizes the halo, and the first step
    trips the escape sentinel). Returns per run its science rows, the
    final slab (SLAB_FIELDS), the driver's counters, the halo shape and
    the telemetry events' kinds."""
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.telemetry import MemorySink, Telemetry

    out = []
    for flat, kw, steps in runs:
        kw = dict(kw)
        margin = kw.pop("halo_margin", None)
        state, box, const = state_from_numpy(*flat, device=mesh.device)
        sink = MemorySink()
        sim = Simulation(state, box, const, device=mesh.device, num_devices=mesh.size,
                         obs_spec=ObservableSpec(), science_rows=True,
                         telemetry=Telemetry(sinks=[sink]), **kw)
        if margin is not None:
            sim._halo_margin = margin
            sim._configure(reason="halo-margin")
        sim.run(steps)
        out.append({"rows": sim.drain_science(), "replays": sim.replays,
                    "rollbacks": sim.rollbacks, "reconfigures": sim.reconfigures,
                    "halo": sim.halo_info, "kinds": [e["kind"] for e in sink.events],
                    **{f: _np(getattr(sim.state, f)) for f in SLAB_FIELDS}})
    return out


def rank_sort(mesh: Mesh, cases: Sequence[tuple]) -> list:
    """``parallel.sort.distributed_sort`` of this rank's slab of each
    case's whole (N,) int64 keys and (N, F) float32 rows; returns each
    result, (keys, rows)."""
    from sphexa_torch.parallel.sort import distributed_sort

    out = []
    for keys, cols in cases:
        S = keys.shape[0] // mesh.size
        sl = slice(mesh.rank * S, (mesh.rank + 1) * S)
        k, c = distributed_sort(mesh, torch.as_tensor(keys[sl], device=mesh.device),
                                torch.as_tensor(cols[sl], device=mesh.device))
        out.append((_np(k), _np(c)))
    return out


def rank_jdata(mesh: Mesh, flat, cases: Sequence[tuple], cell_target=None) -> dict:
    """``jdata_vs_plain`` on this rank for each (prop, av_clean) case at
    the state ``flat``, the stage's halo sized as the Simulation sizes it
    (sparse). Returns the results by case."""
    slab, box, const, cfg = slab_start(mesh, flat, cell_target)
    kw = sizing.halo_sizes(mesh, slab, box, cfg.nbr, "sparse", curve=cfg.curve)
    out = {}
    for prop, av_clean in cases:
        fn = _step_hydro_std if prop == "std" else _step_hydro_ve
        scfg = make_sharded_step(mesh, dataclasses.replace(cfg, av_clean=av_clean), fn,
                                 **kw).cfg
        out[(prop, av_clean)] = jdata_vs_plain(f"rank {mesh.rank} {prop} av_clean {av_clean}",
                                               mesh, slab, box, scfg, prop, av_clean)
    return out


def rank_fail(mesh: Mesh, bad: int):
    """Raise on rank ``bad`` after the others entered a collective (the
    launcher must fail, not hang)."""
    if mesh.rank == bad:
        raise RuntimeError(f"rank {bad} fails")
    all_gather(mesh, torch.zeros(1))
    return mesh.rank


def gather_state(mesh: Mesh, slab):
    """Every rank's slab, concatenated in rank order: the whole state on
    every rank. For checks only: the steps never gather."""
    return dataclasses.replace(slab, **{
        f.name: all_gather(mesh, getattr(slab, f.name)).reshape(-1)
        for f in dataclasses.fields(slab) if getattr(slab, f.name).dim() == 1})


# ---------------------------------------------------------------------------
# K1's jdata form against its plain version
# ---------------------------------------------------------------------------


def jdata_vs_plain(name: str, mesh: Mesh, slab, box, cfg, prop: str, av_clean: bool = False,
                   keep: Dict = None) -> dict:
    """Every K1 launch of one sharded force stage (the ops' jdata form on
    [own slab | halo rows]) against its plain version on the same inputs,
    in the stage's order, the kernel's outputs fed forward and served as
    the stage serves them: nc exact, the tolerances of
    ``checks.std_ops_vs_plain`` (std) and ``checks.ve_chain_vs_plain``
    (VE). ``cfg``: bound to the mesh (``make_sharded_step``'s); ``slab``
    unsorted (the prologue sorts it); every rank calls it (the stage's
    collectives). ``keep`` (a dict): filled with the stage's localized
    ``ranges`` and ``fold``, and per entry point its "calls" (the kernel's
    and the plain version's call on these inputs, for timing; no
    collectives) and "fields" (its OpSpec and i-/j-fields). Returns per
    entry point {max_abs_err, ...} and "stage": the j-buffer's rows, the
    slab's, the runs' candidates and the neighbour pairs."""
    ss, box, keys, _ = _force_stage_prologue(slab, box, cfg)
    const, S = cfg.const, ss.n
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    vx, vy, vz = ss.vx, ss.vy, ss.vz
    ranges, serve, jbuf, _, _, nbr = _halo_stage(cfg, S, x, y, z, h, keys, box)
    kw = {"ranges": ranges}
    res = {}
    if keep is not None:
        keep.update(ranges=ranges, fold=pe.engine_fold(box, nbr), calls={}, fields={})

    def both(key, kern, plain, *args, fields=None, **kwargs):
        if keep is not None:
            keep["calls"][key] = (lambda: kern(*args, **kwargs), lambda: plain(*args, **kwargs))
            keep["fields"][key] = fields
        return kern(*args, **kwargs), plain(*args, **kwargs)

    def entry(key, err, **extra):
        res[key] = {"max_abs_err": err, **extra}

    if prop == "std":
        hx, hy, hz, hm = serve((x, y, z, m))
        jd = jbuf((x, y, z, m), (hx, hy, hz, hm))
        (rho, nc, _), (rho_p, nc_p, _) = both(
            "density", pe.pallas_density, pe.density_plain, x, y, z, h, m, None, box, const,
            nbr, jdata=jd, fields=(pe.DENSITY, pe.density_fields(x, y, z, h, m)[0], jd), **kw)
        _nc_equal(name, "density", nc, nc_p)
        entry("density", _close(name, "rho", rho, rho_p, 1e-5, 0.0),
              nb_pairs=int(nc_p.to(torch.int64).sum()))
        p, c = compute_eos_std(ss.temp, rho, const)
        vol = m / rho
        (hvol,) = serve((vol,))
        jd = jbuf((x, y, z, vol), (hx, hy, hz, hvol))
        (cs, _), (cs_p, _) = both(
            "iad", pe.pallas_iad, pe.iad_plain, x, y, z, h, vol, None, box, const, nbr,
            jdata=jd, fields=(pe.IAD, pe.iad_fields(x, y, z, h, vol)[0], jd), **kw)
        scale = float(cs_p[0].abs().max())
        entry("iad", max(_close(name, f"c{k}", a, b, 1e-4, 1e-5 * scale)
                         for k, (a, b) in enumerate(zip(cs, cs_p))))
        hh, hvx, hvy, hvz, hrho, hp, hc, *hcs = serve((h, vx, vy, vz, rho, p, c, *cs))
        jd = jbuf((x, y, z, h, vx, vy, vz, m, rho, p, c, *cs),
                  (hx, hy, hz, hh, hvx, hvy, hvz, hm, hrho, hp, hc, *hcs))
        margs = (x, y, z, vx, vy, vz, h, m, rho, p, c, *cs)
        out, out_p = both("momentum_energy_std", pe.pallas_momentum_energy_std,
                          pe.momentum_energy_std_plain, *margs, None, box, const, nbr, jdata=jd,
                          fields=(pe.momentum_spec(const), pe.momentum_fields(*margs)[0],
                                  pe.momentum_j_fields(*jd)), **kw)
        err = max(_close(name, nm, a, b, 1e-4, 5e-6 * (float(b.abs().max()) + 1e-12))
                  for nm, a, b in zip(("ax", "ay", "az", "du"), out[:4], out_p[:4]))
        entry("momentum_energy_std", err, min_dt_rel_err=_dt_close(name, out, out_p, 1e-5))
        res["stage"] = _stage_counts(ranges, S, jd[0].shape[0], nc_p)
        return res

    hx, hy, hz, hh, hm = serve((x, y, z, h, m))
    jd = jbuf((x, y, z, m), (hx, hy, hz, hm))
    (xm, nc, _), (xm_p, nc_p, _) = both(
        "xmass", pe.pallas_xmass, pe.xmass_plain, x, y, z, h, m, None, box, const, nbr,
        jdata=jd, fields=(pe.DENSITY, pe.density_fields(x, y, z, h, m)[0], jd), **kw)
    _nc_equal(name, "xmass", nc, nc_p)
    entry("xmass", _close(name, "xm", xm, xm_p, 1e-5, 0.0),
          nb_pairs=int(nc_p.to(torch.int64).sum()))
    (hxm,) = serve((xm,))
    jd = jbuf((x, y, z, m, xm), (hx, hy, hz, hm, hxm))
    ((kx, gradh), _), ((kx_p, gradh_p), _) = both(
        "ve_def_gradh", pe.pallas_ve_def_gradh, pe.ve_def_gradh_plain, x, y, z, h, m, xm, None,
        box, const, nbr, jdata=jd,
        fields=(pe.VE_DEF_GRADH, pe.ve_def_gradh_fields(x, y, z, h, m, xm)[0], jd), **kw)
    entry("ve_def_gradh", max(_close(name, "kx", kx, kx_p, 1e-5, 0.0),
                              _close(name, "gradh", gradh, gradh_p, 5e-4, 1e-5)))
    prho, c, _, _ = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
    hkx, hprho, hc, hvx, hvy, hvz = serve((kx, prho, c, vx, vy, vz))
    cs, _ = pe.pallas_iad(x, y, z, h, xm / kx, None, box, const, nbr,
                          jdata=jbuf((x, y, z, xm / kx), (hx, hy, hz, hxm / hkx)), **kw)
    jd = jbuf((x, y, z, xm, vx, vy, vz), (hx, hy, hz, hxm, hvx, hvy, hvz))
    dspec = pe.IAD_DIVV_CURLV_GRADV if av_clean else pe.IAD_DIVV_CURLV
    (dv, _), (dv_p, _) = both(
        "iad_divv_curlv", pe.pallas_iad_divv_curlv, pe.iad_divv_curlv_plain, x, y, z, vx, vy,
        vz, h, kx, xm, *cs, None, box, const, nbr, with_gradv=av_clean, jdata=jd,
        fields=(dspec, pe.divv_curlv_fields(x, y, z, vx, vy, vz, h, kx, xm, *cs, const)[0], jd),
        **kw)
    scale = float(dv_p[0].abs().max())
    entry("iad_divv_curlv", max(_close(name, f"divv/curlv output {k}", a, b, 1e-4, 1e-5 * scale)
                                for k, (a, b) in enumerate(zip(dv, dv_p))))
    divv, _, gradv = _split_dvout(dv, av_clean)
    (hdivv,) = serve((divv,))
    jd = jbuf((x, y, z, c, vx, vy, vz, xm / kx, divv),
              (hx, hy, hz, hc, hvx, hvy, hvz, hxm / hkx, hdivv))
    aargs = (x, y, z, vx, vy, vz, h, c, kx, xm, divv, ss.alpha, *cs)
    (alpha, _), (alpha_p, _) = both(
        "av_switches", pe.pallas_av_switches, pe.av_switches_plain, *aargs, None, box, ss.min_dt,
        const, nbr, jdata=jd,
        fields=(pe.AV_SWITCHES, pe.av_switches_fields(*aargs, const)[0], jd), **kw)
    entry("av_switches", _close(name, "alpha", alpha, alpha_p, 1e-4, 1e-6))
    gv = tuple(gradv or ())
    halpha, *rest = serve((alpha, *cs) + gv)
    jd = jbuf((x, y, z, h, vx, vy, vz, c, alpha, m, xm, kx, prho, *cs) + gv,
              (hx, hy, hz, hh, hvx, hvy, hvz, hc, halpha, hm, hxm, hkx, hprho, *rest))
    margs = (x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha, *cs)
    out, out_p = both(
        "momentum_energy_ve", pe.pallas_momentum_energy_ve, pe.momentum_energy_ve_plain, *margs,
        None, box, const, nbr, nc=nc, gradv=gradv, jdata=jd,
        fields=(pe.momentum_ve_spec(const, av_clean),
                pe.momentum_ve_fields(*margs, nc=nc, gradv=gradv)[0],
                pe.momentum_ve_j_fields(*jd)), **kw)
    err = max(_close(name, nm, a, b, 2e-4, 1e-5 * float(b.abs().max()))
              for nm, a, b in zip(("ax", "ay", "az", "du"), out[:4], out_p[:4]))
    entry("momentum_energy_ve", err, min_dt_rel_err=_dt_close(name, out, out_p, 1e-4))
    res["stage"] = _stage_counts(ranges, S, jd[0].shape[0], nc_p)
    return res


def _nc_equal(name: str, op: str, nc, nc_p) -> None:
    if not torch.equal(nc, nc_p):
        raise AssertionError(f"{name}: {op} nc differs at {int((nc != nc_p).sum())} targets")


def _dt_close(name: str, out, out_p, rel: float) -> float:
    dk, dp = float(out[4]), float(out_p[4])
    if abs(dk - dp) > rel * abs(dp):
        raise AssertionError(f"{name}: min dt {dk} vs plain {dp}")
    return abs(dk - dp) / abs(dp)


def _stage_counts(ranges, S: int, nj: int, nc) -> dict:
    return {"slab_rows": S, "jbuf_rows": nj, "w3": int(ranges.starts.shape[1]),
            "candidates": int(ranges.lens.to(torch.int64).sum()),
            "nb_pairs": int(nc.to(torch.int64).sum())}


# ---------------------------------------------------------------------------
# self-gravity across ranks
# ---------------------------------------------------------------------------

#: the slab fields a gravity step's rank returns
GRAV_SLAB_FIELDS = SLAB_FIELDS + ("vy", "vz", "du")


def _box_from(b: dict, device):
    from sphexa_torch.sfc.box import BoundaryType, Box

    return Box(lo=torch.as_tensor(np.array(b["lo"], np.float32), device=device),
               hi=torch.as_tensor(np.array(b["hi"], np.float32), device=device),
               boundaries=tuple(BoundaryType(int(v)) for v in b["boundaries"]))


def gravity_slab(mesh: Mesh, setup: dict):
    """This rank's slab of a sorted gravity setup: ``setup`` holds the
    whole sorted arrays (x, y, z, m, h float32, keys int64), the box dict
    and the leaf array (uint64). Returns ((x, y, z, m, h), keys, box, tree,
    meta) on the rank's device."""
    from sphexa_torch.gravity.tree import linkage_from_leaves

    dev = mesh.device
    S = setup["x"].shape[0] // mesh.size
    sl = slice(mesh.rank * S, (mesh.rank + 1) * S)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a[sl]), device=dev)

    xyzmh = tuple(t(setup[f]) for f in ("x", "y", "z", "m", "h"))
    tree, meta = linkage_from_leaves(np.asarray(setup["leaf"], np.uint64), device=dev)
    return xyzmh, t(setup["keys"]), _box_from(setup["box"], dev), tree, meta


def _mps_from(mps_np, dev):
    """Multipoles given as numpy (node_mass, node_com, node_q, edges)."""
    return tuple(torch.as_tensor(np.asarray(a), device=dev) for a in mps_np[:3]) + \
        (torch.as_tensor(np.asarray(mps_np[3], np.int64), device=dev),)


def rank_gravity_sizing(mesh: Mesh, setup: dict, flat, theta: float, cfg_fields: dict,
                        given_mps=None, shifts=None) -> dict:
    """The sharded gravity's replicated pieces on this rank: the tree from
    its unsorted slab of ``flat``'s keys (the histograms summed over the
    ranks) and the one-device tree; the sharded upsweep of its sorted slab
    (``setup``), quadrupole and spherical order 4; and on ``given_mps``
    (the same multipoles for every rank and the reference) the need
    matrix, ``device_gravity_halo`` open and over ``shifts``, and
    ``estimate_gravity_caps(let_shards=P)`` of the GravityConfig fields
    ``cfg_fields``."""
    from sphexa_torch.gravity.traversal import (
        GRAV_BUCKET, GravityConfig, compute_multipoles_sharded, estimate_gravity_caps,
    )

    (x, y, z, m, h), keys, box, tree, meta = gravity_slab(mesh, setup)
    dev = mesh.device
    state, sbox, _ = state_from_numpy(*flat, device=dev)
    slab = shard_state(state, mesh)
    gbox = make_global_box(slab.x, slab.y, slab.z, sbox, mesh=mesh)
    skeys = compute_sfc_keys(slab.x, slab.y, slab.z, gbox)
    out = {"leaf_mesh": sizing.leaf_array_from_device_keys(skeys, GRAV_BUCKET, mesh=mesh),
           "leaf_one": sizing.leaf_array_from_device_keys(
               compute_sfc_keys(state.x, state.y, state.z, gbox), GRAV_BUCKET)}
    for order in (0, 4):
        mps = compute_multipoles_sharded(mesh, x, y, z, m, keys, tree, meta, order=order)
        out[f"upsweep{order}"] = [_np(a) for a in mps]
    mps = _mps_from(given_mps, dev)
    out["need"] = _np(sizing.gravity_need_matrix(mesh, x, y, z, m, keys, box, tree, meta,
                                                 theta, multipoles=mps))
    out["cells"] = sizing.device_gravity_halo(mesh, x, y, z, m, keys, box, tree, meta, theta,
                                              multipoles=mps)
    out["cells_tight"] = sizing.device_gravity_halo(mesh, x, y, z, m, keys, box, tree, meta,
                                                    theta, margin=1.0, quantum=1,
                                                    multipoles=mps)
    if shifts is not None:
        sh = torch.as_tensor(np.asarray(shifts, np.float32), device=dev)
        out["cells_ewald"] = sizing.device_gravity_halo(mesh, x, y, z, m, keys, box, tree,
                                                        meta, theta, shifts=sh,
                                                        multipoles=mps)
    caps = estimate_gravity_caps(x, y, z, m, keys, box, tree, meta, GravityConfig(**cfg_fields),
                                 multipoles=mps, let_shards=mesh.size, mesh=mesh)
    out["caps"] = dataclasses.asdict(caps)
    return out


def sharded_solve(mesh: Mesh, xyzmh, keys, box, tree, meta, cfg, win, ewald=None):
    """One sharded gravity solve on this rank's slab (the propagator's
    stage without its closing reduction): open (any multipole order) or
    Ewald. Returns (ax, ay, az, egrav summed over the ranks in rank order,
    the diagnostics reduced by max)."""
    from sphexa_torch.gravity.ewald import compute_gravity_ewald
    from sphexa_torch.gravity.traversal import compute_gravity, compute_multipoles_sharded
    from sphexa_torch.parallel.mesh import reduce_scalars

    x, y, z, m, h = xyzmh
    if ewald is not None:
        ax, ay, az, egrav, d = compute_gravity_ewald(x, y, z, m, h, keys, box, tree, meta, cfg,
                                                     ewald, shard=(mesh, win))
    else:
        mps = compute_multipoles_sharded(mesh, x, y, z, m, keys, tree, meta,
                                         order=cfg.multipole_order)
        ax, ay, az, egrav, d = compute_gravity(x, y, z, m, h, keys, box, tree, meta, cfg,
                                               multipoles=mps, shard=(mesh, win))
    names = sorted(d)
    (egrav,), maxes, _ = reduce_scalars(mesh, sums=[egrav], maxes=[d[k] for k in names])
    return ax, ay, az, egrav, dict(zip(names, maxes))


def rank_gravity_solves(mesh: Mesh, setup: dict, cfg_fields: dict, cases: Sequence[tuple],
                        shifts=None) -> dict:
    """Sharded solves of the sorted ``setup`` per case (name, GravityConfig
    overrides, "open" or "ewald", "sparse" or "slabs"): the sparse caps
    from ``device_gravity_halo`` (over ``shifts`` for Ewald), else whole
    slabs; the overrides may ask for ``let_cap`` "sized"
    (``estimate_gravity_caps(let_shards=P)``) or "all" (every node).
    Returns per case the slab's ax, ay, az, egrav and the diagnostics."""
    from sphexa_torch.gravity.ewald import EwaldConfig
    from sphexa_torch.gravity.traversal import GravityConfig, estimate_gravity_caps

    xyzmh, keys, box, tree, meta = gravity_slab(mesh, setup)
    S = xyzmh[0].shape[0]
    base = GravityConfig(**cfg_fields)
    out = {}
    for name, over, kind, mode in cases:
        over = dict(over)
        let = over.pop("let_cap", None)
        cfg = dataclasses.replace(base, **over)
        if let == "sized":
            cfg = dataclasses.replace(cfg, let_cap=estimate_gravity_caps(
                *xyzmh[:4], keys, box, tree, meta, cfg, let_shards=mesh.size, mesh=mesh,
                margin=2.0).let_cap)
        elif let == "all":
            cfg = dataclasses.replace(cfg, let_cap=meta.num_nodes)
        win = S
        if mode == "sparse":
            sh = None
            if kind == "ewald":
                sh = torch.as_tensor(np.asarray(shifts, np.float32), device=mesh.device)
            win = sizing.device_gravity_halo(mesh, *xyzmh[:4], keys, box, tree, meta, cfg.theta,
                                             shifts=sh)
        ax, ay, az, egrav, d = sharded_solve(mesh, xyzmh, keys, box, tree, meta, cfg, win,
                                             ewald=EwaldConfig() if kind == "ewald" else None)
        out[name] = {"ax": _np(ax), "ay": _np(ay), "az": _np(az), "egrav": float(egrav),
                     "diag": {k: float(v) for k, v in d.items()}, "win": win,
                     "cfg": dataclasses.asdict(cfg)}
    return out


def rank_gravity_steps(mesh: Mesh, runs: Sequence[tuple]) -> list:
    """For each run (flat, Simulation keywords, steps[, chem]): one
    ``Simulation(num_devices=P)`` from the state ``flat`` (``grav_margin``
    among the keywords sets the gravity serve's starting margin: far
    below 1 it undersizes the caps and the first step trips the escape
    sentinel), ``steps`` checked steps. Returns per run the slab
    (GRAV_SLAB_FIELDS), the last step's scalars, the driver's counters, the
    caps and exchange shapes, the chemistry's ``hi`` where there is one,
    and the telemetry's exchange events."""
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.telemetry import MemorySink, Telemetry

    out = []
    for flat, kw, steps in runs:
        kw = dict(kw)
        margin = kw.pop("grav_margin", None)
        state, box, const = state_from_numpy(*flat, device=mesh.device)
        sink = MemorySink()
        sim = Simulation(state, box, const, device=mesh.device, num_devices=mesh.size,
                         obs_spec=ObservableSpec(), telemetry=Telemetry(sinks=[sink]), **kw)
        if margin is not None:
            sim._grav_halo_margin = margin
            sim._configure(reason="grav-margin")
        cells0 = sim.cfg.grav_cells
        t0 = time.perf_counter()
        for _ in range(steps):
            d = sim.step()
        res = {f: _np(getattr(sim.state, f)) for f in GRAV_SLAB_FIELDS}
        res.update(diag={k: v for k, v in d.items()}, replays=sim.replays,
                   reconfigures=sim.reconfigures,
                   gravity=sim.cfg.gravity and dataclasses.asdict(sim.cfg.gravity),
                   grav_cells0=cells0, grav_cells=sim.cfg.grav_cells,
                   grav_halo=sim.grav_halo_info, halo=sim.halo_info,
                   trips=int(sim.telemetry.counters.get("grav_halo_trips", 0)),
                   exchanges=[e for e in sink.events if e["kind"] == "exchange"],
                   seconds=time.perf_counter() - t0)
        if sim.chem is not None:
            res["chem_hi"] = _np(sim.chem.hi)
        out.append(res)
    return out


def rank_gravity_solve_groups(mesh: Mesh, groups: Sequence[tuple]) -> dict:
    """``rank_gravity_solves`` of each (setup, cfg_fields, cases, shifts)."""
    out = {}
    for setup, cfg_fields, cases, shifts in groups:
        out.update(rank_gravity_solves(mesh, setup, cfg_fields, cases, shifts=shifts))
    return out


def rank_grav_sentinel(mesh: Mesh, flat, caps: Sequence[int], runs=()) -> dict:
    """One VE step with self-gravity through ``make_sharded_step`` with the
    gravity serve's caps forced to ``caps`` (undersized: the near field's
    runs escape and ``p2p_max`` turns the cap + 1 sentinel); then
    ``rank_gravity_steps`` of ``runs``. Returns {"forced": the step's
    p2p_max, cap and per-rank rows, "runs": the runs' results}."""
    from sphexa_torch.propagator import _step_hydro_ve
    from sphexa_torch.simulation import Simulation

    state, box, const = state_from_numpy(*flat, device=mesh.device)
    sim = Simulation(state, box, const, prop="ve", device=mesh.device, num_devices=mesh.size)
    step = make_sharded_step(mesh, dataclasses.replace(sim.cfg, mesh=None), _step_hydro_ve,
                             halo_cells=sim.cfg.halo_cells, grav_cells=caps)
    _, _, d = step(sim.state, sim.box, sim.gtree)
    forced = {"p2p_max": int(d["p2p_max"]), "p2p_cap": sim.cfg.gravity.p2p_cap,
              "gshard_rows": _np(d["gshard_rows"])}
    return {"forced": forced, "runs": rank_gravity_steps(mesh, runs)}


def p2p_jdata_case(mesh: Mesh, xyzmh, keys, box, tree, meta, cfg, win, shift=None,
                   allow_self: bool = False):
    """The near field's inputs of one sharded solve pass on this rank, as
    ``compute_gravity`` builds them: the classification's leaf ranges
    localized into the j-buffer the halo serve fills. Returns (the
    targets x y z m h led by the blocks' lead rows, starts, lens,
    j-buffer)."""
    from sphexa_torch.gravity import traversal as gt

    x, y, z, m, h = xyzmh
    mps = gt.compute_multipoles_sharded(mesh, x, y, z, m, keys, tree, meta,
                                        order=cfg.multipole_order)
    sh = None if shift is None else torch.as_tensor(shift, dtype=x.dtype, device=x.device)
    lists = gt.classify(x, y, z, box, tree, meta, cfg, mps[0], mps[1], shift=sh, let=True,
                        mesh=mesh)
    start, length = gt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], tree, mps[3],
                                        meta.num_nodes)
    starts, lens, jd, _, _ = gt._near_field_halo((mesh, win), x, y, z, m, h, mps[3], start,
                                                 length, lists["lead"])
    return gt._lead_rows(xyzmh, lists["lead"]), starts, lens, jd


def p2p_jdata_vs_plain(name: str, xyzmh, cfg, starts, lens, jdata, groups=None, shift=None,
                       allow_self: bool = False) -> dict:
    """K12's jdata form on a rank's j-buffer against its plain version on
    the same inputs (``checks.p2p_vs_plain``: rtol 1e-4, atol P2P_ATOL
    max|.|)."""
    from sphexa_torch.kernels.checks import p2p_vs_plain

    return p2p_vs_plain(name, *xyzmh, cfg, starts, lens, groups=groups, shift=shift,
                        allow_self=allow_self, jdata=jdata)


def rank_p2p_jdata(mesh: Mesh, flat, groups: int = 0) -> dict:
    """K12's jdata form on this rank's j-buffer against its plain version:
    the VE Simulation's gravity config at the state ``flat`` (the sparse
    gravity serve), the slab sorted as the step sorts it, the near field's
    localized ranges and served j-buffer (``p2p_jdata_case``), without
    and with an image shift and the self pair. ``groups`` > 0: compare
    that many target blocks, evenly spread (the plain version's cost)."""
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.kernels.checks import IMAGE_SHIFT

    state, box, const = state_from_numpy(*flat, device=mesh.device)
    sim = Simulation(state, box, const, prop="ve", device=mesh.device, num_devices=mesh.size)
    ss, sbox, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    cfg = dataclasses.replace(sim.cfg.gravity, G=const.g)
    xyzmh = (ss.x, ss.y, ss.z, ss.m, ss.h)
    win = tuple(min(c, ss.n) for c in sim.cfg.grav_cells) or ss.n
    out = {"win": win}
    for name, shift, allow_self in (("open", None, False), ("image", IMAGE_SHIFT, True)):
        tg, starts, lens, jd = p2p_jdata_case(mesh, xyzmh, keys, sbox, sim.gtree,
                                              sim.cfg.grav_meta, cfg, win, shift=shift,
                                              allow_self=allow_self)
        sel = None
        if groups:
            sel = torch.linspace(0, lens.shape[0] - 1, groups, device=lens.device).round().long()
        out[name] = p2p_jdata_vs_plain(f"rank {mesh.rank} {name}", tg, cfg, starts, lens, jd,
                                       groups=sel, shift=shift, allow_self=allow_self)
        out[name]["halo_rows"] = int(jd[0].shape[0] - tg[0].shape[0])
    return out


def ewald_mesh_vs_one_device(mesh: Mesh, n: int = 4096, seed: int = 3) -> dict:
    """The sharded Ewald solve (sparse serve over the replica shifts) on
    ``checks.periodic_random_case`` against the one-device solve of the
    same sorted particles, tree and config on this rank's device (the
    forces of a lattice cancel, so Sedov is no check of Ewald): ax within
    rtol 1e-2 and atol 2e-3 max|a|, egrav within rel 1e-4 (the rank-ordered
    leaf sums may flip a node at the MAC margin), K12 27 times."""
    from sphexa_torch.gravity.ewald import compute_gravity_ewald, replica_shells
    from sphexa_torch.kernels.checks import periodic_random_case
    from sphexa_torch.simulation import Simulation

    sim = Simulation(*periodic_random_case(n, seed, mesh.device), prop="nbody",
                     device=mesh.device)
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    cfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g)
    tree, meta, ecfg = sim.gtree, sim.cfg.grav_meta, sim.cfg.ewald
    one = compute_gravity_ewald(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, tree, meta, cfg, ecfg)
    S = n // mesh.size
    sl = slice(mesh.rank * S, (mesh.rank + 1) * S)
    xyzmh = tuple(a[sl].contiguous() for a in (ss.x, ss.y, ss.z, ss.m, ss.h))
    skeys = keys[sl].contiguous()
    shifts = torch.as_tensor(replica_shells(ecfg), device=mesh.device) * box.lengths[0]
    win = sizing.device_gravity_halo(mesh, *xyzmh[:4], skeys, box, tree, meta, cfg.theta,
                                     shifts=shifts)
    before = pe.LAUNCHES["gravity_p2p"]
    ax, ay, az, egrav, d = sharded_solve(mesh, xyzmh, skeys, box, tree, meta, cfg, win,
                                         ewald=ecfg)
    launches = pe.LAUNCHES["gravity_p2p"] - before
    scale = float(one[0].abs().max())
    err = 0.0
    for nm, a, b in zip(("ax", "ay", "az"), (ax, ay, az), one[:3]):
        torch.testing.assert_close(a, b[sl], rtol=1e-2, atol=2e-3 * scale,
                                   msg=f"rank {mesh.rank}: sharded Ewald {nm}")
        err = max(err, float((a - b[sl]).abs().max()) / scale)
    e1 = float(one[3])
    if abs(float(egrav) - e1) > 1e-4 * abs(e1):
        raise AssertionError(f"rank {mesh.rank}: sharded Ewald egrav {float(egrav)} vs {e1}")
    if mesh.device.type == "cuda" and launches != 27:
        raise AssertionError(f"rank {mesh.rank}: {launches} K12 launches in an Ewald solve")
    return {"n": n, "win": win, "max_abs_err_over_scale": err,
            "egrav_rel_err": abs(float(egrav) - e1) / abs(e1), "k12_launches": launches,
            "diag": {k: float(v) for k, v in d.items()}}


# ---------------------------------------------------------------------------
# turb-ve, N-body and block time steps across ranks
# ---------------------------------------------------------------------------

#: the BlockDtState's fields as a run returns them
BDT_FIELDS = ("bins", "dt_prev", "substep", "cycle", "dt_min")


def _aux_np(sim) -> dict:
    """The carry's aux slots as numpy: the BlockDtState (this rank's slab
    of its per-particle fields) and the stirring's key and phases."""
    out = {}
    if sim.bdt_state is not None:
        out["bdt"] = {f: _np(getattr(sim.bdt_state, f)) for f in BDT_FIELDS}
    if sim.turb_state is not None:
        out["turb"] = {"key": np.asarray(sim.turb_state.key, np.uint32).copy(),
                       "phases": _np(sim.turb_state.phases)}
    return out


def run_props(flat, kw: Dict, steps: int, device, num_devices=None) -> dict:
    """``Simulation(**kw)`` from the whole state ``flat`` ((fields, box,
    const) numpy dicts) with the science ledger, on one device or as a
    rank of ``num_devices``, ``steps`` steps (``check_every`` among the
    keywords defers them; the run is flushed at its end). ``halo_margin``
    and ``grav_margin`` among the keywords set the SPH or gravity serve's
    starting margin: below 1 they undersize it, and the first step trips
    its escape sentinel. Returns each step's scalars and aux slots
    (``_aux_np``), the final fields (this rank's rows), the science rows,
    the Simulation's counters, the exchange shapes and the telemetry events'
    kinds and stages."""
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.telemetry import MemorySink, Telemetry

    kw = dict(kw)
    margins = {"_halo_margin": kw.pop("halo_margin", None),
               "_grav_halo_margin": kw.pop("grav_margin", None)}
    state, box, const = state_from_numpy(*flat, device=device)
    sink = MemorySink()
    sim = Simulation(state, box, const, device=device, num_devices=num_devices,
                     use_lists=False, obs_spec=ObservableSpec(), science_rows=True,
                     telemetry=Telemetry(sinks=[sink]), **kw)
    if any(v is not None for v in margins.values()):
        for k, v in margins.items():
            if v is not None:
                setattr(sim, k, v)
        sim._configure(reason="margin")
    per_step = []
    t0 = time.perf_counter()
    for _ in range(steps):
        d = sim.step()
        per_step.append({"diag": dict(d), **_aux_np(sim)})
    sim.flush()
    return {"steps": per_step, **_aux_np(sim), "rows": sim.drain_science(),
            "fields": {f.name: _np(getattr(sim.state, f.name))
                       for f in dataclasses.fields(sim.state)
                       if getattr(sim.state, f.name).dim() == 1},
            "replays": sim.replays, "rollbacks": sim.rollbacks,
            "reconfigures": sim.reconfigures, "halo": sim.halo_info,
            "grav_halo": sim.grav_halo_info, "halo_cells": sim.cfg.halo_cells,
            "halo_window": sim.cfg.halo_window,
            "bdt_counters": (sim.bdt_updates, sim.bdt_updates_full, sim.bdt_resorts,
                             sim.bdt_keeps),
            "events": [(e["kind"], e.get("stage")) for e in sink.events],
            "seconds": time.perf_counter() - t0}


def rank_folded_sort(mesh: Mesh, cases: Sequence[tuple]) -> list:
    """For each case (keys (N,) int64 30-bit, bins (N,) int32, cols (N, F)
    float32), this rank's slab of: the sort of the folded keys over 32
    bits with the bins and each row's global index riding as bit columns
    (``sort_slabs``), the rows sent back to their owners (``to_owners``),
    and the 30-bit ``distributed_sort`` of the spatial keys."""
    from sphexa_torch.parallel.sort import distributed_sort, sort_slabs, to_owners
    from sphexa_torch.sph.blockdt import FOLD_BITS, fold_bin_key

    out = []
    for keys, bins, cols in cases:
        S = keys.shape[0] // mesh.size
        sl = slice(mesh.rank * S, (mesh.rank + 1) * S)
        k, b, c = (torch.as_tensor(np.ascontiguousarray(a[sl]), device=mesh.device)
                   for a in (keys, bins, cols))
        gidx = mesh.rank * S + torch.arange(S, dtype=torch.int64, device=mesh.device)
        r = sort_slabs(mesh, fold_bin_key(k, b), c, key_bits=30 + FOLD_BITS, extra=[b, gidx])
        back = to_owners(mesh, r.rows, r.extra[1], r)
        sk, sc_ = distributed_sort(mesh, k, c)
        out.append({"folded": _np(r.keys), "rows": _np(r.rows), "bins": _np(r.extra[0]),
                    "gidx": _np(r.extra[1]), "back": _np(back), "spatial": _np(sk),
                    "spatial_rows": _np(sc_)})
    return out


def one_device_step(sim, prev, prev_box, prev_aux):
    """The one-device step of ``sim``'s propagator from a gathered state
    ``prev`` and aux (the stirring state, or the gathered BlockDtState), on
    this rank's device, with ``sim``'s tree and static sizes. Returns (the
    new SimState, diagnostics)."""
    from sphexa_torch.propagator import STEP_AUX_SLOT, step_sim_state
    from sphexa_torch.state import SimState

    cfg1 = dataclasses.replace(sim.cfg, mesh=None, halo_cells=(), halo_window=0,
                               grav_cells=())
    slot = STEP_AUX_SLOT.get(sim._step_fn)
    carry = SimState(particles=prev, box=prev_box, **({slot: prev_aux} if slot else {}))
    return step_sim_state(sim._step_fn, carry, cfg1, sim.gtree, sim._aux_cfg)


#: the tolerances of a sharded step against the one-device step of the same
#: input on the card, by propagator: (field, rtol, atol, atol as a share of
#: the field's max|.|) (chip_smoke's sharded_path; N-body's the JAX mesh
#: test's rtol, its atol scaled to the field: the ranks classify the
#: one-device target blocks)
CARD_TOL = {"turb-ve": (("vx", 1e-4, 1e-6, 0.0), ("x", 1e-5, 1e-7, 0.0)),
            "nbody": (("vx", 5e-4, 0.0, 1e-3),),
            "blockdt": (("x", 1e-5, 1e-7, 0.0), ("temp", 1e-4, 0.0, 0.0)),
            "gather": (("x", 2e-4, 0.0, 5e-6), ("vx", 2e-4, 0.0, 5e-6),
                       ("temp", 2e-4, 0.0, 5e-6))}

#: the gather step's integer diagnostics, equal to one device's
GATHER_EXACT = ("nc_sum", "nc_max", "occupancy", "n_nc_clip")


def props_vs_one_device(name: str, kind: str, new, new_aux, d: Dict, one) -> dict:
    """A sharded step's gathered slabs ``new`` (and aux, gathered) and its
    scalars ``d`` against the one-device step ``one`` ((SimState,
    diagnostics), ``one_device_step``) of the same input: ``CARD_TOL``'s
    fields; dt within 1e-5; turb-ve the key equal and the OU phases within
    rtol 1e-6, atol 1e-9; N-body egrav within 1e-4; the block time steps'
    bins, substep and dt_min (float32) equal, the active count,
    populations, work, inversions and resort decision equal; the gather
    step (std on the gather backend: tests/test_torch_gather_slice.py's
    field tolerances) h bit for bit (its nc are one device's) and
    GATHER_EXACT equal. Raises past a tolerance; returns the errors."""
    s1, d1 = one
    out = {"dt_rel_err": abs(d["dt"] - float(d1["dt"])) / float(d1["dt"])}
    for f, rtol, atol, atol_rel in CARD_TOL[kind]:
        a, b = getattr(new, f), getattr(s1.particles, f)
        atol = atol + atol_rel * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=f"{name}: {f}")
        out[f"{f}_max_abs_err"] = float((a - b).abs().max())
        out[f"{f}_scale"] = float(b.abs().max())
    if out["dt_rel_err"] > 1e-5:
        raise AssertionError(f"{name}: dt {d['dt']} vs {float(d1['dt'])}")
    if kind == "turb-ve":
        if not np.array_equal(np.asarray(new_aux.key), np.asarray(s1.turb.key)):
            raise AssertionError(f"{name}: the stirring key left the one-device chain")
        torch.testing.assert_close(new_aux.phases, s1.turb.phases, rtol=1e-6, atol=1e-9,
                                   msg=f"{name}: OU phases")
        out["phases_max_abs_err"] = float((new_aux.phases - s1.turb.phases).abs().max())
    if kind == "nbody":
        e1 = float(d1["egrav"])
        out["egrav_rel_err"] = abs(d["egrav"] - e1) / abs(e1)
        if out["egrav_rel_err"] > 1e-4:
            raise AssertionError(f"{name}: egrav {d['egrav']} vs {e1}")
    if kind == "blockdt":
        b1 = s1.bdt
        if not (torch.equal(new_aux.bins, b1.bins) and int(new_aux.substep) == int(b1.substep)
                and float(new_aux.dt_min) == float(b1.dt_min)):
            raise AssertionError(f"{name}: bins, substep or dt_min differ from one device's")
        for k in ("bdt_active", "bdt_work", "bdt_drift", "bdt_resort", "bdt_substep"):
            if d[k] != float(d1[k]):
                raise AssertionError(f"{name}: {k} {d[k]} vs {float(d1[k])}")
        pop = d1["bdt_pop"].tolist()
        if [d[f"bdt_pop[{k}]"] for k in range(len(pop))] != [float(p) for p in pop]:
            raise AssertionError(f"{name}: bin populations differ from one device's")
        out.update(active=d["bdt_active"], drift=d["bdt_drift"], resort=d["bdt_resort"])
    if kind == "gather":
        if not torch.equal(new.h, s1.particles.h):
            raise AssertionError(f"{name}: h differs from the one-device gather step's")
        for k in GATHER_EXACT:
            if d[k] != float(d1[k]):
                raise AssertionError(f"{name}: {k} {d[k]} vs {float(d1[k])}")
        out.update(h_equal=True, **{k: d[k] for k in GATHER_EXACT})
    return out


def compact_row_slab(name: str, mesh: Mesh, bst, nbins: int) -> list:
    """K13's one-row form on this rank's due masks against its plain
    version, exact (``checks.compact_row_vs_plain``): the next substep's
    mask (from the BlockDtState slab) and the cycle's last one, where
    every bin is due. Returns each check's result with its mask."""
    from sphexa_torch.kernels.checks import compact_row_vs_plain
    from sphexa_torch.sph.blockdt import cycle_length, due_mask

    out = []
    for sub in (bst.substep, torch.full_like(bst.substep, cycle_length(nbins) - 1)):
        due = due_mask(bst.bins, sub)
        res = compact_row_vs_plain(f"{name} rank {mesh.rank} substep {int(sub)}", due)
        out.append(({**res, "substep": int(sub)}, due))
    return out


def rank_props_suite(mesh: Mesh, runs: Sequence[tuple], sort_cases: Sequence[tuple]) -> dict:
    """``run_props`` on this rank of each (flat, keywords, steps) of
    ``runs`` and ``rank_folded_sort`` of ``sort_cases``, in one spawn of
    the ranks."""
    return {"runs": [run_props(flat, kw, steps, mesh.device, mesh.size)
                     for flat, kw, steps in runs],
            "sort": rank_folded_sort(mesh, sort_cases)}


def gather_aux(mesh: Mesh, sim):
    """The carry's aux slot of ``sim``'s propagator, whole on every rank:
    the BlockDtState's slabs gathered (``gather_state``), the replicated
    stirring state as it is; None without one. For checks only."""
    if sim.bdt_state is not None:
        return gather_state(mesh, sim.bdt_state)
    return sim.turb_state


def props_path(name: str, mesh: Mesh, make_sim, kind: str, steps: int, check: bool = True):
    """One sharded path on this rank: ``make_sim()`` (a
    ``Simulation(num_devices=P)``), one warm-up step, then ``steps``
    steps, each timed on the host with the card synchronised, the launch
    counts reset just before them and read just after; the slabs and the
    aux gathered (for the check only) before the last step and after it,
    and with ``check`` rank 0 holds the last step to the one-device step
    from the gathered input (``props_vs_one_device``, ``kind`` "turb-ve",
    "nbody" or "blockdt"). Returns (the Simulation, its record)."""
    from sphexa_torch.sph import pair_engine as pe

    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    sim = make_sim()
    rec = {"configure_s": time.perf_counter() - t0}
    sim.step()  # warm-up
    pe.reset_launches()
    replays0 = sim.replays
    ms, diags = [], []
    for i in range(steps):
        if i == steps - 1:
            prev, prev_box = gather_state(mesh, sim.state), sim.box
            prev_aux = gather_aux(mesh, sim)
        sync()
        t1 = time.perf_counter()
        diags.append(sim.step())
        sync()
        ms.append(1e3 * (time.perf_counter() - t1))
    launches = dict(pe.LAUNCHES)
    attempts = steps + sim.replays - replays0
    new, new_aux = gather_state(mesh, sim.state), gather_aux(mesh, sim)
    d = diags[-1]
    P = mesh.size
    rec.update(step_ms=ms, launches=launches, attempts=attempts, n=new.n, slab=sim.state.n,
               halo=sim.halo_info, grav_halo=sim.grav_halo_info, dt=d["dt"],
               replays=sim.replays, energy_drift=sim.energy_drift,
               diags=[{k: v for k, v in dd.items()
                       if k.startswith(("bdt_", "egrav", "dt", "n_nc_clip"))}
                      for dd in diags])
    for key in ("shard_rows", "shard_occ", "gshard_rows", "gshard_occ"):
        if f"{key}[0]" in d:
            rec[key] = [d[f"{key}[{k}]"] for k in range(P)]
    if check and mesh.rank == 0:
        one = one_device_step(sim, prev, prev_box, prev_aux)
        rec["vs_one_device"] = props_vs_one_device(name, kind, new, new_aux, d, one)
        del one
    del prev, prev_aux, new, new_aux
    all_gather(mesh, torch.zeros(1, device=dev))  # rank 0's check before the next path
    return sim, rec


#: the small cases of ``rank_props_card``: (name, init, side, the case's
#: settings, keywords, kind, steps); the block time steps from a
#: Courant-limited start, where the bins differ
CARD_PROP_CASES = (("turb-ve", "sedov", 16, None,
                    {"prop": "turb-ve", "turb_settings": {"stMaxModes": 200}}, "turb-ve", 2),
                   ("nbody", "evrard", 16, None, {"prop": "nbody"}, "nbody", 2),
                   ("blockdt", "sedov", 16, {"minDt": 1e-3, "minDt_m1": 1e-3},
                    {"prop": "std", "dt_bins": 4, "bin_resort_drift": 0.01}, "blockdt", 8))


def rank_props_card(mesh: Mesh, cases=CARD_PROP_CASES) -> dict:
    """``props_path`` of each case on this rank (the Simulation from the
    case's init, trimmed to a multiple of P rows), and on the block time
    steps' path K13's one-row form on this rank's due mask against its
    plain version (``compact_row_slab``). Returns the records by name."""
    from sphexa_torch.init import CASES
    from sphexa_torch.simulation import Simulation

    out = {}
    for name, init, side, settings, kw, kind, steps in cases:
        state, box, const = CASES[init](side, device=mesh.device,
                                        **({"overrides": settings} if settings else {}))
        n = state.n // mesh.size * mesh.size
        state = dataclasses.replace(state, **{f.name: getattr(state, f.name)[:n]
                                              for f in dataclasses.fields(state)
                                              if getattr(state, f.name).dim() == 1})

        def make(state=state, box=box, const=const, kw=kw):
            return Simulation(state, box, const, device=mesh.device, num_devices=mesh.size,
                              **kw)

        sim, rec = props_path(f"{name} rank {mesh.rank}", mesh, make, kind, steps)
        if kind == "blockdt":
            rec["compact_row"] = [r for r, _ in compact_row_slab(name, mesh, sim.bdt_state,
                                                                 kw["dt_bins"])]
        out[name] = rec
    return out
