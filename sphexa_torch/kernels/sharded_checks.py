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
  ``ve_chain_vs_plain``).
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
    localized into the j-buffer the halo serve fills. Returns (starts,
    lens, j-buffer)."""
    from sphexa_torch.gravity import traversal as gt

    x, y, z, m, h = xyzmh
    mps = gt.compute_multipoles_sharded(mesh, x, y, z, m, keys, tree, meta,
                                        order=cfg.multipole_order)
    sh = None if shift is None else torch.as_tensor(shift, dtype=x.dtype, device=x.device)
    lists = gt.classify(x, y, z, box, tree, meta, cfg, mps[0], mps[1], shift=sh, let=True)
    start, length = gt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], tree, mps[3],
                                        meta.num_nodes)
    starts, lens, jd, _, _ = gt._near_field_halo((mesh, win), x, y, z, m, h, mps[3], start,
                                                 length)
    return starts, lens, jd


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
        starts, lens, jd = p2p_jdata_case(mesh, xyzmh, keys, sbox, sim.gtree, sim.cfg.grav_meta,
                                          cfg, win, shift=shift, allow_self=allow_self)
        sel = None
        if groups:
            sel = torch.linspace(0, lens.shape[0] - 1, groups, device=lens.device).round().long()
        out[name] = p2p_jdata_vs_plain(f"rank {mesh.rank} {name}", xyzmh, cfg, starts, lens, jd,
                                       groups=sel, shift=shift, allow_self=allow_self)
        out[name]["halo_rows"] = int(jd[0].shape[0] - ss.n)
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
