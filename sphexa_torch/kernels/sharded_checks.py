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
