"""The comparison that decides ``correct``: one step of the program
against one step of the reference from the same input state.

The program's output may come in another order than its input (the
port sorts its particles), so its rows are matched to the input rows by
identity first: each output row's position less its displacement
(x - x_m1, minimum image) must lie within 1e-3 h of exactly one input
particle, and each input particle must be so claimed once. Every number
then compares matched rows (``readings``), and ``judge`` holds each to
its limit in ``limits/<config>.json``."""

import importlib
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import inits
from benchmark.reference import common as cm
from benchmark.reference.gravity import make_gravity
from benchmark.reference.neighbors import find_pairs

STATE = ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz", "h", "m", "temp",
         "temp_lo", "du", "du_m1", "alpha", "ttot", "min_dt", "min_dt_m1")
#: rows of the gravity sample, and the rows the acceleration dt is sought in
GRAV_SAMPLE = 8192
GRAV_TOP = 1024
#: an output row's identity tolerance, in units of its h
MATCH_TOL = 1e-3


def _box(box0: dict, *pos_sets):
    """(lo, length, periodic): the configuration's box along periodic
    dims, else the extent of every finite position given (a little
    wider)."""
    lo, length = [], []
    for d in range(3):
        if box0["periodic"][d]:
            lo.append(float(box0["lo"][d]))
            length.append(float(box0["hi"][d]) - float(box0["lo"][d]))
        else:
            fin = [p[np.isfinite(p).all(1)] for p in pos_sets]
            a = min(float(p[:, d].min()) for p in fin if len(p))
            b = max(float(p[:, d].max()) for p in fin if len(p))
            pad = 1e-6 * max(1.0, b - a)
            lo.append(a - pad)
            length.append(b - a + 2 * pad)
    return lo, length, [bool(p) for p in box0["periodic"]]


def match_rows(out_pos, out_disp, out_h, in_pos, box) -> tuple:
    """The input row of each output row (-1 where the identity fails) and
    the count of rows, on either side, without exactly one partner."""
    lo, length, periodic = box
    back = out_pos - out_disp
    k, i = find_pairs(back, MATCH_TOL * out_h, in_pos, lo, length, periodic,
                      exclude_self=False)
    n_out, n_in = out_pos.shape[0], in_pos.shape[0]
    ck = torch.bincount(k, minlength=n_out)
    ci = torch.bincount(i, minlength=n_in)
    good = (ck[k] == 1) & (ci[i] == 1)
    src = torch.full((n_out,), -1, dtype=torch.long, device=out_pos.device)
    src[k[good]] = i[good]
    unmatched = int((ck != 1).sum()) + int((ci != 1).sum())
    return src, unmatched


def _rel_max(err, scale, ok=None):
    """max |err| / rms(scale) over the rows ``ok`` (default: where the
    scale is finite); a non-finite error there reads inf, as does an
    empty set of rows."""
    ok = torch.isfinite(scale) if ok is None else ok
    if not bool(ok.any()):
        return float("inf")
    s = torch.sqrt(torch.mean(scale[ok] ** 2))
    e = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))[ok]
    return float(torch.max(torch.abs(e)) / s) if s > 0 else float(torch.max(torch.abs(e)))


def _row_max(err, scale):
    """max over rows of |err| / scale, a non-finite quotient reading inf
    (and an empty set of rows 0: nothing to compare)."""
    if not err.numel():
        return 0.0
    rel = torch.abs(err) / scale
    return float(torch.max(torch.where(torch.isfinite(rel), rel,
                                       torch.full_like(rel, float("inf")))))


def _kinetic(m, v):
    """Per row: 0.5 m |v|^2, m v and m |v|."""
    return (0.5 * m * (v * v).sum(1), m[:, None] * v,
            m * torch.linalg.vector_norm(v, dim=1))


def reference_step(prev: Dict[str, np.ndarray], cfg: dict, box0: dict, seed: int, device,
                   dtype=torch.float64, extra_pos=(), grav_rows=None):
    """The reference's step from the input state ``prev`` (numpy), in
    ``dtype``. Returns (input tensors, new state, force fields, gravity
    info, box, the gravity sample rows)."""
    c = cm.constants(cfg)
    st = {k: torch.as_tensor(np.asarray(prev[k]), device=device).to(dtype) for k in STATE}
    pin = np.stack([prev["x"], prev["y"], prev["z"]], 1).astype(np.float64)
    lo, length, periodic = _box(box0, pin, *extra_pos)
    n = st["x"].shape[0]
    g = inits.rng(seed, "reference")
    k = min(GRAV_SAMPLE, n)
    sample = torch.as_tensor(np.sort(g.choice(n, size=k, replace=False)), device=device)
    gravity, ginfo = (None, {})
    if c["g"] != 0.0:
        gravity, ginfo = make_gravity(st, c, sample, GRAV_TOP, rows=grav_rows)
    prop = importlib.import_module(f"benchmark.reference.{cfg['prop']}")
    geo = cm.Geometry(st, lo, length, periodic)
    boxd = {"lo": lo, "length": length, "periodic": periodic}
    new, f = prop.step(st, geo, c, boxd, gravity)
    return st, new, f, ginfo, (lo, length, periodic), sample, geo


def readings(prev: Dict[str, np.ndarray], out: Dict[str, np.ndarray], row: Optional[dict],
             cfg: dict, box0: dict, seed: int, device, control: bool = False
             ) -> Dict[str, float]:
    """The numbers compared for one step. ``out`` is the program's output
    state (numpy) and ``row`` the ledger's row of that step; with
    ``control`` the program's place is taken by the reference in
    bfloat16 (``out`` and ``row`` are ignored)."""
    f64 = torch.float64
    out_pos = None
    if not control:
        out_pos = np.stack([out["x"], out["y"], out["z"]], 1).astype(np.float64)
        back = out_pos - np.stack([out["x_m1"], out["y_m1"], out["z_m1"]], 1)
    st, new, f, ginfo, box, sample, geo = reference_step(
        prev, cfg, box0, seed, device, extra_pos=() if control else (out_pos, back))
    c = cm.constants(cfg)
    n = st["x"].shape[0]
    if control:
        # with gravity the control has it on every row, so that its
        # ledger sums over all of them as the program's does
        cst, cnew, cf, cginfo, _, _, cgeo = reference_step(
            prev, cfg, box0, seed, device, dtype=torch.bfloat16,
            grav_rows=torch.arange(n, device=device) if ginfo else None)
        p = {k: v.to(f64) if torch.is_tensor(v) and v.dim() else v for k, v in cnew.items()}
        p["temp_lo"] = torch.zeros(n, dtype=f64, device=device)
        p["m"] = cst["m"].to(f64)
        cons_p = cm.conserved(cnew, cst["m"], c["cv"], cf["egrav"])
        dt_p = float(cf["dt"])
    else:
        p = {k: torch.as_tensor(np.asarray(out[k]), device=device).to(f64) for k in STATE}
        cons_p = row
        dt_p = float(out["min_dt"])
    pos_in = torch.stack([st["x"], st["y"], st["z"]], 1)
    ppos = torch.stack([p["x"], p["y"], p["z"]], 1)
    pdisp = torch.stack([p["x_m1"], p["y_m1"], p["z_m1"]], 1)
    src, unmatched = match_rows(ppos, pdisp, p["h"], pos_in, box)
    if control:
        src = torch.arange(n, device=device)  # the control keeps the input order
    rows_out = torch.nonzero(src >= 0).squeeze(1)
    rows_in = src[rows_out]
    q = {k: v[rows_out] for k, v in p.items() if torch.is_tensor(v) and v.dim()}
    r = {k: v[rows_in] for k, v in new.items() if torch.is_tensor(v) and v.dim()}
    fr = {k: v[rows_in] for k, v in f.items() if torch.is_tensor(v) and v.dim() and
          v.shape[0] == n}
    si = {k: v[rows_in] for k, v in st.items() if v.dim()}
    out_r: Dict[str, float] = {"unmatched": float(unmatched)}

    nc_p = cm.count_from_h(q["h"], si["h"], c["ng0"])
    nc_r = geo.nc[rows_in]
    out_r["nc_mismatch"] = float((nc_p != nc_r).double().mean())
    dt_r = float(f["dt"])
    out_r["dt_gap"] = abs(dt_p - dt_r) / dt_r
    # displacement and velocity where the reference has the acceleration:
    # with gravity, on the uniform sample, each gap over the sample's rms
    # (the acceleration dt's extra rows have accelerations far above it),
    # and on those extra rows, each gap over that row's own scale
    r_all = r
    if ginfo:
        ins = torch.isin(rows_in, sample)
        r = {k: torch.where(ins, v, float("nan")) if v.is_floating_point() else v
             for k, v in r.items()}
    dr = torch.stack([r["x_m1"], r["y_m1"], r["z_m1"]], 1)
    dp = torch.stack([q["x_m1"], q["y_m1"], q["z_m1"]], 1)
    out_r["x_gap"] = _rel_max(torch.linalg.vector_norm(dp - dr, dim=1),
                              torch.linalg.vector_norm(dr, dim=1))
    delta_a = dt_r + 0.5 * float(st["min_dt"])
    a_r = torch.stack([fr["ax"], fr["ay"], fr["az"]], 1)
    vr = torch.stack([r["vx"], r["vy"], r["vz"]], 1)
    vp = torch.stack([q["vx"], q["vy"], q["vz"]], 1)
    kick = torch.linalg.vector_norm(a_r, dim=1) * delta_a
    verr = torch.linalg.vector_norm(vp - vr, dim=1)
    ok = torch.isfinite(kick) & torch.isfinite(vr).all(1)
    out_r["v_gap"] = _rel_max(verr, kick, ok)
    if ginfo:
        top = torch.isin(rows_in, ginfo["rows"]) & ~ins
        dr_t = torch.stack([r_all["x_m1"], r_all["y_m1"], r_all["z_m1"]], 1)[top]
        vr_t = torch.stack([r_all["vx"], r_all["vy"], r_all["vz"]], 1)[top]
        out_r["x_gap_top"] = _row_max(torch.linalg.vector_norm(dp[top] - dr_t, dim=1),
                                      torch.linalg.vector_norm(dr_t, dim=1))
        out_r["v_gap_top"] = _row_max(torch.linalg.vector_norm(vp[top] - vr_t, dim=1),
                                      torch.linalg.vector_norm(a_r[top], dim=1) * delta_a)
    out_r["du_gap"] = _rel_max(q["du"] - r["du"], r["du"])
    out_r["temp_gap"] = _rel_max(q["temp"] + q["temp_lo"] - r["temp"], r["temp"] - si["temp"])
    if cfg["prop"] == "ve":
        out_r["alpha_gap"] = _rel_max(q["alpha"] - r["alpha"], r["alpha"])
    # the ledger's sums against the reference's
    cons_r = cm.conserved(new, st["m"], c["cv"], f["egrav"]) if c["g"] == 0.0 else None
    if cons_p is not None:
        if cons_r is not None:
            for k in ("ecin", "eint", "etot"):
                out_r[f"{k}_gap"] = abs(cons_p[k] - cons_r[k]) / abs(cons_r[k])
            out_r["linmom_gap"] = abs(cons_p["linmom"] - cons_r["linmom"]) / cons_r["mv_abs"]
            # in a periodic box the angular momentum turns on how a particle
            # at the edge is wrapped, which float32 and float64 decide apart
            out_r["angmom_gap"] = abs(cons_p["angmom"] - cons_r["angmom"]) / cons_r["rmv_abs"]
        else:
            # with gravity the reference has accelerations on its rows
            # only. The internal energy has none in it. The kinetic sums
            # are the program's own over every row plus N times the mean
            # gap to the reference's on the uniform sample (a survey's
            # difference estimator: unbiased, and its noise is that of
            # the rows' gaps, not of their spread)
            eint_r = float(torch.sum(c["cv"] * new["temp"] * st["m"]))
            out_r["eint_gap"] = abs(cons_p["eint"] - eint_r) / abs(eint_r)
            out_r["egrav_gap"] = abs(cons_p["egrav"] - f["egrav"]) / abs(f["egrav"])
            vp_all = torch.stack([p["vx"], p["vy"], p["vz"]], 1)
            w = n / float(ins.sum())
            sums = [a.sum(0) + w * (b - bp).sum(0) for a, b, bp in zip(
                _kinetic(p["m"], vp_all), _kinetic(si["m"][ins], vr[ins]),
                _kinetic(q["m"][ins], vp[ins]))]
            ecin_r, mv_abs = float(sums[0]), float(sums[2])
            etot_r = ecin_r + eint_r + float(f["egrav"])
            out_r["ecin_gap"] = abs(cons_p["ecin"] - ecin_r) / abs(ecin_r)
            out_r["etot_gap"] = abs(cons_p["etot"] - etot_r) / abs(etot_r)
            out_r["linmom_gap"] = abs(cons_p["linmom"] - float(
                torch.linalg.vector_norm(sums[1]))) / mv_abs
    if ginfo:
        # the program's gravity: its acceleration (from its velocity
        # update, with its dt) less the reference's hydro part, on the
        # uniform sample
        dap = dt_p + 0.5 * float(st["min_dt"])
        val = torch.stack([si["x_m1"], si["y_m1"], si["z_m1"]], 1) / float(st["min_dt"])
        a_tot_p = (vp[ins] - val[ins]) / dap
        a_h = torch.stack([fr["ax"] - ginfo["gx"][rows_in], fr["ay"] - ginfo["gy"][rows_in],
                           fr["az"] - ginfo["gz"][rows_in]], 1)[ins]
        g_r = torch.stack([ginfo["gx"], ginfo["gy"], ginfo["gz"]], 1)[rows_in][ins]
        rel = torch.linalg.vector_norm(a_tot_p - a_h - g_r, dim=1) / \
            torch.linalg.vector_norm(g_r, dim=1)
        rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, float("inf")))
        out_r["grav_gap"] = float(torch.median(rel)) if rel.numel() else float("inf")
        out_r["grav_gap99"] = float(torch.quantile(rel, 0.99)) if rel.numel() else float("inf")
        out_r["egrav_stderr"] = ginfo["egrav_stderr"] / abs(f["egrav"])
    out_r["pairs"] = float(geo.i.shape[0])
    out_r["sym_pairs"] = float(_sym_pairs(geo, st["h"]))
    return out_r


def _sym_pairs(geo: cm.Geometry, h) -> int:
    """Pairs with |r_ij| < 2 min(h_i, h_j) (the momentum ops' pairs)."""
    n = 0
    for sl in geo.chunks():
        i, j, _, d = geo.sep(sl)
        n += int((d < 2.0 * h[j]).sum())
    return n


def pair_counts(state: Dict[str, np.ndarray], cfg: dict, box0: dict, device) -> Dict[str, float]:
    """The interacting pairs of a state: |r_ij| < 2 h_i, and those with
    |r_ij| < 2 h_j as well (the momentum ops' pairs)."""
    st = {k: torch.as_tensor(np.asarray(state[k]), device=device).double()
          for k in ("x", "y", "z", "h")}
    pin = np.stack([state["x"], state["y"], state["z"]], 1).astype(np.float64)
    lo, length, periodic = _box(box0, pin)
    geo = cm.Geometry(st, lo, length, periodic)
    return {"pairs": float(geo.i.shape[0]), "sym_pairs": float(_sym_pairs(geo, st["h"]))}



def judge(rd: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, [(name, reading, limit)]): every number with a limit at or
    under it (a NaN reads as a failure); a limit with no reading fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = rd.get(name, float("nan"))
        good = v == v and v <= lim
        ok &= good
        rows.append((name, v, lim))
    return ok, rows
