"""Kernel-vs-plain checks that chip_smoke.py and tests/test_torch_gpu.py
share: one contract, stated once, with the JAX package's tolerances.

``ve_chain_vs_plain`` runs the VE ops' chain (xmass over the density
kernel, grad-h, EOS, IAD, divv/curlv, AV switches, momentum/energy) on a
sorted state on the card, each op's wrapper against its plain version on
the kernel chain's inputs; with ``lists`` the list-mode forms the JAX
dispatch picks. ``compact_vs_plain`` and ``compact_random_cases`` hold
the gravity list compaction (K13) to its plain version exactly,
``p2p_vs_plain`` the gravity near field (K12) on a solve's leaf ranges
(``near_field_ranges``) within its summation-order tolerance, and
``gravity_vs_cpu`` a whole gravity solve on the card to the same solve on
the CPU, ``ewald_vs_cpu`` a periodic (Ewald) one on
``periodic_random_case``. ``list_build_vs_plain`` holds the list build (K5) to its plain
version bit for bit, on a list state's culled cells or on
``synthetic_cull``'s cells, which exercise each edge of the run merge.
``std_ops_vs_plain`` holds the std ops (density, IAD, momentum), streaming
or list walk, to their plain versions, and ``family_vs_plain`` runs it and
the VE chain with another kernel family (wendland-c6's 20-coefficient
form, or a sinc index). ``compact_row_cases`` holds K13's one-row form
(the block time steps' due rows) to its plain version exactly, and
``blockdt_vs_cpu`` block-time-step substeps on the card to the same
substeps on the CPU. Any disagreement raises."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from sphexa_torch.convert import blockdt_to_numpy, state_from_numpy, state_to_numpy
from sphexa_torch.gravity import pallas_compact as pcmp
from sphexa_torch.gravity import traversal as gt
from sphexa_torch.init import init_sedov, stretch_box
from sphexa_torch.neighbors.cell_list import NeighborConfig
from sphexa_torch.sfc.box import BoundaryType
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph import pair_lists as pl
from sphexa_torch.sph import blockdt as bdt
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_ve import compute_eos_ve


#: K12's tolerance, atol over max|.| (rtol 1e-4, the JAX package's): the
#: near field sums thousands of cancelling float32 terms per target, and
#: two summation orders (the kernel's sequential loop, the plain version's
#: atomic adds on the card) differ by up to 6.5e-6 of max|.| (Evrard 125 on
#: an H100; 3.5e-6 at Evrard 20): three times that, while a wrong body
#: term moves the sums by far more
P2P_ATOL = 2e-5


def _close(name: str, what: str, a, b, rtol: float, atol: float) -> float:
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=f"{name}: {what}")
    return float((a - b).abs().max())


def ve_chain_vs_plain(name: str, ss, box, const, nbr, av_clean: bool, keys=None,
                      ranges=None, lists=None):
    """Each VE op's wrapper against its plain version, with the JAX
    package's streaming tolerances (tests/test_pallas_interpret.py): nc
    exact; xm and kx rtol 1e-5; grad-h rtol 5e-4 / atol 1e-5; divv/curlv
    (and gradv) rtol 1e-4 / atol 1e-5 max|divv|; alpha rtol 1e-4 / atol
    1e-6; a and du rtol 2e-4 / atol 1e-5 max|.|; min dt rel 1e-4.

    Returns (results, chain): per-entry-point results keyed as in
    ``pe.LAUNCHES`` (the ``_lists`` entry points with ``lists``; "xmass"
    for the density kernel's VE use) with each max abs error, and the
    kernel chain's tensors (xm, nc, kx, gradh, prho, c, cs, dv, alpha,
    gradv) for callers that time or count the ops. In list mode the ops run
    as the VE force stage runs them: the xmass walk keeps its mask and the
    walks after it read it (``pe.engine_lists_kernel``'s mask modes)."""
    kw = {"ranges": ranges, "lists": lists, "mask": "read"}
    sfx = "_lists" if lists is not None else ""
    x, y, z, h, m, vel = ss.x, ss.y, ss.z, ss.h, ss.m, (ss.vx, ss.vy, ss.vz)

    res = {}
    wr = {**kw, "mask": "write"}
    xm, nc, _ = pe.pallas_xmass(x, y, z, h, m, keys, box, const, nbr, **wr)
    xm_p, nc_p, _ = pe.xmass_plain(x, y, z, h, m, keys, box, const, nbr, **wr)
    if not torch.equal(nc, nc_p):
        raise AssertionError(f"{name}: xmass nc differs at {int((nc != nc_p).sum())} targets")
    res["xmass"] = {"max_abs_err": _close(name, "xm", xm, xm_p, 1e-5, 0.0),
                    "nb_pairs": int(nc_p.to(torch.int64).sum())}
    (kx, gradh), _ = pe.pallas_ve_def_gradh(x, y, z, h, m, xm, keys, box, const, nbr, **kw)
    (kx_p, gradh_p), _ = pe.ve_def_gradh_plain(x, y, z, h, m, xm, keys, box, const, nbr,
                                               **kw)
    res["ve_def_gradh" + sfx] = {"max_abs_err": max(
        _close(name, "kx", kx, kx_p, 1e-5, 0.0),
        _close(name, "gradh", gradh, gradh_p, 5e-4, 1e-5))}
    prho, c, _, _ = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
    cs, _ = pe.pallas_iad(x, y, z, h, xm / kx, keys, box, const, nbr, **kw)
    dargs = (x, y, z, *vel, h, kx, xm, *cs, keys, box, const, nbr)
    dv, _ = pe.pallas_iad_divv_curlv(*dargs, with_gradv=av_clean, **kw)
    dv_p, _ = pe.iad_divv_curlv_plain(*dargs, with_gradv=av_clean, **kw)
    scale = float(dv_p[0].abs().max())
    res["iad_divv_curlv" + sfx] = {"max_abs_err": max(
        _close(name, f"divv/curlv output {k}", a, b, 1e-4, 1e-5 * scale)
        for k, (a, b) in enumerate(zip(dv, dv_p)))}
    aargs = (x, y, z, *vel, h, c, kx, xm, dv[0], ss.alpha, *cs, keys, box, ss.min_dt,
             const, nbr)
    alpha, _ = pe.pallas_av_switches(*aargs, **kw)
    res["av_switches" + sfx] = {"max_abs_err": _close(name, "alpha", alpha,
                                       pe.av_switches_plain(*aargs, **kw)[0], 1e-4, 1e-6)}
    margs = (x, y, z, *vel, h, m, prho, c, kx, xm, alpha, *cs, keys, box, const, nbr)
    gradv = tuple(dv[2:]) if av_clean else None
    out = pe.pallas_momentum_energy_ve(*margs, nc=nc, gradv=gradv, **kw)
    out_p = pe.momentum_energy_ve_plain(*margs, nc=nc, gradv=gradv, **kw)
    err = max(_close(name, nm, a, b, 2e-4, 1e-5 * float(b.abs().max()))
              for nm, a, b in zip(("ax", "ay", "az", "du"), out[:4], out_p[:4]))
    dk, dp = float(out[4]), float(out_p[4])
    if abs(dk - dp) > 1e-4 * abs(dp):
        raise AssertionError(f"{name}: VE min dt {dk} vs plain {dp}")
    res["momentum_energy_ve" + sfx] = {"max_abs_err": err, "min_dt_rel_err": abs(dk - dp) / abs(dp)}
    chain = SimpleNamespace(xm=xm, nc=nc, kx=kx, gradh=gradh, prho=prho, c=c, cs=cs,
                            dv=dv, alpha=alpha, gradv=gradv)
    return res, chain


def std_ops_vs_plain(name: str, ss, box, const, nbr, keys=None, ranges=None,
                     lists=None) -> dict:
    """The std ops' wrappers (density, IAD, momentum/energy) against their
    plain versions on the kernel chain's inputs, with the JAX package's
    tolerances (tests/test_pallas_interpret.py): nc exact; rho rtol 1e-5;
    IAD rtol 1e-4 / atol 1e-5 max|c11|; a and du rtol 1e-4 / atol 5e-6
    max|.|; min dt rel 1e-5. With ``lists`` the list walks, as the force
    stage runs them (density keeps its mask, the others read it). Returns
    per-entry-point results keyed as in ``pe.LAUNCHES``."""
    kw = {"ranges": ranges, "lists": lists}
    sfx = "_lists" if lists is not None else ""
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    res = {}
    rho, nc, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, mask="write", **kw)
    rho_p, nc_p, _ = pe.density_plain(x, y, z, h, m, keys, box, const, nbr, **kw)
    if not torch.equal(nc, nc_p):
        raise AssertionError(f"{name}: density nc differs at {int((nc != nc_p).sum())} targets")
    res["density" + sfx] = {"max_abs_err": _close(name, "rho", rho, rho_p, 1e-5, 0.0),
                            "nb_pairs": int(nc_p.to(torch.int64).sum())}
    vol = m / rho
    rd = {**kw, "mask": "read"}
    cs, _ = pe.pallas_iad(x, y, z, h, vol, keys, box, const, nbr, **rd)
    cs_p, _ = pe.iad_plain(x, y, z, h, vol, keys, box, const, nbr, **kw)
    scale = float(cs_p[0].abs().max())
    res["iad" + sfx] = {"max_abs_err": max(_close(name, f"c{k}", a, b, 1e-4, 1e-5 * scale)
                                           for k, (a, b) in enumerate(zip(cs, cs_p)))}
    p, c = compute_eos_std(ss.temp, rho, const)
    margs = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho, p, c, *cs, keys, box, const, nbr)
    out = pe.pallas_momentum_energy_std(*margs, **rd)
    out_p = pe.momentum_energy_std_plain(*margs, **kw)
    err = max(_close(name, nm, a, b, 1e-4, 5e-6 * (float(b.abs().max()) + 1e-12))
              for nm, a, b in zip(("ax", "ay", "az", "du"), out[:4], out_p[:4]))
    dk, dp = float(out[4]), float(out_p[4])
    if abs(dk - dp) > 1e-5 * abs(dp):
        raise AssertionError(f"{name}: min dt {dk} vs plain {dp}")
    res["momentum_energy_std" + sfx] = {"max_abs_err": err,
                                        "min_dt_rel_err": abs(dk - dp) / abs(dp)}
    return res


def family_vs_plain(name: str, ss, box, const, nbr, keys=None, ranges=None,
                    lists=None) -> dict:
    """Every std and VE op (both divv/curlv and momentum forms) of the
    kernel family ``const`` names against its plain version:
    ``std_ops_vs_plain`` and ``ve_chain_vs_plain``, streaming or, with
    ``lists``, the list walks. Returns per-entry-point results."""
    res = std_ops_vs_plain(name, ss, box, const, nbr, keys=keys, ranges=ranges, lists=lists)
    for av_clean in (False, True):
        ve, _ = ve_chain_vs_plain(f"{name} av_clean {av_clean}", ss, box, const, nbr,
                                  av_clean, keys=keys, ranges=ranges, lists=lists)
        res.update({(k + ":av_clean" if av_clean and k != "xmass" else k): v
                    for k, v in ve.items()})
    return res


def compact_vs_plain(name: str, packed, cap0: int, cap1: int) -> dict:
    """K13 against its plain version on one packed array: lists and counts
    equal, element for element."""
    out = pcmp.compact_class_lists(packed, cap0, cap1)
    ref = pcmp.compact_class_lists_plain(packed, cap0, cap1)
    for nm, a, b in zip(("list0", "n0", "list1", "n1"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: compaction {nm} differs at "
                                 f"{int((a != b).sum())} entries")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(out, ref))
    return {"max_abs_err": float(err), "rows": packed.shape[0], "width": packed.shape[1],
            "caps": [cap0, cap1]}


#: K13's random cases, (rows, width, cap0, cap1): the JAX package's
#: (tests/test_pallas_interpret.py test_gravity_compact_kernel_interpret:
#: caps and widths off the multiples of 128, truncation, a row shorter
#: than a tile), then the widths the kernel's tiles of 1,024 candidates
#: read as 16-byte words cut: rows narrower than a word, widths off the
#: multiples of 4 (rows that start inside a word), caps that cut inside a
#: tile, a row longer than four tiles
COMPACT_CASES = ((4, 1000, 192, 64), (1, 90, 8, 8), (3, 513, 256, 48),
                 (3, 3, 2, 2), (2, 5, 1, 4), (5, 1001, 200, 300), (2, 4500, 1100, 2000),
                 (7, 2050, 1500, 5))


def compact_random_cases(device) -> list:
    """K13 on ``COMPACT_CASES`` against its plain version and the numpy
    expectation."""
    rng = np.random.default_rng(7)
    out = []
    for B, C, cap0, cap1 in COMPACT_CASES:
        cls = rng.integers(0, 3, size=(B, C))
        vals = rng.integers(0, 1 << 20, size=(B, C))
        packed = torch.as_tensor((cls << pcmp.IDX_BITS) | vals, dtype=torch.int32,
                                 device=device)
        res = compact_vs_plain(f"compact ({B}, {C})", packed, cap0, cap1)
        l0, n0, l1, n1 = (a.cpu().numpy() for a in
                          pcmp.compact_class_lists(packed, cap0, cap1))
        for b in range(B):
            for lst, cnt, cap, k in ((l0, n0, cap0, 0), (l1, n1, cap1, 1)):
                exp = vals[b][cls[b] == k]
                kept = min(len(exp), cap)
                if (int(cnt[b]) != len(exp) or not np.array_equal(lst[b][:kept], exp[:kept])
                        or np.any(lst[b][kept:] != 0)):
                    raise AssertionError(f"compact ({B}, {C}) row {b} class {k}: "
                                         "not the expected list")
        out.append(res)
    return out


#: K13's one-row form, (rows, share of due rows, offset of the mask in
#: its allocation): one tile and one more row, masks that start off the
#: 16-byte words, no due row, every row due, 10^6 rows
COMPACT_ROW_CASES = ((4097, 0.5, 0), (100_003, 0.01, 1), (65_536, 0.0, 3), (50_001, 1.0, 2),
                     (1_000_000, 0.3, 0))


def compact_row_vs_plain(name: str, due) -> dict:
    """``blockdt.compact_active`` on the card (K13's one-row form, counted
    once) against its plain version and against the plain version of the
    one-block form over the packed (1, n) row that the JAX package builds:
    the positions and the count equal, the due rows first in row order,
    zeros after."""
    n = due.shape[0]
    before = pe.LAUNCHES["compact_row"]
    idx, cnt = bdt.compact_active(due)
    if pe.LAUNCHES["compact_row"] != before + 1:
        raise AssertionError(f"{name}: the one-row form was not launched")
    ref_idx, ref_cnt = pcmp.compact_row_plain(due)
    cls = torch.where(due, 0, 1).to(torch.int32)
    packed = ((cls << pcmp.IDX_BITS) | torch.arange(n, dtype=torch.int32,
                                                    device=due.device))[None, :]
    l0, n0, _, _ = pcmp.compact_class_lists_plain(packed, n, 1)
    for nm, a, b in (("idx", idx, ref_idx), ("count", cnt, ref_cnt),
                     ("idx (packed row)", idx, l0[0]), ("count (packed row)", cnt, n0[0])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: one-row {nm} differs at "
                                 f"{int((a != b).sum())} entries")
    want = torch.nonzero(due).flatten().to(torch.int32)
    if int(cnt) != want.numel() or not torch.equal(idx[:want.numel()], want) \
            or bool((idx[want.numel():] != 0).any()):
        raise AssertionError(f"{name}: compact_active is not the due rows, then zeros")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in ((idx, ref_idx), (cnt, ref_cnt)))
    return {"max_abs_err": float(err), "rows": n, "due": int(cnt)}


def compact_row_cases(device) -> list:
    """K13's one-row form on ``COMPACT_ROW_CASES`` (seeded masks; the
    offset cases are views into a longer allocation)."""
    out = []
    for n, share, off in COMPACT_ROW_CASES:
        due_np = np.random.default_rng(n).uniform(size=n + off) < share
        due = torch.as_tensor(due_np, device=device)[off:]
        res = compact_row_vs_plain(f"compact row ({n}, share {share}, offset {off})", due)
        out.append({**res, "offset": off, "share": share})
    return out


def blockdt_vs_cpu(case: str, side: int, steps: int, dt_bins: int = 3, prop: str = "std",
                   resort_drift: float = 0.0) -> dict:
    """Block-time-step substeps on the card against the same substeps on
    the CPU, each from the card's input state and carry: the integer block
    diagnostics and the bins equal, neighbour counts (max and exact total)
    equal, the fields within the slice's tolerance (rtol 1e-4, VE 2e-4;
    atol 5e-6 max|.|); with gravity (Evrard) egrav within 1e-4."""
    from sphexa_torch.init import CASES
    from sphexa_torch.observables import ObservableSpec
    from sphexa_torch.simulation import Simulation

    kw = {"prop": prop, "dt_bins": dt_bins, "bin_resort_drift": resort_drift,
          "obs_spec": ObservableSpec()}
    gpu = Simulation(*CASES[case](side, device="cuda"), device="cuda", **kw)
    cpu = Simulation(*CASES[case](side, device="cpu"), device="cpu", **kw)
    rtol = 1e-4 if prop == "std" else 2e-4
    worst, active = 0.0, []
    for it in range(steps):
        cpu.state, cpu.box = gpu.state.to("cpu"), gpu.box.to("cpu")
        cpu.bdt_state = gpu.bdt_state.to("cpu")
        dg, dc = gpu.step(), cpu.step()
        for k in ("nc_max", "nc_sum", "occupancy", "bdt_active", "bdt_resort", "bdt_drift",
                  *(f"bdt_pop[{b}]" for b in range(dt_bins))):
            if dg[k] != dc[k]:
                raise AssertionError(f"{case} {side} substep {it}: {k} {dg[k]} vs cpu {dc[k]}")
        if gpu.gravity_on and abs(dg["egrav"] - dc["egrav"]) > 1e-4 * abs(dc["egrav"]):
            raise AssertionError(f"{case} {side} substep {it}: egrav {dg['egrav']} vs cpu "
                                 f"{dc['egrav']}")
        got, want = blockdt_to_numpy(gpu.bdt_state), blockdt_to_numpy(cpu.bdt_state)
        for k in ("bins", "substep", "cycle"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{case} {side} substep {it}: {k} differs")
        for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "du", "alpha"):
            a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=rtol, atol=5e-6 * scale,
                                       msg=f"{case} {side} substep {it}: {f}")
            worst = max(worst, float((a - b).abs().max()) / (scale or 1.0))
        active.append(int(dg["bdt_active"]))
    return {"case": case, "side": side, "n": gpu.state.n, "prop": prop, "dt_bins": dt_bins,
            "substeps": steps, "active": active, "max_abs_err_over_scale": worst,
            "gravity": gpu.gravity_on, "energy_drift_gpu": gpu.energy_drift,
            "energy_drift_cpu": cpu.energy_drift}


def gravity_case(side: int, device):
    """VE Evrard ``side`` on ``device``: its Simulation (the tree built
    and the caps sized at construction) and the SFC-sorted state the
    step's force stage sees. Returns (sim, sorted state, box, sorted
    keys)."""
    from sphexa_torch.init import init_evrard
    from sphexa_torch.propagator import _force_stage_prologue
    from sphexa_torch.simulation import Simulation

    sim = Simulation(*init_evrard(side, device=device), prop="ve", device=device)
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    return sim, ss, box, keys


def near_field_ranges(x, y, z, m, keys, box, tree, meta, cfg, keep_packed: bool = False,
                      shift=None):
    """The near-field leaf ranges of one solve (multipoles, classification,
    ``_p2p_leaf_ranges``), as compute_gravity hands them to K12; ``shift``
    ((3,) tensor): those of a replica pass with the targets shifted.
    Returns (starts, lens, classification); ``keep_packed``: as
    ``classify``'s."""
    mps = gt.compute_multipoles(x, y, z, m, keys, tree, meta)
    lists = gt.classify(x, y, z, box, tree, meta, cfg, mps[0], mps[1],
                        keep_packed=keep_packed, shift=shift)
    start, length = gt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], tree, mps[3],
                                        meta.num_nodes)
    return start, length, lists


#: a target shift for the allow_self case (an image offset, as Ewald's
#: replicas pass): about half the radius of the unit Evrard sphere, so the
#: shifted targets overlap their sources and the self pair is a real one
IMAGE_SHIFT = (0.5, -0.25, 0.125)


def p2p_vs_plain(name: str, x, y, z, m, h, cfg, starts, lens, groups=None,
                 shift=None, allow_self: bool = False, jdata=None) -> dict:
    """K12 against its plain version at rtol 1e-4 and atol ``P2P_ATOL``
    max|.|; returns the worst error and its ratio to max|.|. ``groups``:
    compare only these target blocks (the plain version runs with the
    other blocks' leaf lengths zeroed). Without ``shift`` and
    ``allow_self``, the open-box solve's call: no target shift, no self
    pair; an image call passes a shift ((3,) values) and keeps the self
    pair. ``jdata``: the j-buffer the ranges index (K12's jdata form, a
    rank's [own slab | halo rows])."""
    shift = torch.tensor(shift or (0.0, 0.0, 0.0), dtype=x.dtype, device=x.device)
    jkw = {} if jdata is None else {"jdata": jdata}
    out = gt._pallas_p2p(x, y, z, m, h, shift, allow_self, cfg, starts, lens, **jkw)
    plens = lens
    rows = torch.arange(x.shape[0], device=x.device)
    if groups is not None:
        sel = torch.zeros(lens.shape[0], dtype=torch.bool, device=x.device)
        sel[groups] = True
        plens = torch.where(sel[:, None], lens, 0)
        rows = rows[sel[rows // cfg.target_block]]
    ref = gt._pallas_p2p_plain(x, y, z, m, h, shift, allow_self, cfg, starts, plens, **jkw)
    err, rel = 0.0, 0.0
    for nm, a, b in zip(("ax", "ay", "az", "phi"), out, ref):
        a, b = a[rows], b[rows]
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=P2P_ATOL * scale,
                                   msg=f"{name}: near-field {nm}")
        err = max(err, float((a - b).abs().max()))
        rel = max(rel, float((a - b).abs().max()) / scale)
    return {"max_abs_err": err, "max_abs_err_over_scale": rel, "targets": int(rows.shape[0]),
            "cand_pairs": int(plens.to(torch.int64).sum()) * cfg.target_block,
            "allow_self": allow_self, "shift": shift.tolist(),
            "j_rows": x.shape[0] if jdata is None else int(jdata[0].shape[0])}


def gravity_vs_cpu(name: str, x, y, z, m, h, keys, box, tree, meta, cfg) -> dict:
    """One gravity solve on the card against the same solve on the CPU
    (the kernels' plain versions), both from the card's multipoles (the
    upsweep's scatter-adds sum children in another order on the card):
    the M2P and P2P lists and their counts equal, the forces within the
    near field's tolerance (rtol 1e-4, atol ``P2P_ATOL`` max|.|), egrav
    within rel 1e-4, the integer diagnostics equal."""
    mps = gt.compute_multipoles(x, y, z, m, keys, tree, meta)
    cpu = [a.cpu() for a in (x, y, z, m, h, keys)]
    cbox, ctree = box.to("cpu"), tree.to("cpu")
    cmps = tuple(a.cpu() for a in mps)
    lg = gt.classify(x, y, z, box, tree, meta, cfg, mps[0], mps[1])
    lc = gt.classify(*cpu[:3], cbox, ctree, meta, cfg, cmps[0], cmps[1])
    for k in ("m2p_n", "p2p_n"):
        if not torch.equal(lg[k].cpu().to(torch.int64), lc[k].to(torch.int64)):
            raise AssertionError(f"{name}: {k} differs card vs cpu")
    for k, ok in (("m2p", "m2p_ok"), ("p2p", "p2p_ok")):
        a = torch.where(lg[ok], lg[k].to(torch.int64), -1).cpu()
        b = torch.where(lc[ok], lc[k].to(torch.int64), -1)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {k} lists differ card vs cpu at "
                                 f"{int((a != b).sum())} slots")
    og = gt.compute_gravity(x, y, z, m, h, keys, box, tree, meta, cfg, multipoles=mps)
    oc = gt.compute_gravity(*cpu, cbox, ctree, meta, cfg, multipoles=cmps)
    err = 0.0
    for nm, a, b in zip(("ax", "ay", "az"), og[:3], oc[:3]):
        a = a.cpu()
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=P2P_ATOL * scale,
                                   msg=f"{name}: gravity {nm} card vs cpu")
        err = max(err, float((a - b).abs().max()) / scale)
    eg, ec = float(og[3]), float(oc[3])
    if abs(eg - ec) > 1e-4 * abs(ec):
        raise AssertionError(f"{name}: egrav {eg} vs cpu {ec}")
    for k in ("m2p_max", "p2p_max", "leaf_occ", "c_max", "compact_width"):
        if int(og[4][k]) != int(oc[4][k]):
            raise AssertionError(f"{name}: {k} {int(og[4][k])} vs cpu {int(oc[4][k])}")
    return {"max_abs_err_over_scale": err, "egrav_rel_err": abs(eg - ec) / abs(ec),
            "m2p_max": int(og[4]["m2p_max"]), "p2p_max": int(og[4]["p2p_max"]),
            "compaction": cfg.compaction, "super_factor": cfg.super_factor}


def periodic_random_case(n: int, seed: int, device):
    """``n`` particles uniform in the periodic unit cube from a seeded
    generator, equal masses, h 0.02, G 0.5: a periodic configuration
    whose forces do not cancel (a lattice's, Sedov's, cancel to about
    1e-3 of the near field's terms, below the float32 rounding of those
    terms). Returns (state, box, const)."""
    from sphexa_torch.init.utils import build_state
    from sphexa_torch.sfc.box import Box
    from sphexa_torch.sph.particles import SimConstants

    x, y, z = np.random.default_rng(seed).uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    const = SimConstants(g=0.5).normalized()
    state = build_state(x, y, z, 0.0, 0.0, 0.0, 0.02, 1.0 / n, 1.0, 1e-4, const.alphamin,
                        device=device)
    return state, Box.create(-0.5, 0.5, boundary=BoundaryType.periodic, device=device), const


def ewald_vs_cpu(name: str, n: int = 4096, seed: int = 3) -> dict:
    """One Ewald solve on the card against the same solve on the CPU (the
    kernels' plain versions) on ``periodic_random_case``, both from the
    card's multipoles: 27 K12 launches on the card, the forces within the
    near field's tolerance (rtol 1e-4, atol ``P2P_ATOL`` max|.|), egrav
    within rel 1e-4, the folded diagnostics equal."""
    from sphexa_torch.gravity.ewald import compute_gravity_ewald
    from sphexa_torch.propagator import _force_stage_prologue
    from sphexa_torch.simulation import Simulation

    sim = Simulation(*periodic_random_case(n, seed, "cuda"), prop="nbody", device="cuda")
    if not sim.ewald_on:
        raise AssertionError(f"{name}: the periodic box did not take the Ewald solve")
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    cfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g)
    meta = sim.cfg.grav_meta
    mps = gt.compute_multipoles(ss.x, ss.y, ss.z, ss.m, keys, sim.gtree, meta)
    before = pe.LAUNCHES["gravity_p2p"]
    og = compute_gravity_ewald(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree, meta, cfg,
                               sim.cfg.ewald, multipoles=mps)
    launches = pe.LAUNCHES["gravity_p2p"] - before
    cpu = [a.cpu() for a in (ss.x, ss.y, ss.z, ss.m, ss.h, keys)]
    oc = compute_gravity_ewald(*cpu, box.to("cpu"), sim.gtree.to("cpu"), meta, cfg,
                               sim.cfg.ewald, multipoles=tuple(a.cpu() for a in mps))
    err = 0.0
    for nm, a, b in zip(("ax", "ay", "az"), og[:3], oc[:3]):
        a = a.cpu()
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=P2P_ATOL * scale,
                                   msg=f"{name}: Ewald {nm} card vs cpu")
        err = max(err, float((a - b).abs().max()) / scale)
    eg, ec = float(og[3]), float(oc[3])
    if abs(eg - ec) > 1e-4 * abs(ec):
        raise AssertionError(f"{name}: egrav {eg} vs cpu {ec}")
    for k in og[4]:
        if int(og[4][k]) != int(oc[4][k]):
            raise AssertionError(f"{name}: {k} {int(og[4][k])} vs cpu {int(oc[4][k])}")
    return {"n": n, "max_abs_err_over_scale": err, "egrav_rel_err": abs(eg - ec) / abs(ec),
            "k12_launches": launches, "m2p_max": int(og[4]["m2p_max"])}


def list_build_vs_plain(name: str, cull, x, y, z, h, skin, slot_cap: int, cfg) -> dict:
    """The list build's kernel against ``pair_lists.build_lists_plain`` on
    the same card tensors, bit for bit: the pruned run tables, the words
    and counts in pruned order, the chunk totals. Returns the build's
    outputs and the lanes of the chunks it marked."""
    got = pl.build_lists_kernel(cull, x, y, z, h, skin, slot_cap, cfg)
    want = pl.build_lists_plain(cull, x, y, z, h, skin, slot_cap, cfg)
    names = (*pl.RUN_TABLES, "bits", "cnt", "total")
    for nm, a, b in zip(names, (*got[0], *got[1:]), (*want[0], *want[1:])):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: list build {nm} differs from the plain version "
                                 f"({a.dtype} vs {b.dtype}, "
                                 f"{int((a != b).sum()) if a.shape == b.shape else a.shape})")
    lanes = int(torch.clamp(got[3], max=slot_cap).to(torch.int64).sum()) * pe.LANES
    return {"max_abs_err": 0.0, "bits_equal": True, "lanes_visited": lanes, "outputs": got}


#: the mixed-box list case: Sedov side 24 stretched along z, periodic x,
#: open y and z, sized with cell_target 16 (it keeps lists on)
MIXED_BOX = {"side": 24, "z_scale": 1.3, "cell_target": 16,
             "boundaries": (BoundaryType.periodic, BoundaryType.open, BoundaryType.open)}


def mixed_box_case(device):
    """The mixed-box list case's initial (state, box, const) on ``device``
    and the ``make_propagator_config`` keywords that size it."""
    fields, box, const = state_to_numpy(*init_sedov(MIXED_BOX["side"], device="cpu"))
    fields, box = stretch_box(fields, box, MIXED_BOX["z_scale"], MIXED_BOX["boundaries"])
    return (state_from_numpy(fields, box, const, device=device),
            {"cell_target": MIXED_BOX["cell_target"]})


#: the synthetic cull's merge limits: a run of at most SYNTH_RUN_CAP rows,
#: cells joined across at most SYNTH_GAP rows
SYNTH_RUN_CAP, SYNTH_GAP = 512, 32


def synthetic_cull(seed: int, device, groups: int = 64, w3: int = 27):
    """Culled window cells made from a seed that exercise each edge of the
    run merge in every group, in this (start) order: a head, a cell
    exactly SYNTH_GAP rows after it (joins), one SYNTH_GAP + 1 rows after
    that (a new run), a cell that brings that run to exactly SYNTH_RUN_CAP
    rows (joins), a one-row cell right after it (a new run: one row over),
    a cell of another image shift (a new run), an empty cell, a dropped
    cell and a kept one after it (joins across the dropped one); then
    random cells (gaps, lengths, shifts, empty and dropped cells). The
    columns are shuffled, so the build has to rank them. Positions run
    along x in sorted order, repeating every 320 rows (y, z random in a
    thin slab), with h of a few rows' spacing, so that a group marks the
    chunks near its own rows and 320 rows away, and the rest are pruned,
    some in the middle of a run; the last group is partial. Returns (cull,
    x, y, z, h, skin, slot_cap, cfg) on ``device``: cull as
    ``window_cells_culled`` gives it, slot_cap the largest chunk total."""
    rng = np.random.default_rng(seed)
    group = 64
    n = groups * group - 17
    period = 320  # rows i and i + 320 lie at the same x
    x = ((np.arange(n) % period + rng.uniform(0.0, 1.0, n)) / period - 0.5).astype(np.float32)
    y, z = (rng.uniform(-0.05, 0.05, n).astype(np.float32) for _ in range(2))
    h = (rng.uniform(4.0, 8.0, n) / period).astype(np.float32)
    skin = np.float32(4.0 / period)
    start = np.zeros((groups, w3), np.int64)
    lens = np.zeros((groups, w3), np.int64)
    keep = np.zeros((groups, w3), bool)
    shifts = np.zeros((groups, w3, 3), np.float32)
    for g in range(groups):
        cells = []  # (start, len, keep, shift) in start order

        def add(s, ln, kp=True, sh=(0.0, 0.0, 0.0)):
            cells.append((s, ln, kp, sh))
            return s + ln

        s0 = int(np.clip(g * group - 250, 0, n - 1600))
        e = add(s0, int(rng.integers(20, 60)))
        e = add(e + SYNTH_GAP, int(rng.integers(20, 60)))
        c = e + SYNTH_GAP + 1
        e = add(c, int(rng.integers(20, 60)))
        e = add(e + 5, SYNTH_RUN_CAP - (e + 5 - c))
        e = add(e, 1)
        e = add(e + 3, int(rng.integers(20, 60)), sh=(1.0, 0.0, 0.0))
        add(e, 0, kp=False)
        e = add(e, int(rng.integers(5, 20)), kp=False)
        e = add(e, int(rng.integers(20, 60)), sh=(1.0, 0.0, 0.0))
        while len(cells) < w3:
            ln = int(rng.integers(0, 40)) if e < n - 40 else 0
            kp = ln > 0 and rng.uniform() < 0.8
            sh = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0))[int(rng.integers(0, 3))]
            e = add(min(e + int(rng.choice([0, 0, 3, SYNTH_GAP, 80])), n - ln), ln, kp, sh)
        cols = rng.permutation(w3)
        for col, (s, ln, kp, sh) in zip(cols, cells):
            start[g, col], lens[g, col], keep[g, col], shifts[g, col] = s, ln, kp, sh
    cfg = NeighborConfig(level=4, cap=SYNTH_RUN_CAP, curve="hilbert", group=group, window=3,
                         run_cap=SYNTH_RUN_CAP, gap=SYNTH_GAP)
    t = [torch.as_tensor(a, device=device) for a in (start, lens, keep, shifts, x, y, z, h, skin)]
    cull, (xt, yt, zt, ht, skin_t) = tuple(t[:4]), t[4:]
    total = pl.build_lists_plain(cull, xt, yt, zt, ht, skin_t, 1, cfg)[3]
    return cull, xt, yt, zt, ht, skin_t, int(total.max()), cfg
