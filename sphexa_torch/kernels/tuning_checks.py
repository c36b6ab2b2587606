"""Card checks of the kernel shapes the tuning registry reaches, shared by
chip_smoke.py's ``tuning_path`` phase and tests/test_torch_gpu.py
(``-k tuning``).

A tuned run is a normal run: every value in a knob's domain
(sphexa_torch/tuning/knobs.py) launches the kernels at another shape,
and each shape must give what the kernels' plain versions give.

- ``engine_shapes``: on the jittered std Sedov state (side ``SEDOV_SIDE``):
  for each ``group`` (32, 64, 128: K1's block of ``group`` threads and its
  mask words, K5's group bbox, K6's block) the streaming std ops (K1) and,
  in list mode, the list build (K5) and the list walks (K6); for
  ``run_cap`` 1024 / 2048 crossed with ``gap`` 128 / 512 (the runs K1 walks)
  the streaming ops; for ``list_skin_rel`` 0.1 / 0.3 (K5's inflated bbox,
  the slot budget) the list build and walks;
- ``gravity_shapes``: on VE Evrard (side ``EVRARD_SIDE``) built through
  ``Simulation(tuned={"target_block": tb, "super_factor": sf})`` (the
  caps sized for the shape), for ``target_block`` 128 / 256 crossed with
  ``super_factor`` 0 / 4 / 16: the near field (K12) on the solve's leaf
  ranges and the list compaction (K13) on its packed arrays (at
  ``super_factor`` 0 the tuned run takes the sort compaction: K13 is held
  in its one-level bitmask form on the same solve).

The tolerances are chip_smoke.py's: nc, K5 and K13 exact
(``checks.list_build_vs_plain``, ``checks.compact_vs_plain``), the lists
K5 writes equal to those the rebuild made, the std ops' fields as
``checks.std_ops_vs_plain`` (rho rtol 1e-5; IAD rtol 1e-4 / atol 1e-5
max|c11|; a and du rtol 1e-4 / atol 5e-6 max|.|; min dt rel 1e-5), K12
rtol 1e-4 / atol ``checks.P2P_ATOL`` max|.|. Any disagreement raises.
"""

import dataclasses
from typing import Dict

import torch

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_evrard, init_sedov, jitter_sedov
from sphexa_torch.kernels import checks
from sphexa_torch.propagator import _force_stage_prologue, rebuild_pair_lists
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph import pair_lists as pl

SEDOV_SIDE = 40
EVRARD_SIDE = 30

#: the domains held (sphexa_torch/tuning/knobs.py)
GROUPS = (32, 64, 128)
RUN_CAPS = (1024, 2048)
GAPS = (128, 512)
SKINS = (0.1, 0.3)
TARGET_BLOCKS = (128, 256)
SUPER_FACTORS = (0, 4, 16)


def sedov_state(side: int, device):
    """The jittered std Sedov lattice (every pair term non-zero), seeded
    by ``side``."""
    fields, box, const = state_to_numpy(*init_sedov(side, device="cpu"))
    return state_from_numpy(jitter_sedov(fields, side, seed=side), box, const, device=device)


def streaming_vs_plain(name: str, state, box, const, **sizing) -> Dict:
    """K1's std ops at the config ``sizing`` gives (make_propagator_config's
    keywords) against their plain versions."""
    cfg = make_propagator_config(state, box, const, **sizing)
    ss, sbox, keys, _ = _force_stage_prologue(state, box, cfg)
    if pe.engine_fold(sbox, cfg.nbr):
        raise AssertionError(f"{name}: the grid folds; expected per-run shifts")
    ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, sbox, cfg.nbr)
    res = checks.std_ops_vs_plain(name, ss, sbox, const, cfg.nbr, keys=keys, ranges=ranges)
    return {"nbr": {k: getattr(cfg.nbr, k) for k in ("group", "run_cap", "gap", "window",
                                                     "cap", "level")},
            "runs": int((ranges.lens > 0).sum()), **res}


def lists_vs_plain(name: str, state, box, const, **sizing) -> Dict:
    """In list mode at the config ``sizing`` gives: the list build (K5)
    against its plain version bit for bit and against the lists the
    rebuild made, and the std ops' list walks (K6) against their plain
    versions."""
    cfg = make_propagator_config(state, box, const, use_lists=True, **sizing)
    if cfg.list_slot_cap <= 0 or pe.engine_fold(box, cfg.nbr):
        raise AssertionError(f"{name}: no lists (slot cap {cfg.list_slot_cap})")
    st, lbox, lists = rebuild_pair_lists(state, box, cfg)
    if int(lists.overflow):
        raise AssertionError(f"{name}: slot cap overflow")
    keys = compute_sfc_keys(st.x, st.y, st.z, lbox, curve=cfg.curve)
    cull = pe.window_cells_culled(st.x, st.y, st.z, st.h, keys, lbox, cfg.nbr,
                                  radius_pad=lists.skin)[:4]
    mark = checks.list_build_vs_plain(name, cull, st.x, st.y, st.z, st.h, lists.skin,
                                      cfg.list_slot_cap, cfg.nbr)
    tables, bits, cnt, _ = mark.pop("outputs")
    for f, a in zip(pl.RUN_TABLES, tables):
        if not torch.equal(a, getattr(lists.ranges, f)):
            raise AssertionError(f"{name}: the list build's {f} differs from the rebuild's")
    if not (torch.equal(bits, lists.bits) and torch.equal(cnt, lists.cnt)):
        raise AssertionError(f"{name}: the list build's words differ from the rebuild's")
    res = checks.std_ops_vs_plain(name, st, lbox, const, cfg.nbr, keys=keys, lists=lists)
    return {"nbr": {"group": cfg.nbr.group, "window": cfg.nbr.window},
            "list_skin_rel": cfg.list_skin_rel, "slot_cap": cfg.list_slot_cap,
            "mark": mark, **res}


def engine_shapes(device="cuda", side: int = SEDOV_SIDE) -> Dict:
    """Every engine shape the registry reaches, each held to its plain
    versions (the module's docstring); returns the results by shape."""
    state, box, const = sedov_state(side, device)
    out = {}
    for g in GROUPS:
        out[f"group={g}"] = streaming_vs_plain(f"group {g}", state, box, const, group=g)
        out[f"group={g}:lists"] = lists_vs_plain(f"group {g} lists", state, box, const, group=g)
    for rc in RUN_CAPS:
        for gap in GAPS:
            out[f"run_cap={rc},gap={gap}"] = streaming_vs_plain(
                f"run_cap {rc} gap {gap}", state, box, const, run_cap=rc, gap=gap)
    for skin in SKINS:
        out[f"list_skin_rel={skin}:lists"] = lists_vs_plain(
            f"skin {skin} lists", state, box, const, list_skin_rel=skin)
    for key, r in out.items():
        want = dict(kv.split("=") for kv in key.split(":")[0].split(","))
        got = r["list_skin_rel"] if "list_skin_rel" in want else None
        for k, v in want.items():
            have = got if k == "list_skin_rel" else r["nbr"][k]
            if float(have) != float(v):
                raise AssertionError(f"{key}: the config has {k} = {have}")
    return out


def gravity_shapes(device="cuda", side: int = EVRARD_SIDE) -> Dict:
    """K12 and K13 at every (target_block, super_factor) of the registry's
    domains, on the solve the tuned Simulation configures."""
    st, box, const = init_evrard(side, device=device)
    out = {}
    for tb in TARGET_BLOCKS:
        for sf in SUPER_FACTORS:
            name = f"target_block {tb} super_factor {sf}"
            sim = Simulation(st, box, const, prop="ve", device=device,
                             tuned={"target_block": tb, "super_factor": sf})
            gcfg = sim.cfg.gravity
            comp = "bitmask" if sf > 0 else "sort"
            if (gcfg.target_block, gcfg.super_factor, gcfg.compaction) != (tb, sf, comp):
                raise AssertionError(f"{name}: the solver has {gcfg}")
            ss, gbox, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
            kcfg = gcfg if sf > 0 else dataclasses.replace(gcfg, compaction="bitmask")
            starts, lens, cls = checks.near_field_ranges(
                ss.x, ss.y, ss.z, ss.m, keys, gbox, sim.gtree, sim.cfg.grav_meta, kcfg,
                keep_packed=True)
            packed = cls["packed"]
            if len(packed) != (2 if sf > 0 else 1):
                raise AssertionError(f"{name}: {len(packed)} compactions")
            k13 = [checks.compact_vs_plain(f"{name} compaction {i}", *pk)
                   for i, pk in enumerate(packed)]
            k12 = checks.p2p_vs_plain(name, ss.x, ss.y, ss.z, ss.m, ss.h, gcfg, starts, lens)
            out[f"target_block={tb},super_factor={sf}"] = {
                "compaction": gcfg.compaction, "caps": {
                    k: getattr(gcfg, k) for k in ("m2p_cap", "p2p_cap", "super_cap")},
                "gravity_p2p": k12, "compact_class_lists": k13,
                "k13_form": "two-level" if sf > 0 else "one-level (the run sorts)"}
    return out
