"""Kernel-vs-plain checks of the port's CUDA kernels. They need an
NVIDIA card (marker ``gpu``) and skip without one; on the card run

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Each kernel and its plain PyTorch version get the same sorted state on
the card, with the JAX package's tolerances. The pair engine, std and VE
ops: Sedov on the fold case (side 12) and the shift case (side 24,
cell_target=16).
The persistent lists (the list walk, list mode against streaming):
Sedov side 30 and Noh 16 (open box); jittered side 24 has no lists (its
list window spans the grid, fold mode). The list build (K5) bit for bit
against its plain version on those two, the mixed box (Sedov 24
stretched in z, periodic x, open y and z) and synthetic cells that hold
every edge of the run merge. Every Sedov lattice is jittered
from a seed (``jitter_sedov``) so that every term of each pair body, the
viscosity and the IAD off-diagonals included, is non-zero. A VE
list-mode Simulation step on the card is compared with the same step on
the CPU. Gravity: the list compaction (K13) exactly and the near field
(K12, on a solve's leaf ranges; also with a target shift and the self
pair) against their plain versions (sphexa_torch/kernels/checks.py,
shared with chip_smoke.py), a whole solve on the card against the CPU in
both compactions (Evrard 30), and a VE Evrard Simulation step; N-body
steps (Evrard 20, a Plummer sphere), an Ewald solve (Sedov 16) and
spherical order-4 and order-6 solves on the card against the CPU.
turb-ve and std-cooling steps on the card against the CPU, the OU draw's
copy to the card, and a turb-ve restart (kernels/aux_checks.py). Every
std and VE op of K1 and K6 with wendland-c6 (the 20-coefficient form) and
with sinc at index 5; K13's one-row form bit for bit; block-time-step
substeps on the card against the CPU (Sedov std and VE, Evrard). Under
``-k sharded``: two gloo ranks on the card, K1's jdata form of every std
and VE op against its plain version and one std and one VE step against
the one-device step (kernels/sharded_checks.py); with gravity, a VE
Evrard step and an Ewald solve against the one-device ones. K12's jdata
form (``-k p2p_jdata``): bit for bit the one-device form on the targets'
own arrays, and within its tolerance of the plain version on a rank's
[own slab | halo rows]. turb-ve, N-body and block time steps on two gloo
ranks of the card (``-k sharded_props``) against the one-device steps,
K13's one-row form on each rank's due masks. The app shell (``-k
app_shell``, kernels/app_checks.py): the snapshot deposit against its
plain numpy version, a deferred window's host syncs with snapshots equal
to the run without, the debug checks, the substep split's K1 launches and
a ``--trace-dir`` capture's coverage on the card. The gather backend
(``-k gather``, kernels/gather_checks.py): the search card vs CPU bit for
bit on a truncating case, a force stage against the engine's, no
launches; across two gloo ranks of the card (``-k sharded_gather``,
kernels/sharded_gather_checks.py) the truncating search's lists as
global rows bit for bit the one-card search's, and std Sedov steps held
to the one-card gather step with no launch."""

import dataclasses

import pytest
import torch

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_noh, init_sedov, jitter_sedov
from sphexa_torch.kernels import checks
from sphexa_torch.kernels.checks import ve_chain_vs_plain
from sphexa_torch.propagator import _force_stage_prologue, rebuild_pair_lists
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph import pair_lists as pl
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_ve import compute_eos_ve

pytestmark = pytest.mark.gpu

CASES = {"fold": (12, None), "shift": (24, 16)}


@pytest.fixture(params=list(CASES))
def case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    side, ct = CASES[request.param]
    fields, box, const = state_to_numpy(*init_sedov(side, device="cpu"))
    state, box, const = state_from_numpy(jitter_sedov(fields, side, seed=side), box,
                                         const, device="cuda")
    cfg = make_propagator_config(state, box, const, cell_target=ct)
    assert pe.engine_fold(box, cfg.nbr) == (request.param == "fold")
    ss, box, keys, _ = _force_stage_prologue(state, box, cfg)
    ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr)
    return ss, box, const, cfg.nbr, keys, ranges


def test_kernels_match_plain(case):
    ss, box, const, nbr, keys, ranges = case
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    pe.reset_launches()
    rho_k, nc_k, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    rho_p, nc_p, _ = pe.density_plain(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    assert torch.equal(nc_k, nc_p)
    torch.testing.assert_close(rho_k, rho_p, rtol=1e-5, atol=0.0)

    p, c = compute_eos_std(ss.temp, rho_k, const)
    vol = m / rho_k
    cs_k, _ = pe.pallas_iad(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)
    cs_p, _ = pe.iad_plain(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)
    scale = float(cs_p[0].abs().max())
    for a, b in zip(cs_k, cs_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)

    args = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho_k, p, c, *cs_k, keys, box, const, nbr)
    out_k = pe.pallas_momentum_energy_std(*args, ranges=ranges)
    out_p = pe.momentum_energy_std_plain(*args, ranges=ranges)
    for a, b in zip(out_k[:4], out_p[:4]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-6 * float(b.abs().max()) + 1e-12)
    assert float(out_k[4]) == pytest.approx(float(out_p[4]), rel=1e-5)
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), "density": 1, "iad": 1,
                           "momentum_energy_std": 1}


def test_wrapper_rejects_bad_input(case):
    ss, box, const, nbr, keys, ranges = case
    with pytest.raises(ValueError):
        pe.pallas_density(ss.x, ss.y, ss.z, ss.h, ss.m.double(), keys, box, const,
                          nbr, ranges=ranges)


LIST_CASES = {"sedov": (init_sedov, 30), "noh": (init_noh, 16)}


def _list_case(name):
    """A list-mode config, the frozen sorted state and its lists (built by
    the list-build kernel), and the streaming runs of the same state. The
    mixed box (``checks.mixed_box_case``) is not jittered: jittered, its
    window would span the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kw = {}
    if name == "mixed":
        (state, box, const), kw = checks.mixed_box_case("cpu")
    else:
        init, side = LIST_CASES[name]
        state, box, const = init(side, device="cpu")
    if name == "sedov":
        fields, b, c = state_to_numpy(state, box, const)
        state, box, const = state_from_numpy(jitter_sedov(fields, side, seed=side), b, c,
                                             device="cpu")
    state, box = state.to("cuda"), box.to("cuda")
    cfg = make_propagator_config(state, box, const, use_lists=True, **kw)
    assert cfg.list_slot_cap > 0 and not pe.engine_fold(box, cfg.nbr)
    ss, box, lists = rebuild_pair_lists(state, box, cfg)
    assert int(lists.overflow) == 0
    keys = compute_sfc_keys(ss.x, ss.y, ss.z, box, curve=cfg.curve)  # sorted: frozen order
    ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr)
    return ss, box, const, cfg, keys, lists, ranges


@pytest.fixture(scope="module", params=list(LIST_CASES))
def list_case(request):
    return _list_case(request.param)


@pytest.fixture(scope="module", params=[*LIST_CASES, "mixed"])
def build_case(request):
    """The list cases and the mixed box, for K5. The walk tests above hold
    each output to its own max|.|; on the mixed box the x-mirror symmetry
    makes IAD's off-diagonal x components vanish, rounding noise whose
    summation order differs, so they take the list cases only; chip_smoke
    runs the walk there against the global scale."""
    return _list_case(request.param)


def _cull(ss, box, cfg, keys, skin):
    """The list build's input: the culled window cells at the skin."""
    return pe.window_cells_culled(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr,
                                  radius_pad=skin)[:4]


def test_list_build_matches_plain(build_case):
    """K5: the list build equals its plain version (merge, mark, prune,
    gathers) bit for bit on the list cases' culled cells, in one launch,
    and its outputs are the lists the rebuild made."""
    ss, box, const, cfg, keys, lists, _ = build_case
    cull = _cull(ss, box, cfg, keys, lists.skin)
    pe.reset_launches()
    res = checks.list_build_vs_plain("list case", cull, ss.x, ss.y, ss.z, ss.h, lists.skin,
                                     cfg.list_slot_cap, cfg.nbr)
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), "mark": 1}
    tables, bits, cnt, _ = res["outputs"]
    for nm, a in zip(pl.RUN_TABLES, tables):
        assert torch.equal(a, getattr(lists.ranges, nm)), nm
    assert torch.equal(bits, lists.bits) and torch.equal(cnt, lists.cnt)
    assert torch.equal(cnt, pe.lane_mask(bits).sum(-1).to(torch.int32))


def test_list_build_overflow_matches_plain(build_case):
    """A slot budget of 2 overflows: the chunk totals (unclipped) and
    everything else still equal the plain version's, and the lists carry
    the overflow sentinel."""
    ss, box, const, cfg, keys, lists, _ = build_case
    cull = _cull(ss, box, cfg, keys, lists.skin)
    res = checks.list_build_vs_plain("list case, 2 slots", cull, ss.x, ss.y, ss.z, ss.h,
                                     lists.skin, 2, cfg.nbr)
    assert int(res["outputs"][3].max()) > 2
    small = pl.build_pair_lists(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr, lists.skin, 2)
    assert int(small.overflow) == 1


@pytest.mark.parametrize("slots", ["fit", "overflow"])
def test_list_build_synthetic_matches_plain(slots):
    """K5 on ``checks.synthetic_cull``'s cells, which hold every edge of
    the run merge (a gap of exactly ``gap``, a run of exactly ``run_cap``,
    a shift change between adjacent cells, empty and dropped cells between
    kept ones, shuffled columns) and prune chunks in the middle of runs."""
    _need_card()
    cull, x, y, z, h, skin, scap, cfg = checks.synthetic_cull(7, "cuda")
    checks.list_build_vs_plain(f"synthetic {slots}", cull, x, y, z, h, skin,
                               scap if slots == "fit" else 3, cfg)


def test_list_build_refuses_oversized_shared_memory():
    """Shared memory is sized from W3 and slot_cap; past the card's limit
    the launch is refused and the wrapper raises. The refusal does not
    leak into the next launch's error check."""
    _need_card()
    cull, x, y, z, h, skin, scap, cfg = checks.synthetic_cull(7, "cuda")
    with pytest.raises(RuntimeError, match="launch_mark"):
        pl.build_lists_kernel(cull, x, y, z, h, skin, 60000, cfg)
    checks.list_build_vs_plain("synthetic after a refusal", cull, x, y, z, h, skin, scap, cfg)


def test_rebuild_skips_the_composition(build_case, monkeypatch):
    """On the card a list rebuild is one K5 launch: neither the run merge,
    the plain mark pass nor the prune runs."""
    ss, box, const, cfg, keys, lists, _ = build_case

    def refuse(*_args, **_kw):
        raise AssertionError("the plain list build's composition ran on the card")

    for mod, name in ((pe, "_merge_runs"), (pl, "_prune_empty_chunks"), (pl, "mark_plain")):
        monkeypatch.setattr(mod, name, refuse)
    pe.reset_launches()
    _, _, again = rebuild_pair_lists(ss, box, cfg)
    assert pe.LAUNCHES["mark"] == 1
    assert torch.equal(again.bits, lists.bits) and torch.equal(again.cnt, lists.cnt)


def test_list_build_info():
    """The list build's static facts at the std main path's sizes (W3 125,
    slot_cap 112): registers without spills, shared bytes from the sizes,
    four warps a block."""
    _need_card()
    info = pl.list_build_info(125, 112)
    assert info["registers"] > 0 and info["local_bytes"] == 0, info
    assert info["dynamic_smem"] == 4 * (11 * 125 + 1 + 9 * 112), info
    assert info["blocks_per_sm"] >= 1 and info["warps_per_sm"] == 4 * info["blocks_per_sm"]


def test_list_walk_matches_plain(list_case):
    """K6: the list walk's momentum/energy against its plain version; in
    list mode density and IAD take the walk too, and K1 is not launched."""
    ss, box, const, cfg, keys, lists, _ = list_case
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    rho, _, _ = pe.pallas_density(x, y, z, h, m, None, box, const, cfg.nbr, lists=lists)
    p, c = compute_eos_std(ss.temp, rho, const)
    cs, _ = pe.pallas_iad(x, y, z, h, m / rho, None, box, const, cfg.nbr, lists=lists)
    args = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho, p, c, *cs, None, box, const, cfg.nbr)
    pe.reset_launches()
    out_k = pe.pallas_momentum_energy_std(*args, lists=lists)
    out_p = pe.momentum_energy_std_plain(*args, lists=lists)
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), "momentum_energy_std_lists": 1}
    for a, b in zip(out_k[:4], out_p[:4]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-6 * float(b.abs().max()) + 1e-12)
    assert float(out_k[4]) == pytest.approx(float(out_p[4]), rel=1e-5)


def test_lists_match_streaming(list_case):
    """List mode (the list walk K6) against the streaming kernels (K1)
    with fresh runs on the same frozen-order state: nc exact, the rest
    within the JAX package's list-vs-streaming tolerances
    (tests/test_pair_lists.py)."""
    ss, box, const, cfg, keys, lists, ranges = list_case
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    nbr = cfg.nbr
    rho0, nc0, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    rho1, nc1, _ = pe.pallas_density(x, y, z, h, m, None, box, const, nbr, lists=lists)
    assert torch.equal(nc0, nc1)
    torch.testing.assert_close(rho1, rho0, rtol=2e-6, atol=0.0)
    p, c = compute_eos_std(ss.temp, rho0, const)
    cs0, _ = pe.pallas_iad(x, y, z, h, m / rho0, keys, box, const, nbr, ranges=ranges)
    cs1, _ = pe.pallas_iad(x, y, z, h, m / rho0, None, box, const, nbr, lists=lists)
    csc = max(float(a.abs().max()) for a in cs0)
    for a, b in zip(cs1, cs0):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6 * csc)
    args = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho0, p, c, *cs0, keys, box, const, nbr)
    out0 = pe.pallas_momentum_energy_std(*args, ranges=ranges)
    out1 = pe.pallas_momentum_energy_std(*args, lists=lists)
    scale = float(out0[0].abs().max())
    for a, b in zip(out1[:3], out0[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(out1[3], out0[3], rtol=1e-4,
                               atol=1e-6 * float(out0[3].abs().max()))
    assert float(out1[4]) == pytest.approx(float(out0[4]), rel=1e-5)


def _ve_kernels_vs_plain(ss, box, const, nbr, av_clean, **kw):
    """The VE chain's kernels against their plain versions
    (``ve_chain_vs_plain``). Returns the launch counts."""
    pe.reset_launches()
    ve_chain_vs_plain("VE", ss, box, const, nbr, av_clean, **kw)
    return dict(pe.LAUNCHES)


@pytest.mark.parametrize("av_clean", [False, True], ids=["plain", "avclean"])
def test_ve_kernels_match_plain(case, av_clean):
    """K2 (xmass) and K8-K11 on the streaming engine."""
    ss, box, const, nbr, keys, ranges = case
    la = _ve_kernels_vs_plain(ss, box, const, nbr, av_clean, keys=keys, ranges=ranges)
    assert la == {**dict.fromkeys(la, 0), "density": 1, "iad": 1, "ve_def_gradh": 1,
                  "iad_divv_curlv": 1, "av_switches": 1, "momentum_energy_ve": 1}


@pytest.mark.parametrize("av_clean", [False, True], ids=["plain", "avclean"])
def test_ve_list_kernels_match_plain(list_case, av_clean):
    """The VE ops in list mode: every op, xmass over the density op and
    both forms of divv/curlv, takes the list walk; K1 is not launched."""
    ss, box, const, cfg, keys, lists, _ = list_case
    la = _ve_kernels_vs_plain(ss, box, const, cfg.nbr, av_clean, keys=None, lists=lists)
    assert la == {**dict.fromkeys(la, 0), "density_lists": 1, "iad_lists": 1,
                  "ve_def_gradh_lists": 1, "iad_divv_curlv_lists": 1, "av_switches_lists": 1,
                  "momentum_energy_ve_lists": 1}


def _walk_fields(ss, const, lists, group, forces=False):
    """Every SPH op the streaming engine ran in list mode before, with its
    precombined fields on the state's plain list-mode chain (density,
    grad-h, IAD); with ``forces`` also the ops that took the walk already
    (std momentum; the AV switches and VE momentum, both forms)."""
    x, y, z, h, m, vel = ss.x, ss.y, ss.z, ss.h, ss.m, (ss.vx, ss.vy, ss.vz)
    consts = pe.op_consts(const)
    (rho,), nc = pe.engine_lists_plain(pe.DENSITY, lists, *pe.density_fields(x, y, z, h, m),
                                       group, consts)
    xm = m / rho
    (kx, gradh), _ = pe.engine_lists_plain(
        pe.VE_DEF_GRADH, lists, *pe.ve_def_gradh_fields(x, y, z, h, m, xm), group, consts)
    cs, _ = pe.engine_lists_plain(pe.IAD, lists, *pe.iad_fields(x, y, z, h, xm / kx), group,
                                  consts)
    divv = pe.divv_curlv_fields(x, y, z, *vel, h, kx, xm, *cs, const)
    out = {
        "density": (pe.DENSITY, pe.density_fields(x, y, z, h, m)),
        "iad": (pe.IAD, pe.iad_fields(x, y, z, h, xm / kx)),
        "ve_def_gradh": (pe.VE_DEF_GRADH, pe.ve_def_gradh_fields(x, y, z, h, m, xm)),
        "iad_divv_curlv": (pe.IAD_DIVV_CURLV, divv),
        "iad_divv_curlv_gradv": (pe.IAD_DIVV_CURLV_GRADV, divv),
    }
    if forces:
        p, c = compute_eos_std(ss.temp, rho, const)
        cs_std, _ = pe.engine_lists_plain(pe.IAD, lists, *pe.iad_fields(x, y, z, h, m / rho),
                                          group, consts)
        out["momentum_energy_std"] = (pe.momentum_spec(const), pe.momentum_fields(
            x, y, z, *vel, h, m, rho, p, c, *cs_std))
        prho, cv, _, _ = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
        dv, _ = pe.engine_lists_plain(pe.IAD_DIVV_CURLV_GRADV, lists, *divv, group, consts)
        out["av_switches"] = (pe.AV_SWITCHES, pe.av_switches_fields(
            x, y, z, *vel, h, cv, kx, xm, dv[0], ss.alpha, *cs, const))
        for key, gradv in (("momentum_energy_ve", None),
                           ("momentum_energy_ve_clean", tuple(dv[2:]))):
            out[key] = (pe.momentum_ve_spec(const, gradv is not None), pe.momentum_ve_fields(
                x, y, z, *vel, h, m, prho, cv, kx, xm, ss.alpha, *cs, nc=nc, gradv=gradv))
    return out


WALK_OPS = ["density", "iad", "ve_def_gradh", "iad_divv_curlv", "iad_divv_curlv_gradv"]


@pytest.mark.parametrize("op", WALK_OPS)
def test_list_walk_entry_matches_plain(list_case, op):
    """The list walk's entry points of the ops the streaming engine ran in
    list mode before (``launch_{density,iad,ve_def_gradh}_lists`` and
    both forms of ``launch_iad_divv_curlv_lists``) against the plain list
    walk on the same fields: nc exact, the outputs within the JAX
    package's tolerances (rtol 1e-5 density, 1e-4 the rest, atol 1e-5
    max|.|)."""
    ss, box, const, cfg, keys, lists, _ = list_case
    spec, (i_f, j_f) = _walk_fields(ss, const, lists, cfg.nbr.group)[op]
    consts = pe.op_consts(const)
    pe.reset_launches()
    out_k, nc_k = pe.engine_lists_kernel(spec, lists, i_f, j_f, cfg.nbr.group, consts)
    out_p, nc_p = pe.engine_lists_plain(spec, lists, i_f, j_f, cfg.nbr.group, consts)
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), f"{spec.name}_lists": 1}
    if spec.want_nc:
        assert torch.equal(nc_k, nc_p)
    rtol = 1e-5 if op == "density" else 1e-4
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("op", WALK_OPS + ["momentum_energy_std", "av_switches",
                                           "momentum_energy_ve", "momentum_energy_ve_clean"])
def test_list_walk_mask_modes_agree(list_case, op):
    """Each list-walk op with its own mask phase (mask="own") and reading
    the words a density walk kept at the same positions (mask="read";
    density itself: "own" against "write") gives the same outputs bit for
    bit: the same pairs in the same order."""
    ss, box, const, cfg, keys, lists, _ = list_case
    g = cfg.nbr.group
    ops = _walk_fields(ss, const, lists, g, forces=True)
    dt = torch.as_tensor(ss.min_dt, dtype=torch.float32, device=ss.x.device)
    consts = {**pe.op_consts(const), "dt": dt}
    spec, (i_f, j_f) = ops[op]
    own, nc_own = pe.engine_lists_kernel(spec, lists, i_f, j_f, g, consts, mask="own")
    d_spec, (d_i, d_j) = ops["density"]
    _, nc_w = pe.engine_lists_kernel(d_spec, lists, d_i, d_j, g, consts, mask="write")
    if spec.want_nc:
        kept, nc_kept = pe.engine_lists_kernel(spec, lists, i_f, j_f, g, consts, mask="write")
        assert torch.equal(nc_kept, nc_own) and torch.equal(nc_w, nc_own)
    else:
        kept, _ = pe.engine_lists_kernel(spec, lists, i_f, j_f, g, consts, mask="read")
    for a, b in zip(kept, own):
        assert torch.equal(a, b), op


def test_kernel_info_reports_occupancy():
    """The engines' static facts: every SPH instantiation has registers, the
    window of 256 candidates and at least one resident block of 64
    threads per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    specs = (pe.DENSITY, pe.IAD, pe.MOMENTUM_ENERGY_STD, pe.VE_DEF_GRADH, pe.IAD_DIVV_CURLV,
             pe.IAD_DIVV_CURLV_GRADV, pe.AV_SWITCHES, pe.MOMENTUM_ENERGY_VE,
             pe.MOMENTUM_ENERGY_VE_CLEAN)
    for spec in specs:
        for walk in (True, False):
            info = pe.kernel_info(spec, 64, walk)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, (spec.name, info)
            assert info["window"] == 256
            assert info["warps_per_sm"] == 2 * info["blocks_per_sm"]


def test_ve_simulation_step_matches_cpu():
    """One list-mode VE Simulation step on the card against the same step
    on the CPU (jittered Sedov 30: periodic, per-run shifts), from the same
    input; the accelerations' tolerance carried through the integrator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    fields, box, const = state_to_numpy(*init_sedov(30, device="cpu"))
    args = state_from_numpy(jitter_sedov(fields, 30, seed=30), box, const, device="cpu")
    cpu = Simulation(*args, prop="ve", device="cpu")
    gpu = Simulation(*args, prop="ve", device="cuda")
    dc, dg = cpu.step(), gpu.step()
    assert gpu.lists is not None and dg["use_lists"] == dc["use_lists"] == 1.0
    for k in ("nc_max", "nc_sum", "occupancy"):
        assert dg[k] == dc[k], k
    for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha"):
        a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-6 * float(b.abs().max()))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def test_gravity_compact_matches_plain():
    _need_card()
    pe.reset_launches()
    checks.compact_random_cases("cuda")
    assert pe.LAUNCHES["compact_class_lists"] == 2 * len(checks.COMPACT_CASES)


@pytest.mark.parametrize("form", ["open_box", "image_self", "image_noself"])
def test_gravity_near_field_matches_plain(form):
    """K12 on Evrard 20's leaf ranges against its plain version, every
    block: the open-box call, and an image's (a shift) with the self pair
    kept and dropped (at a shift the self pair is a real pair, so the
    kernel's self test shows)."""
    _need_card()
    from sphexa_torch.gravity import traversal as gt

    sim, ss, box, keys = checks.gravity_case(20, "cuda")
    starts, lens, _ = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                               sim.cfg.grav_meta, sim.cfg.gravity)
    image = form != "open_box"
    pe.reset_launches()
    checks.p2p_vs_plain("Evrard 20", ss.x, ss.y, ss.z, ss.m, ss.h, sim.cfg.gravity, starts,
                        lens, shift=checks.IMAGE_SHIFT if image else None,
                        allow_self=form == "image_self")
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), "gravity_p2p": 1}


def test_gravity_near_field_subset_matches_plain():
    """K12 against its plain version on a subset of Evrard 20's blocks
    (the plain version with the other blocks' leaf lengths zeroed), as the
    Evrard 125 check compares 256 of its blocks."""
    _need_card()
    sim, ss, box, keys = checks.gravity_case(20, "cuda")
    starts, lens, _ = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                               sim.cfg.grav_meta, sim.cfg.gravity)
    groups = torch.arange(0, lens.shape[0], 3, device="cuda")
    res = checks.p2p_vs_plain("Evrard 20 subset", ss.x, ss.y, ss.z, ss.m, ss.h,
                              sim.cfg.gravity, starts, lens, groups=groups)
    assert 0 < res["targets"] < ss.x.shape[0]


def test_gravity_launchers_repeat_the_wrappers():
    """The launchers that time K12 and K13 alone (``traversal.p2p_launcher``,
    ``pallas_compact.compact_launcher``) launch the same kernels on the
    same arguments as the wrappers: bit-equal outputs, and no count."""
    _need_card()
    from sphexa_torch.gravity import pallas_compact as pcmp
    from sphexa_torch.gravity import traversal as gt

    sim, ss, box, keys = checks.gravity_case(20, "cuda")
    starts, lens, _ = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                               sim.cfg.grav_meta, sim.cfg.gravity)
    args = (ss.x, ss.y, ss.z, ss.m, ss.h, torch.zeros(3, device="cuda"), False,
            sim.cfg.gravity, starts, lens)
    packed = torch.randint(0, 3 << pcmp.IDX_BITS, (37, 2053), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7)).cuda()
    pe.reset_launches()
    want = gt._pallas_p2p(*args), pcmp.compact_class_lists(packed, 100, 300)
    launch_p2p, got_p2p = gt.p2p_launcher(*args)
    launch_cmp, got_cmp = pcmp.compact_launcher(packed, 100, 300)
    for _ in range(2):
        launch_p2p()
        launch_cmp()
    for a, b in zip(want[0] + want[1], got_p2p + got_cmp):
        assert torch.equal(a, b)
    assert pe.LAUNCHES == {**dict.fromkeys(pe.LAUNCHES, 0), "gravity_p2p": 1,
                           "compact_class_lists": 1}


def test_gravity_solve_skips_the_run_merge(monkeypatch):
    """On the card a solve hands K12 the leaf ranges as they are: neither
    the near-field run merge nor the engines' run merge runs."""
    _need_card()
    from sphexa_torch.gravity import traversal as gt

    sim, ss, box, keys = checks.gravity_case(20, "cuda")

    def refuse(*_args, **_kw):
        raise AssertionError("the run merge ran on the card's path")

    monkeypatch.setattr(gt, "p2p_runs", refuse)
    monkeypatch.setattr(pe, "_merge_runs", refuse)
    pe.reset_launches()
    out = gt.compute_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree,
                             sim.cfg.grav_meta, sim.cfg.gravity)
    assert pe.LAUNCHES["gravity_p2p"] == 1
    assert all(bool(torch.isfinite(a).all()) for a in out[:3])


def test_gravity_near_field_kernel_info():
    """K12's static facts at the two target blocks the solver uses (64
    below 500k particles, 256 above): registers without spills, the tile,
    resident warps."""
    _need_card()
    from sphexa_torch.gravity import traversal as gt

    for blk in (64, 256):
        info = gt.p2p_kernel_info(blk)
        assert info["registers"] > 0 and info["local_bytes"] == 0, info
        assert info["blocks_per_sm"] >= 1 and info["window"] == 256, info
        assert info["warps_per_sm"] == info["blocks_per_sm"] * blk // (
            32 * info["targets_per_thread"])


@pytest.mark.parametrize("compaction", ["sort", "bitmask_sf8"])
def test_gravity_solve_matches_cpu(compaction):
    _need_card()
    sim, ss, box, keys = checks.gravity_case(30, "cuda")
    cfg = sim.cfg.gravity
    if compaction == "bitmask_sf8":
        cfg = dataclasses.replace(cfg, compaction="bitmask", super_factor=8,
                                  super_cap=sim.cfg.grav_meta.num_nodes)
    checks.gravity_vs_cpu(f"Evrard 30 {compaction}", ss.x, ss.y, ss.z, ss.m, ss.h, keys, box,
                          sim.gtree, sim.cfg.grav_meta, cfg)


def test_ve_evrard_step_matches_cpu():
    """One VE Evrard 20 Simulation step with gravity on the card against
    the same step on the CPU, from the same input."""
    _need_card()
    from sphexa_torch.init import init_evrard

    cpu = Simulation(*init_evrard(20, device="cpu"), prop="ve", device="cpu")
    gpu = Simulation(*init_evrard(20, device="cpu"), prop="ve", device="cuda")
    pe.reset_launches()
    dc, dg = cpu.step(), gpu.step()
    for k in ("nc_max", "nc_sum", "occupancy"):
        assert dg[k] == dc[k], k
    assert dg["egrav"] == pytest.approx(dc["egrav"], rel=1e-4)
    assert pe.LAUNCHES["gravity_p2p"] == 1
    for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "alpha"):
        a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-6 * float(b.abs().max()))


# -- deferred check windows on the card (kernels/deferred_checks.py, shared
# with chip_smoke.py's deferred_checks phase, here at small sizes) ----------


def test_deferred_cap_rollback_on_card():
    """The cap forced to 8 in a window of 5 (Sedov 12): rollback, re-size
    and replay to a clean run's state within rel 1e-6."""
    _need_card()
    from sphexa_torch.kernels import deferred_checks

    deferred_checks.cap_rollback(12, "cuda")


def test_deferred_h_growth_on_card():
    """h x 4 before a window of 4 (Sedov 32, the JAX test's case): the
    windows' kernels run on a too-small search window without a fault,
    and the replay matches a run sized for the grown h."""
    _need_card()
    from sphexa_torch.kernels import deferred_checks

    deferred_checks.h_growth_rollback(32, "cuda", window=4)


def test_deferred_matches_checked_on_card():
    """Streaming Sedov 12, check_every 4 against 1: bit for bit."""
    _need_card()
    from sphexa_torch.kernels import deferred_checks

    deferred_checks.matches_sync(12, "cuda")


def test_deferred_ve_list_window_replays_on_card():
    """VE list mode (Sedov 30): a window on stale lists rolls back on
    list-expiry and replays."""
    _need_card()
    from sphexa_torch.kernels import deferred_checks

    deferred_checks.list_expiry_replay(30, "cuda", prop="ve")


def test_deferred_happy_window_syncs_once_on_card():
    """Std list mode (Sedov 30, check_every 4): a window without a list
    build or a rollback reads the card exactly once (its flush), and its
    launches before the flush run under the "error" sync debug mode."""
    _need_card()
    from sphexa_torch.kernels import deferred_checks
    from sphexa_torch.observables import ObservableSpec

    sim = Simulation(*init_sedov(30, device="cuda"), device="cuda", check_every=4,
                     obs_spec=ObservableSpec())
    for _ in range(4):
        sim.step()
    windows = [deferred_checks.window_syncs(sim) for _ in range(3)]
    happy = [w for w in windows if not w["rebuilds"] and not w["rollbacks"]]
    assert happy and all(w["syncs"] == 1 for w in happy), windows


def test_dump_and_restart_on_card(tmp_path):
    """Noh 16 in list mode on the card, dumped (.npz) at step 3: the state
    read back bit for bit, the restarted run's first step to the JAX
    package's restart contract and its fields within the restart bound at
    step 8 (``io_checks.restart_vs_unbroken``)."""
    _need_card()
    from sphexa_torch.kernels import io_checks

    r = io_checks.restart_vs_unbroken("noh", 16, "cuda", str(tmp_path), dump_at=3, to_step=8)
    assert r["restored"][0].x.is_cuda and r["first_step"]["dt_rel"] <= 1e-6


@pytest.mark.parametrize("pipeline", ["std", "ve"])
def test_output_fields_match_plain_on_card(case, pipeline):
    """The output fields through K1 (std: density; VE: xmass, grad-h)
    against their plain versions on the card, rho, p and c rtol 1e-5; the
    kernels launched."""
    from sphexa_torch.kernels import io_checks

    ss, box, const, nbr, keys, ranges = case
    cfg = make_propagator_config(ss, box, const)
    cfg = dataclasses.replace(cfg, nbr=nbr)
    pe.reset_launches()
    io_checks.output_fields_vs_plain("sedov", ss, box, cfg, pipeline)
    assert pe.LAUNCHES["density"] == 1
    assert pe.LAUNCHES["ve_def_gradh"] == (1 if pipeline == "ve" else 0)


#: L1_rho of std Sedov side 30 after 200 steps (check_every 10) on the CPU,
#: the plain versions (``io_checks.l1_reference``; about 25 minutes there,
#: so it is not a CPU test)
SEDOV_30_L1_RHO = 0.40987546084938403


def test_sedov_l1_side_30_on_card():
    """Std Sedov side 30, 200 steps in windows of 10 on the card: the
    drift within the reference configuration's 1e-3, and L1_rho against
    the Sedov solution the CPU's (the plain versions, ``SEDOV_30_L1_RHO``)
    within rel 1e-3: the two differ by summation orders over 200 steps."""
    _need_card()
    from sphexa_torch.kernels import io_checks

    r = io_checks.l1_reference("sedov", "std", 30, steps=200, device="cuda")
    assert r["drift"] < 1e-3
    assert r["l1_rho"] == pytest.approx(SEDOV_30_L1_RHO, rel=1e-3), r


# -- the rest of gravity on the card: N-body, Ewald, spherical ---------------


@pytest.mark.parametrize("case", ["evrard", "plummer"])
def test_nbody_step_matches_cpu(case):
    """One N-body Simulation step on the card against the same step on the
    CPU (Evrard 20; a 20,000-particle Plummer sphere): K12 once and K13
    never (the sort compaction below 500k), the fields within the near
    field's tolerance carried through the integrator."""
    _need_card()
    from sphexa_torch.init import init_evrard
    from sphexa_torch.init.plummer import plummer_state

    make = {"evrard": lambda d: init_evrard(20, device=d),
            "plummer": lambda d: plummer_state(20_000, device=d)}[case]
    cpu = Simulation(*make("cpu"), prop="nbody", device="cpu")
    gpu = Simulation(*make("cpu"), prop="nbody", device="cuda")
    pe.reset_launches()
    dc, dg = cpu.step(), gpu.step()
    assert pe.LAUNCHES["gravity_p2p"] == 1 and pe.LAUNCHES["compact_class_lists"] == 0
    assert dg["egrav"] == pytest.approx(dc["egrav"], rel=1e-4)
    assert dg["dt"] == pytest.approx(dc["dt"], rel=1e-4)
    for f in ("x", "y", "z", "vx", "vy", "vz"):
        a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-6 * float(b.abs().max()))


def test_ewald_solve_matches_cpu():
    """A periodic solve (4,096 particles uniform in the unit cube, G 0.5)
    on the card against the CPU from the card's multipoles
    (``checks.ewald_vs_cpu``): 27 K12 launches, forces at the near field's
    tolerance, egrav rel 1e-4, the folded diagnostics equal."""
    _need_card()
    r = checks.ewald_vs_cpu("random 4096")
    assert r["k12_launches"] == 27


@pytest.mark.parametrize("order", [4, 6])
def test_spherical_solve_matches_cpu(order):
    """An order-P solve (Evrard 20) on the card against the CPU from the
    card's multipoles: the autograd M2P forces at rtol 1e-4."""
    _need_card()
    from sphexa_torch.gravity import traversal as gt

    sim, ss, box, keys = checks.gravity_case(20, "cuda")
    cfg = dataclasses.replace(sim.cfg.gravity, multipole_order=order)
    mps = gt.compute_multipoles(ss.x, ss.y, ss.z, ss.m, keys, sim.gtree, sim.cfg.grav_meta,
                                order=order)
    og = gt.compute_gravity(ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, sim.gtree,
                            sim.cfg.grav_meta, cfg, multipoles=mps)
    cpu = [a.cpu() for a in (ss.x, ss.y, ss.z, ss.m, ss.h, keys)]
    oc = gt.compute_gravity(*cpu, box.to("cpu"), sim.gtree.to("cpu"), sim.cfg.grav_meta, cfg,
                            multipoles=tuple(a.cpu() for a in mps))
    for a, b in zip(og[:3], oc[:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=checks.P2P_ATOL * float(
            b.abs().max()))


# -- the turb-ve and std-cooling paths (kernels/aux_checks.py, shared with
# chip_smoke.py's turb_cooling_vs_cpu and turb_cli phases) -----------------


def test_turb_ve_steps_match_cpu():
    """Two list-mode turb-ve steps (turbulence 16, ng0 20) on the card
    against the CPU: the fields within the VE tolerance, the stirring key
    bit for bit, the phases within 5e-5 of their scale."""
    _need_card()
    from sphexa_torch.kernels import aux_checks

    r = aux_checks.aux_slice_vs_cpu("turb-ve", "turbulence", 16, 2, device="cuda",
                                    overrides={"ng0": 20, "ngmax": 70})
    assert r["use_lists"] == 1.0


@pytest.mark.parametrize("evolve", [False, True])
def test_cooling_steps_match_cpu(evolve):
    """Two std-cooling steps with self-gravity (evrard-cooling 12) on the
    card against the CPU, CIE (the chemistry permuted exactly) and the
    evolved network."""
    _need_card()
    from sphexa_torch.kernels import aux_checks

    aux_checks.aux_slice_vs_cpu("std-cooling", "evrard-cooling", 12, 2, device="cuda",
                                evolve=evolve)


def test_turb_draw_reaches_the_card_bit_for_bit():
    """The OU draw made on the host reaches the card unchanged (one copy
    from pinned memory), and a turb-ve step's key moves as the host's."""
    _need_card()
    import numpy as np

    from sphexa_torch.sph import hydro_turb as ht
    from sphexa_torch.sph import threefry

    _, sub = threefry.split(threefry.prng_key(251299))
    z = threefry.normal(sub, (112, 3, 2))
    card = ht._to_device(z, torch.device("cuda"))
    assert card.is_cuda and np.array_equal(card.cpu().numpy().view(np.uint32),
                                           z.view(np.uint32))


def test_turb_restart_on_card(tmp_path):
    """turb-ve (turbulence 12) dumped at step 2 and restarted on the card:
    the stirring state read back bit for bit, the first restarted step to
    the restart contract, the CLI restarted with --prop turb-ve."""
    _need_card()
    from sphexa_torch.kernels import aux_checks

    r = aux_checks.turb_restart(12, "cuda", str(tmp_path))
    assert r["cli"]["rows"] == [3, 4]


# -- the kernel families, K13's one-row form and the block time steps
# (kernels/checks.py, shared with chip_smoke.py's kernel_family and
# blockdt_path phases) ------------------------------------------------------


@pytest.mark.parametrize("kind,sinc_index", [("wendland-c6", 6.0), ("sinc", 5.0)])
def test_kernel_family_ops_match_plain(case, kind, sinc_index):
    """Every std and VE op of the streaming engine K1 with wendland-c6 (its
    20-coefficient form) and with sinc at index 5, against its plain
    version (nc exact, the JAX package's tolerances)."""
    ss, box, const, nbr, keys, ranges = case
    const = const.with_kernel(kind, sinc_index)
    res = checks.family_vs_plain(f"{kind} K1", ss, box, const, nbr, keys=keys, ranges=ranges)
    assert "momentum_energy_ve:av_clean" in res and "density" in res


@pytest.mark.parametrize("kind,sinc_index", [("wendland-c6", 6.0), ("sinc", 5.0)])
def test_kernel_family_walks_match_plain(kind, sinc_index):
    """The list walk K6 of every op in both forms, on Sedov 30's lists."""
    _need_card()
    fields, box, const = state_to_numpy(*init_sedov(30, device="cpu"))
    state, box, const = state_from_numpy(jitter_sedov(fields, 30, seed=30), box, const,
                                         device="cuda")
    cfg = make_propagator_config(state, box, const, use_lists=True)
    ss, box, lists = rebuild_pair_lists(state, box, cfg)
    const = const.with_kernel(kind, sinc_index)
    res = checks.family_vs_plain(f"{kind} K6", ss, box, const, cfg.nbr, lists=lists)
    assert "momentum_energy_std_lists" in res


def test_compact_row_form_matches_plain():
    """K13's one-row form (the block time steps' due rows) bit for bit its
    plain version, rows off the 16-byte words included."""
    _need_card()
    assert len(checks.compact_row_cases("cuda")) == len(checks.COMPACT_ROW_CASES)


@pytest.mark.parametrize("case_name,side,prop", [("sedov", 12, "std"), ("sedov", 12, "ve"),
                                                 ("evrard", 12, "std")])
def test_blockdt_substeps_match_cpu(case_name, side, prop):
    """Block-time-step substeps at dt_bins 3 on the card against the CPU."""
    _need_card()
    r = checks.blockdt_vs_cpu(case_name, side, 5, dt_bins=3, prop=prop)
    assert sum(r["active"]) > 0


# ---------------------------------------------------------------------------
# the sharded steps on the card (-k sharded): two gloo ranks share it
# ---------------------------------------------------------------------------


def _sharded_flat(side=24, seed=24):
    fields, box, const = state_to_numpy(*init_sedov(side, device="cpu"))
    return jitter_sedov(fields, side, seed=seed), box, const


def test_sharded_jdata_kernels_match_plain(tmp_path):
    """K1's jdata form (j-fields [own slab | halo rows], runs past the
    slab) of every std and VE op on two ranks of one card against its
    plain version, nc exact (kernels/sharded_checks.py)."""
    _need_card()
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.parallel.mesh import spawn

    cases = [("std", False), ("ve", False), ("ve", True)]
    out = spawn(sc.rank_jdata, 2, args=(_sharded_flat(), cases, 16), workdir=str(tmp_path),
                backend="gloo", timeout=600)
    for res in out:
        for case in cases:
            stage = res[case]["stage"]
            assert stage["jbuf_rows"] > stage["slab_rows"], stage  # halo rows were read


def test_sharded_step_two_ranks_on_one_card(tmp_path):
    """One std and one VE step over two gloo ranks on the card against the
    one-device step on the card from the same state (tests/test_parallel.py's
    tolerances, h and the neighbour total exact)."""
    _need_card()
    import numpy as np

    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.parallel.mesh import spawn
    from sphexa_torch.propagator import _step_hydro_std, _step_hydro_ve

    flat = _sharded_flat()
    cases = [("std", False, "sparse"), ("ve", False, "windowed")]
    out = spawn(sc.rank_steps, 2, args=(flat, cases, 16), workdir=str(tmp_path),
                backend="gloo", timeout=600)
    state, box, const = state_from_numpy(*flat, device="cuda")
    cfg = make_propagator_config(state, box, const, cell_target=16)
    for prop, _, mode in cases:
        fn = _step_hydro_std if prop == "std" else _step_hydro_ve
        s, _, d = fn(state, box, cfg)
        res = [o[(prop, False, mode)] for o in out]
        x = np.concatenate([r["x"] for r in res])
        np.testing.assert_allclose(x, s.x.cpu().numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.concatenate([r["temp"] for r in res]),
                                   s.temp.cpu().numpy(), rtol=1e-4)
        np.testing.assert_array_equal(np.concatenate([r["h"] for r in res]), s.h.cpu().numpy())
        assert res[0]["nc_sum"] == float(d["nc_sum"])
        np.testing.assert_allclose(res[0]["dt"], float(d["dt"]), rtol=1e-5)


def _evrard_flat(side=20):
    from sphexa_torch.init import init_evrard

    state, box, const = init_evrard(side, device="cpu")
    n = state.n // 2 * 2
    state = dataclasses.replace(state, **{f.name: getattr(state, f.name)[:n]
                                          for f in dataclasses.fields(state)
                                          if getattr(state, f.name).dim() == 1})
    return state_to_numpy(state, box, const)


def test_p2p_jdata_matches_plain(tmp_path):
    """K12's jdata form: the targets' own arrays as its j-buffer give the
    one-device launch's outputs bit for bit; on two ranks of the card, a
    rank's served [own slab | halo rows] within the near field's tolerance
    of the plain version, open and with an image shift and the self pair."""
    _need_card()
    from sphexa_torch.gravity import traversal as gt
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.parallel.mesh import spawn

    sim = Simulation(*state_from_numpy(*_evrard_flat(), device="cuda"), prop="ve",
                     device="cuda")
    ss, box, keys, _ = _force_stage_prologue(sim.state, sim.box, sim.cfg)
    cfg = dataclasses.replace(sim.cfg.gravity, G=sim.const.g)
    starts, lens, _ = checks.near_field_ranges(ss.x, ss.y, ss.z, ss.m, keys, box, sim.gtree,
                                               sim.cfg.grav_meta, cfg)
    own = (ss.x, ss.y, ss.z, ss.m, ss.h)
    z3 = torch.zeros(3, device="cuda")
    ref = gt._pallas_p2p(*own, z3, False, cfg, starts, lens)
    got = gt._pallas_p2p(*own, z3, False, cfg, starts, lens, jdata=own)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    out = spawn(sc.rank_p2p_jdata, 2, args=(_evrard_flat(),), workdir=str(tmp_path),
                backend="gloo", timeout=600)
    for res in out:
        for case in ("open", "image"):
            assert res[case]["halo_rows"] > 0, res[case]


def test_sharded_gravity_two_ranks_on_one_card(tmp_path):
    """One VE Evrard step with self-gravity over two gloo ranks on the card
    (the sparse gravity serve) against the one-device step on the card from
    the same state (tests/test_parallel.py's tolerances: vx rtol 1e-2, atol
    5e-4, egrav rtol 1e-4), every high-water mark within its cap; and the
    sharded Ewald solve against the one-device one."""
    _need_card()
    import numpy as np

    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.parallel.mesh import spawn

    flat = _evrard_flat()
    out = spawn(sc.rank_gravity_steps, 2, args=([(flat, {"prop": "ve"}, 1)],),
                workdir=str(tmp_path / "steps"), backend="gloo", timeout=600)
    sim = Simulation(*state_from_numpy(*flat, device="cuda"), prop="ve", device="cuda")
    d = sim.step()
    res = [o[0] for o in out]
    vx = np.concatenate([r["vx"] for r in res])
    np.testing.assert_allclose(vx, sim.state.vx.cpu().numpy(), rtol=1e-2, atol=5e-4)
    np.testing.assert_allclose(res[0]["diag"]["egrav"], d["egrav"], rtol=1e-4)
    g = res[0]["gravity"]
    assert res[0]["diag"]["p2p_max"] <= g["p2p_cap"]
    assert 0 < res[0]["diag"]["let_max"] <= g["let_cap"]
    assert res[0]["grav_halo"]["mode"] == "sparse"
    ew = spawn(sc.ewald_mesh_vs_one_device, 2, workdir=str(tmp_path / "ewald"),
               backend="gloo", timeout=600)
    assert all(r["k12_launches"] == 27 for r in ew)


def test_sharded_props_two_ranks_on_one_card(tmp_path):
    """turb-ve (Sedov 16, 200 modes), N-body (Evrard 16) and block time
    steps (Sedov 16 from a Courant-limited start, dt_bins 4, a cycle)
    over two gloo ranks on the card, each path's last step held to the
    one-device step on the card from the gathered input
    (``sharded_checks.props_vs_one_device``: the key and the bins equal,
    the block counts exact, the fields within the mesh tests'
    tolerances), K13's one-row form once per substep attempt and on each
    rank's due masks bit for bit its plain version, K12 once per N-body
    step attempt (below 500,000 rows the sort compaction runs: no K13)."""
    _need_card()
    from sphexa_torch.kernels import sharded_checks as sc
    from sphexa_torch.parallel.mesh import spawn

    out = spawn(sc.rank_props_card, 2, workdir=str(tmp_path), backend="gloo", timeout=900)
    for res in out:
        b = res["blockdt"]
        assert b["launches"]["compact_row"] == b["attempts"]
        assert all(c["max_abs_err"] == 0.0 for c in b["compact_row"])
        assert b["compact_row"][1]["due"] == b["slab"]  # the cycle's end: every row
        nb = res["nbody"]
        assert nb["launches"]["gravity_p2p"] == nb["attempts"]
        assert nb["halo"] == {}
        assert res["turb-ve"]["launches"]["momentum_energy_ve"] == res["turb-ve"]["attempts"]
    for name in ("turb-ve", "nbody", "blockdt"):
        assert "vs_one_device" in out[0][name], name
    assert any(d["bdt_active"] > 0 for d in out[0]["blockdt"]["diags"])


def test_app_shell_deposit_vs_plain():
    """The snapshot deposit on the card (Sedov 30 after a step) against the
    plain numpy deposit of the same state: sums within rtol 1e-5 of the
    grid's max on each axis and the volume, "max" exact
    (``app_checks.deposit_vs_plain``)."""
    _need_card()
    from sphexa_torch.kernels import app_checks as ac
    from sphexa_torch.observables.snapshot import SnapshotSpec

    sim = Simulation(*init_sedov(30, device="cuda"), device="cuda")
    sim.step()
    s = sim.state
    rho = s.m / (s.h * s.h * s.h)
    for kw in (dict(axis=0), dict(axis=1), dict(axis=2), dict(reduce="max"),
               dict(volume=True, grid=16)):
        spec = SnapshotSpec(**{"fields": ("rho", "temp"), "grid": 64, **kw})
        ac.deposit_vs_plain(f"Sedov 30 {kw}", s, rho, sim.box, spec)


def test_app_shell_frames_and_debug_checks():
    """A deferred run on the card with snapshots: frames at the window's
    flush, one read a window (``deferred_checks.window_syncs``, the
    launches before the flush with syncs raising), equal to the run
    without snapshots; the debug checks on the card
    (``app_checks.debug_checks_case``)."""
    _need_card()
    from sphexa_torch.kernels import app_checks as ac
    from sphexa_torch.kernels.deferred_checks import window_syncs
    from sphexa_torch.observables.snapshot import SnapshotSpec

    syncs = {}
    for snap in (None, SnapshotSpec(fields=("rho", "temp"), grid=32)):
        sim = Simulation(*init_sedov(30, device="cuda"), device="cuda", check_every=4,
                         snap_spec=snap)
        for _ in range(4):
            sim.step()
        syncs[snap is not None] = window_syncs(sim)
        if snap is not None:
            assert sim._last_diag["snap_grid"].shape == (2, 32, 32)
    assert syncs[True]["syncs"] == syncs[False]["syncs"], syncs
    ac.debug_checks_case(12, "cuda")


def test_app_shell_substeps_launch_k1():
    """``substep_breakdown`` on the card launches K1's streaming op of each
    stage 1 + iters times (std and VE, Sedov 20)."""
    _need_card()
    from sphexa_torch.kernels import app_checks as ac

    for prop in ("std", "ve"):
        sim = Simulation(*init_sedov(20, device="cuda"), prop=prop, device="cuda")
        sim.step()
        out = ac.substep_launches(sim, iters=2)
        assert all(v >= 0.0 for v in out["ms"].values())


def test_app_shell_trace_attribution(tmp_path):
    """The CLI's --trace-dir on the card (Sedov 30, 3 steps, list mode):
    the kernels' device time attributed to the step's phases, coverage at
    least 0.8 (the JAX package's gate)."""
    _need_card()
    from sphexa_torch.app.main import main
    from sphexa_torch.telemetry.traceview import summarize_trace

    assert main(["--init", "sedov", "-n", "30", "-s", "3", "--quiet", "-o", str(tmp_path),
                 "--trace-dir", str(tmp_path / "trace")]) == 0
    s = summarize_trace(str(tmp_path / "trace"))
    assert s["device"] == "cuda" and s["coverage"] >= 0.8, s


def test_gather_card_vs_cpu_and_engine():
    """The gather backend on the card (kernels/gather_checks.py): the
    search of a truncating jittered Sedov 16 (ngmax 40) bit for bit the
    CPU's, the density rtol 1e-6; one gather force stage against the
    engine's (K1) on Sedov 20, where no row is truncated; a gather step
    launches no kernel."""
    _need_card()
    from sphexa_torch.kernels import gather_checks as gc

    r = gc.card_vs_cpu(16, 40)
    assert r["bits_equal"] and r["truncated_rows"] == r["n"]
    gc.vs_engine(*init_sedov(20, device="cuda"))
    pe.reset_launches()
    sim = Simulation(*init_sedov(20, device="cuda"), device="cuda", backend="xla")
    sim.step()
    assert not any(pe.LAUNCHES.values()), pe.LAUNCHES


def test_sharded_gather_two_ranks_on_one_card(tmp_path):
    """The gather backend over two gloo ranks on the card
    (``sharded_gather_checks.rank_gather_card`` at Sedov 30 and 16): the
    ranks' lists of a jittered, truncating Sedov 16 (ngmax 40, slabs that
    end in partial groups) as global rows equal the one-card
    ``find_neighbors`` bit for bit; std Sedov 30 at ngmax 150, the last
    step's h bit for bit and nc_sum, nc_max, the occupancy and the
    truncated-row count equal to the one-card gather step's from the
    gathered input, the fields within tests/test_torch_gather_slice.py's
    tolerances; no kernel launch on any rank."""
    _need_card()
    from sphexa_torch.kernels import sharded_gather_checks as sgc
    from sphexa_torch.parallel.mesh import spawn

    out = spawn(sgc.rank_gather_card, 2, args=(30, 2, 150, 16, 40), workdir=str(tmp_path),
                backend="gloo", timeout=900)
    for res in out:
        assert not any(res["path"]["launches"].values())
        assert res["path"]["halo"]["mode"] == "sparse"
    assert out[0]["truncation"]["bits_equal"]
    assert out[0]["truncation"]["truncated_rows"] == out[0]["truncation"]["n"]
    assert out[0]["path"]["vs_one_device"]["h_equal"]


# -- the tuned knobs' kernel shapes (kernels/tuning_checks.py, shared with
# chip_smoke.py's tuning_path phase) ------------------------------------------


def test_tuning_engine_shapes_match_plain():
    """K1's std ops at group 32 / 64 / 128 and at run_cap 1024 / 2048 x gap
    128 / 512; the list build (K5, bit for bit) and the walks (K6) at the
    three groups and at list_skin_rel 0.1 / 0.3; each against its plain
    version on the jittered Sedov 40, with chip_smoke's tolerances."""
    _need_card()
    from sphexa_torch.kernels import tuning_checks

    res = tuning_checks.engine_shapes("cuda")
    assert len(res) == 2 * len(tuning_checks.GROUPS) + len(tuning_checks.RUN_CAPS) * len(
        tuning_checks.GAPS) + len(tuning_checks.SKINS)
    assert all(r["mark"]["bits_equal"] for k, r in res.items() if k.endswith(":lists"))


def test_tuning_gravity_shapes_match_plain():
    """K12 and K13 at target_block 128 / 256 x super_factor 0 / 4 / 16 on
    the solves the tuned Simulation configures (VE Evrard 30)."""
    _need_card()
    from sphexa_torch.kernels import tuning_checks

    res = tuning_checks.gravity_shapes("cuda")
    assert len(res) == len(tuning_checks.TARGET_BLOCKS) * len(tuning_checks.SUPER_FACTORS)
    for key, r in res.items():
        assert r["compaction"] == ("sort" if key.endswith("=0") else "bitmask")
