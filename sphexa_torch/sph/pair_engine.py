"""SPH pair ops with the neighbour search fused in: the candidate-run
prologue (torch) and the std-SPH and VE pair ops, each a hand-written CUDA
kernel with a plain PyTorch version beside it.

Counterpart of sphexa_tpu/sph/pallas_pairs.py. Targets are groups of ``cfg.group`` SFC-consecutive
particles; ``group_cell_ranges`` finds each group's candidate cells,
culls them against the group's bbox inflated by 2 max h, and merges
SFC-adjacent survivors into contiguous runs of the sorted arrays. Each op
then walks its group's runs, applying a per-run periodic shift (or the
per-pair minimum-image fold when the window spans the whole periodic grid,
``engine_fold``), masks pairs to ``d^2 < 4 h_i^2`` (and ``d^2 < 4 h_j^2``
for the symmetric momentum cutoff) minus the self pair, and accumulates.

With persistent lists (sph/pair_lists.py) the ops take ``lists=``, and
every SPH op then runs the list walk (csrc/pair_lists.cu,
``engine_lists_kernel``/``engine_lists_plain``), which does the pair
math only on the lanes the mark pass kept. The JAX dispatch sends
density, IAD, grad-h and the plain divv/curlv to the streaming engine
over the lists' pruned runs (the TPU kernel's ``skip_slots`` form),
because the TPU favours dense 128-lane chunks; on the card the marks
cost nothing to use, and the pairs and their order are the same: every
pair within 2 h of a target is among the marked lanes while the lists
are valid (a geometric test, independent of any op's output), and both
engines take a target's candidates in ascending slot and lane order.
The streaming engine (csrc/pair_engine.cu) serves the streaming steps
(``use_lists=False``, fold-mode grids, steps under self-gravity); the
gravity near field, which has no cutoff, runs a kernel of its own
(gravity/traversal.py ``_pallas_p2p``) and only the plain engine here
(``OpSpec.cutoff``). The ops of a list-mode step share one mask (the same
positions and smoothing lengths), so the force stage runs it once: the
density walk keeps its words (``mask="write"``) and the walks after it
read them (``mask="read"``; ``engine_lists_kernel``).

Op wrappers, named as in the JAX package: std ``pallas_density``,
``pallas_iad``, ``pallas_momentum_energy_std``; VE ``pallas_xmass``
(m / rho0 over the density op), ``pallas_ve_def_gradh``,
``pallas_iad_divv_curlv``, ``pallas_av_switches``,
``pallas_momentum_energy_ve``. Dispatch of every wrapper:

- CUDA tensors launch the kernel in csrc/pair_engine.cu or
  csrc/pair_lists.cu, or raise;
- CPU tensors run the plain PyTorch version (``*_plain``), which the
  tests compare with the JAX package and chip_smoke.py compares with the
  kernel on the card.

Each wrapper counts its kernel launches in ``LAUNCHES``, one key per
library entry point.
"""

import ctypes
import dataclasses
import functools
import math
import struct
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.kernels import costs
from sphexa_torch.neighbors.cell_list import NeighborConfig, _window_offsets_on
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sfc.hilbert import hilbert_encode
from sphexa_torch.sfc.morton import morton_encode
from sphexa_torch.sph.kernels import (
    dterh_poly_eval, kernel_dterh_coeffs, kernel_poly_coeffs, sinc_poly_eval,
)
from sphexa_torch.util import phases
from sphexa_torch.util.phases import check_runs, named_phase

#: the pair ops' entry points of K1 (csrc/pair_engine.cu) and K6
#: (csrc/pair_lists.cu)
PAIR_ENTRIES = tuple(f"{op}{walk}" for op in (
    "density", "iad", "momentum_energy_std", "ve_def_gradh", "iad_divv_curlv",
    "av_switches", "momentum_energy_ve") for walk in ("", "_lists"))

#: kernel launches per op since the last ``reset_launches()``; only the
#: wrappers' CUDA branch adds to it. A pair op's launch with wendland-c6's
#: 20 polynomial coefficients counts under ``name:wendland-c6``, one with
#: a sinc fit's 14 under the entry point's own name
LAUNCHES: Dict[str, int] = {
    **dict.fromkeys(PAIR_ENTRIES, 0), "mark": 0, "gravity_p2p": 0,
    "compact_class_lists": 0, "compact_row": 0,
    **dict.fromkeys((f"{e}:wendland-c6" for e in PAIR_ENTRIES), 0)}

#: pair elements per tile of the plain version (bounds its transient
#: memory: the momentum op keeps ~50 float32 temporaries of a tile)
PLAIN_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 25}

#: lanes of a chunk: one 128-aligned row of the sorted arrays
LANES = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class GroupRanges(NamedTuple):
    """Compacted candidate runs of every target group (one per step,
    shared by all pair ops)."""

    starts: torch.Tensor     # (NG, W3) int32 sorted-array offset of run w
    lens: torch.Tensor       # (NG, W3) int32 particles in run w (0 = dead slot)
    shift_x: torch.Tensor    # (NG, W3) f32 periodic image offset of run w
    shift_y: torch.Tensor
    shift_z: torch.Tensor
    ncells: torch.Tensor     # (NG,) int32 live runs
    occupancy: torch.Tensor  # () int64 cap/window overflow diagnostic
    boxl: torch.Tensor       # (3,) f32 fold periods (1e30 on open dims)

    @property
    def num_groups(self) -> int:
        return self.starts.shape[0]


def engine_fold(box: Box, cfg: NeighborConfig) -> bool:
    """Per-pair minimum-image fold instead of per-run shifts: needed when
    the window spans the whole periodic grid, where one instance of a
    wrapped cell cannot stand for both images a target may need."""
    any_periodic = any(b == BoundaryType.periodic for b in box.boundaries)
    return any_periodic and cfg.window >= (1 << cfg.level)


def _pad_groups(a: torch.Tensor, group: int) -> torch.Tensor:
    """(NG, group) blocks; the tail group re-reads the last particle."""
    n = a.shape[0]
    num_groups = -(-n // group)
    pad = num_groups * group - n
    if pad:
        a = torch.cat([a, a[-1:].expand(pad)])
    return a.reshape(num_groups, group)


@named_phase("neighbors")
def group_cell_ranges(x, y, z, h, sorted_keys, box: Box,
                      cfg: NeighborConfig, radius_pad=0.0, table=None) -> GroupRanges:
    """Candidate runs of every group, culled, merged and compacted
    (pallas_pairs.group_cell_ranges). ``occupancy`` is the densest kept
    cell, or ``cap + 1`` when some group's search extent outgrew the
    window block; either above ``cap`` means the config must be re-sized
    and the step replayed. ``radius_pad`` (a float32 0-d tensor: the
    list-build skin) widens each group's search radius to
    2 max h + radius_pad, so that the runs stay valid while particles
    drift between list rebuilds. ``table``: a cell-starts table of the
    level grid built elsewhere, in place of ``sorted_keys``: under a mesh
    the global one (parallel/exchange.py ``global_cell_table``), and the
    runs then hold global rows."""
    start, lens, keep, shifts, raw_len, window_ok = window_cells_culled(
        x, y, z, h, sorted_keys, box, cfg, radius_pad, table=table)
    starts_c, lens_c, sh, ncells = _merge_runs(
        start, lens, keep, shifts, cfg.run_cap, cfg.gap)
    occupancy, boxl = occupancy_and_boxl(keep, raw_len, window_ok, box, cfg)
    i32 = torch.int32
    return GroupRanges(
        starts=starts_c.to(i32).contiguous(), lens=lens_c.to(i32).contiguous(),
        shift_x=sh[0].contiguous(), shift_y=sh[1].contiguous(),
        shift_z=sh[2].contiguous(), ncells=ncells.to(i32).contiguous(),
        occupancy=occupancy, boxl=boxl,
    )


def occupancy_and_boxl(keep, raw_len, window_ok, box: Box, cfg: NeighborConfig):
    """``GroupRanges``' occupancy (the densest kept cell, or cap + 1 where
    a group's search extent outgrew the window) and fold periods (1e30 on
    open dims) from ``window_cells_culled``'s outputs."""
    occupancy = torch.where(window_ok, torch.where(keep, raw_len, 0).max(), cfg.cap + 1)
    boxl = torch.where(box.periodic_mask, box.lengths, 1e30)
    return occupancy, boxl.to(torch.float32)


def window_cells_culled(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig,
                        radius_pad=0.0, table=None):
    """Every group's window^3 block of grid cells with its sorted-array
    range and the cull verdict: a cell is kept when it exists (periodic
    images de-aliased, open-boundary cells inside the grid), is non-empty
    and, off the fold path, its AABB at its image position meets the
    group's bbox inflated by 2 max h + radius_pad. Returns (start, lens, keep, shifts,
    raw_len, window_ok), shaped (NG, W3[, 3]). ``table``: the cell-starts
    table to read the ranges from (``group_cell_ranges``)."""
    n = x.shape[0]
    dev = x.device
    level = cfg.level
    shift = 3 * (KEY_BITS - level)
    ncell = 1 << level
    encode = hilbert_encode if cfg.curve == "hilbert" else morton_encode
    lengths = box.lengths
    edge = lengths / ncell
    periodic = box.periodic_mask

    xg, yg, zg, hg = (_pad_groups(a, cfg.group) for a in (x, y, z, h))
    lo = torch.stack([xg.amin(1), yg.amin(1), zg.amin(1)], dim=1)  # (NG, 3)
    hi = torch.stack([xg.amax(1), yg.amax(1), zg.amax(1)], dim=1)
    radius = 2.0 * hg.amax(1) + radius_pad  # (NG,) float32
    box_lo = box.lo
    base = torch.floor((lo - radius[:, None] - box_lo) / edge).to(torch.int32)
    need = torch.floor((hi + radius[:, None] - box_lo) / edge).to(torch.int32)
    # open dims: slide the window inside the grid (cells outside do not exist)
    base = torch.where(periodic, base,
                       base.clamp(0, max(0, ncell - cfg.window)))
    need_eff = torch.where(periodic, need, need.clamp(max=ncell - 1))
    window_ok = bool(cfg.window >= ncell) | torch.all(
        need_eff - base + 1 <= cfg.window)

    offsets = _window_offsets_on(cfg.window, dev)  # (W3, 3)
    cells = base[:, None, :] + offsets[None, :, :]  # (NG, W3, 3) unwrapped
    wrapped = torch.remainder(cells, ncell)
    in_range = (cells >= 0) & (cells < ncell)
    unique = offsets[None, :, :] < ncell
    cell_ok = torch.where(periodic, unique, in_range).all(dim=-1)  # (NG, W3)
    lookup = torch.where(periodic, wrapped, cells.clamp(0, ncell - 1))
    ckey = encode(lookup[..., 0], lookup[..., 1], lookup[..., 2], bits=level)

    if table is not None or ncell**3 <= 4 * max(n, 1024):
        # one cell-starts table for the whole grid, then gathers
        if table is None:
            cid = sorted_keys >> shift
            table = torch.searchsorted(
                cid, torch.arange(ncell**3 + 1, device=dev, dtype=cid.dtype))
        start = table[ckey]
        end = table[ckey + 1]
    else:
        start = torch.searchsorted(sorted_keys, ckey << shift)
        end = torch.searchsorted(sorted_keys, (ckey + 1) << shift)
    raw_len = end - start
    lens = torch.where(cell_ok, raw_len.clamp(max=cfg.cap), 0)

    if engine_fold(box, cfg):
        # the kernel folds every pair: keep all non-empty cells, no shifts
        keep = cell_ok & (lens > 0)
        shifts = torch.zeros(cells.shape, dtype=torch.float32, device=dev)
    else:
        # exact cell-AABB vs inflated-group-bbox cull at the image position
        cell_lo = box_lo + cells.to(torch.float32) * edge
        cell_hi = cell_lo + edge
        r = radius[:, None, None]
        overlap = ((cell_hi >= lo[:, None, :] - r)
                   & (cell_lo <= hi[:, None, :] + r)).all(dim=-1)
        keep = cell_ok & overlap & (lens > 0)
        img = torch.div(cells, ncell, rounding_mode="floor").to(torch.float32)
        shifts = img * lengths

    return start, lens, keep, shifts, raw_len, window_ok


def _merge_runs(start, lens, keep, shifts, run_cap: int, gap: int):
    """Merge kept cells into contiguous runs per group
    (pallas_pairs._merge_runs): SFC-adjacent cells of one box image whose
    ranges lie within ``gap`` slots join one run of at most ``run_cap``
    slots. Gap particles belong to culled cells outside the group's
    inflated bbox, so they never pass the distance mask.

    The JAX package's two ``lax.scan``s are Python loops over the W3
    window columns, vectorised over groups."""
    INF = 2**30
    order = torch.sort(torch.where(keep, start, INF), dim=1, stable=True).indices
    s = start.gather(1, order)
    ln = lens.gather(1, order)
    k = keep.gather(1, order)
    sx, sy, sz = (shifts[..., d].gather(1, order) for d in range(3))
    end_eff = torch.where(k, s + ln, -1)

    # forward scan: run heads are kept cells that cannot join the open run
    ng, w3 = s.shape
    run_start = torch.zeros_like(s[:, 0])
    prev_end = torch.full_like(s[:, 0], -INF)
    px, py, pz = (torch.zeros_like(sx[:, 0]) for _ in range(3))
    heads = []
    for w in range(w3):
        s_w, l_w, k_w = s[:, w], ln[:, w], k[:, w]
        x_w, y_w, z_w = sx[:, w], sy[:, w], sz[:, w]
        same = (x_w == px) & (y_w == py) & (z_w == pz)
        join = (k_w & same & (s_w - prev_end <= gap)
                & (s_w + l_w - run_start <= run_cap))
        run_start = torch.where(k_w, torch.where(join, run_start, s_w), run_start)
        prev_end = torch.where(k_w, s_w + l_w, prev_end)
        px = torch.where(k_w, x_w, px)
        py = torch.where(k_w, y_w, py)
        pz = torch.where(k_w, z_w, pz)
        heads.append(k_w & ~join)
    is_head = torch.stack(heads, dim=1)

    # reverse scan: a head's run ends at the max cell end before the next head
    head_next = torch.cat(
        [is_head[:, 1:], torch.ones((ng, 1), dtype=torch.bool, device=s.device)],
        dim=1)
    carry = torch.full_like(s[:, 0], -1)
    ends = [None] * w3
    for w in range(w3 - 1, -1, -1):
        carry = torch.maximum(end_eff[:, w],
                              torch.where(head_next[:, w], -1, carry))
        ends[w] = carry
    run_end = torch.stack(ends, dim=1)

    # compact heads to the front, keeping key order
    order2 = torch.sort((~is_head).to(torch.int32), dim=1, stable=True).indices
    hk = is_head.gather(1, order2)
    hs = torch.where(hk, s.gather(1, order2), 0)
    hl = torch.where(hk, (run_end - s).gather(1, order2), 0)
    sh = [torch.where(hk, a.gather(1, order2), 0.0) for a in (sx, sy, sz)]
    nruns = is_head.sum(dim=1)
    return hs, hl, sh, nruns


# ---------------------------------------------------------------------------
# Op definitions shared by the plain version (torch) and, field for field,
# by the CUDA kernels' Op structs (csrc/pair_ops.cuh).
# ---------------------------------------------------------------------------


class PairGeom(NamedTuple):
    rx: torch.Tensor  # x_i - x_j, image-resolved
    ry: torch.Tensor
    rz: torch.Tensor
    d2: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    num_i: int
    num_j: int
    num_out: int
    # pair(geom, i_fields, j_fields, consts) -> per-pair terms, unmasked
    pair: Callable
    # reduction of each term over a target's pairs: "sum" or "max" (from 0)
    reduce: Tuple[str, ...]
    # finalize(i_fields, accs, nc, consts) -> outputs per target
    finalize: Callable
    want_nc: bool
    sym_j: Optional[int] = None  # j-field index of 1/h_j^2 (min-h cutoff)
    # the kernel's template form behind the entry point (gradv, av_clean)
    variant: int = 0
    # the SPH support test d^2 < 4 h_i^2 in the mask; without it every
    # candidate pairs, and the self pair only with consts["allow_self"]
    cutoff: bool = True


def _density_pair(g, I, J, c):
    return (J[3] * sinc_poly_eval(g.d2 * I[4], c["coeffs"]),)


def _density_finalize(I, accs, nc, c):
    hi, mi = I[3], I[5]
    return (c["K"] * (mi + accs[0]) / (hi * hi * hi),)


def _iad_pair(g, I, J, c):
    vw = J[3] * sinc_poly_eval(g.d2 * I[4], c["coeffs"])
    return (g.rx * g.rx * vw, g.rx * g.ry * vw, g.rx * g.rz * vw,
            g.ry * g.ry * vw, g.ry * g.rz * vw, g.rz * g.rz * vw)


def _iad_invert(hi, t11, t12, t13, t22, t23, t33, K):
    """Inverse of the IAD moment matrix scaled by h^3/K, after the exponent
    renormalisation (iad_kern.hpp ilogb/ldexp trick): the power-of-two
    factor cancels exactly in adj/det."""
    def exp_of(v):
        return torch.where(v != 0.0, torch.floor(torch.log2(torch.abs(v) + 1e-45)), 0.0)

    esum = (exp_of(t11) + exp_of(t12) + exp_of(t13)
            + exp_of(t22) + exp_of(t23) + exp_of(t33))
    norm = torch.exp2(-torch.floor(esum / 6.0))
    t11, t12, t13 = t11 * norm, t12 * norm, t13 * norm
    t22, t23, t33 = t22 * norm, t23 * norm, t33 * norm
    det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
           - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12)
    factor = norm * (hi * hi * hi) / (det * K)
    return (
        (t22 * t33 - t23 * t23) * factor,
        (t13 * t23 - t33 * t12) * factor,
        (t12 * t23 - t22 * t13) * factor,
        (t11 * t33 - t13 * t13) * factor,
        (t13 * t12 - t11 * t23) * factor,
        (t11 * t22 - t12 * t12) * factor,
    )


def _iad_finalize(I, accs, nc, c):
    return _iad_invert(I[3], *accs, c["K"])


def _momentum_pair(g, I, J, c):
    (xi, yi, zi, hi, inv_h2i, inv_h3i, vxi, vyi, vzi, ci, pro_i, mi_roi,
     c11i, c12i, c13i, c22i, c23i, c33i) = I
    (cx, cy, cz, inv_h2j, vxj, vyj, vzj, cj, mj, mjroj3, pjroj,
     c11j, c12j, c13j, c22j, c23j, c33j) = J
    coeffs = c["coeffs"]
    w_i = sinc_poly_eval(g.d2 * inv_h2i, coeffs) * inv_h3i
    mjw = mjroj3 * sinc_poly_eval(g.d2 * inv_h2j, coeffs)
    # the engine passes masked pairs only: d2 > 0 unless two particles coincide
    inv_dist = torch.rsqrt(g.d2)
    vx_ij, vy_ij, vz_ij = vxi - vxj, vyi - vyj, vzi - vzj
    rv = g.rx * vx_ij + g.ry * vy_ij + g.rz * vz_ij
    w_ij = rv * inv_dist
    # Monaghan constant-alpha AV, halved per pair (kernels.hpp:60-84)
    cij = ci + cj
    v_signal = 0.5 * cij - 2.0 * w_ij
    visc = 0.5 * torch.where(w_ij < 0.0, -v_signal * w_ij, 0.0)

    tA1_i = c11i * g.rx + c12i * g.ry + c13i * g.rz
    tA2_i = c12i * g.rx + c22i * g.ry + c23i * g.rz
    tA3_i = c13i * g.rx + c23i * g.ry + c33i * g.rz
    tA1_j = c11j * g.rx + c12j * g.ry + c13j * g.rz
    tA2_j = c12j * g.rx + c22j * g.ry + c23j * g.rz
    tA3_j = c13j * g.rx + c23j * g.ry + c33j * g.rz

    mj_pro_i = mj * pro_i
    vmi = visc * mi_roi
    a = w_i * (mj_pro_i + vmi)
    b = mjw * (pjroj + visc)
    a_e = w_i * (2.0 * mj_pro_i + vmi)
    b_e = visc * mjw
    energy = (vx_ij * (a_e * tA1_i + b_e * tA1_j)
              + vy_ij * (a_e * tA2_i + b_e * tA2_j)
              + vz_ij * (a_e * tA3_i + b_e * tA3_j))
    return (a * tA1_i + b * tA1_j, a * tA2_i + b * tA2_j,
            a * tA3_i + b * tA3_j, energy, cij - 3.0 * w_ij)


def _momentum_finalize(I, accs, nc, c):
    hi, ci = I[3], I[9]
    momx, momy, momz, energy, mv = accs
    K = c["K"]
    du = -K * 0.5 * energy
    v = torch.where(mv > 0.0, mv, ci)
    dt_i = c["k_cour"] * hi / v
    return (K * momx, K * momy, K * momz, du, dt_i)


DENSITY = OpSpec("density", 6, 4, 1, _density_pair, ("sum",),
                  _density_finalize, want_nc=True)
IAD = OpSpec("iad", 5, 4, 6, _iad_pair, ("sum",) * 6, _iad_finalize,
              want_nc=False)
MOMENTUM_ENERGY_STD = OpSpec(
    "momentum_energy_std", 18, 17, 5, _momentum_pair,
    ("sum", "sum", "sum", "sum", "max"), _momentum_finalize, want_nc=False,
    sym_j=3)


def _iad_project(g, F, k, w):
    """(C r) w with the symmetric IAD tensor (c11 c12 c13 c22 c23 c33) at
    fields F[k:k+6]."""
    c11, c12, c13, c22, c23, c33 = F[k:k + 6]
    return ((c11 * g.rx + c12 * g.ry + c13 * g.rz) * w,
            (c12 * g.rx + c22 * g.ry + c23 * g.rz) * w,
            (c13 * g.rx + c23 * g.ry + c33 * g.rz) * w)


def _gradh_pair(g, I, J, c):
    u = g.d2 * I[4]
    w = sinc_poly_eval(u, c["coeffs"])
    dterh = dterh_poly_eval(u, c["dcoeffs"])
    mj, xmj = J[3], J[4]
    return (xmj * w, xmj * dterh, mj * dterh)


def _gradh_finalize(I, accs, nc, c):
    hi, mi, xmi = I[3], I[5], I[6]
    K = c["K"]
    h3inv = 1.0 / (hi * hi * hi)
    kx = (xmi + accs[0]) * K * h3inv
    whomega = (-3.0 * xmi + accs[1]) * K * h3inv / hi
    wrho0 = (-3.0 * mi + accs[2]) * K * h3inv / hi
    whomega = whomega * mi / xmi + (kx - K * xmi * h3inv) * wrho0
    rho = kx * mi / xmi
    dhdrho = -hi / (rho * 3.0)
    return (kx, 1.0 - dhdrho * whomega)


def _divv_pair(gradv: bool):
    def pair(g, I, J, c):
        # negated projection: the VE kernels use tA = -(C r) W
        w = -sinc_poly_eval(g.d2 * I[4], c["coeffs"])
        tA1, tA2, tA3 = _iad_project(g, I, 5, w)
        vx_ji, vy_ji, vz_ji = J[4] - I[12], J[5] - I[13], J[6] - I[14]
        mw = J[3]
        if gradv:
            return tuple(mw * v * t for v in (vx_ji, vy_ji, vz_ji) for t in (tA1, tA2, tA3))
        return (mw * (vx_ji * tA1 + vy_ji * tA2 + vz_ji * tA3),
                mw * (vz_ji * tA2 - vy_ji * tA3),
                mw * (vx_ji * tA3 - vz_ji * tA1),
                mw * (vy_ji * tA1 - vx_ji * tA2))
    return pair


def _divv_finalize(gradv: bool):
    def finalize(I, accs, nc, c):
        knorm = I[11]
        if gradv:
            dvx1, dvx2, dvx3, dvy1, dvy2, dvy3, dvz1, dvz2, dvz3 = accs
            cx, cy, cz = dvz2 - dvy3, dvx3 - dvz1, dvy1 - dvx2
            return (knorm * (dvx1 + dvy2 + dvz3),
                    knorm * torch.sqrt(cx * cx + cy * cy + cz * cz),
                    knorm * dvx1, knorm * (dvx2 + dvy1), knorm * (dvx3 + dvz1),
                    knorm * dvy2, knorm * (dvy3 + dvz2), knorm * dvz3)
        adiv, acx, acy, acz = accs
        return (knorm * adiv, knorm * torch.sqrt(acx * acx + acy * acy + acz * acz))
    return finalize


def _av_pair(g, I, J, c):
    w = -sinc_poly_eval(g.d2 * I[4], c["coeffs"]) * I[5]
    vx_ij, vy_ij, vz_ij = I[14] - J[4], I[15] - J[5], I[16] - J[6]
    rv = g.rx * vx_ij + g.ry * vy_ij + g.rz * vz_ij
    inv_dist = torch.rsqrt(g.d2)
    vsig = torch.where(rv < 0.0, I[6] + J[3] - 3.0 * rv * inv_dist, 0.0)
    tA1, tA2, tA3 = _iad_project(g, I, 8, w)
    factor = J[7] * (I[7] - J[8])
    return (vsig, factor * tA1, factor * tA2, factor * tA3)


def _av_finalize(I, accs, nc, c):
    hi, ci, divvi, alpha_i = I[3], I[6], I[7], I[17]
    vs, gdx, gdy, gdz = accs
    # 1e-40 is a float32 denormal: an isolated particle's decay stays finite
    vijsignal = torch.maximum(vs, 1e-40 * ci)
    graddivv = torch.sqrt(gdx * gdx + gdy * gdy + gdz * gdz)
    a_const = hi * hi * graddivv
    alphaloc = torch.where(
        divvi < 0.0,
        c["alphamax"] * a_const / (a_const + hi * torch.abs(divvi) + 0.05 * ci), 0.0)
    decay = hi / (c["decay_c"] * vijsignal)
    target = torch.clamp_min(alphaloc, c["alphamin"])
    alphadot = (target - alpha_i) / decay
    alpha_decayed = alpha_i + alphadot * c["dt"]
    return (torch.where(alphaloc >= alpha_i, alphaloc, alpha_decayed),)


def _momentum_ve_pair(av_clean: bool):
    def pair(g, I, J, c):
        (_xi, _yi, _zi, _hi, inv_h2i, inv_h3i, vxi, vyi, vzi, ci, ali,
         xmi, xm2i, lxi, rhoi, irhoi, prhoi) = I[:17]
        (_xj, _yj, _zj, inv_h2j, inv_h3j, vxj, vyj, vzj, cj, alj,
         mj, xmj, xm2j, lxj, rhoj, irhoj, prhoj) = J[:17]
        u_i = g.d2 * inv_h2i
        u_j = g.d2 * inv_h2j
        # the negative normalisation bakes the projection sign into w
        w_i = -sinc_poly_eval(u_i, c["coeffs"]) * inv_h3i
        w_j = -sinc_poly_eval(u_j, c["coeffs"]) * inv_h3j
        vx_ij, vy_ij, vz_ij = vxi - vxj, vyi - vyj, vzi - vzj
        rv = g.rx * vx_ij + g.ry * vy_ij + g.rz * vz_ij
        inv_dist = torch.rsqrt(g.d2)
        if av_clean:
            def sym(gv):
                return (g.rx * (gv[0] * g.rx + gv[1] * g.ry + gv[2] * g.rz)
                        + g.ry * (gv[3] * g.ry + gv[4] * g.rz) + g.rz * (gv[5] * g.rz))
            eta_crit = I[23]
            d1, d2_ = sym(I[24:30]), sym(J[23:29])
            eta_ab = torch.minimum(torch.sqrt(u_i), torch.sqrt(u_j))
            eta_diff = 5.0 * (eta_ab - eta_crit)
            d3 = torch.where(eta_ab < eta_crit, torch.exp(-(eta_diff * eta_diff)), 1.0)
            A = torch.where(d2_ != 0.0, d1 / d2_, 0.0)
            Ap1 = 1.0 + A
            phi = 0.5 * d3 * torch.clamp(4.0 * A / (Ap1 * Ap1), 0.0, 1.0)
            rv = rv - phi * (d1 + d2_)
        w_ij = rv * inv_dist
        # per-particle-alpha Monaghan AV (kernels.hpp:60-84)
        cij = ci + cj
        v_sig = 0.25 * (ali + alj) * cij - 2.0 * w_ij
        visc = torch.where(w_ij < 0.0, -v_sig * w_ij, 0.0)
        tA1_i, tA2_i, tA3_i = _iad_project(g, I, 17, w_i)
        tA1_j, tA2_j, tA3_j = _iad_project(g, J, 17, w_j)
        # Atwood ramp between uncrossed (xm_i^2, xm_j^2) and crossed
        # (xm_i xm_j) volume elements
        at_min, at_max = c["at_min"], c["at_max"]
        atwood = torch.abs(rhoi - rhoj) / (rhoi + rhoj)
        sigma = c["ramp"] * (atwood - at_min)
        dl = lxj - lxi
        a_ramp = xm2i * torch.exp(sigma * dl)
        b_ramp = xm2j * torch.exp(-sigma * dl)
        crossed = xmi * xmj
        a_mom = torch.where(atwood < at_min, xm2i,
                            torch.where(atwood > at_max, crossed, a_ramp))
        b_mom = torch.where(atwood < at_min, xm2j,
                            torch.where(atwood > at_max, crossed, b_ramp))
        a_visc = mj * irhoi * visc
        b_visc = mj * irhoj * visc
        avx = 0.5 * (a_visc * tA1_i + b_visc * tA1_j)
        avy = 0.5 * (a_visc * tA2_i + b_visc * tA2_j)
        avz = 0.5 * (a_visc * tA3_i + b_visc * tA3_j)
        mom_i = mj * prhoi * a_mom
        mom_j = mj * prhoj * b_mom
        return (mom_i * tA1_i + mom_j * tA1_j + avx,
                mom_i * tA2_i + mom_j * tA2_j + avy,
                mom_i * tA3_i + mom_j * tA3_j + avz,
                mj * a_mom * (vx_ij * tA1_i + vy_ij * tA2_i + vz_ij * tA3_i),
                avx * vx_ij + avy * vy_ij + avz * vz_ij,
                0.5 * cij - 2.0 * w_ij)
    return pair


def _momentum_ve_finalize(I, accs, nc, c):
    hi, ci, prhoi = I[3], I[9], I[16]
    momx, momy, momz, energy, avisc_e, mv = accs
    K = c["K"]
    du = K * (prhoi * energy + 0.5 * torch.clamp_min(avisc_e, 0.0))
    v = torch.where(mv > 0.0, mv, ci)
    dt_i = c["k_cour"] * hi / v
    return (-K * momx, -K * momy, -K * momz, du, dt_i)


VE_DEF_GRADH = OpSpec("ve_def_gradh", 7, 5, 2, _gradh_pair, ("sum",) * 3,
                      _gradh_finalize, want_nc=False)
IAD_DIVV_CURLV = OpSpec("iad_divv_curlv", 15, 7, 2, _divv_pair(False), ("sum",) * 4,
                        _divv_finalize(False), want_nc=False)
IAD_DIVV_CURLV_GRADV = OpSpec("iad_divv_curlv", 15, 7, 8, _divv_pair(True), ("sum",) * 9,
                              _divv_finalize(True), want_nc=False, variant=1)
AV_SWITCHES = OpSpec("av_switches", 18, 9, 1, _av_pair, ("max", "sum", "sum", "sum"),
                     _av_finalize, want_nc=False)
MOMENTUM_ENERGY_VE = OpSpec(
    "momentum_energy_ve", 23, 23, 5, _momentum_ve_pair(False), ("sum",) * 5 + ("max",),
    _momentum_ve_finalize, want_nc=False, sym_j=3)
MOMENTUM_ENERGY_VE_CLEAN = OpSpec(
    "momentum_energy_ve", 30, 29, 5, _momentum_ve_pair(True), ("sum",) * 5 + ("max",),
    _momentum_ve_finalize, want_nc=False, sym_j=3, variant=1)


def op_consts(const) -> dict:
    n, kind = float(const.sinc_index), const.kernel_choice
    return {"coeffs": kernel_poly_coeffs(n, kind), "dcoeffs": kernel_dterh_coeffs(n, kind),
            "K": float(const.K), "k_cour": float(const.k_cour),
            "alphamin": float(const.alphamin), "alphamax": float(const.alphamax),
            "decay_c": float(const.decay_constant), "at_min": float(const.at_min),
            "at_max": float(const.at_max), "ramp": float(const.ramp)}


# ---------------------------------------------------------------------------
# Plain PyTorch version of the engine
# ---------------------------------------------------------------------------


def engine_plain(spec: OpSpec, ranges: GroupRanges, i_fields: Sequence,
                 j_fields: Sequence, fold: bool, group: int, consts: dict):
    """The engine's contract in plain PyTorch: each group's runs are
    expanded into one padded candidate index row, and (groups, G, C) tiles
    get the kernel's shift or fold and masks; the op's pair math then runs
    on the masked pairs and is reduced per target. Returns (outs (n,) x
    num_out, nc (n,) int32)."""
    return _engine_plain_core(spec, i_fields, j_fields, group, consts,
                              *_run_candidates(ranges, fold))


def _run_candidates(ranges: GroupRanges, fold: bool):
    """(total, candidates, boxl) of the streaming engine: each group's runs
    in order, with their shifts (None on the fold path)."""
    lens = ranges.lens.to(torch.int64)
    starts = ranges.starts.to(torch.int64)
    cum = torch.cumsum(lens, dim=1)
    first = cum - lens  # candidate offset of each run inside its group
    total = cum[:, -1]
    shifts = (ranges.shift_x, ranges.shift_y, ranges.shift_z)

    def candidates(sl: slice, cmax: int):
        kk = torch.arange(cmax, device=lens.device).expand(sl.stop - sl.start, cmax)
        run = torch.searchsorted(cum[sl], kk.contiguous(), right=True)
        run = run.clamp(max=lens.shape[1] - 1)
        cand = starts[sl].gather(1, run) + (kk - first[sl].gather(1, run))
        valid = kk < total[sl, None]
        sh = None if fold else [a[sl].gather(1, run) for a in shifts]
        return torch.where(valid, cand, 0), valid, sh

    return total, candidates, ranges.boxl


def chunk_slots(ranges: GroupRanges, slot_cap: int):
    """Slot -> (run, chunk) map of every group's runs: a slot is one
    128-aligned row of the sorted arrays that a run touches, numbered in
    run order (pair_lists._prune_empty_chunks). Returns (w_of_s, c_of_s,
    total) with (NG, slot_cap) int64 run index and chunk-in-run of each
    slot and the (NG,) int64 chunk count of each group; slots at or past
    the count map to the last live run."""
    starts, lens = ranges.starts.to(torch.int64), ranges.lens.to(torch.int64)
    ng, w3 = starts.shape
    off = starts % LANES
    nch = torch.where(lens > 0, (off + lens + LANES - 1) // LANES, 0)
    cum = torch.cumsum(nch, dim=1) - nch  # first slot of each run
    # live runs lead each row (the runs are compacted), so their first
    # slots ascend; a dead run sorts last
    live_cum = torch.where(nch > 0, cum, 2**62)
    s_idx = torch.arange(slot_cap, device=starts.device)
    w_of_s = torch.searchsorted(live_cum, s_idx.expand(ng, slot_cap).contiguous(),
                                right=True) - 1
    w_of_s = w_of_s.clamp(0, w3 - 1)
    c_of_s = s_idx[None, :] - cum.gather(1, w_of_s)
    return w_of_s, c_of_s, nch.sum(dim=1)


def lane_mask(bits: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 mask words -> (..., 128) bool: lane l is bit l % 32
    of word l // 32."""
    lane = torch.arange(LANES, device=bits.device)
    return ((bits[..., lane // 32] >> (lane % 32)) & 1).bool()


def engine_lists_plain(spec: OpSpec, lists, i_fields: Sequence,
                       j_fields: Sequence, group: int, consts: dict):
    """The list walk's contract in plain PyTorch: each group's candidates
    are the lanes its mark bits keep, in slot order, each with its run's
    shift; the pair math and reduction are ``engine_plain``'s. Returns
    (outs (n,) x num_out, nc (n,) int32)."""
    return _engine_plain_core(spec, i_fields, j_fields, group, consts,
                              *_list_candidates(lists))


def _list_candidates(lists):
    """(total, candidates, boxl) of the list walk: each group's marked
    lanes in slot order, with their runs' shifts."""
    ranges = lists.ranges
    # slots past a group's pruned chunks hold no marked lane
    w_of_s, c_of_s, _ = chunk_slots(ranges, lists.slot_cap)
    row = ranges.starts.to(torch.int64).gather(1, w_of_s) // LANES + c_of_s
    shifts = [a.gather(1, w_of_s) for a in (ranges.shift_x, ranges.shift_y, ranges.shift_z)]
    lane = torch.arange(LANES, device=row.device)
    total = lists.cnt.to(torch.int64).sum(dim=1)

    def candidates(sl: slice, cmax: int):
        gc = sl.stop - sl.start
        marked = lane_mask(lists.bits[sl]).reshape(gc, -1)
        gi, fi = marked.nonzero(as_tuple=True)  # row-major: slot, then lane order
        pos = (torch.cumsum(marked, dim=1) - 1)[gi, fi]
        si = fi // LANES
        cand = torch.zeros(gc, cmax, dtype=torch.int64, device=row.device)
        valid = torch.zeros(gc, cmax, dtype=torch.bool, device=row.device)
        cand[gi, pos] = row[sl][gi, si] * LANES + lane[fi % LANES]
        valid[gi, pos] = True
        sh = []
        for a in shifts:
            t = torch.zeros(gc, cmax, dtype=a.dtype, device=row.device)
            t[gi, pos] = a[sl][gi, si]
            sh.append(t)
        return cand, valid, sh

    return total, candidates, ranges.boxl


def _masked_tiles(spec: OpSpec, i_fields: Sequence, j_fields: Sequence, group: int,
                  consts: dict, total: torch.Tensor, candidates: Callable,
                  boxl: torch.Tensor):
    """The engines' mask over each group's candidates, in chunks of groups
    whose padded (groups, G, C) tiles fit the budget. ``total`` holds each
    group's candidate count; ``candidates(groups, C)`` returns the padded
    (groups, C) candidate indices, their validity and their per-candidate
    shifts (None: fold every pair with the periods ``boxl``). Yields
    (groups slice, candidates, mask, rx, ry, rz, d2), the geometry and
    mask (groups, G, C) each."""
    dev = i_fields[0].device
    tile_elems = PLAIN_TILE_ELEMS[dev.type]
    I4 = [_pad_groups(a, group) for a in i_fields[:4]]  # (NG, G) each
    ng = I4[0].shape[0]
    lx, ly, lz = (boxl[d] for d in range(3))
    tgt_all = torch.arange(ng * group, device=dev).reshape(ng, group)
    g0 = 0
    total_host = total.tolist()
    while g0 < ng:
        # grow the chunk of groups while its padded tile fits the budget
        g1, cmax = g0 + 1, max(total_host[g0], 1)
        while g1 < ng and (g1 + 1 - g0) * group * max(cmax, total_host[g1]) <= tile_elems:
            cmax = max(cmax, total_host[g1])
            g1 += 1
        sl = slice(g0, g1)
        cand, valid, sh = candidates(sl, cmax)
        J = [a[cand][:, None, :] for a in j_fields[:3]]  # (gc, 1, C)
        if spec.sym_j is not None:
            J.append(j_fields[spec.sym_j][cand][:, None, :])
        xi, yi, zi, hi = (a[sl][:, :, None] for a in I4)  # (gc, G, 1)
        if sh is None:
            rx = xi - J[0]
            ry = yi - J[1]
            rz = zi - J[2]
            rx = rx - lx * torch.round(rx / lx)
            ry = ry - ly * torch.round(ry / ly)
            rz = rz - lz * torch.round(rz / lz)
        else:
            sx, sy, sz = (a[:, None, :] for a in sh)
            rx = xi - (J[0] + sx)
            ry = yi - (J[1] + sy)
            rz = zi - (J[2] + sz)
        d2 = rx * rx + ry * ry + rz * rz
        not_self = cand[:, None, :] != tgt_all[sl][:, :, None]
        if spec.cutoff:
            mask = valid[:, None, :] & (d2 < 4.0 * hi * hi) & not_self
            if spec.sym_j is not None:
                mask = mask & (d2 * J[3] < 4.0)
        else:
            mask = valid[:, None, :] & (not_self | bool(consts.get("allow_self", False)))
        yield sl, cand, mask, rx, ry, rz, d2
        g0 = g1


def _engine_plain_core(spec: OpSpec, i_fields: Sequence, j_fields: Sequence,
                       group: int, consts: dict, total: torch.Tensor,
                       candidates: Callable, boxl: torch.Tensor):
    """Masked pair math over each group's candidates (``_masked_tiles``):
    the op's pair terms on the masked pairs only, in candidate order, each
    target's terms summed (or maxed, from 0) in turn, then its finalize."""
    n = i_fields[0].shape[0]
    dev = i_fields[0].device
    I_all = [_pad_groups(a, group) for a in i_fields]  # (NG, G) each
    ng = I_all[0].shape[0]
    outs = [torch.empty(ng, group, device=dev) for _ in range(spec.num_out)]
    nc_out = torch.empty(ng, group, dtype=torch.int32, device=dev)
    for sl, cand, mask, rx, ry, rz, d2 in _masked_tiles(
            spec, i_fields, j_fields, group, consts, total, candidates, boxl):
        gc = sl.stop - sl.start
        gi, ti, ci = mask.nonzero(as_tuple=True)
        flat = gi * group + ti
        width = gc * group
        geom = PairGeom(rx[gi, ti, ci], ry[gi, ti, ci], rz[gi, ti, ci], d2[gi, ti, ci])
        jc = cand[gi, ci]
        terms = spec.pair(geom, [a[sl][gi, ti] for a in I_all],
                          [a[jc] for a in j_fields], consts)
        accs = []
        for t, how in zip(terms, spec.reduce):
            acc = torch.zeros(width, dtype=t.dtype, device=dev)
            if how == "sum":
                acc.index_add_(0, flat, t)
            else:
                acc.scatter_reduce_(0, flat, t, "amax", include_self=True)
            accs.append(acc.reshape(gc, group))
        nc = torch.bincount(flat, minlength=width).reshape(gc, group).to(torch.int32)
        res = spec.finalize([a[sl] for a in I_all], accs, nc, consts)
        for o, r in zip(outs, res):
            o[sl] = r
        nc_out[sl] = nc
    return [o.reshape(-1)[:n] for o in outs], nc_out.reshape(-1)[:n]


def body_pass_counts(spec: OpSpec, i_fields: Sequence, j_fields: Sequence, group: int,
                     consts: dict, windows: Sequence[int], ranges: Optional[GroupRanges] = None,
                     fold: bool = False, lists=None) -> dict:
    """How much of an engine's pair-body work holds a pair, counted in
    lane-passes (one warp lane running the body once), on the engine's own
    candidates: each group's runs (``ranges``, ``fold``) or, with
    ``lists``, its marked lanes, and the op's mask. Under the union rule a
    warp of 32 targets runs the body on every candidate any of its lanes
    accepts; with per-lane windows of W consecutive candidates it runs, per
    window, as many passes as its busiest lane has pairs there (the tail
    group's padding lanes, which re-read the last particle, run passes but
    hold no pair). Returns
    {"pairs": neighbour pairs, "union": lane-passes, "windows": {W:
    lane-passes}}; a pair count over lane-passes is that rule's efficiency.
    ``group`` must be a multiple of 32."""
    if group % 32:
        raise ValueError(f"group must be a multiple of 32, got {group}")
    if lists is not None:
        total, candidates, boxl = _list_candidates(lists)
    else:
        total, candidates, boxl = _run_candidates(ranges, fold)
    n = i_fields[0].shape[0]
    pairs, union, per = 0, 0, {w: 0 for w in windows}
    for sl, _, mask, *_ in _masked_tiles(spec, i_fields, j_fields, group, consts, total,
                                         candidates, boxl):
        gc, _, c = mask.shape
        warps = mask.reshape(gc, group // 32, 32, c)
        # the tail group's padding lanes run the body too, but hold no pair
        real = torch.arange(sl.start * group, sl.stop * group, device=mask.device) < n
        pairs += int((mask & real.reshape(gc, group, 1)).sum())
        union += 32 * int(warps.any(dim=2).sum())
        for w in windows:
            padded = torch.cat([warps, warps.new_zeros(gc, group // 32, 32, (-c) % w)], dim=-1)
            busiest = padded.reshape(gc, group // 32, 32, -1, w).sum(dim=-1).amax(dim=2)
            per[w] += 32 * int(busiest.sum())
    return {"pairs": pairs, "union": union, "windows": per}


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

_MAX_F = 32
_MAX_OUT = 8
#: the kernel polynomials' coefficient counts the CUDA ops are built for:
#: the sinc family's degree 13 and wendland-c6's degree 19 (csrc/pair_ops.cuh
#: NCOEF_SINC, NCOEF_WENDLAND); EngineArgs holds the larger
KERNEL_NCOEFS = (14, 20)
#: the op form each coefficient count launches (None: the entry point's own)
NCOEF_FORM = {14: None, 20: "wendland-c6"}
_MAX_NCOEF = max(KERNEL_NCOEFS)


class EngineArgs(ctypes.Structure):
    """Mirror of ``EngineArgs`` in csrc/pair_ops.cuh (same field order;
    its layout version, ABI 9, is kernels.build.ABI_VERSION)."""

    _fields_ = [
        ("starts", ctypes.c_void_p),
        ("lens", ctypes.c_void_p),
        ("shift_x", ctypes.c_void_p),
        ("shift_y", ctypes.c_void_p),
        ("shift_z", ctypes.c_void_p),
        ("ncells", ctypes.c_void_p),
        ("ifields", ctypes.c_void_p * _MAX_F),
        ("jfields", ctypes.c_void_p * _MAX_F),
        ("outs", ctypes.c_void_p * _MAX_OUT),
        ("nc", ctypes.c_void_p),
        ("n", ctypes.c_int32),
        ("num_groups", ctypes.c_int32),
        ("w3", ctypes.c_int32),
        ("group", ctypes.c_int32),
        ("fold", ctypes.c_int32),
        ("sym_j", ctypes.c_int32),
        ("boxl", ctypes.c_void_p),
        ("K", ctypes.c_float),
        ("mhalf_K", ctypes.c_float),
        ("k_cour", ctypes.c_float),
        ("coeffs", ctypes.c_float * _MAX_NCOEF),
        ("bits", ctypes.c_void_p),
        ("slot_cap", ctypes.c_int32),
        ("dcoeffs", ctypes.c_float * _MAX_NCOEF),
        ("alphamin", ctypes.c_float),
        ("alphamax", ctypes.c_float),
        ("decay_c", ctypes.c_float),
        ("at_min", ctypes.c_float),
        ("at_max", ctypes.c_float),
        ("ramp", ctypes.c_float),
        ("dt", ctypes.c_void_p),
        ("variant", ctypes.c_int32),
        ("mask_words", ctypes.c_void_p),
        ("word_off", ctypes.c_void_p),
        ("mask_mode", ctypes.c_int32),
        ("ncoef", ctypes.c_int32),
        ("nj", ctypes.c_int32),
    ]


def check_cuda_f32(name: str, a: torch.Tensor, n: int, dev) -> None:
    if a.device != dev or a.dtype != torch.float32 or a.shape != (n,) \
            or not a.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 ({n},) tensor on {dev}, got "
            f"{a.dtype} {tuple(a.shape)} on {a.device}")


def check_table(name: str, a: torch.Tensor, dtype, shape, dev) -> None:
    if a.device != dev or a.dtype != dtype or tuple(a.shape) != tuple(shape) \
            or not a.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")


@functools.lru_cache(maxsize=None)
def _coeff_array(coeffs: tuple):
    """A kernel polynomial's coefficients as the EngineArgs array (the
    slots past its count are never read: the op form launched is the
    count's, ``EngineArgs.ncoef``)."""
    if len(coeffs) not in KERNEL_NCOEFS:
        raise ValueError(f"the kernels take {' or '.join(map(str, KERNEL_NCOEFS))} "
                         f"polynomial coefficients, got {len(coeffs)}")
    return (ctypes.c_float * _MAX_NCOEF)(*coeffs)


def _engine_args(spec: OpSpec, ranges: GroupRanges, i_fields: Sequence,
                 j_fields: Sequence, fold: bool, group: int, consts: dict):
    """Check the inputs of a CUDA launch and fill its EngineArgs; returns
    (args, outs, nc), the outputs allocated on the inputs' device. The
    i-fields hold the n targets, the j-fields the nj >= n rows of the
    j-buffer that the runs index: the targets themselves, or under a mesh
    [own slab | halo rows] (the ``jdata`` form), whose own slab at offset 0
    keeps each target's row index for the self test."""
    x = i_fields[0]
    dev, n = x.device, x.shape[0]
    nj = j_fields[0].shape[0] if j_fields else n
    if dev.type != "cuda":
        raise ValueError(f"{spec.name}: the kernel needs CUDA tensors, got {dev}")
    if not 0 < group <= 256 or group % 32:
        raise ValueError(f"group must be a multiple of 32 in (0, 256], got {group}")
    if len(i_fields) != spec.num_i or len(j_fields) != spec.num_j:
        raise ValueError(f"{spec.name}: field count mismatch")
    if not spec.cutoff:
        raise ValueError(f"{spec.name}: the engines' kernels run only ops with the SPH cutoff")
    if nj < n:
        raise ValueError(f"{spec.name}: the j-buffer holds {nj} rows, fewer than the {n} "
                         "targets (its own slab comes first)")
    f32 = torch.float32
    for side, fields, rows in (("i", i_fields, n), ("j", j_fields, nj)):
        for k, a in enumerate(fields):
            if a.dtype is not f32 or a.shape != (rows,) or a.device != dev \
                    or not a.is_contiguous():
                check_cuda_f32(f"{spec.name} {side}-field {k}", a, rows, dev)
    ng, w3 = ranges.starts.shape
    if ng != -(-n // group):
        raise ValueError(f"ranges hold {ng} groups, {n} targets need {-(-n // group)}")
    for nm, a, dt in (("starts", ranges.starts, torch.int32),
                      ("lens", ranges.lens, torch.int32),
                      ("shift_x", ranges.shift_x, torch.float32),
                      ("shift_y", ranges.shift_y, torch.float32),
                      ("shift_z", ranges.shift_z, torch.float32)):
        check_table(f"ranges.{nm}", a, dt, (ng, w3), dev)
    check_table("ranges.ncells", ranges.ncells, torch.int32, (ng,), dev)
    check_table("ranges.boxl", ranges.boxl, torch.float32, (3,), dev)

    # one allocation for all outputs, a row each
    outs = list(torch.empty(spec.num_out, n, dtype=torch.float32, device=dev).unbind(0))
    nc = torch.empty(n, dtype=torch.int32, device=dev) if spec.want_nc else None

    args = EngineArgs()
    args.starts = ranges.starts.data_ptr()
    args.lens = ranges.lens.data_ptr()
    args.shift_x = ranges.shift_x.data_ptr()
    args.shift_y = ranges.shift_y.data_ptr()
    args.shift_z = ranges.shift_z.data_ptr()
    args.ncells = ranges.ncells.data_ptr()
    args.ifields[:len(i_fields)] = [a.data_ptr() for a in i_fields]
    args.jfields[:len(j_fields)] = [a.data_ptr() for a in j_fields]
    args.outs[:len(outs)] = [a.data_ptr() for a in outs]
    args.nc = nc.data_ptr() if nc is not None else None
    args.n, args.num_groups, args.w3, args.group = n, ng, w3, group
    args.nj = nj
    args.fold = int(fold)
    args.sym_j = -1 if spec.sym_j is None else spec.sym_j
    # a device pointer: reading the periods on the host would sync the stream
    args.boxl = ranges.boxl.data_ptr()
    args.K = consts["K"]
    args.mhalf_K = -consts["K"] * 0.5
    args.k_cour = consts["k_cour"]
    if len(consts["dcoeffs"]) != len(consts["coeffs"]):
        raise ValueError("W and dterh polynomials of different degrees")
    args.coeffs = _coeff_array(tuple(consts["coeffs"]))
    args.dcoeffs = _coeff_array(tuple(consts["dcoeffs"]))
    args.ncoef = len(consts["coeffs"])
    for key in ("alphamin", "alphamax", "decay_c", "at_min", "at_max", "ramp"):
        setattr(args, key, consts[key])
    if "dt" in consts:
        # a device pointer, as for boxl: float() of the step's dt would sync
        check_table("dt", consts["dt"], torch.float32, (), dev)
        args.dt = consts["dt"].data_ptr()
    args.variant = spec.variant
    return args, outs, nc


def launch(entry: str, args: ctypes.Structure, dev: torch.device) -> None:
    """Call a kernel library entry point on ``dev``'s current stream (no
    sync); raises on a refused launch and counts it in LAUNCHES."""
    from sphexa_torch.kernels.build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, f"launch_{entry}")(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"launch_{entry} failed: CUDA error {err} "
                           f"({lib.pair_engine_error_string(err).decode()})")
    form = NCOEF_FORM[args.ncoef]
    LAUNCHES[entry if form is None else f"{entry}:{form}"] += 1


def engine_kernel(spec: OpSpec, ranges: GroupRanges, i_fields: Sequence,
                  j_fields: Sequence, fold: bool, group: int, consts: dict):
    """Launch the op's CUDA kernel on the current stream (no sync).
    Returns (outs (n,) x num_out, nc (n,) int32 or None)."""
    args, outs, nc = _engine_args(spec, ranges, i_fields, j_fields, fold, group, consts)
    launch(spec.name, args, i_fields[0].device)
    return outs, nc


#: the list walk's mask modes (``mask=``): run the mask phase ("own"), run
#: it and keep its words in ``lists.mask_words`` ("write"), or read the
#: words a "write" walk kept instead of running it ("read")
MASK_MODES = {"own": 0, "write": 1, "read": 2}


def engine_lists_kernel(spec: OpSpec, lists, i_fields: Sequence,
                        j_fields: Sequence, group: int, consts: dict, mask: str = "own"):
    """Launch the op's list-walk kernel (csrc/pair_lists.cu) on the
    current stream (no sync). Returns (outs (n,) x num_out, nc or None).

    The ops of one step share their mask (d^2 < 4 h_i^2, not self, on the
    same positions and smoothing lengths), so the caller may run it once:
    ``mask="write"`` keeps each target's accepted-candidate words in
    ``lists.mask_words``, and a later walk of the step with ``mask="read"``
    reads them instead of running its mask phase. A "read" walk is right
    only on the positions and smoothing lengths of the "write" walk before
    it, and it counts no neighbours, so an op that counts them (density)
    cannot read."""
    mode = mask_mode(spec, mask)
    args, outs, nc = _engine_args(spec, lists.ranges, i_fields, j_fields, False,
                                  group, consts)
    dev = i_fields[0].device
    ng, scap = lists.ranges.num_groups, lists.slot_cap
    check_table("lists.bits", lists.bits, torch.int32, (ng, scap, LANES // 32), dev)
    args.bits = lists.bits.data_ptr()
    args.slot_cap = scap
    if mode:
        words = lists.mask_words
        if words is None or words.device != dev:
            raise ValueError(f"{spec.name}: mask={mask!r} needs the lists' mask-word "
                             f"buffer on {dev}")
        check_table("lists.word_off", lists.word_off, torch.int32, (ng + 1,), dev)
        args.mask_words, args.word_off = words.data_ptr(), lists.word_off.data_ptr()
        args.mask_mode = mode
    launch(f"{spec.name}_lists", args, dev)
    return outs, nc


def mask_mode(spec: OpSpec, mask: str) -> int:
    """The kernel's code of a ``mask=`` mode (``MASK_MODES``), checked."""
    if mask not in MASK_MODES:
        raise ValueError(f"mask must be one of {tuple(MASK_MODES)}, got {mask!r}")
    if mask == "read" and spec.want_nc:
        raise ValueError(f"{spec.name} counts neighbours: it runs its mask, it cannot "
                         "read one")
    return MASK_MODES[mask]


def mask_word_offsets(cnt: torch.Tensor) -> torch.Tensor:
    """Where each group's words start in the list walk's mask-word buffer:
    (NG + 1,) int32 ``off``, word j of target t of group g at
    (off[g] + j) * group + t, one word per 32 of the group's marked lanes
    (``cnt``: (NG, S_cap) marked lanes per slot). The buffer holds
    off[NG] * group words."""
    per_group = (cnt.to(torch.int64).sum(dim=1) + 31) // 32
    off = torch.zeros(per_group.shape[0] + 1, dtype=torch.int64, device=cnt.device)
    off[1:] = torch.cumsum(per_group, dim=0)
    return off.to(torch.int32)


#: kernel_info's keys, in the order of the library's int32 output
KERNEL_INFO_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
                    "blocks_per_sm", "window", "warps_per_sm")


def kernel_info(spec: OpSpec, group: int, walk: bool, fold: bool = False,
                ncoef: int = KERNEL_NCOEFS[0]) -> dict:
    """Static facts of the kernel instantiation that a launch of ``spec``
    would run (the list walk with ``walk``, else the streaming engine's
    ``fold`` form; the op form of ``ncoef`` polynomial coefficients) at
    blocks of ``group`` threads: registers and local
    (spill) bytes a thread, static and dynamic shared bytes a block,
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    the window it was built for (csrc/engine_window.cuh WINDOW) and
    resident warps per SM. Needs a CUDA device; launches nothing."""
    from sphexa_torch.kernels.build import load_library

    lib = load_library()
    args = EngineArgs()
    args.variant, args.fold, args.group = spec.variant, int(fold), group
    args.sym_j = -1 if spec.sym_j is None else spec.sym_j
    args.ncoef = ncoef
    out = (ctypes.c_int32 * len(KERNEL_INFO_KEYS))()
    fn = lib.list_walk_info if walk else lib.pair_engine_info
    err = fn(spec.name.encode(), ctypes.addressof(args), out)
    if err != 0:
        raise RuntimeError(f"{spec.name} kernel info failed: CUDA error {err} "
                           f"({lib.pair_engine_error_string(err).decode()})")
    return dict(zip(KERNEL_INFO_KEYS, out))


def _consts(const, dt) -> dict:
    consts = op_consts(const)
    if dt is not None:
        consts["dt"] = dt
    return consts


def _run(spec: OpSpec, ranges, i_fields, j_fields, box, cfg, const, lists=None, dt=None,
         mask="own"):
    """Dispatch by device: CUDA launches the kernel (the list walk when
    ``lists`` is given, in the ``mask`` mode of ``engine_lists_kernel``),
    CPU runs the plain version; anything else raises. ``dt``: the 0-d
    device tensor of the AV switches' time step."""
    dev = i_fields[0].device
    runs = lists.ranges if lists is not None else ranges
    # --debug-checks: the runs the kernel reads stay inside its j-arrays
    check_runs(spec.name, runs.starts, runs.lens, j_fields[0].shape[0])
    # a cost tally charges the kernel's rule, not the ops of either branch
    with costs.charging():
        if dev.type == "cuda":
            consts = _consts(const, dt)
            if lists is not None:
                out = engine_lists_kernel(spec, lists, i_fields, j_fields, cfg.group, consts,
                                          mask)
            else:
                mask_mode(spec, mask)
                out = engine_kernel(spec, ranges, i_fields, j_fields, engine_fold(box, cfg),
                                    cfg.group, consts)
        elif dev.type == "cpu":
            out = _run_plain(spec, ranges, i_fields, j_fields, box, cfg, const, lists, dt,
                             mask)
        else:
            raise ValueError(f"unsupported device {dev}")
    charge_pair(spec, ranges, i_fields, j_fields, out[1], box, cfg, const, dt, lists, mask,
                outs=out)
    return out


def _run_plain(spec: OpSpec, ranges, i_fields, j_fields, box, cfg, const, lists=None,
               dt=None, mask="own"):
    mask_mode(spec, mask)  # every plain pass computes its own mask
    consts = _consts(const, dt)
    if lists is not None:
        return engine_lists_plain(spec, lists, i_fields, j_fields, cfg.group, consts)
    return engine_plain(spec, ranges, i_fields, j_fields, engine_fold(box, cfg),
                        cfg.group, consts)


# ---------------------------------------------------------------------------
# The cost tally's charge of one K1 or K6 launch (kernels/costs.py holds the
# rules): the data-dependent counts, read by the plain engine only while a
# tally runs.
# ---------------------------------------------------------------------------


def momentum_pair_counts(spec, fields, consts, group, runs=None, fold=False, lists=None):
    """The pairs a momentum op's body runs on (its mask: d^2 < 4 h_i^2 and,
    with the symmetric cutoff, d^2 < 4 h_j^2) and, for the VE op, those of
    them that take each branch with operations of its own
    (``costs.BRANCH_OPS``): the Atwood ramp, the crossed volume element,
    the av_clean limiter. Counted by the plain engine on the op's own
    fields, the branch tests copied from the body (csrc/pair_ops.cuh
    MomentumEnergyVeOp)."""
    ve = spec.name == "momentum_energy_ve"
    names = ("pairs",) + (("ramp", "crossed") if ve else ()) + (
        ("limiter",) if ve and spec.variant else ())

    def count(g, I, J, c):
        terms = [torch.ones_like(g.d2)]
        if ve:
            atwood = torch.abs(I[14] - J[14]) / (I[14] + J[14])
            terms += [(atwood >= c["at_min"]) & (atwood <= c["at_max"]), atwood > c["at_max"]]
            if spec.variant:
                eta_ab = torch.minimum(torch.sqrt(g.d2 * I[4]), torch.sqrt(g.d2 * J[3]))
                terms.append(eta_ab < I[23])
        return tuple(t.to(torch.float32) for t in terms)

    cspec = dataclasses.replace(spec, num_out=len(names), pair=count,
                                reduce=("sum",) * len(names),
                                finalize=lambda I, accs, nc, c: accs)
    if lists is not None:
        outs, _ = engine_lists_plain(cspec, lists, *fields, group, consts)
    else:
        outs, _ = engine_plain(cspec, runs, *fields, fold, group, consts)
    # per-target counts are small integers, exact in float32
    return {k: int(o.to(torch.int64).sum()) for k, o in zip(names, outs)}


def _pair_counts(t, spec, i_fields, j_fields, nc, consts, group, ranges, fold, lists):
    """The counts of one op's charge: sets ``t.nb_pairs``, the neighbour
    pairs (an op that counts them, its own; else those of the step's last
    counting op, on the same positions and smoothing lengths), and returns
    a momentum body's own counted pairs (``momentum_pair_counts``; None
    for the other bodies)."""
    if nc is not None and spec.want_nc:
        # the plain version returns its mask count for every op; only an
        # op that counts neighbours (density) has the neighbour pairs
        t.nb_pairs = int(nc.to(torch.int64).sum())
    if t.nb_pairs is None:
        # no counting op before this one: count the neighbour pairs
        bare = dataclasses.replace(spec, sym_j=None, variant=0)
        t.nb_pairs = momentum_pair_counts(bare, (i_fields, j_fields), consts, group,
                                          runs=ranges, fold=fold, lists=lists)["pairs"]
    if costs.spec_body(spec) not in costs.SYM_BODIES:
        return None
    return momentum_pair_counts(spec, (i_fields, j_fields), consts, group, runs=ranges,
                                fold=fold, lists=lists)


def charge_pair(spec, ranges, i_fields, j_fields, nc, box, cfg, const, dt=None,
                lists=None, mask="own", outs=None):
    """Charge one K1 or K6 launch (``_run``'s arguments and its ``nc``
    output; ``outs`` its outputs) under its ``LAUNCHES`` key
    (``costs.pair_cost``); a no-op without a tally."""
    t = phases._TALLY
    if t is None:
        return
    with t.suppressed():
        consts = _consts(const, dt)
        fold = lists is None and engine_fold(box, cfg)
        runs = lists.ranges if lists is not None else ranges
        pairs = _pair_counts(t, spec, i_fields, j_fields, nc, consts, cfg.group, runs, fold,
                             lists)
        ops, nbytes = costs.pair_cost(spec, ranges, i_fields, j_fields, consts, cfg.group,
                                      lists, mask, t.nb_pairs, pairs)
        cand = int(runs.lens.to(torch.int64).sum())
    entry = spec.name + ("_lists" if lists is not None else "")
    form = NCOEF_FORM[len(consts["coeffs"])]
    costs.kernel_charge(entry if form is None else f"{entry}:{form}", ops, nbytes,
                        counts={"runs": cand, "nb_pairs": t.nb_pairs, "pairs": pairs},
                        outs=outs)


# ---------------------------------------------------------------------------
# The std-SPH ops (pallas_pairs.pallas_density / pallas_iad /
# pallas_momentum_energy_std). Each builds its precombined i/j fields,
# runs the engine and applies the post-processing of the JAX wrapper.
# With ``lists`` (persistent PairLists) every op takes the list walk and
# ``sorted_keys`` and ``ranges`` are unused; ``mask`` is the walk's mask
# mode (``engine_lists_kernel``: "own", "write" or "read"), which the
# streaming engine and the plain versions, running every mask, ignore.
# ---------------------------------------------------------------------------


def density_fields(x, y, z, h, m):
    return [x, y, z, h, 1.0 / (h * h), m], [x, y, z, m]


def iad_fields(x, y, z, h, vol):
    return [x, y, z, h, 1.0 / (h * h)], [x, y, z, vol]


def momentum_fields(x, y, z, vx, vy, vz, h, m, rho, p, c,
                     c11, c12, c13, c22, c23, c33):
    # per-particle ratios precombined so the pair math has no divisions
    inv_h2 = 1.0 / (h * h)
    inv_h3 = inv_h2 / h
    i_f = [x, y, z, h, inv_h2, inv_h3, vx, vy, vz, c, p / (rho * rho), m / rho,
           c11, c12, c13, c22, c23, c33]
    return i_f, momentum_j_fields(x, y, z, h, vx, vy, vz, m, rho, p, c,
                                  c11, c12, c13, c22, c23, c33, inv_h2=inv_h2)


def momentum_j_fields(x, y, z, h, vx, vy, vz, m, rho, p, c, c11, c12, c13, c22, c23, c33,
                      inv_h2=None):
    """The std momentum op's j-fields from the raw ones, in the order of
    its ``jdata`` (the JAX package's)."""
    inv_h2 = 1.0 / (h * h) if inv_h2 is None else inv_h2
    return [x, y, z, inv_h2, vx, vy, vz, c, m, m / (rho * h * h * h), p / rho,
            c11, c12, c13, c22, c23, c33]


def _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg):
    if lists is not None:
        return lists.ranges
    return ranges if ranges is not None else \
        group_cell_ranges(x, y, z, h, sorted_keys, box, cfg)


def _density(run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists, mask,
             jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = density_fields(x, y, z, h, m)
    (rho,), nc = run(DENSITY, ranges, i_f, _j(j_f, jdata), box, cfg, const, lists, mask=mask)
    return rho, nc, ranges.occupancy


def _j(j_f, jdata):
    """An op's j-fields: its own, or the ``jdata`` j-buffers as they are."""
    return j_f if jdata is None else list(jdata)


def _iad(run, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges, lists, mask,
         jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = iad_fields(x, y, z, h, vol)
    cs, _ = run(IAD, ranges, i_f, _j(j_f, jdata), box, cfg, const, lists, mask=mask)
    return tuple(cs), ranges.occupancy


def _momentum_energy_std(run, x, y, z, vx, vy, vz, h, m, rho, p, c,
                         c11, c12, c13, c22, c23, c33, sorted_keys, box, const,
                         cfg, ranges, lists, mask, jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = momentum_fields(x, y, z, vx, vy, vz, h, m, rho, p, c,
                               c11, c12, c13, c22, c23, c33)
    if jdata is not None:
        j_f = momentum_j_fields(*jdata)
    (ax, ay, az, du, dt_i), _ = run(momentum_spec(const), ranges, i_f, j_f, box,
                                    cfg, const, lists, mask=mask)
    return ax, ay, az, du, torch.min(dt_i), ranges.occupancy


# ``jdata`` (every op): the j-side inputs as j-buffers of their own length,
# under a mesh [own slab | halo rows] (parallel/exchange.py), which the
# runs (``ranges``, then required) index; the JAX package's jdata tuples,
# in its order. The i-side arrays are the targets.


@named_phase("density")
def pallas_density(x, y, z, h, m, sorted_keys, box: Box, const,
                   cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                   lists=None, mask: str = "own", jdata=None):
    """rho_i = K h_i^-3 (m_i + sum_j m_j W(d^2/h_i^2)) and neighbour counts;
    ``jdata`` (x, y, z, m). Returns (rho, nc, occupancy)."""
    return _density(_run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists, mask,
                    jdata)


def density_plain(x, y, z, h, m, sorted_keys, box: Box, const,
                  cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                  lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_density`` on any device."""
    return _density(_run_plain, x, y, z, h, m, sorted_keys, box, const, cfg, ranges,
                    lists, mask, jdata)


@named_phase("iad")
def pallas_iad(x, y, z, h, vol, sorted_keys, box: Box, const,
               cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
               lists=None, mask: str = "own", jdata=None):
    """IAD tensor components; ``vol`` is m/rho; ``jdata`` (x, y, z, vol).
    Returns ((c11..c33), occupancy)."""
    return _iad(_run, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges, lists, mask,
                jdata)


def iad_plain(x, y, z, h, vol, sorted_keys, box: Box, const,
              cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
              lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_iad`` on any device."""
    return _iad(_run_plain, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges,
                lists, mask, jdata)


@named_phase("momentum-energy")
def pallas_momentum_energy_std(x, y, z, vx, vy, vz, h, m, rho, p, c,
                               c11, c12, c13, c22, c23, c33, sorted_keys,
                               box: Box, const, cfg: NeighborConfig,
                               ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own",
                               jdata=None):
    """Pressure-gradient accelerations, energy rate and the Courant dt;
    ``jdata`` (x, y, z, h, vx, vy, vz, m, rho, p, c, c11..c33). Returns
    (ax, ay, az, du, min_dt, occupancy)."""
    return _momentum_energy_std(_run, x, y, z, vx, vy, vz, h, m, rho, p, c,
                                c11, c12, c13, c22, c23, c33, sorted_keys, box,
                                const, cfg, ranges, lists, mask, jdata)


def momentum_energy_std_plain(x, y, z, vx, vy, vz, h, m, rho, p, c,
                              c11, c12, c13, c22, c23, c33, sorted_keys,
                              box: Box, const, cfg: NeighborConfig,
                              ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own",
                              jdata=None):
    """Plain PyTorch version of ``pallas_momentum_energy_std`` on any device."""
    return _momentum_energy_std(_run_plain, x, y, z, vx, vy, vz, h, m, rho, p, c,
                                c11, c12, c13, c22, c23, c33, sorted_keys, box,
                                const, cfg, ranges, lists, mask, jdata)


def momentum_spec(const) -> OpSpec:
    if getattr(const, "sym_pairs", True):
        return MOMENTUM_ENERGY_STD
    return dataclasses.replace(MOMENTUM_ENERGY_STD, sym_j=None)


# ---------------------------------------------------------------------------
# The VE ops (pallas_pairs.pallas_xmass ... pallas_momentum_energy_ve), with
# the JAX wrappers' precombined per-particle ratios. With ``lists`` every
# op takes the list walk.
# ---------------------------------------------------------------------------


def ve_def_gradh_fields(x, y, z, h, m, xm):
    return [x, y, z, h, 1.0 / (h * h), m, xm], [x, y, z, m, xm]


def divv_curlv_fields(x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23, c33,
                      const):
    knorm = float(const.K) / (h * h * h * kx)
    return ([x, y, z, h, 1.0 / (h * h), c11, c12, c13, c22, c23, c33, knorm, vx, vy, vz],
            [x, y, z, xm, vx, vy, vz])


def av_switches_fields(x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                       c11, c12, c13, c22, c23, c33, const):
    i_f = [x, y, z, h, 1.0 / (h * h), float(const.K) / (h * h * h), c, divv,
           c11, c12, c13, c22, c23, c33, vx, vy, vz, alpha]
    return i_f, [x, y, z, c, vx, vy, vz, xm / kx, divv]


#: 1/3 rounded to float32, the exponent of XLA's cbrt
_THIRD_F32 = struct.unpack("f", struct.pack("f", 1.0 / 3.0))[0]


def eta_crit(nc: torch.Tensor) -> torch.Tensor:
    """av_clean's eta_crit = cbrt(32 pi / 3 / (nc + 1)), as XLA computes
    jnp.cbrt: the float32 quotient (a true division, not scalar / tensor's
    reciprocal product) to the power float32(1/3), rounded from float64,
    so that both devices agree."""
    q = torch.div(torch.tensor(32.0 * math.pi / 3.0, device=nc.device),
                  nc.to(torch.float32) + 1.0)
    return torch.pow(q.to(torch.float64), _THIRD_F32).to(torch.float32)


def momentum_ve_fields(x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                       c11, c12, c13, c22, c23, c33, nc=None, gradv=None):
    """The Atwood ramp's powers xm_i^(2-sigma) xm_j^sigma become
    xm_i^2 exp(sigma (ln xm_j - ln xm_i)) with the logs per particle; with
    ``gradv`` (av_clean) the i-side adds eta_crit = cbrt(32 pi/3/(nc+1))
    and both sides the six gradv components."""
    inv_h2 = 1.0 / (h * h)
    inv_h3 = inv_h2 / h
    rho = kx * m / xm
    inv_rho = 1.0 / rho
    lx = torch.log(xm)
    cs = [c11, c12, c13, c22, c23, c33]
    i_f = [x, y, z, h, inv_h2, inv_h3, vx, vy, vz, c, alpha, xm, xm * xm, lx,
           rho, inv_rho, prho, *cs]
    j_f = [x, y, z, inv_h2, inv_h3, vx, vy, vz, c, alpha, m, xm, xm * xm, lx,
           rho, inv_rho, prho, *cs]
    if gradv is not None:
        i_f += [eta_crit(nc), *gradv]
        j_f += list(gradv)
    return i_f, j_f


def momentum_ve_j_fields(x, y, z, h, vx, vy, vz, c, alpha, m, xm, kx, prho,
                         c11, c12, c13, c22, c23, c33, *gradv):
    """The VE momentum op's j-fields from the raw ones, in the order of its
    ``jdata`` (the JAX package's; av_clean appends the six gradv)."""
    inv_h2 = 1.0 / (h * h)
    rho = kx * m / xm
    return [x, y, z, inv_h2, inv_h2 / h, vx, vy, vz, c, alpha, m, xm, xm * xm, torch.log(xm),
            rho, 1.0 / rho, prho, c11, c12, c13, c22, c23, c33, *gradv]


def momentum_ve_spec(const, av_clean: bool) -> OpSpec:
    spec = MOMENTUM_ENERGY_VE_CLEAN if av_clean else MOMENTUM_ENERGY_VE
    if getattr(const, "sym_pairs", True):
        return spec
    return dataclasses.replace(spec, sym_j=None)


def _xmass(run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists, mask,
           jdata=None):
    rho0, nc, occ = _density(run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges,
                             lists, mask, jdata)
    return m / rho0, nc, occ


def _ve_def_gradh(run, x, y, z, h, m, xm, sorted_keys, box, const, cfg, ranges, lists,
                  mask, jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = ve_def_gradh_fields(x, y, z, h, m, xm)
    (kx, gradh), _ = run(VE_DEF_GRADH, ranges, i_f, _j(j_f, jdata), box, cfg, const, lists,
                         mask=mask)
    return (kx, gradh), ranges.occupancy


def _iad_divv_curlv(run, x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23, c33,
                    sorted_keys, box, const, cfg, ranges, with_gradv, lists, mask,
                    jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = divv_curlv_fields(x, y, z, vx, vy, vz, h, kx, xm,
                                 c11, c12, c13, c22, c23, c33, const)
    spec = IAD_DIVV_CURLV_GRADV if with_gradv else IAD_DIVV_CURLV
    outs, _ = run(spec, ranges, i_f, _j(j_f, jdata), box, cfg, const, lists, mask=mask)
    return tuple(outs), ranges.occupancy


def _av_switches(run, x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                 c11, c12, c13, c22, c23, c33, sorted_keys, box, dt, const, cfg,
                 ranges, lists, mask, jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = av_switches_fields(x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                                  c11, c12, c13, c22, c23, c33, const)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=x.device)
    (alpha_new,), _ = run(AV_SWITCHES, ranges, i_f, _j(j_f, jdata), box, cfg, const, lists,
                          dt=dt, mask=mask)
    return alpha_new, ranges.occupancy


def _momentum_energy_ve(run, x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                        c11, c12, c13, c22, c23, c33, sorted_keys, box, const, cfg,
                        nc, gradv, ranges, lists, mask, jdata=None):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = momentum_ve_fields(x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                                  c11, c12, c13, c22, c23, c33, nc=nc, gradv=gradv)
    if jdata is not None:
        j_f = momentum_ve_j_fields(*jdata)
    spec = momentum_ve_spec(const, gradv is not None)
    (ax, ay, az, du, dt_i), _ = run(spec, ranges, i_f, j_f, box, cfg, const, lists,
                                    mask=mask)
    return ax, ay, az, du, torch.min(dt_i), ranges.occupancy


@named_phase("xmass")
def pallas_xmass(x, y, z, h, m, sorted_keys, box: Box, const, cfg: NeighborConfig,
                 ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own", jdata=None):
    """VE volume element xm = m / rho0 over the density op (K2), and the
    neighbour counts. Returns (xm, nc, occupancy)."""
    return _xmass(_run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists, mask,
                  jdata)


def xmass_plain(x, y, z, h, m, sorted_keys, box: Box, const, cfg: NeighborConfig,
                ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_xmass`` on any device."""
    return _xmass(_run_plain, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists,
                  mask, jdata)


@named_phase("gradh")
def pallas_ve_def_gradh(x, y, z, h, m, xm, sorted_keys, box: Box, const,
                        cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                        lists=None, mask: str = "own", jdata=None):
    """VE normalisation kx and the grad-h correction
    (ve_def_gradh_kern.hpp:43-90). Returns ((kx, gradh), occupancy)."""
    return _ve_def_gradh(_run, x, y, z, h, m, xm, sorted_keys, box, const, cfg, ranges,
                         lists, mask, jdata)


def ve_def_gradh_plain(x, y, z, h, m, xm, sorted_keys, box: Box, const,
                       cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                       lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_ve_def_gradh`` on any device."""
    return _ve_def_gradh(_run_plain, x, y, z, h, m, xm, sorted_keys, box, const, cfg,
                         ranges, lists, mask, jdata)


@named_phase("divv-curlv")
def pallas_iad_divv_curlv(x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23, c33,
                          sorted_keys, box: Box, const, cfg: NeighborConfig,
                          ranges: Optional[GroupRanges] = None, with_gradv: bool = False,
                          lists=None, mask: str = "own", jdata=None):
    """Velocity divergence and curl through the IAD gradient
    (divv_curlv_kern.hpp:43-120), with ``with_gradv`` also the symmetrised
    velocity-gradient tensor of av_clean. Returns ((divv, curlv[, dv11,
    dv12, dv13, dv22, dv23, dv33]), occupancy)."""
    return _iad_divv_curlv(_run, x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23,
                           c33, sorted_keys, box, const, cfg, ranges, with_gradv, lists, mask,
                           jdata)


def iad_divv_curlv_plain(x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23, c33,
                         sorted_keys, box: Box, const, cfg: NeighborConfig,
                         ranges: Optional[GroupRanges] = None, with_gradv: bool = False,
                         lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_iad_divv_curlv`` on any device."""
    return _iad_divv_curlv(_run_plain, x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13,
                           c22, c23, c33, sorted_keys, box, const, cfg, ranges,
                           with_gradv, lists, mask, jdata)


@named_phase("av-switches")
def pallas_av_switches(x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                       c11, c12, c13, c22, c23, c33, sorted_keys, box: Box, dt, const,
                       cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                       lists=None, mask: str = "own", jdata=None):
    """Per-particle viscosity switch (av_switches_kern.hpp:43-137) over
    ``dt``, a 0-d float32 tensor on the particles' device (the kernel
    reads it there). Returns (alpha_new, occupancy)."""
    return _av_switches(_run, x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                        c11, c12, c13, c22, c23, c33, sorted_keys, box, dt, const, cfg,
                        ranges, lists, mask, jdata)


def av_switches_plain(x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                      c11, c12, c13, c22, c23, c33, sorted_keys, box: Box, dt, const,
                      cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                      lists=None, mask: str = "own", jdata=None):
    """Plain PyTorch version of ``pallas_av_switches`` on any device."""
    return _av_switches(_run_plain, x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                        c11, c12, c13, c22, c23, c33, sorted_keys, box, dt, const, cfg,
                        ranges, lists, mask, jdata)


@named_phase("momentum-energy")
def pallas_momentum_energy_ve(x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                              c11, c12, c13, c22, c23, c33, sorted_keys, box: Box, const,
                              cfg: NeighborConfig, nc=None, gradv=None,
                              ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own",
                              jdata=None):
    """VE momentum and energy (momentum_energy_kern.hpp:65-222): the
    Atwood-ramped volume elements, per-particle alpha viscosity and, with
    ``gradv`` (and ``nc``), the av_clean correction. Returns (ax, ay, az,
    du, min_dt, occupancy)."""
    return _momentum_energy_ve(_run, x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                               c11, c12, c13, c22, c23, c33, sorted_keys, box, const,
                               cfg, nc, gradv, ranges, lists, mask, jdata)


def momentum_energy_ve_plain(x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                             c11, c12, c13, c22, c23, c33, sorted_keys, box: Box, const,
                             cfg: NeighborConfig, nc=None, gradv=None,
                             ranges: Optional[GroupRanges] = None, lists=None, mask: str = "own",
                             jdata=None):
    """Plain PyTorch version of ``pallas_momentum_energy_ve`` on any device."""
    return _momentum_energy_ve(_run_plain, x, y, z, vx, vy, vz, h, m, prho, c, kx, xm,
                               alpha, c11, c12, c13, c22, c23, c33, sorted_keys, box,
                               const, cfg, nc, gradv, ranges, lists, mask, jdata)
