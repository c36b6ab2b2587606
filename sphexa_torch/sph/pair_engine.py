"""SPH pair ops with the neighbour search fused in: the candidate-run
prologue (torch) and the three std-SPH pair ops, each a hand-written CUDA
kernel with a plain PyTorch version beside it.

Counterpart of sphexa_tpu/sph/pallas_pairs.py. Targets are groups of ``cfg.group`` SFC-consecutive
particles; ``group_cell_ranges`` finds each group's candidate cells,
culls them against the group's bbox inflated by 2 max h, and merges
SFC-adjacent survivors into contiguous runs of the sorted arrays. Each op
then walks its group's runs, applying a per-run periodic shift (or the
per-pair minimum-image fold when the window spans the whole periodic grid,
``engine_fold``), masks pairs to ``d^2 < 4 h_i^2`` (and ``d^2 < 4 h_j^2``
for the symmetric momentum cutoff) minus the self pair, and accumulates.

With persistent lists (sph/pair_lists.py) the ops take ``lists=``:
density and IAD run the same engine on the lists' pruned runs, and the
momentum op runs the list walk, which does the pair math only on the
lanes the mark pass kept (``engine_lists_kernel``/``engine_lists_plain``).

Dispatch of every op wrapper (``pallas_density``, ``pallas_iad``,
``pallas_momentum_energy_std``, named as in the JAX package):

- CUDA tensors launch the kernel in csrc/pair_engine.cu, or raise;
- CPU tensors run the plain PyTorch version (``*_plain``), which the
  tests compare with the JAX package and chip_smoke.py compares with the
  kernel on the card.

Each wrapper counts its kernel launches in ``LAUNCHES``.
"""

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.neighbors.cell_list import NeighborConfig, _window_offsets
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sfc.hilbert import hilbert_encode
from sphexa_torch.sfc.morton import morton_encode
from sphexa_torch.sph.kernels import kernel_poly_coeffs, sinc_poly_eval

#: kernel launches per op since the last ``reset_launches()``; only the
#: wrappers' CUDA branch adds to it
LAUNCHES: Dict[str, int] = {"density": 0, "iad": 0, "momentum_energy_std": 0,
                            "momentum_energy_std_lists": 0, "mark": 0}

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


def group_cell_ranges(x, y, z, h, sorted_keys, box: Box,
                      cfg: NeighborConfig, radius_pad=0.0) -> GroupRanges:
    """Candidate runs of every group, culled, merged and compacted
    (pallas_pairs.group_cell_ranges). ``occupancy`` is the densest kept
    cell, or ``cap + 1`` when some group's search extent outgrew the
    window block; either above ``cap`` means the config must be re-sized
    and the step replayed. ``radius_pad`` (a float32 0-d tensor: the
    list-build skin) widens each group's search radius to
    2 max h + radius_pad, so that the runs stay valid while particles
    drift between list rebuilds."""
    start, lens, keep, shifts, raw_len, window_ok = window_cells_culled(
        x, y, z, h, sorted_keys, box, cfg, radius_pad)
    starts_c, lens_c, sh, ncells = _merge_runs(
        start, lens, keep, shifts, cfg.run_cap, cfg.gap)
    occupancy = torch.where(window_ok, torch.where(keep, raw_len, 0).max(), cfg.cap + 1)
    boxl = torch.where(box.periodic_mask, box.lengths, 1e30)
    i32 = torch.int32
    return GroupRanges(
        starts=starts_c.to(i32).contiguous(), lens=lens_c.to(i32).contiguous(),
        shift_x=sh[0].contiguous(), shift_y=sh[1].contiguous(),
        shift_z=sh[2].contiguous(), ncells=ncells.to(i32).contiguous(),
        occupancy=occupancy, boxl=boxl.to(torch.float32),
    )


def window_cells_culled(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig,
                        radius_pad=0.0):
    """Every group's window^3 block of grid cells with its sorted-array
    range and the cull verdict: a cell is kept when it exists (periodic
    images de-aliased, open-boundary cells inside the grid), is non-empty
    and, off the fold path, its AABB at its image position meets the
    group's bbox inflated by 2 max h + radius_pad. Returns (start, lens, keep, shifts,
    raw_len, window_ok), shaped (NG, W3[, 3])."""
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

    if ncell**3 <= 4 * max(n, 1024):
        # one cell-starts table for the whole grid, then gathers
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


@functools.lru_cache(maxsize=None)
def _window_offsets_on(window: int, device: torch.device) -> torch.Tensor:
    """The window's cell offsets on the device, copied there once (a copy
    in every step would sync the stream); shared read-only."""
    return torch.as_tensor(_window_offsets(window), device=device)


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
# by the CUDA kernel's Op structs (csrc/pair_engine.cu).
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


def op_consts(const) -> dict:
    return {"coeffs": kernel_poly_coeffs(float(const.sinc_index), const.kernel_choice),
            "K": float(const.K), "k_cour": float(const.k_cour)}


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

    return _engine_plain_core(spec, i_fields, j_fields, group, consts, total,
                              candidates, ranges.boxl)


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

    return _engine_plain_core(spec, i_fields, j_fields, group, consts, total,
                              candidates, ranges.boxl)


def _engine_plain_core(spec: OpSpec, i_fields: Sequence, j_fields: Sequence,
                       group: int, consts: dict, total: torch.Tensor,
                       candidates: Callable, boxl: torch.Tensor):
    """Masked pair math over each group's candidates, in chunks of groups
    whose padded (groups, G, C) tiles fit the budget. ``total`` holds each
    group's candidate count; ``candidates(groups, C)`` returns the padded
    (groups, C) candidate indices, their validity and their per-candidate
    shifts (None: fold every pair with the periods ``boxl``)."""
    n = i_fields[0].shape[0]
    dev = i_fields[0].device
    tile_elems = PLAIN_TILE_ELEMS[dev.type]
    I_all = [_pad_groups(a, group) for a in i_fields]  # (NG, G) each
    ng = I_all[0].shape[0]
    lx, ly, lz = (boxl[d] for d in range(3))
    tgt_all = torch.arange(ng * group, device=dev).reshape(ng, group)

    outs = [torch.empty(ng, group, device=dev) for _ in range(spec.num_out)]
    nc_out = torch.empty(ng, group, dtype=torch.int32, device=dev)
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
        xi, yi, zi, hi = (a[sl][:, :, None] for a in I_all[:4])  # (gc, G, 1)
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
        mask = valid[:, None, :] & (d2 < 4.0 * hi * hi)
        if spec.sym_j is not None:
            mask = mask & (d2 * J[3] < 4.0)
        mask = mask & (cand[:, None, :] != tgt_all[sl][:, :, None])
        # the pair math runs on the masked pairs only, in candidate order,
        # and each target's terms are summed (or maxed, from 0) in turn
        gi, ti, ci = mask.nonzero(as_tuple=True)
        flat = gi * group + ti
        width = (g1 - g0) * group
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
            accs.append(acc.reshape(g1 - g0, group))
        nc = torch.bincount(flat, minlength=width).reshape(g1 - g0, group).to(torch.int32)
        res = spec.finalize([a[sl] for a in I_all], accs, nc, consts)
        for o, r in zip(outs, res):
            o[sl] = r
        nc_out[sl] = nc
        g0 = g1
    return [o.reshape(-1)[:n] for o in outs], nc_out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

_MAX_F = 24
_MAX_OUT = 8
_NCOEF = 14


class EngineArgs(ctypes.Structure):
    """Mirror of ``EngineArgs`` in csrc/pair_ops.cuh (same field order)."""

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
        ("coeffs", ctypes.c_float * _NCOEF),
        ("bits", ctypes.c_void_p),
        ("slot_cap", ctypes.c_int32),
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


def _engine_args(spec: OpSpec, ranges: GroupRanges, i_fields: Sequence,
                 j_fields: Sequence, fold: bool, group: int, consts: dict):
    """Check the inputs of a CUDA launch and fill its EngineArgs; returns
    (args, outs, nc), the outputs allocated on the inputs' device."""
    x = i_fields[0]
    dev, n = x.device, x.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{spec.name}: the kernel needs CUDA tensors, got {dev}")
    if not 0 < group <= 256 or group % 32:
        raise ValueError(f"group must be a multiple of 32 in (0, 256], got {group}")
    if len(i_fields) != spec.num_i or len(j_fields) != spec.num_j:
        raise ValueError(f"{spec.name}: field count mismatch")
    for k, a in enumerate(i_fields):
        check_cuda_f32(f"{spec.name} i-field {k}", a, n, dev)
    for k, a in enumerate(j_fields):
        check_cuda_f32(f"{spec.name} j-field {k}", a, n, dev)
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

    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(spec.num_out)]
    nc = torch.empty(n, dtype=torch.int32, device=dev) if spec.want_nc else None

    args = EngineArgs()
    args.starts = ranges.starts.data_ptr()
    args.lens = ranges.lens.data_ptr()
    args.shift_x = ranges.shift_x.data_ptr()
    args.shift_y = ranges.shift_y.data_ptr()
    args.shift_z = ranges.shift_z.data_ptr()
    args.ncells = ranges.ncells.data_ptr()
    for k, a in enumerate(i_fields):
        args.ifields[k] = a.data_ptr()
    for k, a in enumerate(j_fields):
        args.jfields[k] = a.data_ptr()
    for k, a in enumerate(outs):
        args.outs[k] = a.data_ptr()
    args.nc = nc.data_ptr() if nc is not None else None
    args.n, args.num_groups, args.w3, args.group = n, ng, w3, group
    args.fold = int(fold)
    args.sym_j = -1 if spec.sym_j is None else spec.sym_j
    # a device pointer: reading the periods on the host would sync the stream
    args.boxl = ranges.boxl.data_ptr()
    args.K = consts["K"]
    args.mhalf_K = -consts["K"] * 0.5
    args.k_cour = consts["k_cour"]
    coeffs = consts["coeffs"]
    if len(coeffs) != _NCOEF:
        raise ValueError(f"the kernel takes {_NCOEF} polynomial coefficients")
    for k, v in enumerate(coeffs):
        args.coeffs[k] = v
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
    LAUNCHES[entry] += 1


def engine_kernel(spec: OpSpec, ranges: GroupRanges, i_fields: Sequence,
                  j_fields: Sequence, fold: bool, group: int, consts: dict):
    """Launch the op's CUDA kernel on the current stream (no sync).
    Returns (outs (n,) x num_out, nc (n,) int32 or None)."""
    args, outs, nc = _engine_args(spec, ranges, i_fields, j_fields, fold, group, consts)
    launch(spec.name, args, i_fields[0].device)
    return outs, nc


def engine_lists_kernel(spec: OpSpec, lists, i_fields: Sequence,
                        j_fields: Sequence, group: int, consts: dict):
    """Launch the op's list-walk kernel (csrc/pair_lists.cu) on the
    current stream (no sync). Returns (outs (n,) x num_out, nc or None)."""
    args, outs, nc = _engine_args(spec, lists.ranges, i_fields, j_fields, False,
                                  group, consts)
    dev = i_fields[0].device
    ng, scap = lists.ranges.num_groups, lists.slot_cap
    check_table("lists.bits", lists.bits, torch.int32, (ng, scap, LANES // 32), dev)
    args.bits = lists.bits.data_ptr()
    args.slot_cap = scap
    launch(f"{spec.name}_lists", args, dev)
    return outs, nc


def _run(spec: OpSpec, ranges, i_fields, j_fields, box, cfg, const, lists=None):
    """Dispatch by device: CUDA launches the kernel (the list walk when
    ``lists`` is given), CPU runs the plain version; anything else raises."""
    dev = i_fields[0].device
    if dev.type == "cuda":
        consts = op_consts(const)
        if lists is not None:
            return engine_lists_kernel(spec, lists, i_fields, j_fields, cfg.group, consts)
        return engine_kernel(spec, ranges, i_fields, j_fields, engine_fold(box, cfg),
                             cfg.group, consts)
    if dev.type == "cpu":
        return _run_plain(spec, ranges, i_fields, j_fields, box, cfg, const, lists)
    raise ValueError(f"unsupported device {dev}")


def _run_plain(spec: OpSpec, ranges, i_fields, j_fields, box, cfg, const, lists=None):
    if lists is not None:
        return engine_lists_plain(spec, lists, i_fields, j_fields, cfg.group,
                                  op_consts(const))
    return engine_plain(spec, ranges, i_fields, j_fields, engine_fold(box, cfg),
                        cfg.group, op_consts(const))


# ---------------------------------------------------------------------------
# The three std-SPH ops (pallas_pairs.pallas_density / pallas_iad /
# pallas_momentum_energy_std). Each builds its precombined i/j fields,
# runs the engine and applies the post-processing of the JAX wrapper.
# With ``lists`` (persistent PairLists) the candidate runs are the lists'
# pruned ones, ``sorted_keys`` and ``ranges`` are unused, and the momentum
# op takes the list walk.
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
    j_f = [x, y, z, inv_h2, vx, vy, vz, c, m, m / (rho * h * h * h), p / rho,
           c11, c12, c13, c22, c23, c33]
    return i_f, j_f


def _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg):
    if lists is not None:
        return lists.ranges
    return ranges if ranges is not None else \
        group_cell_ranges(x, y, z, h, sorted_keys, box, cfg)


def _density(run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    (rho,), nc = run(DENSITY, ranges, *density_fields(x, y, z, h, m), box, cfg, const)
    return rho, nc, ranges.occupancy


def _iad(run, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges, lists):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    cs, _ = run(IAD, ranges, *iad_fields(x, y, z, h, vol), box, cfg, const)
    return tuple(cs), ranges.occupancy


def _momentum_energy_std(run, x, y, z, vx, vy, vz, h, m, rho, p, c,
                         c11, c12, c13, c22, c23, c33, sorted_keys, box, const,
                         cfg, ranges, lists):
    ranges = _with_ranges(ranges, lists, x, y, z, h, sorted_keys, box, cfg)
    i_f, j_f = momentum_fields(x, y, z, vx, vy, vz, h, m, rho, p, c,
                               c11, c12, c13, c22, c23, c33)
    (ax, ay, az, du, dt_i), _ = run(momentum_spec(const), ranges, i_f, j_f, box,
                                    cfg, const, lists)
    return ax, ay, az, du, torch.min(dt_i), ranges.occupancy


def pallas_density(x, y, z, h, m, sorted_keys, box: Box, const,
                   cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                   lists=None):
    """rho_i = K h_i^-3 (m_i + sum_j m_j W(d^2/h_i^2)) and neighbour counts.
    Returns (rho, nc, occupancy)."""
    return _density(_run, x, y, z, h, m, sorted_keys, box, const, cfg, ranges, lists)


def density_plain(x, y, z, h, m, sorted_keys, box: Box, const,
                  cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
                  lists=None):
    """Plain PyTorch version of ``pallas_density`` on any device."""
    return _density(_run_plain, x, y, z, h, m, sorted_keys, box, const, cfg, ranges,
                    lists)


def pallas_iad(x, y, z, h, vol, sorted_keys, box: Box, const,
               cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
               lists=None):
    """IAD tensor components; ``vol`` is m/rho. Returns ((c11..c33), occupancy)."""
    return _iad(_run, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges, lists)


def iad_plain(x, y, z, h, vol, sorted_keys, box: Box, const,
              cfg: NeighborConfig, ranges: Optional[GroupRanges] = None,
              lists=None):
    """Plain PyTorch version of ``pallas_iad`` on any device."""
    return _iad(_run_plain, x, y, z, h, vol, sorted_keys, box, const, cfg, ranges,
                lists)


def pallas_momentum_energy_std(x, y, z, vx, vy, vz, h, m, rho, p, c,
                               c11, c12, c13, c22, c23, c33, sorted_keys,
                               box: Box, const, cfg: NeighborConfig,
                               ranges: Optional[GroupRanges] = None, lists=None):
    """Pressure-gradient accelerations, energy rate and the Courant dt.
    Returns (ax, ay, az, du, min_dt, occupancy)."""
    return _momentum_energy_std(_run, x, y, z, vx, vy, vz, h, m, rho, p, c,
                                c11, c12, c13, c22, c23, c33, sorted_keys, box,
                                const, cfg, ranges, lists)


def momentum_energy_std_plain(x, y, z, vx, vy, vz, h, m, rho, p, c,
                              c11, c12, c13, c22, c23, c33, sorted_keys,
                              box: Box, const, cfg: NeighborConfig,
                              ranges: Optional[GroupRanges] = None, lists=None):
    """Plain PyTorch version of ``pallas_momentum_energy_std`` on any device."""
    return _momentum_energy_std(_run_plain, x, y, z, vx, vy, vz, h, m, rho, p, c,
                                c11, c12, c13, c22, c23, c33, sorted_keys, box,
                                const, cfg, ranges, lists)


def momentum_spec(const) -> OpSpec:
    if getattr(const, "sym_pairs", True):
        return MOMENTUM_ENERGY_STD
    return dataclasses.replace(MOMENTUM_ENERGY_STD, sym_j=None)
