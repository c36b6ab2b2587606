"""Persistent neighbour lists (sphexa_tpu/sph/pair_lists.py).

A list build takes the sorted arrays and each group's candidate runs,
widened by a skin (``group_cell_ranges(radius_pad=skin)``), and runs the
mark pass: for every slot, one (run, 128-aligned chunk) pair of a group's
runs, it records which of the chunk's 128 lanes lie inside the group's
bbox inflated by 2 max h + skin, as a 128-bit mask. Chunks with no marked
lane are then pruned from the runs. Between rebuilds the sorted order is
frozen: a steady step skips the box regrow, the sort and the run
prologue, and every pair op walks only the marked lanes (the list walk).
The lists stay valid while 2 (max h growth + max drift) <= skin
(``list_slack``).

``mark_chunks`` launches the mark kernel (csrc/pair_lists.cu) on CUDA
tensors and runs ``mark_plain`` on CPU tensors. The JAX package's staging
bookkeeping (fill, emit, tail, pre-rotated gather indices) served the
TPU's 256-lane staging window and has no counterpart here: the list walk
ranks the marked lanes from the bits itself.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from sphexa_torch.neighbors.cell_list import NeighborConfig, pad_cap
from sphexa_torch.sfc.box import Box
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.pair_engine import LANES, GroupRanges

WORDS = LANES // 32  # 32-bit mask words per slot


class PairLists(NamedTuple):
    """Build-time candidate structure shared by the list-mode pair ops."""

    ranges: GroupRanges       # pruned build-time runs, (NG, S_cap) tables
    bits: torch.Tensor        # (NG, S_cap, 4) int32: lane l of slot s is bit
    #                           l % 32 of word l // 32 (slots in pruned order)
    cnt: torch.Tensor         # (NG, S_cap) int32 marked lanes per slot
    overflow: torch.Tensor    # () int32: 1 if a group needed > S_cap slots
    lanes_total: torch.Tensor  # () float32 sum of cnt (diagnostics)
    xb: torch.Tensor          # build positions and smoothing lengths, for
    yb: torch.Tensor          # the validity test (the Verlet skin)
    zb: torch.Tensor
    hb: torch.Tensor
    skin: torch.Tensor        # () float32 coverage slack baked into ranges
    word_off: torch.Tensor    # (NG + 1,) int32 first mask word of each group
    # the list walk's accepted-candidate words (pair_engine.engine_lists_kernel
    # mask="write" fills it, mask="read" reads it): int32, word_off[NG] x
    # group words on the card; None on the CPU, whose plain walk keeps none
    mask_words: Optional[torch.Tensor]

    @property
    def slot_cap(self) -> int:
        return self.bits.shape[1]


def list_slack(x, y, z, h, lists: PairLists) -> torch.Tensor:
    """Remaining skin fraction (<= 1): positive while the build-time
    coverage (bbox inflated by 2 h_build + skin) still covers every
    current 2 h_i sphere, which holds while 2 (max h growth + max drift)
    <= skin. Drift is measured unfolded, so a particle that wraps the
    periodic box shows a jump of about L and forces a rebuild."""
    dx = x - lists.xb
    dy = y - lists.yb
    dz = z - lists.zb
    d2 = dx * dx + dy * dy + dz * dz
    drift = torch.sqrt(torch.max(d2))
    growth = torch.clamp(torch.max(h - lists.hb), min=0.0)
    used = 2.0 * (growth + drift)
    return (lists.skin - used) / torch.clamp(lists.skin, min=1e-30)


def lists_valid(x, y, z, h, lists: PairLists) -> torch.Tensor:
    """Verlet-skin validity; zero used skin counts as valid."""
    return list_slack(x, y, z, h, lists) >= 0.0


class MarkArgs(ctypes.Structure):
    """Mirror of ``MarkArgs`` in csrc/pair_lists.cu (same field order)."""

    _fields_ = [
        ("starts", ctypes.c_void_p),
        ("lens", ctypes.c_void_p),
        ("shift_x", ctypes.c_void_p),
        ("shift_y", ctypes.c_void_p),
        ("shift_z", ctypes.c_void_p),
        ("ncells", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("z", ctypes.c_void_p),
        ("h", ctypes.c_void_p),
        ("skin", ctypes.c_void_p),
        ("bits", ctypes.c_void_p),
        ("cnt", ctypes.c_void_p),
        ("total", ctypes.c_void_p),
        ("n", ctypes.c_int32),
        ("num_groups", ctypes.c_int32),
        ("w3", ctypes.c_int32),
        ("group", ctypes.c_int32),
        ("slot_cap", ctypes.c_int32),
    ]


def mark_kernel(ranges: GroupRanges, x, y, z, h, skin, slot_cap: int, group: int):
    """Launch the mark pass (csrc/pair_lists.cu) on the current stream (no
    sync). Returns (bits (NG, S_cap, 4) int32, cnt (NG, S_cap) int32,
    total (NG,) int32 chunks of each group's runs)."""
    dev, n = x.device, x.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"mark_kernel needs CUDA tensors, got {dev}")
    if slot_cap <= 0:
        raise ValueError(f"slot_cap must be positive, got {slot_cap}")
    ng, w3 = ranges.starts.shape
    if ng != -(-n // group):
        raise ValueError(f"ranges hold {ng} groups, {n} targets need {-(-n // group)}")
    for nm, a in (("x", x), ("y", y), ("z", z), ("h", h)):
        pe.check_cuda_f32(nm, a, n, dev)
    for nm, a, dt in (("starts", ranges.starts, torch.int32),
                      ("lens", ranges.lens, torch.int32),
                      ("shift_x", ranges.shift_x, torch.float32),
                      ("shift_y", ranges.shift_y, torch.float32),
                      ("shift_z", ranges.shift_z, torch.float32)):
        pe.check_table(f"ranges.{nm}", a, dt, (ng, w3), dev)
    pe.check_table("ranges.ncells", ranges.ncells, torch.int32, (ng,), dev)
    pe.check_table("skin", skin, torch.float32, (), dev)

    bits = torch.empty(ng, slot_cap, WORDS, dtype=torch.int32, device=dev)
    cnt = torch.empty(ng, slot_cap, dtype=torch.int32, device=dev)
    total = torch.empty(ng, dtype=torch.int32, device=dev)
    args = MarkArgs()
    for nm in ("starts", "lens", "shift_x", "shift_y", "shift_z", "ncells"):
        setattr(args, nm, getattr(ranges, nm).data_ptr())
    for nm, a in (("x", x), ("y", y), ("z", z), ("h", h), ("skin", skin),
                  ("bits", bits), ("cnt", cnt), ("total", total)):
        setattr(args, nm, a.data_ptr())
    args.n, args.num_groups, args.w3, args.group = n, ng, w3, group
    args.slot_cap = slot_cap
    pe.launch("mark", args, dev)
    return bits, cnt, total


def mark_plain(ranges: GroupRanges, x, y, z, h, skin, slot_cap: int, group: int):
    """Plain PyTorch version of ``mark_kernel`` on any device: every
    group's slots expanded into (groups, slots, 128) lane tiles, tested,
    and packed into bits, in chunks of groups that fit the tile budget."""
    dev = x.device
    xg, yg, zg, hg = (pe._pad_groups(a, group) for a in (x, y, z, h))
    r = 2.0 * hg.amax(1) + skin  # (NG,) float32
    lo = [a.amin(1) - r for a in (xg, yg, zg)]
    hi = [a.amax(1) + r for a in (xg, yg, zg)]
    # a slot past a group's chunks maps to rows past its last run: no lane
    # lies in the run, so it reads as empty
    w_of_s, c_of_s, total = pe.chunk_slots(ranges, slot_cap)
    ng = w_of_s.shape[0]
    s_w = ranges.starts.to(torch.int64).gather(1, w_of_s)
    e_w = s_w + ranges.lens.to(torch.int64).gather(1, w_of_s)
    row = s_w // LANES + c_of_s
    shifts = [a.gather(1, w_of_s) for a in (ranges.shift_x, ranges.shift_y, ranges.shift_z)]
    lane = torch.arange(LANES, device=dev)
    weight = torch.ones(1, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)

    bits = torch.empty(ng, slot_cap, WORDS, dtype=torch.int32, device=dev)
    cnt = torch.empty(ng, slot_cap, dtype=torch.int32, device=dev)
    step = max(1, pe.PLAIN_TILE_ELEMS[dev.type] // max(1, slot_cap * LANES))
    for g0 in range(0, ng, step):
        sl = slice(g0, min(ng, g0 + step))
        cand = row[sl, :, None] * LANES + lane  # (gc, S, 128)
        m = (cand >= s_w[sl, :, None]) & (cand < e_w[sl, :, None])
        ci = torch.where(m, cand, 0)
        for a, sh, l, u in zip((x, y, z), shifts, lo, hi):
            j = a[ci] + sh[sl, :, None]
            m &= (j >= l[sl, None, None]) & (j <= u[sl, None, None])
        words = (m.reshape(*m.shape[:2], WORDS, 32).to(torch.int64) * weight).sum(-1)
        bits[sl] = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
        cnt[sl] = m.sum(-1).to(torch.int32)
    return bits, cnt, total.to(torch.int32)


def mark_chunks(ranges: GroupRanges, x, y, z, h, skin, slot_cap: int, group: int):
    """Dispatch by device: CUDA launches the mark kernel, CPU runs
    ``mark_plain``; anything else raises."""
    if x.device.type == "cuda":
        return mark_kernel(ranges, x, y, z, h, skin, slot_cap, group)
    if x.device.type == "cpu":
        return mark_plain(ranges, x, y, z, h, skin, slot_cap, group)
    raise ValueError(f"unsupported device {x.device}")


def _prune_empty_chunks(ranges: GroupRanges, cnt, slot_cap: int):
    """Rebuild the runs without the chunks that hold no marked lane
    (pair_lists._prune_empty_chunks): new runs are maximal consecutive
    kept chunks within one original run, with exact particle bounds, so
    no pair is lost and none is counted twice. Returns (new_ranges, perm),
    perm[g, k] the original slot of new slot k (kept slots first, in order).

    The JAX package's reverse scan over the slots is one scatter here:
    each slot is labelled with its block (a head and the slots up to the
    next head), and a head's run ends at the largest chunk end in its
    block, which is the end of its last kept chunk."""
    starts, lens = ranges.starts.to(torch.int64), ranges.lens.to(torch.int64)
    ng = starts.shape[0]
    dev = starts.device
    w_of_s, c_of_s, total = pe.chunk_slots(ranges, slot_cap)
    s_w = starts.gather(1, w_of_s)
    ln_w = lens.gather(1, w_of_s)
    row = s_w // LANES + c_of_s
    lo = torch.maximum(s_w, row * LANES)
    hi = torch.minimum(s_w + ln_w, (row + 1) * LANES)

    s_idx = torch.arange(slot_cap, device=dev)
    kept = (cnt > 0) & (s_idx[None, :] < total[:, None])
    kept_prev = torch.cat([torch.zeros(ng, 1, dtype=torch.bool, device=dev),
                           kept[:, :-1]], dim=1)
    head = kept & ((c_of_s == 0) | ~kept_prev)
    block = torch.cumsum(head, dim=1)  # 0 before the first head
    end_eff = torch.where(kept, hi, -1)
    block_end = torch.full((ng, slot_cap + 1), -1, dtype=torch.int64, device=dev)
    block_end.scatter_reduce_(1, block, end_eff, "amax", include_self=True)
    run_end = block_end.gather(1, block)

    order = torch.sort((~head).to(torch.int32), dim=1, stable=True).indices
    hk = head.gather(1, order)
    i32 = torch.int32

    def heads(a, zero):
        return torch.where(hk, a.gather(1, order), zero).contiguous()

    new = GroupRanges(
        starts=heads(lo, 0).to(i32), lens=heads(run_end - lo, 0).to(i32),
        shift_x=heads(ranges.shift_x.gather(1, w_of_s), 0.0),
        shift_y=heads(ranges.shift_y.gather(1, w_of_s), 0.0),
        shift_z=heads(ranges.shift_z.gather(1, w_of_s), 0.0),
        ncells=head.sum(dim=1).to(i32), occupancy=ranges.occupancy, boxl=ranges.boxl,
    )
    perm = torch.sort((~kept).to(torch.int32), dim=1, stable=True).indices
    return new, perm


def build_pair_lists(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig,
                     skin: torch.Tensor, slot_cap: int) -> PairLists:
    """Build the persistent lists from SFC-sorted arrays: runs widened by
    ``skin`` (a float32 0-d tensor), the mark pass, the pruned runs and the
    overflow sentinel, and on the card the walk's mask-word buffer. No host
    sync on the CPU; on the card one (the buffer's size)."""
    if pe.engine_fold(box, cfg):
        raise ValueError(
            "persistent lists need per-cell image shifts; a grid in fold mode "
            "streams instead")
    ranges = pe.group_cell_ranges(x, y, z, h, sorted_keys, box, cfg, radius_pad=skin)
    bits, cnt, total = mark_chunks(ranges, x, y, z, h, skin, slot_cap, cfg.group)
    ranges, perm = _prune_empty_chunks(ranges, cnt, slot_cap)
    cnt = cnt.gather(1, perm).contiguous()
    bits = bits.gather(1, perm[:, :, None].expand(-1, -1, WORDS)).contiguous()
    word_off = pe.mask_word_offsets(cnt)
    words = None
    if x.device.type == "cuda":
        words = torch.empty(int(word_off[-1]) * cfg.group, dtype=torch.int32, device=x.device)
    return PairLists(
        ranges=ranges, bits=bits, cnt=cnt,
        overflow=(total.max() > slot_cap).to(torch.int32),
        lanes_total=cnt.sum(dim=1).to(torch.float32).sum(),
        xb=x, yb=y, zb=z, hb=h, skin=skin, word_off=word_off, mask_words=words,
    )


def _slot_need(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig, skin) -> int:
    ranges = pe.group_cell_ranges(x, y, z, h, sorted_keys, box, cfg, radius_pad=skin)
    _, _, total = pe.chunk_slots(ranges, 1)
    return int(total.max())


def estimate_slot_cap(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig,
                      skin: float, margin: float = 1.3, quantum: int = 8) -> int:
    """Host-side sizing of the per-group slot budget from the current
    (SFC-sorted) distribution, at configure time like the cell caps; the
    build's ``overflow`` sentinel guards against outgrowing it."""
    skin_t = torch.tensor(skin, dtype=torch.float32, device=x.device)
    return pad_cap(_slot_need(x, y, z, h, sorted_keys, box, cfg, skin_t), margin, quantum)
