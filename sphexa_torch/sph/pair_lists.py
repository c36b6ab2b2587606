"""Persistent neighbour lists (sphexa_tpu/sph/pair_lists.py).

A list build takes the sorted arrays and each group's window cells,
culled against its bbox widened by a skin
(``window_cells_culled(radius_pad=skin)``). It merges the kept cells
into candidate runs and runs the mark pass: for every slot, one (run,
128-aligned chunk) pair of a group's runs, it records which of the
chunk's 128 lanes lie inside the group's bbox inflated by 2 max h +
skin, as a 128-bit mask. Chunks with no marked lane are then pruned from
the runs. Between rebuilds the sorted order is frozen: a steady step
skips the box regrow, the sort and the run prologue, and every pair op
walks only the marked lanes (the list walk). The lists stay valid while
2 (max h growth + max drift) <= skin (``list_slack``).

``build_lists`` launches the list build (csrc/pair_lists.cu: merge, mark
and prune in one kernel) on CUDA tensors and runs ``build_lists_plain``,
the composition ``_merge_runs`` -> ``mark_plain`` ->
``_prune_empty_chunks`` -> gathers, on CPU tensors. The JAX package's
staging bookkeeping (fill, emit, tail, pre-rotated gather indices)
served the TPU's 256-lane staging window and has no counterpart here:
the list walk ranks the marked lanes from the bits itself.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from sphexa_torch.kernels import costs
from sphexa_torch.neighbors.cell_list import NeighborConfig, pad_cap
from sphexa_torch.sfc.box import Box
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.pair_engine import LANES, GroupRanges
from sphexa_torch.util.phases import named_phase

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


@named_phase("neighbors")
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


class BuildArgs(ctypes.Structure):
    """Mirror of ``BuildArgs`` in csrc/pair_lists.cu (same field order)."""

    _fields_ = [(nm, ctypes.c_void_p) for nm in (
        "cell_start", "cell_len", "cell_keep", "cell_shift", "x", "y", "z", "h", "skin",
        "starts", "lens", "shift_x", "shift_y", "shift_z", "ncells", "bits", "cnt", "total")] + [
        (nm, ctypes.c_int32) for nm in (
            "n", "num_groups", "w3", "group", "slot_cap", "run_cap", "gap")]


#: the run tables of a ``GroupRanges`` that a list build writes (the rest,
#: occupancy and boxl, come from the cull)
RUN_TABLES = GroupRanges._fields[:6]


def build_lists_launcher(cull, x, y, z, h, skin, slot_cap: int, cfg: NeighborConfig):
    """The list build's arguments checked and built once. ``cull`` is
    (start, lens, keep, shifts) as ``pair_engine.window_cells_culled``
    gives them: (NG, W3) int64, int64, bool and (NG, W3, 3) float32.
    Returns (launch, (tables, bits, cnt, total)): each ``launch()`` runs
    csrc/pair_lists.cu's list build on the current stream (no sync) into
    those outputs and raises on a launch error; ``tables`` are the pruned
    ``RUN_TABLES``. ``build_lists_kernel`` launches it once; a timing
    loop may launch it again without the argument building."""
    from sphexa_torch.kernels.build import load_library

    dev, n = x.device, x.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the list build needs CUDA tensors, got {dev}")
    if not 0 < slot_cap < 1 << 16:
        raise ValueError(f"slot_cap must lie in [1, 65535], got {slot_cap}")
    if n >= 1 << 30:
        raise ValueError(f"the list build takes fewer than 2^30 particles, got {n}")
    start, lens, keep, shifts = cull
    ng, w3 = start.shape
    if ng != -(-n // cfg.group):
        raise ValueError(f"the cull holds {ng} groups, {n} targets need {-(-n // cfg.group)}")
    for nm, a in (("x", x), ("y", y), ("z", z), ("h", h)):
        pe.check_cuda_f32(nm, a, n, dev)
    pe.check_table("start", start, torch.int64, (ng, w3), dev)
    pe.check_table("lens", lens, torch.int64, (ng, w3), dev)
    pe.check_table("keep", keep, torch.bool, (ng, w3), dev)
    pe.check_table("shifts", shifts, torch.float32, (ng, w3, 3), dev)
    pe.check_table("skin", skin, torch.float32, (), dev)

    i32, f32 = torch.int32, torch.float32
    tables = (*(torch.empty(ng, slot_cap, dtype=t, device=dev) for t in (i32, i32, f32, f32, f32)),
              torch.empty(ng, dtype=i32, device=dev))
    bits = torch.empty(ng, slot_cap, WORDS, dtype=i32, device=dev)
    cnt = torch.empty(ng, slot_cap, dtype=i32, device=dev)
    total = torch.empty(ng, dtype=i32, device=dev)
    args = BuildArgs()
    for nm, a in zip(("cell_start", "cell_len", "cell_keep", "cell_shift", "x", "y", "z", "h",
                      "skin", *RUN_TABLES, "bits", "cnt", "total"),
                     (*cull, x, y, z, h, skin, *tables, bits, cnt, total)):
        setattr(args, nm, a.data_ptr())
    args.n, args.num_groups, args.w3, args.group = n, ng, w3, cfg.group
    args.slot_cap, args.run_cap, args.gap = slot_cap, cfg.run_cap, cfg.gap
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):
            err = lib.launch_mark(ctypes.addressof(args), stream)
        if err != 0:
            raise RuntimeError(f"launch_mark failed: CUDA error {err} "
                               f"({lib.pair_engine_error_string(err).decode()})")

    return launch, (tables, bits, cnt, total)


def build_lists_kernel(cull, x, y, z, h, skin, slot_cap: int, cfg: NeighborConfig):
    """Launch the list build (csrc/pair_lists.cu) once on the current
    stream (no sync), counted as "mark" in ``LAUNCHES``. Returns (tables,
    bits, cnt, total), ``build_lists_plain``'s outputs bit for bit."""
    launch, out = build_lists_launcher(cull, x, y, z, h, skin, slot_cap, cfg)
    launch()
    pe.LAUNCHES["mark"] += 1
    return out


def list_build_info(w3: int, slot_cap: int) -> dict:
    """Static facts of the list build at a window of ``w3`` cells and
    ``slot_cap`` slots (``pair_engine.KERNEL_INFO_KEYS``; "window" is the
    chunk's lanes). Needs a CUDA device; launches nothing."""
    from sphexa_torch.kernels.build import load_library

    lib = load_library()
    out = (ctypes.c_int32 * len(pe.KERNEL_INFO_KEYS))()
    err = lib.list_build_info(w3, slot_cap, out)
    if err != 0:
        raise RuntimeError(f"list build info failed: CUDA error {err} "
                           f"({lib.pair_engine_error_string(err).decode()})")
    return dict(zip(pe.KERNEL_INFO_KEYS, out))


def mark_plain(ranges: GroupRanges, x, y, z, h, skin, slot_cap: int, group: int):
    """The mark pass of ``build_lists_plain`` over merged runs, on any
    device: every group's slots expanded into (groups, slots, 128) lane
    tiles, tested, and packed into bits, in chunks of groups that fit the
    tile budget. Returns (bits (NG, S_cap, 4) int32, cnt (NG, S_cap) int32,
    total (NG,) int32 chunks of each group's runs)."""
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


def build_lists_plain(cull, x, y, z, h, skin, slot_cap: int, cfg: NeighborConfig):
    """Plain PyTorch version of the list build on any device: the culled
    cells merged into runs (``pair_engine._merge_runs``), the mark pass
    (``mark_plain``), the empty chunks pruned (``_prune_empty_chunks``) and
    the words and counts gathered into pruned order. Returns (tables, bits,
    cnt, total): the pruned ``RUN_TABLES`` ((NG, S_cap) tables, zero past
    each group's runs, and the (NG,) run counts), bits (NG, S_cap, 4) and
    cnt (NG, S_cap) int32 zero past the kept slots, and the (NG,) int32
    chunk count of each group's merged runs, unclipped."""
    starts, lens, sh, nruns = pe._merge_runs(*cull, cfg.run_cap, cfg.gap)
    i32 = torch.int32
    runs = GroupRanges(starts.to(i32), lens.to(i32), *sh, nruns.to(i32),
                       occupancy=None, boxl=None)
    bits, cnt, total = mark_plain(runs, x, y, z, h, skin, slot_cap, cfg.group)
    pruned, perm = _prune_empty_chunks(runs, cnt, slot_cap)
    cnt = cnt.gather(1, perm).contiguous()
    bits = bits.gather(1, perm[:, :, None].expand(-1, -1, WORDS)).contiguous()
    return tuple(pruned)[:len(RUN_TABLES)], bits, cnt, total


def build_lists(cull, x, y, z, h, skin, slot_cap: int, cfg: NeighborConfig):
    """Dispatch by device: CUDA launches the list build, CPU runs
    ``build_lists_plain``; anything else raises. A cost tally charges the
    kernel's rule (kernels/costs.py), not the ops of either branch."""
    with costs.charging():
        if x.device.type == "cuda":
            out = build_lists_kernel(cull, x, y, z, h, skin, slot_cap, cfg)
        elif x.device.type == "cpu":
            out = build_lists_plain(cull, x, y, z, h, skin, slot_cap, cfg)
        else:
            raise ValueError(f"unsupported device {x.device}")
    costs.charge_list_build(cull, x.shape[0], out[3], slot_cap, outs=out)
    return out


@named_phase("neighbors")
def build_pair_lists(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig,
                     skin: torch.Tensor, slot_cap: int) -> PairLists:
    """Build the persistent lists from SFC-sorted arrays: each group's
    window cells culled against its bbox widened by ``skin`` (a float32
    0-d tensor), then the list build (runs, mark, prune; one kernel on the
    card), the overflow sentinel, and on the card the walk's mask-word
    buffer. One host sync on either device (the buffer's size)."""
    if pe.engine_fold(box, cfg):
        raise ValueError(
            "persistent lists need per-cell image shifts; a grid in fold mode "
            "streams instead")
    start, lens, keep, shifts, raw_len, window_ok = pe.window_cells_culled(
        x, y, z, h, sorted_keys, box, cfg, radius_pad=skin)
    tables, bits, cnt, total = build_lists((start, lens, keep, shifts), x, y, z, h, skin,
                                           slot_cap, cfg)
    ranges = GroupRanges(*tables, *pe.occupancy_and_boxl(keep, raw_len, window_ok, box, cfg))
    word_off = pe.mask_word_offsets(cnt)
    # the size of the walk's mask words, read on either device (the one
    # host sync of a build on both, as the audit's record expects); the
    # buffer is the kernel's, the plain walks keep none
    # torchlint: disable=JXL002 -- the mask-word buffer's size
    nwords = int(word_off[-1]) * cfg.group
    words = None
    if x.device.type == "cuda":
        words = torch.empty(nwords, dtype=torch.int32, device=x.device)
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
