"""The halo exchanges of the sharded force stages
(sphexa_tpu/parallel/exchange.py) on ``torch.distributed``.

Each rank runs the group-window prologue on its own slab against the
GLOBAL cell-starts table (an all_reduce of the per-rank cell histograms,
``global_cell_table``), so its candidate runs hold global rows. Runs that
cross a slab boundary are split there (``_split_runs``), and the runs are
rewritten into rows of the rank's j-buffer [own slab (S) | halo rows],
from which K1 reads every j-field (``pair_engine``'s ``jdata`` form). The
own slab sits at offset 0 of the j-buffer, so a target's own row keeps
its index there and the kernels' self test stays right.

Two exchanges, as in the JAX package:

- windowed (``shard_halo_stage``): per source rank one contiguous row
  window [lo, hi) covering every run this rank needs from it; the (P, P,
  2) bounds are all_gathered, and one all_to_all of fixed (P, Wmax, nf)
  buffers serves the windows (the own block rides along as a local copy);
- sparse (``shard_halo_stage_sparse``): the cells any run touches
  (the coverage bitmap, all_gathered) are packed per source in cell order,
  and P - 1 rounds, one per peer distance r, ship each rank's packed rows
  to its distance-r successor in a buffer of static size hmax[r - 1]
  (issued as one batch of sends and receives).

The gather backend's halo (``gather_halo_stage``) serves the whole
window cells of the global groups of 64 that meet the slab, through
either exchange, and maps every global row to its j-buffer row: the
search reads its candidates, global rows in the one-device order, there.

Runs outside the served rows (drift since the last sizing) are zeroed and
flip ``escaped``, which the force stage folds into the occupancy sentinel
(cap + 1): the driver discards the step, re-sizes the halo and replays it.

The JAX package's ``chain_after`` has no counterpart: it pins one order
on XLA:CPU's collective rendezvous, and torch issues collectives in
program order.
"""

import dataclasses
from typing import Sequence, Tuple

import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, all_to_all_rows, \
    exchange_rounds
from sphexa_torch.sph.pair_engine import GroupRanges, group_cell_ranges
from sphexa_torch.util.phases import named_phase

INF32 = 2**30


def slab_nbr(nbr, S: int):
    """The neighbour config of a sharded stage on slabs of S rows: a
    merged run must fit in one source slab, so run_cap is clamped to S (a
    cell wider than a slab still crosses, and trips the split-overflow
    sentinel). The sizing measures with the same clamp."""
    return dataclasses.replace(nbr, run_cap=S) if nbr.run_cap > S else nbr


@named_phase("halo-exchange")
def global_cell_table(mesh: Mesh, local_keys: torch.Tensor, level: int) -> torch.Tensor:
    """Cell-starts table of the level-``level`` grid over the distributed
    keys: the per-rank cell histogram summed over ranks, then an exclusive
    cumsum. (ncells + 1,) int64, the same on every rank."""
    ncells = (1 << level) ** 3
    cid = local_keys >> (3 * (KEY_BITS - level))
    hist = all_reduce_sum(mesh, torch.bincount(cid, minlength=ncells))
    return torch.cat([hist.new_zeros(1), torch.cumsum(hist, dim=0)])


def _split_runs(starts, lens, shifts3, S: int, extra: int = 8):
    """Split candidate runs that cross slab boundaries: the first piece
    keeps its slot, the remainders go to ``extra`` more slots per group,
    and the live runs are compacted to the front in order. Returns
    (starts, lens, shifts3, nruns, overflow), int64 tables; ``overflow``
    (a 0-d bool) when a group has more remainders than slots or a
    remainder crosses again (a run longer than a slab)."""
    starts, lens = starts.to(torch.int64), lens.to(torch.int64)
    src0 = starts // S
    src1 = torch.where(lens > 0, (starts + lens - 1) // S, src0)
    cross = (src1 > src0) & (lens > 0)
    len1 = torch.where(cross, (src0 + 1) * S - starts, lens)
    r_start = torch.where(cross, (src0 + 1) * S, 0)
    r_len = torch.where(cross, lens - len1, 0)
    r_cross = torch.any((r_len > 0) & ((r_start + r_len - 1) // S > r_start // S))

    order = torch.argsort((r_len <= 0).to(torch.int32), dim=1, stable=True)[:, :extra]
    e_start, e_len = r_start.gather(1, order), r_len.gather(1, order)
    e_sh = [a.gather(1, order) for a in shifts3]
    overflow = torch.any(torch.sum(r_len > 0, dim=1) > extra)

    starts = torch.cat([starts, e_start], dim=1)
    lens = torch.cat([len1, e_len], dim=1)
    shifts3 = [torch.cat([a, e], dim=1) for a, e in zip(shifts3, e_sh)]

    active = lens > 0
    order = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    act = active.gather(1, order)
    lens = torch.where(act, lens.gather(1, order), 0)
    starts = torch.where(act, starts.gather(1, order), 0)
    shifts3 = [a.gather(1, order) for a in shifts3]
    return starts, lens, shifts3, active.sum(dim=1), overflow | r_cross


def _localized(ranges: GroupRanges, local, lens, shifts3, nruns) -> GroupRanges:
    i32 = torch.int32
    return GroupRanges(starts=local.to(i32).contiguous(), lens=lens.to(i32).contiguous(),
                       shift_x=shifts3[0].contiguous(), shift_y=shifts3[1].contiguous(),
                       shift_z=shifts3[2].contiguous(), ncells=nruns.to(i32).contiguous(),
                       occupancy=ranges.occupancy, boxl=ranges.boxl)


def _bool_all_gather(mesh: Mesh, b: torch.Tensor) -> torch.Tensor:
    return all_gather(mesh, b.to(torch.uint8)).bool()


# ---------------------------------------------------------------------------
# the windowed exchange
# ---------------------------------------------------------------------------


def window_bounds(mesh: Mesh, starts, lens, S: int):
    """Per source rank the row window [lo, hi) this rank's runs need from
    it (its own slab excluded: served locally), then the all_gathered
    (P_dest, P_src, 2) bounds. Returns (mine (P, 2), bounds_all)."""
    P, k = mesh.size, mesh.rank
    active = lens > 0
    src = torch.clamp(starts // S, 0, P - 1)
    lo = torch.full((P,), INF32, dtype=torch.int64, device=starts.device)
    hi = torch.zeros(P, dtype=torch.int64, device=starts.device)
    lo = lo.scatter_reduce(0, src[active], starts[active], "amin")
    hi = hi.scatter_reduce(0, src[active], (starts + lens)[active], "amax")
    # the own slab is served locally (no Python scalar written into a
    # device tensor: that would be a copy from the host)
    own = torch.arange(P, device=starts.device) == k
    lo = torch.where(own, INF32, lo)
    hi = torch.where(own, 0, hi)
    mine = torch.stack([lo, hi], dim=1)
    return mine, all_gather(mesh, mine)


def _effective_lo(bounds_all, S: int, Wmax: int, P: int):
    """Each window's served offset, clamped into its source slab so that a
    fixed Wmax slice stays in range; sender and receiver evaluate it on the
    same replicated bounds. (P_dest, P_src)."""
    srcs = torch.arange(P, device=bounds_all.device)[None, :]
    return torch.minimum(torch.maximum(bounds_all[:, :, 0], srcs * S), (srcs + 1) * S - Wmax)


@named_phase("halo-exchange")
def serve_windows(mesh: Mesh, fields: Sequence[torch.Tensor], bounds_all, S: int,
                  Wmax: int) -> list:
    """One all_to_all: this rank serves every destination's window out of
    its slab; returns the annex, (P Wmax,) per field, block j holding
    source j's window."""
    P, k = mesh.size, mesh.rank
    lo_eff = _effective_lo(bounds_all, S, Wmax, P)
    local = torch.stack(list(fields), dim=1)  # (S, nf)
    idx = (lo_eff[:, k] - k * S)[:, None] + torch.arange(Wmax, device=local.device)[None, :]
    send = local[idx].reshape(P * Wmax, -1)
    annex = all_to_all_rows(mesh, send, [Wmax] * P, [Wmax] * P)
    return list(annex.unbind(1))


@named_phase("halo-exchange")
def localize_ranges(mesh: Mesh, ranges: GroupRanges, S: int, Wmax: int):
    """Global-row runs -> j-buffer rows [own slab (S) | annex (P Wmax)].
    Returns (localized ranges, bounds_all, escaped)."""
    P, k = mesh.size, mesh.rank
    starts, lens, sh3, nruns, split_ovf = _split_runs(
        ranges.starts, ranges.lens, (ranges.shift_x, ranges.shift_y, ranges.shift_z), S,
        extra=max(8, P - 1))
    _, bounds_all = window_bounds(mesh, starts, lens, S)
    lo_eff = _effective_lo(bounds_all, S, Wmax, P)[k]
    src = torch.clamp(starts // S, 0, P - 1)
    own = src == k
    lo_run = lo_eff[src]
    in_window = own | ((starts >= lo_run) & (starts + lens <= lo_run + Wmax))
    active = lens > 0
    escaped = torch.any(active & ~in_window) | split_ovf
    local = torch.where(own, starts - k * S, S + src * Wmax + (starts - lo_run))
    lens = torch.where(active & in_window, lens, 0)
    local = torch.where(lens > 0, local, 0)
    return _localized(ranges, local, lens, sh3, nruns), bounds_all, escaped


@named_phase("shard-metrics")
def exchange_metrics_windowed(bounds_all, Wmax: int, k: int) -> dict:
    """This rank's true need (the sum of its window spans; the windowed
    exchange ships (P - 1) Wmax rows regardless) and the fullest window's
    span over Wmax."""
    mine = bounds_all[k]
    span = torch.clamp(mine[:, 1] - torch.minimum(mine[:, 0], mine[:, 1]), min=0)
    return {"halo_rows": span.sum(),
            "halo_occ": span.max().to(torch.float32) / float(max(Wmax, 1))}


def shard_halo_stage(mesh: Mesh, x, y, z, h, keys, box, nbr, Wmax: int):
    """The shared prologue of a sharded pair stage, windowed exchange:
    global table -> group windows on the slab -> localized runs. Returns
    (ranges, serve, jbuf, escaped, metrics): ``serve(fields)`` ships the
    fields' halo rows, ``jbuf(own, halo)`` concatenates j-buffers."""
    S = x.shape[0]
    table = global_cell_table(mesh, keys, nbr.level)
    granges = group_cell_ranges(x, y, z, h, None, box, nbr, table=table)
    ranges, bounds, escaped = localize_ranges(mesh, granges, S, Wmax)

    def serve(fields):
        return serve_windows(mesh, fields, bounds, S, Wmax)

    metrics = exchange_metrics_windowed(bounds, Wmax, mesh.rank)
    return ranges, serve, jbuf, escaped, metrics


def jbuf(own: Sequence[torch.Tensor], halo: Sequence[torch.Tensor]) -> tuple:
    """The j-buffers [own slab | halo rows] of each field."""
    return tuple(torch.cat([o, a]) for o, a in zip(own, halo))


def fold_escape_sentinel(occ, escaped, cap: int):
    """Escaped runs mean truncated candidates: the occupancy becomes cap + 1
    (the caller reduces it over ranks with the step's other scalars)."""
    return torch.where(escaped, torch.full_like(occ, cap + 1), occ)


# ---------------------------------------------------------------------------
# the sparse exchange
# ---------------------------------------------------------------------------


def _cells_of_runs(starts, lens, table):
    """First and last cell of every run (runs are unions of consecutive
    cells, so [c0, c1] brackets their rows); dead runs give [c0, c0]."""
    ends = torch.where(lens > 0, starts + lens - 1, starts)
    ncells = table.shape[0] - 1
    c0 = torch.searchsorted(table, starts.contiguous(), right=True) - 1
    c1 = torch.searchsorted(table, ends.contiguous(), right=True) - 1
    return c0.clamp(0, ncells - 1), c1.clamp(0, ncells - 1)


def coverage_from_runs(starts, lens, table) -> torch.Tensor:
    """(ncells,) bool: the cells whose rows any live run touches, this
    rank's halo need at cell granularity (one +1/-1 scatter and a cumsum)."""
    starts, lens = starts.to(torch.int64), lens.to(torch.int64)
    c0, c1 = _cells_of_runs(starts, lens, table)
    active = (lens > 0).to(torch.int64).reshape(-1)
    ncells = table.shape[0] - 1
    diff = torch.zeros(ncells + 1, dtype=torch.int64, device=starts.device)
    diff.index_add_(0, c0.reshape(-1), active)
    diff.index_add_(0, c1.reshape(-1) + 1, -active)
    return torch.cumsum(diff, dim=0)[:ncells] > 0


def _sparse_layout(covered, table, S: int, P: int):
    """The packed layout of one destination's coverage: per source j the
    rows of every covered cell clipped to j's slab, packed in cell order.
    Returns (clen, poff, need): (P, ncells) clipped lengths and exclusive
    packed offsets, (P,) rows per source."""
    t0, t1 = table[:-1][None, :], table[1:][None, :]
    slab = torch.arange(P, device=table.device)[:, None] * S
    lo = torch.minimum(torch.maximum(t0, slab), slab + S)
    hi = torch.minimum(torch.maximum(t1, slab), slab + S)
    clen = torch.where(covered[None, :], hi - lo, 0)
    csum = torch.cumsum(clen, dim=1)
    return clen, csum - clen, csum[:, -1]


def _sparse_layout_dest(covered_all, dest: int, table, S: int, k: int):
    """One (dest <- this rank k) column of the packed layout."""
    t0, t1 = table[:-1], table[1:]
    lo = torch.clamp(t0, k * S, (k + 1) * S)
    hi = torch.clamp(t1, k * S, (k + 1) * S)
    clen = torch.where(covered_all[dest], hi - lo, 0)
    csum = torch.cumsum(clen, dim=0)
    return clen, csum - clen


def _pack_rows(clen_j, poff_j, table, S: int, k: int, hmax: int) -> torch.Tensor:
    """Local row of each of the ``hmax`` packed positions of one (dest <-
    this rank) buffer, in cell order; positions past the total repeat row
    0, which no localized run reads."""
    sel = clen_j > 0
    clip_lo = torch.clamp(table[:-1], min=k * S) - k * S
    off = torch.where(sel, clip_lo - poff_j, 0)
    ncells = off.shape[0]
    off_c = torch.cat([off[sel], off[~sel]])  # selected cells first, in cell order
    heads = torch.zeros(hmax, dtype=torch.int64, device=off.device)
    idx = poff_j[sel & (poff_j < hmax)]  # heads past the buffer drop (an overflow)
    heads.index_add_(0, idx, torch.ones_like(idx))
    seg = torch.cumsum(heads, dim=0) - 1
    i = torch.arange(hmax, device=off.device)
    total = clen_j.sum()
    ridx = i + off_c[seg.clamp(0, ncells - 1)]
    return torch.where((i < total) & (seg >= 0), ridx, 0)


@named_phase("halo-exchange")
def localize_ranges_sparse(mesh: Mesh, ranges: GroupRanges, table, S: int,
                           hmax: Tuple[int, ...]):
    """Global-row runs -> j-buffer rows [own slab (S) | packed annex
    (sum(hmax))], through the cell-granular packed layout; the coverage
    bitmap is all_gathered (the negotiation). Returns (localized ranges,
    covered_all (P, ncells), escaped, this rank's coverage)."""
    P, k = mesh.size, mesh.rank
    if len(hmax) != P - 1:
        raise ValueError(f"hmax needs P-1={P - 1} per-distance caps, got {len(hmax)}")
    starts, lens, sh3, nruns, split_ovf = _split_runs(
        ranges.starts, ranges.lens, (ranges.shift_x, ranges.shift_y, ranges.shift_z), S,
        extra=max(8, P - 1))
    covered = coverage_from_runs(starts, lens, table)
    covered_all = _bool_all_gather(mesh, covered)
    _, poff, need = _sparse_layout(covered, table, S, P)
    dev = starts.device
    hmax_arr = torch.tensor((0,) + tuple(hmax), dtype=torch.int64, device=dev)
    src_j = torch.arange(P, device=dev)
    over = (need > hmax_arr[(k - src_j) % P]) & (src_j != k)
    escaped = torch.any(over) | split_ovf
    prefix = torch.cumsum(torch.tensor((0,) + tuple(hmax), dtype=torch.int64, device=dev), 0)

    active = lens > 0
    src = torch.clamp(starts // S, 0, P - 1)
    own = src == k
    c0, _ = _cells_of_runs(starts, lens, table)
    clip_lo = torch.maximum(table[c0], src * S)
    packed = poff[src, c0] + (starts - clip_lo)
    r_run = (k - src) % P
    in_cap = own | (packed + lens <= hmax_arr[r_run])
    local = torch.where(own, starts - k * S,
                        S + prefix[torch.clamp(r_run - 1, 0, P - 1)] + packed)
    lens = torch.where(active & in_cap, lens, 0)
    local = torch.where(lens > 0, local, 0)
    return _localized(ranges, local, lens, sh3, nruns), covered_all, escaped, covered


@named_phase("halo-exchange")
def serve_sparse(mesh: Mesh, fields: Sequence[torch.Tensor], ridx: Sequence[torch.Tensor]
                 ) -> list:
    """The P - 1 rounds of one serve: round r ships this rank's packed rows
    ``ridx[r - 1]`` to rank (k + r) % P. Returns the annex per field, rows
    [distance 1 | distance 2 | ...], matching ``localize_ranges_sparse``."""
    local = torch.stack(list(fields), dim=1)
    parts = exchange_rounds(mesh, [local[i] for i in ridx])
    annex = torch.cat(parts) if parts else local[:0]
    return list(annex.unbind(1))


@named_phase("halo-exchange")
def sparse_send_rows(mesh: Mesh, covered_all, table, S: int, hmax: Tuple[int, ...]) -> list:
    """Each round's packed local rows, fixed for the step (the coverage
    and the table are): computed once and used by every serve."""
    P, k = mesh.size, mesh.rank
    out = []
    for r in range(1, P):
        clen, poff = _sparse_layout_dest(covered_all, (k + r) % P, table, S, k)
        out.append(_pack_rows(clen, poff, table, S, k, hmax[r - 1]))
    return out


@named_phase("shard-metrics")
def exchange_metrics_sparse(covered, table, S: int, hmax: Tuple[int, ...], P: int,
                            k: int) -> dict:
    """This rank's true remote need (its covered cells clipped to the other
    slabs; the exchange ships sum(hmax) rows regardless) and the fullest
    per-distance buffer's need over its cap."""
    _, _, need = _sparse_layout(covered, table, S, P)
    src_j = torch.arange(P, device=need.device)
    own = src_j == k
    caps = torch.tensor((1,) + tuple(hmax), dtype=torch.float32,
                        device=need.device)[(k - src_j) % P]
    return {"halo_rows": torch.where(own, 0, need).sum(),
            "halo_occ": torch.where(own, 0.0, need.to(torch.float32) / caps).max()}


def shard_halo_stage_sparse(mesh: Mesh, x, y, z, h, keys, box, nbr,
                            hmax: Tuple[int, ...]):
    """The sparse-exchange form of ``shard_halo_stage``, same contract;
    each serve ships sum(hmax) rows."""
    S = x.shape[0]
    table = global_cell_table(mesh, keys, nbr.level)
    granges = group_cell_ranges(x, y, z, h, None, box, nbr, table=table)
    ranges, covered_all, escaped, covered = localize_ranges_sparse(mesh, granges, table, S,
                                                                   hmax)
    ridx = sparse_send_rows(mesh, covered_all, table, S, hmax)

    def serve(fields):
        return serve_sparse(mesh, fields, ridx)

    metrics = exchange_metrics_sparse(covered, table, S, hmax, mesh.size, mesh.rank)
    return ranges, serve, jbuf, escaped, metrics


# ---------------------------------------------------------------------------
# the gather backend's halo: the whole window cells of the global groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherHalo:
    """The gather backend's halo stage on a rank (``gather_halo_stage``):
    the slab's global groups' window cells (``win``, cell_list's
    SlabWindows), ``serve(fields)`` shipping the halo rows of the fields,
    ``g2l`` the (N,) global row -> j-buffer row map of [own slab | halo
    rows] (-1: not served), ``escaped`` (() bool: the caps cut covered
    rows) and the exchange metrics."""

    win: object
    serve: object
    g2l: torch.Tensor
    escaped: torch.Tensor
    metrics: dict


def gather_coverage(mesh: Mesh, x, y, z, h, keys, box, nbr, table=None):
    """The cells the gather search of this rank's slab reads: the global
    table (computed when None), the slab's global groups' windows
    (``cell_list.slab_windows``) and (ncells,) bool coverage, every
    existing window cell with rows (``coverage_from_runs`` on (start,
    min(len, cap)))."""
    from sphexa_torch.neighbors.cell_list import slab_windows

    if table is None:
        table = global_cell_table(mesh, keys, nbr.level)
    win = slab_windows(mesh, x, y, z, h, box, nbr, table)
    starts, lens = win.runs(nbr.cap)
    return table, win, coverage_from_runs(starts, lens, table)


def covered_bounds(covered, table, S: int, P: int, k: int) -> torch.Tensor:
    """(P, 2) per source rank the row window [lo, hi) of the covered
    cells' rows in its slab (this rank's own slab excluded), the windowed
    exchange's need."""
    t0, t1 = table[:-1][None, :], table[1:][None, :]
    slab = torch.arange(P, device=table.device)[:, None] * S
    lo = torch.minimum(torch.maximum(t0, slab), slab + S)
    hi = torch.minimum(torch.maximum(t1, slab), slab + S)
    use = covered[None, :] & (hi > lo)
    lo = torch.where(use, lo, INF32).amin(1)
    hi = torch.where(use, hi, 0).amax(1)
    lo[k] = INF32
    hi[k] = 0
    return torch.stack([lo, hi], dim=1)


@named_phase("halo-exchange")
def gather_halo_stage(mesh: Mesh, x, y, z, h, keys, box, nbr, sizes) -> GatherHalo:
    """The halo of the gather search and ops on this rank's slab: the
    window cells of the global groups that meet the slab, whole
    (``gather_coverage``), served from the other slabs. ``sizes``: a
    tuple of P - 1 per-distance row caps selects the sparse exchange (the
    covered cells' rows packed per source in cell order, P - 1 rounds), an
    int the windowed one (per source one row window of that many rows).
    Covered rows past a cap are not served and flip ``escaped``, which the
    force stage folds into the occupancy sentinel."""
    S, P, k = x.shape[0], mesh.size, mesh.rank
    dev = x.device
    table, win, covered = gather_coverage(mesh, x, y, z, h, keys, box, nbr)
    g2l = torch.full((S * P,), -1, dtype=torch.int64, device=dev)
    g2l[k * S:(k + 1) * S] = torch.arange(S, device=dev)
    if isinstance(sizes, tuple):
        hmax = tuple(min(int(c), S) for c in sizes)
        if len(hmax) != P - 1:
            raise ValueError(f"the sparse gather halo needs P-1={P - 1} caps, got {len(hmax)}")
        covered_all = _bool_all_gather(mesh, covered)
        clen, poff, need = _sparse_layout(covered, table, S, P)
        off = S
        escaped = torch.zeros((), dtype=torch.bool, device=dev)
        for r in range(1, P):
            j = (k - r) % P
            cap = hmax[r - 1]
            pos = torch.arange(cap, device=dev)
            rows = _pack_rows(clen[j], poff[j], table, S, j, cap) + j * S
            live = pos < need[j]
            g2l[rows[live]] = off + pos[live]
            escaped = escaped | (need[j] > cap)
            off += cap
        ridx = sparse_send_rows(mesh, covered_all, table, S, hmax)

        def serve(fields):
            return serve_sparse(mesh, fields, ridx)

        metrics = exchange_metrics_sparse(covered, table, S, hmax, P, k)
    else:
        wmax = min(int(sizes), S) or S
        bounds_all = all_gather(mesh, covered_bounds(covered, table, S, P, k))
        lo_eff = _effective_lo(bounds_all, S, wmax, P)[k]
        pos = torch.arange(wmax, device=dev)
        for j in range(P):
            if j != k:
                g2l[lo_eff[j] + pos] = S + j * wmax + pos
        mine = bounds_all[k]
        live = mine[:, 1] > mine[:, 0]
        escaped = torch.any(live & ((mine[:, 0] < lo_eff) | (mine[:, 1] > lo_eff + wmax)))

        def serve(fields):
            return serve_windows(mesh, fields, bounds_all, S, wmax)

        metrics = exchange_metrics_windowed(bounds_all, wmax, k)
    return GatherHalo(win=win, serve=serve, g2l=g2l, escaped=escaped, metrics=metrics)


def localize_rows(g2l: torch.Tensor, rows: torch.Tensor):
    """Global rows (a gather search's ``nidx``) -> j-buffer rows through
    the halo's map, int32; a row the halo did not serve maps to 0 and
    flips the returned () bool ``escaped``."""
    local = g2l[rows.long()]
    return local.clamp_min(0).to(torch.int32), torch.any(local < 0)
