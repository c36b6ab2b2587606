"""Cell-grid configuration of the neighbour search and the gather
backend's neighbour lists (sphexa_tpu/neighbors/cell_list.py).

``find_neighbors`` is the JAX package's XLA search: particles arrive
sorted by SFC key; a uniform grid at octree level ``level`` is implied by
the keys; targets are processed in groups of ``group`` SFC-consecutive
particles, each gathering one shared candidate set from its
``window^3`` block of cells (``_window_offsets`` order, each cell's
particles in key order up to ``cap``); the hits ``|r_ij| < 2 h_i`` are
kept in that candidate order up to ``ngmax`` (the reference's
first-found truncation, findneighbors.hpp:96-172: no distance sort).
Every output equals the JAX function's bit for bit, on either device.

On a rank's slab (the gather backend across ranks) ``slab_windows`` and
``search_slab`` search the global array's groups that meet the slab:
their windows from the bbox of all their rows, their cells' ranges from
the global cell-starts table, their candidates global rows in the same
order, so that the lists, the truncation and ``nc`` are the one-device
search's whatever the slabs.
"""

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.sfc.box import Box, apply_pbc_xyz
from sphexa_torch.sfc.hilbert import hilbert_encode
from sphexa_torch.sfc.morton import morton_encode
from sphexa_torch.util.blocking import device_block
from sphexa_torch.util.phases import named_phase


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static configuration of the neighbour search: the fields of the JAX
    package's NeighborConfig, with their names and meaning. The engine
    always merges runs (``run_cap > 0``); ``ngmax`` and ``block`` are the
    gather backend's (the engine sums every pair within 2h)."""

    level: int  # octree level of the cell grid
    cap: int  # max particles counted per cell
    ngmax: int = 150  # gather backend: neighbours kept per particle
    block: int = 2048  # gather backend: rows per processing chunk
    curve: str = "hilbert"
    group: int = 64  # targets per group
    window: int = 4  # cells per dimension of the group candidate block
    run_cap: int = 1536  # merged-run length cap
    gap: int = 384  # key-space gap a run may bridge

    def __post_init__(self):
        if self.run_cap <= 0:
            raise ValueError(f"run_cap must be positive, got {self.run_cap}")


def choose_grid_level(box_lengths, h_max: float) -> int:
    """Deepest grid level whose cell edge still covers the 2h radius."""
    min_extent = float(np.min(np.asarray(box_lengths)))
    if h_max <= 0:
        return KEY_BITS
    level = int(np.floor(np.log2(min_extent / (2.0 * h_max))))
    return max(1, min(KEY_BITS, level))


def pad_cap(occ: int, margin: float = 1.3, quantum: int = 8) -> int:
    """Pad an observed max cell occupancy into a static cap."""
    return max(quantum, int(np.ceil(occ * margin / quantum) * quantum))


def window_cells(ext: float, radius: float, edge: float, ncell: int,
                 margin_cells: int = 1) -> int:
    """Cells needed along one dimension to cover a group extent plus the
    search radius, clamped to the grid."""
    return min(int(np.ceil((ext + radius) / edge)) + 1 + margin_cells, ncell)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def estimate_cell_cap(keys, level: int, margin: float = 1.3, quantum: int = 8) -> int:
    """Max level-``level`` cell occupancy of ``keys`` (a tensor or an
    array), padded with slack."""
    shift = 3 * (KEY_BITS - level)
    cells = _host(keys).astype(np.uint64) >> np.uint64(shift)
    occ = int(np.bincount(cells.astype(np.int64)).max()) if len(cells) else 1
    return pad_cap(occ, margin, quantum)


def estimate_group_window(x, y, z, h, box_lengths, level: int, group: int,
                          margin_cells: int = 1) -> int:
    """Cells per dimension needed to cover any group's search extent:
    per dimension ceil((max group extent + 2 * 2 h_max) / edge) + 1 (+
    the margin), clamped to the grid; the runtime guard is the
    occupancy's cap + 1."""
    ncell = 1 << level
    edges = _host(box_lengths).astype(np.float64) / ncell
    n = len(_host(x))
    ng = -(-n // group)
    pad = ng * group - n
    radius = 2.0 * 2.0 * float(np.max(_host(h)))
    need = 1
    for a, edge in zip((x, y, z), edges):
        a = _host(a)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1], pad)])
        g = a.reshape(ng, group)
        ext = float((g.max(axis=1) - g.min(axis=1)).max())
        need = max(need, window_cells(ext, radius, edge, ncell, margin_cells))
    return need


@functools.lru_cache(maxsize=None)
def _window_offsets(window: int) -> np.ndarray:
    """(window^3, 3) int32 offsets of the group candidate cell block."""
    r = np.arange(window, dtype=np.int32)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _window_offsets_on(window: int, device: torch.device) -> torch.Tensor:
    """The window's cell offsets on the device, copied there once (a copy
    in every step would sync the stream); shared read-only."""
    return torch.as_tensor(_window_offsets(window), device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's CPU code contracts it (the
    product is exact in float64; the sum's float64 rounding is a second
    rounding only on a float32 tie, about 2^-29 of the time)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _group_bounds(x, y, z, h, g: int):
    """The groups of ``g`` consecutive rows: their rows (NG, g), the tail
    padded with the last row (min(idx, n - 1)), and each group's (NG, 3)
    bbox ``lo``, ``hi`` and (NG,) search radius 2 max h."""
    n, dev = x.shape[0], x.device
    ng = -(-n // g)
    rows = torch.arange(ng * g, device=dev).clamp_max(n - 1).reshape(ng, g)
    gx, gy, gz, gh = (a[rows] for a in (x, y, z, h))
    lo = torch.stack([gx.amin(1), gy.amin(1), gz.amin(1)], dim=1)
    hi = torch.stack([gx.amax(1), gy.amax(1), gz.amax(1)], dim=1)
    return rows, lo, hi, 2.0 * gh.amax(1)


def _window_cells(lo, hi, radius, box: Box, cfg: NeighborConfig, cell_range):
    """Every group's window^3 cells from its bbox and radius: each cell's
    sorted-array range [start, end) (``cell_range(ckey)``: the global
    rows of cell ``ckey``) and existence (NG, W3), the group's densest
    cell over all W^3 (before any cull) and its window verdict (NG,)."""
    dev = lo.device
    level = cfg.level
    ncell = 1 << level
    encode = hilbert_encode if cfg.curve == "hilbert" else morton_encode
    edge = box.lengths / ncell
    periodic = box.periodic_mask
    base = torch.floor((lo - radius[:, None] - box.lo) / edge).to(torch.int64)
    need = torch.floor((hi + radius[:, None] - box.lo) / edge).to(torch.int64)
    # open dims: the window slides inside the grid; one spanning the
    # whole grid always covers
    base = torch.where(periodic, base, base.clamp(0, max(0, ncell - cfg.window)))
    need_eff = torch.where(periodic, need, need.clamp(max=ncell - 1))
    window_ok = ((need_eff - base + 1 <= cfg.window) | (cfg.window >= ncell)).all(dim=1)

    offsets = _window_offsets_on(cfg.window, dev)  # (W3, 3)
    cells = base[:, None, :] + offsets  # (NG, W3, 3)
    in_range = (cells >= 0) & (cells < ncell)
    # periodic dims wrap but must not alias (offsets past the grid revisit
    # the same cells: dropped); open dims clip and exclude
    cell_ok = torch.where(periodic, offsets < ncell, in_range).all(dim=-1)
    cells = torch.where(periodic, torch.remainder(cells, ncell), cells.clamp(0, ncell - 1))
    ckey = encode(cells[..., 0], cells[..., 1], cells[..., 2], bits=level)
    start, end = cell_range(ckey)
    return start, end, cell_ok, (end - start).amax(1), window_ok


def _group_windows(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig):
    """Every group's window^3 cells (``_window_cells``) on one device:
    the group's rows (NG, g) first, the cells' ranges by a searchsorted
    over the sorted keys."""
    shift = 3 * (KEY_BITS - cfg.level)
    rows, lo, hi, radius = _group_bounds(x, y, z, h, cfg.group)

    def cell_range(ckey):
        return (torch.searchsorted(sorted_keys, ckey << shift),
                torch.searchsorted(sorted_keys, (ckey + 1) << shift))

    return (rows, *_window_cells(lo, hi, radius, box, cfg, cell_range))


#: bytes of temporaries per (target, candidate) element of a chunk at its
#: peak (the float64 squared distance's operands beside three float32
#: displacements)
_PAIR_BYTES = 64


@named_phase("neighbors")
def find_neighbors(x, y, z, h, sorted_keys, box: Box, cfg: NeighborConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbour lists of every particle (the JAX package's
    find_neighbors). Arguments are the SFC-sorted particle arrays and
    their keys. Returns:

    - ``nidx`` (N, ngmax) int32: neighbour indices in candidate order;
      invalid slots hold the particle's own index (safe to gather, must be
      masked);
    - ``nmask`` (N, ngmax) bool: validity of each slot;
    - ``nc`` (N,) int32: the true neighbour count within 2h (self
      excluded; may exceed ngmax);
    - ``occupancy`` () int32: the densest cell seen, or cap + 1 if some
      group's search extent outgrew the window block; above ``cfg.cap``
      the config must be re-sized and the search re-run.

    Each group's candidates are its valid slots only (a cell's first
    ``min(len, cap)`` rows, existing cells), kept in candidate order: the
    invalid slots of the JAX function never hit, so the k-th hit, the
    truncation and every output are the same. Groups are processed in
    chunks of at most ``cfg.block`` targets' worth of W^3 cap candidates
    (on the card as many as a share of the free memory holds); the
    chunking changes no result. The distance test rounds as XLA's CPU code
    does (its FMA contraction of the squared distance), so that the hits,
    and therefore the truncation, are the JAX function's."""
    n = x.shape[0]
    rows, start, end, cell_ok, occ, window_ok = _group_windows(x, y, z, h, sorted_keys, box,
                                                               cfg)
    nidx, nmask, nc, _, _ = _search_windows(rows, rows, start, end, cell_ok, x, y, z, h,
                                            (x, y, z), None, n, box, cfg)
    occupancy = torch.where(window_ok.all(), occ.amax(), cfg.cap + 1).to(torch.int32)
    return nidx[:n], nmask[:n], nc[:n], occupancy


def _search_windows(rows, ti, start, end, cell_ok, x, y, z, h, jxyz, g2l, n: int, box: Box,
                    cfg: NeighborConfig):
    """The search of every group over its window cells: ``rows`` (NG, g)
    the targets' global rows (self-exclusion, and the invalid slots'
    fill), ``ti`` their rows of x, y, z, h; the candidates are the global
    rows ``start + slot`` of the cells, their positions ``jxyz`` read at
    ``g2l[row]`` (None: at the row itself), and a candidate that ``g2l``
    maps to -1 (a row the halo did not serve) never hits. Returns (nidx
    (NG g, ngmax) int32 global rows, nmask, nc (NG g,), the candidates
    streamed (), unserved () bool: a valid candidate was not served)."""
    dev = x.device
    g, cap, ngmax = cfg.group, cfg.cap, cfg.ngmax
    xj, yj, zj = jxyz
    ng, w3 = start.shape
    lens = torch.where(cell_ok, (end - start).clamp(max=cap), 0)  # (NG, W3)
    cum = torch.cumsum(lens, dim=1)  # inclusive
    totals = cum[:, -1].tolist()  # the one host read: each group's candidates
    # (target, candidate) elements a chunk may hold: cfg.block targets of
    # W^3 cap candidates each, as the JAX function's chunks
    budget = w3 * cap * device_block(cfg.block, w3 * cap * _PAIR_BYTES, dev)
    ks = torch.arange(1, ngmax + 1, dtype=torch.int32, device=dev)
    nidx, nmask, nc = [], [], []
    unserved = torch.zeros((), dtype=torch.bool, device=dev)
    c0 = 0
    while c0 < ng:
        # grow the chunk while its padded (C, g, T) tile fits the budget
        c1, tmax = c0 + 1, max(totals[c0], 1)
        while c1 < ng and (c1 + 1 - c0) * g * max(tmax, totals[c1]) <= budget:
            tmax = max(tmax, totals[c1])
            c1 += 1
        sl = slice(c0, c1)
        c0 = c1
        idx, it = rows[sl], ti[sl]  # (C, g)
        # slot p of a group: cell w with cum[w - 1] <= p < cum[w], row
        # start[w] + p - cum[w - 1]
        p = torch.arange(tmax, device=dev).expand(idx.shape[0], tmax)
        w = torch.searchsorted(cum[sl], p.contiguous(), right=True).clamp_max(w3 - 1)
        cand = start[sl].gather(1, w) + p - (cum[sl] - lens[sl]).gather(1, w)
        cand_ok = p < cum[sl][:, -1:]
        cand = cand.clamp(0, n - 1)
        if g2l is None:
            jc = cand
        else:
            jc = g2l[cand]
            served = jc >= 0
            unserved = unserved | (cand_ok & ~served).any()
            cand_ok = cand_ok & served
            jc = jc.clamp_min(0)
        dx, dy, dz = apply_pbc_xyz(box, x[it][:, :, None] - xj[jc][:, None, :],
                                   y[it][:, :, None] - yj[jc][:, None, :],
                                   z[it][:, :, None] - zj[jc][:, None, :])
        del jc
        d2 = _fma(dz, dz, _fma(dx, dx, dy * dy))  # (C, g, T)
        del dx, dy, dz
        gh = h[it]
        r2 = (2.0 * gh) * (2.0 * gh)
        hit = cand_ok[:, None, :] & (d2 < r2[..., None]) & (cand[:, None, :] != idx[..., None])
        del d2
        # the k-th neighbour is the first slot where the inclusive hit count
        # reaches k (a batched binary search, no scatter)
        csum = torch.cumsum(hit, dim=-1, dtype=torch.int32).reshape(-1, tmax)
        del hit
        cnt = csum[:, -1].clone()  # a view would keep the chunk's csum alive
        slot = torch.searchsorted(csum, ks.expand(csum.shape[0], ngmax).contiguous())
        del csum
        m = ks <= cnt[:, None]
        found = cand.gather(1, slot.clamp_max(tmax - 1).reshape(idx.shape[0], -1))
        nidx.append(torch.where(m, found.reshape(-1, ngmax), idx.reshape(-1, 1))
                    .to(torch.int32))
        nmask.append(m)
        nc.append(cnt)
    work = torch.as_tensor(float(sum(totals)), dtype=torch.float64, device=dev)
    return torch.cat(nidx), torch.cat(nmask), torch.cat(nc), work, unserved


# ---------------------------------------------------------------------------
# the search on a rank's slab
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlabWindows:
    """The window cells of the global groups that meet a rank's slab
    (``slab_windows``): ``rows`` (NG, g) the groups' global rows, ``own``
    (NG, g) the lanes that are this rank's rows (its targets; the padded
    tail on the last rank is not), ``start``/``end`` (NG, W3) the cells'
    global row ranges, ``cell_ok`` their existence, ``occ`` () the
    rank's densest window cell and ``window_ok`` () whether every one of
    its groups' windows covers."""

    rows: torch.Tensor
    own: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    cell_ok: torch.Tensor
    occ: torch.Tensor
    window_ok: torch.Tensor

    def runs(self, cap: int):
        """The window cells as candidate runs (start, min(len, cap)), dead
        cells 0 long: the rows a search may read."""
        return self.start, torch.where(self.cell_ok, (self.end - self.start).clamp(max=cap), 0)


def slab_group_bounds(mesh, x, y, z, h, g: int):
    """``_group_bounds`` of the global array's groups on rank k's slab
    (rows [kS, (k + 1) S) of the global sorted array, N = P S): the groups
    [g0, g1] that meet the slab, their global rows (NG, g; the global
    tail padded with row N - 1), the lanes that are this rank's rows, and
    each group's bbox and radius over ALL its rows: a group that straddles
    a slab boundary takes its other ranks' extrema from one all_gather of
    every rank's first and last group's partial extrema."""
    from sphexa_torch.parallel.mesh import all_gather

    S, dev = x.shape[0], x.device
    k, P = mesh.rank, mesh.size
    N = S * P
    g0, g1 = k * S // g, ((k + 1) * S - 1) // g
    raw = g0 * g + torch.arange((g1 - g0 + 1) * g, device=dev)
    rows = raw.clamp_max(N - 1).reshape(-1, g)
    own = ((raw >= k * S) & (raw < (k + 1) * S)).reshape(-1, g)
    member = (rows >= k * S) & (rows < (k + 1) * S)  # the padded tail repeats row N - 1
    loc = (rows - k * S).clamp(0, S - 1)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=dev)
    lo = torch.stack([torch.where(member, a[loc], inf).amin(1) for a in (x, y, z)], dim=1)
    hi = torch.stack([torch.where(member, a[loc], -inf).amax(1) for a in (x, y, z)], dim=1)
    hm = torch.where(member, h[loc], -inf).amax(1)
    if P > 1:
        ends = [0, lo.shape[0] - 1]
        mine = torch.cat([torch.tensor([g0, g1], dtype=torch.float64, device=dev)[:, None],
                          lo[ends].double(), hi[ends].double(), hm[ends].double()[:, None]],
                         dim=1)
        every = all_gather(mesh, mine).reshape(-1, 8)  # (2P, gid lo3 hi3 hmax)
        lo, hi, hm = lo.clone(), hi.clone(), hm.clone()
        for row, gid in zip(ends, (g0, g1)):
            hit = (every[:, 0] == gid)[:, None]
            lo[row] = torch.where(hit, every[:, 1:4], float("inf")).amin(0).to(x.dtype)
            hi[row] = torch.where(hit, every[:, 4:7], float("-inf")).amax(0).to(x.dtype)
            hm[row] = torch.where(hit[:, 0], every[:, 7], float("-inf")).amax(0).to(x.dtype)
    return rows, own, lo, hi, 2.0 * hm


def slab_windows(mesh, x, y, z, h, box: Box, cfg: NeighborConfig, table) -> SlabWindows:
    """The window cells of the global groups that meet this rank's slab,
    as one device computes them (``slab_group_bounds``), each cell's range
    read off the global cell-starts table (``parallel.exchange.
    global_cell_table``: its entries are the searchsorted of the global
    sorted keys at the cells' boundaries)."""
    rows, own, lo, hi, radius = slab_group_bounds(mesh, x, y, z, h, cfg.group)

    def cell_range(ckey):
        return table[ckey], table[ckey + 1]

    start, end, cell_ok, occ, window_ok = _window_cells(lo, hi, radius, box, cfg, cell_range)
    return SlabWindows(rows=rows, own=own, start=start, end=end, cell_ok=cell_ok,
                       occ=occ.amax().to(torch.int32), window_ok=window_ok.all())


@named_phase("neighbors")
def search_slab(mesh, win: SlabWindows, x, y, z, h, jxyz, g2l, box: Box, cfg: NeighborConfig):
    """The neighbour lists of this rank's rows (``find_neighbors`` on a
    slab): every global group that meets the slab searches its window
    cells' global rows ``start + slot``, so that the candidates, the k-th
    hit, the truncation and ``nc`` are the one-device search's whatever
    the slabs; ``jxyz``: the j-buffers [own slab | halo rows] of x, y, z,
    ``g2l`` the global row -> j-buffer row map (-1: not served). Returns
    (nidx (S, ngmax) int32 GLOBAL rows, nmask, nc (S,), the candidates
    streamed, unserved () bool)."""
    S = x.shape[0]
    ti = (win.rows - mesh.rank * S).clamp(0, S - 1)
    nidx, nmask, nc, work, unserved = _search_windows(
        win.rows, ti, win.start, win.end, win.cell_ok, x, y, z, h, jxyz, g2l,
        S * mesh.size, box, cfg)
    own = win.own.reshape(-1)
    return nidx[own], nmask[own], nc[own], work, unserved
