"""Every pair within a radius, by cell grids: the straightforward search
of SPH-EXA's findneighbors.hpp without its truncation at ngmax.

The queries are grouped by radius into levels a factor 1.25 apart; each
level bins all sources into a grid whose cells are at least its largest
radius and scans the 27 cells around each query. Minimum-image
separations along periodic dimensions."""

from typing import Sequence, Tuple

import torch

#: candidate pairs one expansion holds at most
CANDIDATES_PER_CHUNK = 1 << 23


def min_image(r: torch.Tensor, length: torch.Tensor, periodic: Sequence[bool]) -> torch.Tensor:
    """(..., 3) separations folded to the nearest image along periodic dims."""
    out = []
    for d in range(3):
        c = r[..., d]
        if periodic[d]:
            c = c - length[d] * torch.round(c / length[d])
        out.append(c)
    return torch.stack(out, dim=-1)


def _grid(pos64: torch.Tensor, lo, length, periodic, cell: float):
    """Cell counts per dimension and the cell coordinates of ``pos64``."""
    dims, coords = [], []
    for d in range(3):
        span = float(length[d])
        if periodic[d]:
            g = int(span // cell)
            g = g if g >= 3 else 1
            size = span / g
            ix = torch.floor((pos64[:, d] - float(lo[d])) / size).long() % g
        else:
            g = int(span // cell) + 1
            ix = torch.clamp(torch.floor((pos64[:, d] - float(lo[d])) / cell).long(), 0, g - 1)
        dims.append(g)
        coords.append(ix)
    return dims, coords


def find_pairs(qpos: torch.Tensor, qrad: torch.Tensor, spos: torch.Tensor, lo, length,
               periodic: Sequence[bool], exclude_self: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs (i, j) of query i and source j with |q_i - s_j| < qrad_i,
    sorted by (i, j); ``exclude_self`` drops j == i (one set). The
    separations are computed in the positions' dtype; ``lo`` and
    ``length`` bound both sets."""
    dev = qpos.device
    q64, s64 = qpos.double(), spos.double()
    length_t = torch.as_tensor([float(v) for v in length], dtype=qpos.dtype, device=dev)
    rad = qrad.double()
    rmin = float(rad.min())
    level = torch.floor(torch.log(rad / rmin) / torch.log(torch.tensor(1.25, dtype=torch.float64))
                        ).long()
    out_i, out_j = [], []
    for lv in torch.unique(level).tolist():
        q = torch.nonzero(level == lv).squeeze(1)
        cell = float(rad[q].max())
        dims, scoord = _grid(s64, lo, length, periodic, cell)
        gy, gz = dims[1], dims[2]
        scid = (scoord[0] * gy + scoord[1]) * gz + scoord[2]
        order = torch.argsort(scid)
        sorted_cid = scid[order]
        _, qcoord = _grid(q64[q], lo, length, periodic, cell)
        offs = [[0] if (periodic[d] and dims[d] == 1) else [-1, 0, 1] for d in range(3)]
        for ox in offs[0]:
            for oy in offs[1]:
                for oz in offs[2]:
                    valid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
                    nc = []
                    for d, o in enumerate((ox, oy, oz)):
                        c = qcoord[d] + o
                        if periodic[d]:
                            c = c % dims[d]
                        else:
                            valid &= (c >= 0) & (c < dims[d])
                        nc.append(c)
                    ncid = (nc[0] * gy + nc[1]) * gz + nc[2]
                    start = torch.searchsorted(sorted_cid, ncid)
                    cnt = torch.where(valid, torch.searchsorted(sorted_cid, ncid, right=True)
                                      - start, 0)
                    _expand(q, start, cnt, order, qpos, spos, qrad, length_t, periodic,
                            exclude_self, out_i, out_j)
    i = torch.cat(out_i) if out_i else torch.zeros(0, dtype=torch.long, device=dev)
    j = torch.cat(out_j) if out_j else torch.zeros(0, dtype=torch.long, device=dev)
    key = torch.argsort(i * spos.shape[0] + j)
    return i[key], j[key]


def _expand(q, start, cnt, order, qpos, spos, qrad, length_t, periodic, exclude_self,
            out_i, out_j):
    """The candidates of queries ``q`` in one cell each, in chunks, kept
    where they lie within the query's radius."""
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1]) if csum.numel() else 0
    a = 0
    while a < q.shape[0] and total:
        # the queries whose candidates fit one chunk (at least one query)
        base = int(csum[a - 1]) if a else 0
        b = int(torch.searchsorted(csum, torch.tensor(base + CANDIDATES_PER_CHUNK,
                                                      device=csum.device), right=True))
        b = max(b, a + 1)
        c = cnt[a:b]
        n = int(c.sum())
        if n:
            qi = torch.repeat_interleave(q[a:b], c)
            first = torch.cumsum(c, 0) - c
            jpos = torch.arange(n, device=q.device) + torch.repeat_interleave(start[a:b] - first, c)
            j = order[jpos]
            r = min_image(qpos[qi] - spos[j], length_t, periodic)
            d2 = (r * r).sum(-1)
            rq = qrad[qi]
            keep = d2 < rq * rq
            if exclude_self:
                keep &= j != qi
            out_i.append(qi[keep])
            out_j.append(j[keep])
        a = b
