"""The global SFC sort across ranks: the JAX package's stable
``jnp.argsort`` of the sharded keys (propagator._sort_by_keys under a
mesh), here as a distributed sample-free sort.

Rank k must end with rows [k S, (k + 1) S) of the one-device stable sort,
keys included, bit for bit: ties on a key go by the pre-sort global row
k S + local. So the splitters are exact: for each boundary b_r = r S
(r = 1 .. P-1) a radix select finds the key K_r at global position b_r
from cumulative key counts (the key histograms' role: each round counts,
on every rank's sorted keys, the keys below 511 thresholds that cut the
current key interval into 512 sub-intervals, three octree levels' 8^3
sub-cells, and sums the counts over ranks; four rounds cover the 30 bits
of a spatial key, and the 32 of the block time steps' folded key,
``key_bits``). Rows with key K_r are split between the ranks in rank
order, which is global row order. Each rank then sends every other rank one piece of
its locally sorted rows (one all_to_all; rows that keep their owner do not
travel), and a stable sort of the received pieces, which arrive in rank
order, gives the slab. Collectives: four integer all_reduces of (P-1,
511) counts, one all_gather of (P-1, 2) counts, one host read of the
(P, P+1) cut table (the all_to_all's sizes), the all_to_all.

Integer per-row fields (the block time steps' int32 bins, a row's int64
global index) ride as float32 columns of their bits (``extra``), as the
keys do: copied, never computed on. ``to_owners`` sends rows back to the
ranks that held them before the sort (a second all_to_all on the
transposed cut table), each to the slot its global index names.
"""

from typing import List, NamedTuple, Sequence, Tuple

import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, all_to_all_rows

#: bits resolved per radix-select round (three octree levels)
_ROUND_BITS = 9

#: the width of a spatial key
SPATIAL_KEY_BITS = 3 * KEY_BITS


def _rounds(key_bits: int = SPATIAL_KEY_BITS):
    """(shift, bits) of each radix-select round, top bits first, over the
    ``key_bits`` bits of a key."""
    out, hi = [], key_bits
    while hi > 0:
        step = min(_ROUND_BITS, hi)
        hi -= step
        out.append((hi, step))
    return out


def splitter_keys(mesh: Mesh, sorted_keys: torch.Tensor, bounds: torch.Tensor,
                  key_bits: int = SPATIAL_KEY_BITS) -> torch.Tensor:
    """The key at each global position of ``bounds`` ((B,) int64) in the
    stable sort of every rank's keys; ``sorted_keys``: this rank's keys in
    ascending order, each below 2**key_bits. Every rank returns the same
    (B,) int64."""
    dev = sorted_keys.device
    base = torch.zeros(bounds.shape[0], dtype=torch.int64, device=dev)
    for shift, bits in _rounds(key_bits):
        digits = torch.arange(1, 1 << bits, dtype=torch.int64, device=dev)
        thresholds = base[:, None] + digits[None, :] * (1 << shift)
        below = torch.searchsorted(sorted_keys, thresholds.contiguous())
        below = all_reduce_sum(mesh, below)
        base = base + (below <= bounds[:, None]).sum(dim=1) * (1 << shift)
    return base


def cut_table(mesh: Mesh, sorted_keys: torch.Tensor,
              key_bits: int = SPATIAL_KEY_BITS) -> torch.Tensor:
    """(P, P + 1) int64: row j holds where rank j's locally sorted rows
    split into the pieces that ranks 0 .. P-1 own after the sort (0 first,
    the slab size last)."""
    P, S = mesh.size, sorted_keys.shape[0]
    dev = sorted_keys.device
    bounds = torch.arange(1, P, dtype=torch.int64, device=dev) * S
    kstar = splitter_keys(mesh, sorted_keys, bounds, key_bits)
    less = torch.searchsorted(sorted_keys, kstar)
    eq = torch.searchsorted(sorted_keys, kstar, right=True) - less
    g = all_gather(mesh, torch.stack([less, eq]))  # (P, 2, P-1)
    less_all, eq_all = g[:, 0], g[:, 1]
    # the rows with key K_r that fall below b_r, taken in rank order
    ties = bounds[None, :] - less_all.sum(dim=0, keepdim=True)
    before = torch.cumsum(eq_all, dim=0) - eq_all
    take = torch.minimum(torch.clamp(ties - before, min=0), eq_all)
    cuts = less_all + take  # (P, P-1)
    zero = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    return torch.cat([zero, cuts, torch.full_like(zero, S)], dim=1)


def bit_columns(t: torch.Tensor) -> torch.Tensor:
    """An (S,) int32 or int64 tensor as (S, 1) or (S, 2) float32 columns of
    its bits (a view: nothing is converted)."""
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bit columns carry int32 or int64 rows, not {t.dtype}")
    return t.contiguous().view(torch.float32).view(t.shape[0], -1)


def from_bit_columns(cols: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``bit_columns``: the (S,) ``dtype`` rows of the columns."""
    return cols.contiguous().view(dtype).view(-1)


class SortResult(NamedTuple):
    """This rank's slab of the global stable sort: its keys, its float32
    rows, its ``extra`` integer rows, and the all_to_all's piece sizes
    (the rows this rank sent to, and received from, each rank)."""

    keys: torch.Tensor
    rows: torch.Tensor
    extra: List[torch.Tensor]
    send_counts: List[int]
    recv_counts: List[int]


def sort_slabs(mesh: Mesh, keys: torch.Tensor, cols: torch.Tensor,
               key_bits: int = SPATIAL_KEY_BITS, extra: Sequence[torch.Tensor] = ()
               ) -> SortResult:
    """Sort every rank's (S,) int64 ``keys`` (each below 2**key_bits), its
    (S, F) float32 ``cols`` rows and its (S,) int32 or int64 ``extra``
    rows across ranks (``distributed_sort``); the piece sizes come back
    too, for ``to_owners``."""
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    # torchlint: disable=JXL002 -- the all_to_all's sizes: one host read
    cuts = cut_table(mesh, skeys, key_bits).tolist()
    k = mesh.rank
    send_counts = [cuts[k][d + 1] - cuts[k][d] for d in range(mesh.size)]
    recv_counts = [cuts[j][k + 1] - cuts[j][k] for j in range(mesh.size)]
    # the keys and the integer rows ride as float32 columns of their bits
    # (copied, never computed on)
    bits = [bit_columns(skeys)] + [bit_columns(e.index_select(0, order)) for e in extra]
    widths = [b.shape[1] for b in bits]
    payload = torch.cat([cols.index_select(0, order), *bits], dim=1)
    got = all_to_all_rows(mesh, payload, send_counts, recv_counts)
    nf = cols.shape[1]
    tail = torch.split(got[:, nf:], widths, dim=1)
    rkeys = from_bit_columns(tail[0], torch.int64)
    # the pieces arrive in rank order, each sorted: a stable sort by key
    # orders ties by (rank, local row), the pre-sort global row
    order2 = torch.argsort(rkeys, stable=True)
    rextra = [from_bit_columns(t, e.dtype).index_select(0, order2)
              for t, e in zip(tail[1:], extra)]
    return SortResult(rkeys[order2], got[:, :nf].index_select(0, order2), rextra,
                      send_counts, recv_counts)


def distributed_sort(mesh: Mesh, keys: torch.Tensor, cols: torch.Tensor,
                     key_bits: int = SPATIAL_KEY_BITS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort every rank's (S,) int64 ``keys`` and (S, F) float32 ``cols``
    rows across ranks. Returns this rank's slab of the one-device stable
    sort: its (S,) keys and (S, F) rows."""
    r = sort_slabs(mesh, keys, cols, key_bits)
    return r.keys, r.rows


def to_owners(mesh: Mesh, rows: torch.Tensor, gidx: torch.Tensor, sort: SortResult
              ) -> torch.Tensor:
    """Rows of the sorted slab back to the ranks and slots they came from:
    ``rows`` ((S, F) float32, in the slab's order), ``gidx`` ((S,) int64,
    each row's global index before the sort, rank j holding [j S, (j + 1)
    S)), ``sort`` the sort that made the slab. One all_to_all on the
    transposed piece sizes. Returns this rank's (S, F) rows in its
    pre-sort order."""
    S = rows.shape[0]
    # a row's owner is gidx // S: ordering by gidx groups the rows by owner
    order = torch.argsort(gidx, stable=True)
    payload = torch.cat([rows.index_select(0, order), bit_columns(gidx.index_select(0, order))],
                        dim=1)
    got = all_to_all_rows(mesh, payload, sort.recv_counts, sort.send_counts)
    nf = rows.shape[1]
    slot = from_bit_columns(got[:, nf:], torch.int64) - mesh.rank * S
    out = torch.empty_like(rows)
    out[slot] = got[:, :nf]
    return out
