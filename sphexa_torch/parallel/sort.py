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
sub-cells, and sums the counts over ranks; four rounds cover the 30 key
bits). Rows with key K_r are split between the ranks in rank order, which
is global row order. Each rank then sends every other rank one piece of
its locally sorted rows (one all_to_all; rows that keep their owner do not
travel), and a stable sort of the received pieces, which arrive in rank
order, gives the slab. Collectives: four integer all_reduces of (P-1,
511) counts, one all_gather of (P-1, 2) counts, one host read of the
(P, P+1) cut table (the all_to_all's sizes), the all_to_all.
"""

from typing import Tuple

import torch

from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, all_to_all_rows

#: bits resolved per radix-select round (three octree levels)
_ROUND_BITS = 9


def _rounds():
    """(shift, bits) of each radix-select round, top bits first, over the
    3 KEY_BITS bits of a key."""
    out, hi = [], 3 * KEY_BITS
    while hi > 0:
        step = min(_ROUND_BITS, hi)
        hi -= step
        out.append((hi, step))
    return out


def splitter_keys(mesh: Mesh, sorted_keys: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """The key at each global position of ``bounds`` ((B,) int64) in the
    stable sort of every rank's keys; ``sorted_keys``: this rank's keys in
    ascending order. Every rank returns the same (B,) int64."""
    dev = sorted_keys.device
    base = torch.zeros(bounds.shape[0], dtype=torch.int64, device=dev)
    for shift, bits in _rounds():
        digits = torch.arange(1, 1 << bits, dtype=torch.int64, device=dev)
        thresholds = base[:, None] + digits[None, :] * (1 << shift)
        below = torch.searchsorted(sorted_keys, thresholds.contiguous())
        below = all_reduce_sum(mesh, below)
        base = base + (below <= bounds[:, None]).sum(dim=1) * (1 << shift)
    return base


def cut_table(mesh: Mesh, sorted_keys: torch.Tensor) -> torch.Tensor:
    """(P, P + 1) int64: row j holds where rank j's locally sorted rows
    split into the pieces that ranks 0 .. P-1 own after the sort (0 first,
    the slab size last)."""
    P, S = mesh.size, sorted_keys.shape[0]
    dev = sorted_keys.device
    bounds = torch.arange(1, P, dtype=torch.int64, device=dev) * S
    kstar = splitter_keys(mesh, sorted_keys, bounds)
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


def distributed_sort(mesh: Mesh, keys: torch.Tensor, cols: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort every rank's (S,) int64 ``keys`` and (S, F) float32 ``cols``
    rows across ranks. Returns this rank's slab of the one-device stable
    sort: its (S,) keys and (S, F) rows."""
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    cuts = cut_table(mesh, skeys).tolist()  # the all_to_all's sizes: one host read
    k = mesh.rank
    send_counts = [cuts[k][d + 1] - cuts[k][d] for d in range(mesh.size)]
    recv_counts = [cuts[j][k + 1] - cuts[j][k] for j in range(mesh.size)]
    # the keys ride as two float32 columns of their bits (copied, never computed on)
    payload = torch.cat([cols.index_select(0, order),
                         skeys.contiguous().view(torch.float32).view(-1, 2)], dim=1)
    got = all_to_all_rows(mesh, payload, send_counts, recv_counts)
    rkeys = got[:, -2:].contiguous().view(torch.int64).view(-1)
    # the pieces arrive in rank order, each sorted: a stable sort by key
    # orders ties by (rank, local row), the pre-sort global row
    order2 = torch.argsort(rkeys, stable=True)
    return rkeys[order2], got[:, :-2].index_select(0, order2)
