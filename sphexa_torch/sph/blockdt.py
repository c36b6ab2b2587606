"""Hierarchical block time steps (sphexa_tpu/sph/blockdt.py): each particle
sits in a power-of-two dt bin ``k`` and is kicked with ``dt_min * 2**k``
every ``2**k``-th substep (Bonsai's block scheme, Bédorf et al. 2014 §3.4).

- ``B = dt_bins`` bins, a cycle of ``C = 2**(B-1)`` substeps, each substep
  advancing ``ttot`` by the cycle's ``dt_min``;
- bin ``k`` is due at substep ``s`` iff ``(s + 1) % 2**k == 0``, so every
  bin is due at ``s = C - 1``: the cycle's end synchronizes all;
- at ``s = 0`` ``dt_min`` is recomputed by the global path's
  ``compute_timestep``, and every ``bin_sync_every``-th cycle the bins are
  reassigned from per-particle candidates (Courant ``k_cour h / c`` and,
  under gravity, ``eta_acc sqrt(eps / |a|)``);
- inactive particles drift ``x += v dt_min`` each substep; a due particle
  first removes the drift since its last kick, then takes one full update
  of ``dt_min * 2**k`` (propagator._integrate_and_finish_blockdt).

``dt_bins = 1`` is C = 1, every particle due every substep: the global
step. Keys are int64 here (sphexa_torch/dtypes.py) where the JAX
package's are uint32; the folded key has the same values and, sorted
stably, the same order.

``compact_active`` is the list of due rows: K13's one-row form
(gravity/pallas_compact.py ``compact_row``), on the card its kernel, on
the CPU its plain version; the gather backend takes the plain version on
either device.
"""

import dataclasses

import torch

from sphexa_torch.dtypes import HYDRO_DTYPE, INDEX_DTYPE, KEY_BITS
from sphexa_torch.gravity.pallas_compact import compact_row, compact_row_plain

#: secondary-key bits below the 3 KEY_BITS spatial key in one 32-bit sort
#: key (the spatial key takes 30 bits, leaving 2)
FOLD_BITS = 32 - 3 * KEY_BITS


@dataclasses.dataclass
class BlockDtState:
    """Per-particle bins and the cycle's scalars, the carry's ``bdt`` slot:
    its (n,) fields ride the step's sort with the particles, its scalars
    pass through."""

    bins: torch.Tensor     # (n,) int32 dt bin of each particle
    dt_prev: torch.Tensor  # (n,) float32 dt of each particle's last kick
    substep: torch.Tensor  # () int32 position in the cycle
    cycle: torch.Tensor    # () int32 completed cycles
    dt_min: torch.Tensor   # () float32 bin 0's dt in this cycle

    def to(self, device) -> "BlockDtState":
        return BlockDtState(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def make_blockdt_state(state, nbins: int) -> BlockDtState:
    """A fresh carry: every particle in bin 0 (the first sync substep
    re-bins) and dt_prev the state's min_dt, so the first update sees the
    dt_m1 the global path would. ``nbins`` does not enter, as in the JAX
    package."""
    del nbins
    dev = state.x.device
    zero = torch.zeros((), dtype=INDEX_DTYPE, device=dev)
    return BlockDtState(
        bins=torch.zeros(state.n, dtype=INDEX_DTYPE, device=dev),
        dt_prev=torch.full((state.n,), 1.0, dtype=HYDRO_DTYPE, device=dev) * state.min_dt,
        substep=zero, cycle=zero.clone(),
        dt_min=state.min_dt.to(HYDRO_DTYPE).clone())


def cycle_length(nbins: int) -> int:
    """Substeps per cycle: the deepest bin steps once a cycle."""
    return 1 << (nbins - 1)


def particle_dt_candidates(h, c, const, ax=None, ay=None, az=None) -> torch.Tensor:
    """Each particle's own dt: Courant ``k_cour h / c`` and, with the
    accelerations, ``eta_acc sqrt(eps / |a|)`` (inf at |a| = 0, which the
    bin clip saturates)."""
    dt = const.k_cour * h / c
    if ax is not None:
        acc = torch.sqrt(ax * ax + ay * ay + az * az)
        dt = torch.minimum(dt, const.eta_acc * torch.sqrt(const.eps / acc))
    return dt


def assign_bins(dt_part, dt_min, nbins: int) -> torch.Tensor:
    """``k = clip(floor(log2(dt_i / dt_min)), 0, nbins - 1)``: the deepest
    power-of-two multiple of dt_min each particle admits; clipped in
    float32 before the int cast, so inf saturates."""
    ratio = torch.clamp_min(dt_part / dt_min, 1.0)
    k = torch.clamp(torch.floor(torch.log2(ratio)), 0.0, float(nbins - 1))
    return k.to(INDEX_DTYPE)


def due_mask(bins, substep) -> torch.Tensor:
    """Bin k is due every 2**k-th substep, all aligned at the cycle's end:
    ``(substep + 1) & (2**k - 1) == 0``."""
    period_mask = torch.bitwise_left_shift(torch.ones_like(bins), bins) - 1
    return torch.bitwise_and(substep + 1, period_mask) == 0


def bin_populations(bins, nbins: int) -> torch.Tensor:
    """(nbins,) int32 histogram of the bins: updates per cycle are
    sum_k pop[k] C / 2**k. An integer ``index_add_`` into nbins + 1 slots
    (bins past the last land in the dropped one): ``bincount`` sizes its
    output from the data, a read of the card."""
    pop = torch.zeros(nbins + 1, dtype=INDEX_DTYPE, device=bins.device)
    return pop.index_add_(0, torch.clamp(bins, max=nbins),
                          torch.ones_like(bins, dtype=INDEX_DTYPE))[:nbins]


def fold_bin_key(keys, bins) -> torch.Tensor:
    """The spatial key in the high bits and the bin, saturated at
    2**FOLD_BITS - 1, in the low FOLD_BITS: one stable sort keeps the
    spatial order and groups equal keys by bin. The state stays spatially
    sorted (the engines need it); the active rows are gathered by
    ``compact_active`` instead."""
    b = torch.clamp_max(bins, (1 << FOLD_BITS) - 1).to(keys.dtype)
    return torch.bitwise_or(torch.bitwise_left_shift(keys, FOLD_BITS), b)


def compact_active(due, use_kernel: bool = True) -> tuple:
    """The due rows first, in row order, and their count: K13's one-row
    form (the JAX package runs K13 over one (1, n) row, class 0 the due
    rows, cap0 = n); without ``use_kernel`` (the gather backend, the JAX
    package's use_kernel=False) its plain version on either device, no
    launch. Returns (idx (n,) int32, zero past the count; n_active ()
    int32). The JAX package's XLA path and its path past 2**24 rows put
    the inactive rows past the count instead of zeros; no caller reads
    past it."""
    return compact_row(due) if use_kernel else compact_row_plain(due)
