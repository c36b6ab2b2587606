"""Sizing from device data (sphexa_tpu/parallel/sizing.py): only scalars
or O(cells) histograms reach the host, never the particles.

- the gravity tree from device keys (``key_histogram``,
  ``drill_histogram``, ``leaf_array_from_device_keys``): a histogram
  pyramid plus drill-down rounds over the overfull cells;
- the SPH sizing of the sharded steps, over every rank's slab: the
  densest cell and widest group (``sizing_stats``), the windowed
  exchange's per-peer window (``device_halo_window``) and the sparse
  exchange's per-distance row caps (``device_sparse_halo``). Each sorts
  the slabs as the step will (parallel/sort.py) and sizes from the runs
  the step's prologue will make; one window, or P - 1 caps, reach the
  host;
- the gravity near field's sizing on a mesh (``gravity_need_matrix``,
  ``device_gravity_halo``): the rows of every slab's leaves that another
  slab's bbox opens under the monotone MAC (its P2P essential set), the
  sparse gravity serve's per-distance caps.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sphexa_torch.dtypes import KEY_BITS


def key_histogram(keys: torch.Tensor, level: int) -> torch.Tensor:
    """Cell-occupancy histogram at ``level``: (8^level,) int64."""
    cid = keys >> (3 * (KEY_BITS - level))
    return torch.bincount(cid, minlength=1 << (3 * level))


def drill_histogram(keys: torch.Tensor, cell_ids_sorted: torch.Tensor, level: int,
                    sub: int, k_cap: int) -> torch.Tensor:
    """Counts of the 8^sub sub-cells of ``k_cap`` selected cells at
    ``level`` (keys outside them fall in a discard bin).
    ``cell_ids_sorted``: (k_cap,) sorted cell indices padded with 2^30.
    Returns (k_cap, 8^sub) int64."""
    nsub = 1 << (3 * sub)
    cid = keys >> (3 * (KEY_BITS - level))
    pos = torch.searchsorted(cell_ids_sorted, cid).clamp(0, k_cap - 1)
    hit = cell_ids_sorted[pos] == cid
    subid = (keys >> (3 * (KEY_BITS - level - sub))) & (nsub - 1)
    b = torch.where(hit, pos * nsub + subid, k_cap * nsub)
    return torch.bincount(b, minlength=k_cap * nsub + 1)[: k_cap * nsub].reshape(k_cap, nsub)


def leaf_array_from_device_keys(keys_dev: torch.Tensor, bucket_size: int,
                                base_level: int = 5, sub: int = 2,
                                k_cap: int = 4096, mesh=None) -> np.ndarray:
    """Cornerstone leaf array (sorted start keys + the 2^30 sentinel),
    uint64, built without shipping the keys to the host: a node splits
    while its count exceeds ``bucket_size`` (capped at the key resolution),
    which equals the converged rebalance of compute_octree. Counts come
    from one base-level histogram plus drill rounds over the overfull
    frontier. Each histogram is one host read. ``mesh``: ``keys_dev`` is
    this rank's slab of the keys, and every histogram is summed over the
    ranks (an integer all_reduce, update_mpi.hpp's node-count allreduce),
    so that every rank builds the tree of the union of the keys, the
    one-device tree bit for bit."""
    if mesh is not None:
        from sphexa_torch.parallel.mesh import all_reduce_sum

        def total(h):
            return all_reduce_sum(mesh, h)
    else:
        def total(h):
            return h
    base_level = min(base_level, KEY_BITS)
    hist = total(key_histogram(keys_dev, base_level)).cpu().numpy()
    pyramid = {base_level: hist.astype(np.int64)}
    for lvl in range(base_level - 1, -1, -1):
        pyramid[lvl] = pyramid[lvl + 1].reshape(-1, 8).sum(axis=1)

    leaves: list = []  # (cell_index, level)
    overfull = []      # frontier beyond the pyramid, all at base_level
    stack = [(0, 0)]
    while stack:
        i, lv = stack.pop()
        c = int(pyramid[lv][i])
        if c <= bucket_size or lv >= KEY_BITS:
            leaves.append((i, lv))
        elif lv < base_level:
            stack.extend((i * 8 + k, lv + 1) for k in range(8))
        else:
            overfull.append(i)

    # drill rounds: refine every overfull cell ``sub`` levels at a time;
    # the depth-``sub`` counts are summed back up so that splitting still
    # happens one level at a time
    level = base_level
    pending = overfull
    while pending and level < KEY_BITS:
        step = min(sub, KEY_BITS - level)
        nsub = 1 << (3 * step)
        nxt = []
        for c0 in range(0, len(pending), k_cap):
            chunk = np.sort(np.asarray(pending[c0: c0 + k_cap], np.int64))
            ids = np.full(k_cap, 2**30, np.int64)
            ids[: len(chunk)] = chunk
            counts = total(drill_histogram(keys_dev,
                                           torch.as_tensor(ids, device=keys_dev.device),
                                           level, step, k_cap)).cpu().numpy()
            for r, cell in enumerate(chunk):
                sums = [counts[r].reshape(1 << (3 * d), -1).sum(axis=1)
                        for d in range(step + 1)]
                stack = [(k, 1) for k in range(8)]  # the cell is known overfull
                while stack:
                    i, d = stack.pop()
                    c = int(sums[d][i])
                    lvl = level + d
                    if c <= bucket_size or lvl >= KEY_BITS:
                        leaves.append((int(cell) * (1 << (3 * d)) + i, lvl))
                    elif d < step:
                        stack.extend((i * 8 + k, d + 1) for k in range(8))
                    else:
                        nxt.append(int(cell) * nsub + i)
        pending = nxt
        level += step

    starts = np.sort(np.asarray(
        [np.uint64(i) << np.uint64(3 * (KEY_BITS - lv)) for i, lv in leaves], np.uint64))
    return np.concatenate([starts, [np.uint64(1) << np.uint64(3 * KEY_BITS)]])


# ---------------------------------------------------------------------------
# SPH sizing of the sharded steps
# ---------------------------------------------------------------------------


def _sorted_slab(mesh, keys, *fields):
    """This rank's slab of the global sort of (keys, fields): (keys, fields)."""
    from sphexa_torch.parallel.sort import distributed_sort

    skeys, mat = distributed_sort(mesh, keys, torch.stack(fields, dim=1))
    return skeys, mat.unbind(1)


def sizing_stats(mesh, x, y, z, box, level: int, group: int, curve: str = "hilbert",
                 global_groups: bool = False):
    """(densest level-``level`` cell, (3,) widest per-dimension extent of a
    group of ``group`` SFC-consecutive particles) over every rank's
    particles, as floats on the host: the inputs of the neighbour config
    beyond n and h_max. Groups form within each slab, as in the engine's
    step, or with ``global_groups`` over the global sorted array, as the
    gather search forms them (``cell_list.slab_group_bounds``)."""
    from sphexa_torch.neighbors.cell_list import slab_group_bounds
    from sphexa_torch.parallel.exchange import global_cell_table
    from sphexa_torch.parallel.mesh import reduce_scalars
    from sphexa_torch.sfc.keys import compute_sfc_keys
    from sphexa_torch.sph.pair_engine import _pad_groups

    keys = compute_sfc_keys(x, y, z, box, curve=curve)
    skeys, (xs, ys, zs) = _sorted_slab(mesh, keys, x, y, z)
    occ = torch.diff(global_cell_table(mesh, skeys, level)).max()
    if global_groups:
        _, _, lo, hi, _ = slab_group_bounds(mesh, xs, ys, zs, torch.zeros_like(xs), group)
        ext = (hi - lo).amax(0)
    else:
        ext = torch.stack([(g.amax(1) - g.amin(1)).max()
                           for g in (_pad_groups(a, group) for a in (xs, ys, zs))])
    _, (occ, ext), _ = reduce_scalars(mesh, maxes=[occ, ext])
    # torchlint: disable=JXL002 -- the sizing's results, read once at configuration
    return int(occ), tuple(float(e) for e in ext.tolist())


def _slab_ranges(mesh, x, y, z, h, keys, box, nbr):
    """The sorted slab's global table and the prologue's global-row runs."""
    from sphexa_torch.parallel.exchange import global_cell_table
    from sphexa_torch.sph.pair_engine import group_cell_ranges

    skeys, (xs, ys, zs, hs) = _sorted_slab(mesh, keys, x, y, z, h)
    table = global_cell_table(mesh, skeys, nbr.level)
    return table, group_cell_ranges(xs, ys, zs, hs, None, box, nbr, table=table)


def _halo_window_spans(mesh, x, y, z, h, keys, box, nbr) -> torch.Tensor:
    """The largest source-row span any rank's runs need from another rank
    (runs split at slab boundaries, as the step splits them): () int64,
    the same on every rank."""
    from sphexa_torch.parallel.exchange import _split_runs, window_bounds
    from sphexa_torch.parallel.mesh import reduce_scalars

    S = x.shape[0]
    _, r = _slab_ranges(mesh, x, y, z, h, keys, box, nbr)
    starts, lens, *_ = _split_runs(r.starts, r.lens, (r.shift_x, r.shift_y, r.shift_z), S,
                                   extra=max(8, mesh.size - 1))
    _, bounds = window_bounds(mesh, starts, lens, S)
    span = torch.clamp(bounds[..., 1] - torch.minimum(bounds[..., 0], bounds[..., 1]), min=0)
    return span.max()


def device_halo_window(mesh, x, y, z, h, keys, box, nbr, margin: float = 1.4,
                       quantum: int = 1024) -> int:
    """The windowed exchange's per-peer window: the widest span padded by
    ``margin`` up to a multiple of ``quantum``, at most the slab. ``keys``:
    this slab's keys against ``box`` (the regrown box). One scalar to the
    host."""
    from sphexa_torch.parallel.exchange import slab_nbr

    S = x.shape[0]
    nbr = slab_nbr(nbr, S)
    wmax = max(int(_halo_window_spans(mesh, x, y, z, h, keys, box, nbr)), 1)
    return min(int(-(-int(wmax * margin) // quantum) * quantum), S)


def sparse_need_matrix(mesh, x, y, z, h, keys, box, nbr) -> torch.Tensor:
    """(P_dest, P_src) rows rank k's covered cells clip to rank j's slab
    (the diagonal: its own slab), from the coverage of the runs the step
    will make (exchange.localize_ranges_sparse): each rank's row, all
    gathered. The same on every rank."""
    from sphexa_torch.parallel.exchange import _sparse_layout, coverage_from_runs
    from sphexa_torch.parallel.mesh import all_gather

    S = x.shape[0]
    table, r = _slab_ranges(mesh, x, y, z, h, keys, box, nbr)
    covered = coverage_from_runs(r.starts, r.lens, table)
    return all_gather(mesh, _sparse_layout(covered, table, S, mesh.size)[2])


def _sparse_halo_needs(mesh, x, y, z, h, keys, box, nbr) -> torch.Tensor:
    """(P - 1,) per-distance needs: entry r - 1 the most rows any rank
    needs from its distance-r predecessor (round r's buffer)."""
    need = sparse_need_matrix(mesh, x, y, z, h, keys, box, nbr)
    P = mesh.size
    j = torch.arange(P, device=need.device)
    return torch.stack([need[(j + r) % P, j].max() for r in range(1, P)]) if P > 1 else \
        need.new_zeros(0)


def _caps(per_r, S: int, margin: float, quantum: int) -> Tuple[int, ...]:
    """Per-distance needs padded by ``margin`` up to multiples of
    ``quantum``, each at most the slab ``S``."""
    return tuple(min(int(-(-int(max(int(v), 1) * margin) // quantum) * quantum), S)
                 for v in per_r)


def device_sparse_halo(mesh, x, y, z, h, keys, box, nbr, margin: float = 1.4,
                       quantum: int = 256) -> Tuple[int, ...]:
    """The sparse exchange's per-distance row caps, each need padded by
    ``margin`` up to a multiple of ``quantum``, at most the slab (a cap of
    S ships the whole slab, where the escape sentinel cannot fire). P - 1
    scalars to the host."""
    from sphexa_torch.parallel.exchange import slab_nbr

    S = x.shape[0]
    nbr = slab_nbr(nbr, S)
    per_r = _sparse_halo_needs(mesh, x, y, z, h, keys, box, nbr).tolist()
    return _caps(per_r, S, margin, quantum)


def _gather_covered(mesh, x, y, z, h, keys, box, nbr):
    """The sorted slab's global table and the gather search's coverage
    (``exchange.gather_coverage``)."""
    from sphexa_torch.parallel.exchange import gather_coverage

    skeys, (xs, ys, zs, hs) = _sorted_slab(mesh, keys, x, y, z, h)
    table, _, covered = gather_coverage(mesh, xs, ys, zs, hs, skeys, box, nbr)
    return table, covered


def gather_need_matrix(mesh, x, y, z, h, keys, box, nbr) -> torch.Tensor:
    """``sparse_need_matrix`` of the gather halo: (P_dest, P_src) rows of
    rank k's covered window cells (the whole window^3 blocks of the global
    groups that meet its slab) clipped to rank j's slab. The same on every
    rank."""
    from sphexa_torch.parallel.exchange import _sparse_layout
    from sphexa_torch.parallel.mesh import all_gather

    table, covered = _gather_covered(mesh, x, y, z, h, keys, box, nbr)
    return all_gather(mesh, _sparse_layout(covered, table, x.shape[0], mesh.size)[2])


def device_gather_halo(mesh, x, y, z, h, keys, box, nbr, margin: float = 1.4,
                       quantum: int = 256) -> Tuple[int, ...]:
    """``device_sparse_halo`` of the gather halo (``gather_need_matrix``):
    P - 1 per-distance row caps, each need padded by ``margin`` up to a
    multiple of ``quantum``, at most the slab."""
    need = gather_need_matrix(mesh, x, y, z, h, keys, box, nbr)
    P = mesh.size
    j = torch.arange(P, device=need.device)
    per_r = torch.stack([need[(j + r) % P, j].max() for r in range(1, P)]).tolist() \
        if P > 1 else []
    return _caps(per_r, x.shape[0], margin, quantum)


def device_gather_window(mesh, x, y, z, h, keys, box, nbr, margin: float = 1.4,
                         quantum: int = 1024) -> int:
    """``device_halo_window`` of the gather halo: the widest row span of
    any rank's covered window cells in another rank's slab, padded by
    ``margin`` up to a multiple of ``quantum``, at most the slab."""
    from sphexa_torch.parallel.exchange import covered_bounds
    from sphexa_torch.parallel.mesh import all_gather

    S = x.shape[0]
    table, covered = _gather_covered(mesh, x, y, z, h, keys, box, nbr)
    b = all_gather(mesh, covered_bounds(covered, table, S, mesh.size, mesh.rank))
    span = torch.clamp(b[..., 1] - torch.minimum(b[..., 0], b[..., 1]), min=0)
    return _caps([int(span.max())], S, margin, quantum)[0]


def halo_sizes(mesh, state, box, nbr, mode: str, margin: float = 1.4,
               curve: str = "hilbert", backend: str = "pallas") -> dict:
    """The halo exchange's sizes at this state (the box regrown as the step
    regrows it): {"halo_cells": the sparse caps} for ``mode`` "sparse",
    else {"halo_window": the window}, ``make_sharded_step``'s keywords;
    ``backend`` "xla" sizes the gather halo (the whole window cells of the
    global groups), else the engine's runs."""
    from sphexa_torch.sfc.box import make_global_box
    from sphexa_torch.sfc.keys import compute_sfc_keys

    gbox = make_global_box(state.x, state.y, state.z, box, mesh=mesh)
    keys = compute_sfc_keys(state.x, state.y, state.z, gbox, curve=curve)
    args = (mesh, state.x, state.y, state.z, state.h, keys, gbox, nbr)
    if backend == "xla":
        if mode == "sparse":
            return {"halo_cells": device_gather_halo(*args, margin=margin)}
        return {"halo_window": device_gather_window(*args, margin=margin)}
    if mode == "sparse":
        return {"halo_cells": device_sparse_halo(*args, margin=margin)}
    return {"halo_window": device_halo_window(*args, margin=margin)}


# ---------------------------------------------------------------------------
# the gravity near field's sizing on a mesh
# ---------------------------------------------------------------------------


def gravity_need_matrix(mesh, xs, ys, zs, ms, skeys, box, tree, meta, theta: float,
                        shifts=None, multipoles=None) -> torch.Tensor:
    """(P_dest, P_src) rows of gravity near-field need (the JAX package's
    gravity_need_matrix): entry [k, j] counts the rows of rank j's slab in
    the leaves that rank k's slab bbox opens under the monotone MAC, rank
    k's P2P essential set. Whatever the slab's bbox accepts arrives by M2P
    on the replicated tree; the accept region only grows as the target
    bbox shrinks, so a leaf that any block, superblock or essential-set
    classification of the slab opens is opened by the slab too, but for
    the rows of a target block shared with a neighbour rank, which reach
    past the slab's bbox (the serve's margin and its escape sentinel
    cover them).
    ``shifts`` ((ns, 3)): the opened set is unioned over the targets
    shifted by each (the Ewald replica passes). ``xs`` .. ``skeys``: this
    rank's slab of the sorted particles; ``multipoles``: the sharded
    upsweep's (computed when None). Each rank's row, all_gathered: the
    same on every rank."""
    from sphexa_torch.gravity.traversal import (
        _accept, _bbox, _monotone_mac_geometry, compute_multipoles_sharded,
    )
    from sphexa_torch.parallel.exchange import _sparse_layout
    from sphexa_torch.parallel.mesh import all_gather

    S = xs.shape[0]
    if multipoles is None:
        multipoles = compute_multipoles_sharded(mesh, xs, ys, zs, ms, skeys, tree, meta)
    node_mass, node_com, _, edges = multipoles
    valid = node_mass > 0
    gc, gs, mac2 = _monotone_mac_geometry(box, tree, meta, node_com, valid, theta)
    bc, bs = _bbox(xs, ys, zs)
    opened = ~_accept(bc, bs, gc, gs, mac2)
    if shifts is not None:
        for sh in shifts:
            opened = opened | ~_accept(bc + sh, bs, gc, gs, mac2)
    cov = opened[tree.node_of_leaf]  # (L,): the leaves this slab opens
    return all_gather(mesh, _sparse_layout(cov, edges, S, mesh.size)[2])


def _gravity_halo_needs(mesh, *args, **kw) -> torch.Tensor:
    """(P - 1,) per-distance gravity needs: entry r - 1 the most rows any
    rank needs from its distance-r predecessor (the fold of
    ``gravity_need_matrix`` that ``_sparse_halo_needs`` makes of the SPH
    one)."""
    need = gravity_need_matrix(mesh, *args, **kw)
    P = mesh.size
    j = torch.arange(P, device=need.device)
    return torch.stack([need[(j + r) % P, j].max() for r in range(1, P)]) if P > 1 else \
        need.new_zeros(0)


def device_gravity_halo(mesh, xs, ys, zs, ms, skeys, box, tree, meta, theta: float,
                        shifts=None, margin: float = 1.4, quantum: int = 256,
                        multipoles=None) -> Tuple[int, ...]:
    """The sparse gravity serve's per-distance row caps (the JAX package's
    device_gravity_halo): each need padded by ``margin`` up to a multiple
    of ``quantum``, at most the slab (a cap of S ships the whole slab, the
    retry ceiling, where the escape sentinel cannot fire). P - 1 scalars
    reach the host."""
    S = xs.shape[0]
    per_r = _gravity_halo_needs(mesh, xs, ys, zs, ms, skeys, box, tree, meta, theta,
                                shifts=shifts, multipoles=multipoles).tolist()
    return _caps(per_r, S, margin, quantum)
