"""Field snapshots deposited inside the step
(sphexa_tpu/observables/snapshot.py): fixed-shape downsampled field grids
that ride the step's diagnostics and reach the host in the Simulation's one
read at a check or flush boundary.

The reference's in-situ leg hands the whole mesh to Ascent or ParaView
Catalyst around the main loop (``main/src/ascent_adaptor.h``,
``catalyst_adaptor.h``); here a ``SnapshotSpec`` lowers to one stacked
deposit per step: an ``(F, G, G)`` column projection (or an
``(F, G, G, G)`` volume) and, optionally, a strided particle subsample.
The JAX package computes it outside any Pallas kernel, with a
scatter-add; the port's "sum" sorts the particles by cell (a stable
argsort) and sums each cell's segment in a fixed order (the exact float64
prefix sums of ``gravity.multipole.edge_segment_sum``, rounded to the
weights' dtype), so that the card gives the same bits every run (an
``index_add_`` there adds colliding cells with atomics in no fixed order:
audit rule JXA401); the "max" is ``scatter_reduce_(..., "amax")``, which
depends on no order.

Under a mesh each rank deposits its slab; the partial grids are summed
(or maxed) over the ranks inside the step's one ``reduce_scalars``
all_gather (propagator.py ``_step_diagnostics``), so the deposit adds no
collective. A strided subsample on a mesh gathers the slabs' rows."""

import dataclasses
from typing import Dict, Tuple

import torch

from sphexa_torch.gravity.multipole import edge_segment_sum
from sphexa_torch.util.phases import named_phase

#: the snapshot diagnostics the step tail emits when PropagatorConfig.snap
#: is set (None: the steps deposit nothing; consumers .get() them).
#: ``snap_grid`` is the (F, G, G) (or (F, G, G, G)) field grid, ``snap_min``
#: / ``snap_max`` the per-field grid extrema, ``snap_pts`` the optional
#: strided particle subsample ((3 + F, ceil(N / stride)))
SNAP_DIAG_KEYS = ("snap_grid", "snap_min", "snap_max", "snap_pts")

#: the fields a spec may name: "rho" is the force stage's density (in the
#: post-step order, the ledger's pairing); the rest are ParticleState fields
SNAP_FIELDS = ("rho", "m", "temp", "vx", "vy", "vz", "h", "du")


@dataclasses.dataclass(frozen=True)
class SnapshotSpec:
    """Static description of the deposit, so that every shape is fixed.

    ``fields``: names from SNAP_FIELDS, deposited as weights.
    ``grid``: side G of the deposit grid.
    ``axis``: the projection axis of the 2-D deposit (2 = along z onto the
    (x, y) plane, as ``viz.render_field``).
    ``reduce``: "sum" (column deposit) or "max" (peak value).
    ``stride``: > 0 ships every stride-th particle's position and fields
    as ``snap_pts`` beside the grids; 0 = grids only.
    ``volume``: True deposits the whole (F, G, G, G) volume instead of the
    projection.
    """

    fields: Tuple[str, ...] = ("rho",)
    grid: int = 16
    axis: int = 2
    reduce: str = "sum"
    stride: int = 0
    volume: bool = False

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))
        if not self.fields:
            raise ValueError("SnapshotSpec.fields must name >= 1 field")
        for f in self.fields:
            if f not in SNAP_FIELDS:
                raise ValueError(f"unknown snapshot field {f!r}; "
                                 f"choices: {list(SNAP_FIELDS)}")
        if self.grid < 2:
            raise ValueError("SnapshotSpec.grid must be >= 2")
        if self.axis not in (0, 1, 2):
            raise ValueError("SnapshotSpec.axis must be 0, 1 or 2")
        if self.reduce not in ("sum", "max"):
            raise ValueError("SnapshotSpec.reduce must be 'sum' or 'max'")
        if self.stride < 0:
            raise ValueError("SnapshotSpec.stride must be >= 0")

    @property
    def shape(self) -> Tuple[int, ...]:
        G = self.grid
        return (len(self.fields),) + ((G, G, G) if self.volume else (G, G))


def _weights(state, rho, spec: SnapshotSpec) -> torch.Tensor:
    return torch.stack([rho if f == "rho" else getattr(state, f) for f in spec.fields])


def deposit(state, rho, box, spec: SnapshotSpec) -> torch.Tensor:
    """This rank's (or the one device's) partial grid, flat: (F, G^2) or
    (F, G^3), in the weights' dtype. A "max" grid holds the dtype's
    lowest value in its empty cells until ``finish``."""
    G = spec.grid
    lo, lengths = box.lo, box.lengths

    def cell_index(coord, d):
        # clipped: escaped particles (positions before a regrow) land in
        # the boundary cells instead of wrapping
        u = (coord - lo[d]) / lengths[d]
        return torch.clamp((u * G).to(torch.int32), 0, G - 1).to(torch.int64)

    pos = (state.x, state.y, state.z)
    w = _weights(state, rho, spec)
    if spec.volume:
        flat = (cell_index(pos[0], 0) * G + cell_index(pos[1], 1)) * G + cell_index(pos[2], 2)
        cells = G ** 3
    else:
        rem = tuple(d for d in (0, 1, 2) if d != spec.axis)
        # row = the second remaining axis, column = the first: the
        # orientation of viz.render_field's (y, x) histogram
        flat = cell_index(pos[rem[1]], rem[1]) * G + cell_index(pos[rem[0]], rem[0])
        cells = G ** 2
    F = len(spec.fields)
    if spec.reduce == "sum":
        order = torch.argsort(flat, stable=True)
        edges = torch.searchsorted(flat[order], torch.arange(cells + 1, device=flat.device))
        return edge_segment_sum(w[:, order].t(), edges).t()
    neg = torch.finfo(w.dtype).min
    g = torch.full((F, cells), neg, dtype=w.dtype, device=w.device)
    return g.scatter_reduce_(1, flat.expand(F, -1), w, "amax", include_self=True)


def finish(g: torch.Tensor, spec: SnapshotSpec) -> Dict[str, torch.Tensor]:
    """The whole grid (flat, reduced over the ranks where there are any)
    into ``snap_grid`` with its per-field extrema; a "max" grid's empty
    cells become 0."""
    if spec.reduce == "max":
        g = torch.where(g == torch.finfo(g.dtype).min, torch.zeros((), dtype=g.dtype,
                                                                   device=g.device), g)
    return {"snap_grid": g.reshape(spec.shape), "snap_min": torch.amin(g, dim=1),
            "snap_max": torch.amax(g, dim=1)}


def snapshot_points(state, rho, spec: SnapshotSpec, mesh=None) -> torch.Tensor:
    """``snap_pts``: every ``stride``-th row's x, y, z and fields, (3 + F,
    ceil(N / stride)); on a mesh of the global array (the slabs gathered
    in rank order)."""
    rows = torch.cat([torch.stack([state.x, state.y, state.z]), _weights(state, rho, spec)])
    if mesh is not None:
        from sphexa_torch.parallel.mesh import all_gather

        g = all_gather(mesh, rows)  # (P, 3 + F, S)
        rows = g.permute(1, 0, 2).reshape(rows.shape[0], -1)
    return rows[:, ::spec.stride].contiguous()


@named_phase("snapshot")
def snapshot_diagnostics(state, rho, box, spec: SnapshotSpec,
                         mesh=None) -> Dict[str, torch.Tensor]:
    """SNAP_DIAG_KEYS over a post-integration state: ``rho`` is the force
    stage's density in the step's order. One stacked (F, N) deposit, the
    extrema over the grid and, with ``stride``, the subsample. ``mesh``:
    the state is this rank's slab and the grid is reduced over the ranks
    here (the step folds that reduction into its own all_gather)."""
    g = deposit(state, rho, box, spec)
    if mesh is not None:
        from sphexa_torch.parallel.mesh import reduce_scalars

        sums, maxes, _ = reduce_scalars(mesh, sums=[g] if spec.reduce == "sum" else [],
                                        maxes=[g] if spec.reduce == "max" else [])
        g = (sums or maxes)[0]
    out = finish(g, spec)
    if spec.stride > 0:
        out["snap_pts"] = snapshot_points(state, rho, spec, mesh)
    return out

