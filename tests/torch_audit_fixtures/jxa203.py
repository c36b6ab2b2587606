"""JXA203 fixtures: (a) a particle field all_gathered whole onto every
rank (N rows each: the gather the halo exchange exists to avoid) vs the
slabs' bounds gathered; (b) a P2P round shipping a whole slab against a
declared budget of an eighth of it vs the honest budget."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, audit_mesh, entrypoint
from sphexa_torch.parallel.mesh import all_gather, exchange_rounds

_N = 4096  # rows a rank


def _slab():
    mesh = audit_mesh()
    return mesh, torch.linspace(0.0, 1.0, _N) + mesh.rank


@entrypoint("replicated_particle_field", mesh_axes=("p",), phase_coverage_min=0.0)  # expect: JXA203
def replicated_particle_field():
    mesh, x = _slab()
    return EntryCase(fn=lambda x: x.sum() + all_gather(mesh, x).sum(), args=(x,))


@entrypoint("gathered_slab_bounds", mesh_axes=("p",), phase_coverage_min=0.0)
def gathered_slab_bounds():
    mesh, x = _slab()
    return EntryCase(fn=lambda x: all_gather(mesh, torch.stack([x.min(), x.max()])).sum(),
                     args=(x,))


def _round(mesh):
    return lambda x: exchange_rounds(mesh, [x])[0] + x


@entrypoint("volume_over_budget", mesh_axes=("p",), phase_coverage_min=0.0)  # expect: JXA203
def volume_over_budget():
    # the round ships a whole slab; the declared budget covers an eighth of
    # it, slack included
    mesh, x = _slab()
    return EntryCase(fn=_round(mesh), args=(x,), exchange_budget_bytes=_N * 4 // 16)


@entrypoint("volume_within_budget", mesh_axes=("p",), phase_coverage_min=0.0)
def volume_within_budget():
    mesh, x = _slab()
    return EntryCase(fn=_round(mesh), args=(x,), exchange_budget_bytes=_N * 4)
