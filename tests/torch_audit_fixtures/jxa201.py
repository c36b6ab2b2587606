"""JXA201 fixtures: two same-shape all_reduces from two sites, issued in
an order that depends on the rank (gloo completes them, the payloads
cross-wired: rank 0's first sum meets rank 1's second) vs the same pair
in one order on every rank."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, audit_mesh, entrypoint
from sphexa_torch.parallel.mesh import all_reduce_sum


def _rank_ordered(mesh, a, b):
    if mesh.rank == 0:
        ra = all_reduce_sum(mesh, a)
        rb = all_reduce_sum(mesh, b)
    else:
        rb = all_reduce_sum(mesh, b)
        ra = all_reduce_sum(mesh, a)
    return ra, rb


def _program_ordered(mesh, a, b):
    ra = all_reduce_sum(mesh, a)
    rb = all_reduce_sum(mesh, b)
    return ra, rb


def _case(fn):
    mesh = audit_mesh()
    a = torch.arange(8, dtype=torch.int32) + mesh.rank
    return EntryCase(fn=lambda a, b: fn(mesh, a, b), args=(a, 10 * a))


@entrypoint("rank_ordered_reduces", mesh_axes=("p",), phase_coverage_min=0.0)  # expect: JXA201
def rank_ordered_reduces():
    return _case(_rank_ordered)


@entrypoint("program_ordered_reduces", mesh_axes=("p",), phase_coverage_min=0.0)
def program_ordered_reduces():
    return _case(_program_ordered)
