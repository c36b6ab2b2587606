"""JXA106 fixtures: a collective over the mesh's group ("p") in an entry
that declares another axis ("data") vs the consistent declaration."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, audit_mesh, entrypoint
from sphexa_torch.parallel.mesh import all_reduce_sum


def _reduce_case():
    mesh = audit_mesh()
    return EntryCase(fn=lambda x: all_reduce_sum(mesh, x),
                     args=(torch.arange(8, dtype=torch.int32) + mesh.rank,))


@entrypoint("wrong_axis_declaration", mesh_axes=("data",), phase_coverage_min=0.0)  # expect: JXA106
def wrong_axis_declaration():
    return _reduce_case()


@entrypoint("matching_axis_declaration", mesh_axes=("p",), phase_coverage_min=0.0)
def matching_axis_declaration():
    return _reduce_case()
