"""JXA401 fixtures of the collectives: a float all_reduce sum (the
backend picks the order of the ranks' terms) vs the mesh's proven order,
an all_gather and the sum in rank order (``reduce_scalars``)."""

import torch
import torch.distributed as dist

from sphexa_torch.devtools.audit.core import EntryCase, audit_mesh, entrypoint
from sphexa_torch.parallel.mesh import reduce_scalars


def _float_all_reduce(x):
    s = x.sum().reshape(1)
    dist.all_reduce(s)
    return s


def _x():
    mesh = audit_mesh()
    return mesh, torch.linspace(0.0, 1.0, 64) * (mesh.rank + 1)


@entrypoint("float_all_reduce", mesh_axes=("p",), phase_coverage_min=0.0)  # expect: JXA401
def float_all_reduce():
    _, x = _x()
    return EntryCase(fn=_float_all_reduce, args=(x,))


@entrypoint("rank_order_sum", mesh_axes=("p",), phase_coverage_min=0.0)
def rank_order_sum():
    mesh, x = _x()
    return EntryCase(fn=lambda x: reduce_scalars(mesh, sums=[x.sum()])[0][0], args=(x,))
