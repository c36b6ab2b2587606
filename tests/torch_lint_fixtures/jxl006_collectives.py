"""JXL006 fixture: collectives outside parallel/mesh.py vs. queries."""

import torch.distributed as dist
from torch.distributed import all_reduce


def bad(t, group):
    dist.all_reduce(t, group=group)          # expect: JXL006
    dist.all_gather([t, t], t)               # expect: JXL006
    all_reduce(t)                            # expect: JXL006
    dist.barrier()                           # expect: JXL006
    dist.all_to_all_single(t, t)             # expect: JXL006
    ops = [dist.P2POp(dist.isend, t, 1)]
    dist.batch_isend_irecv(ops)              # expect: JXL006
    dist.broadcast(t, src=0)                 # expect: JXL006


def ok_queries():
    if not dist.is_initialized():            # ok: a query
        return 0
    return dist.get_rank() + dist.get_world_size() + len(dist.get_backend())
