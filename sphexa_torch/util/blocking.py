"""Blocked mapping over particle ranges (sphexa_tpu/util/blocking.py).

The gather backend's SPH ops materialize (block, ngmax) tiles of gathered
neighbour fields; mapping a block body over the rows keeps the transient
footprint at ``block * ngmax * n_fields * 4`` bytes instead of ``N * ...``.
A row's result does not depend on the block it falls in, so on the card
``device_block`` may take blocks far larger than the JAX package's 2048
(fewer kernel launches), sized from the memory free there.
"""

from typing import Callable

import torch

#: share of the card's free memory one block's temporaries may take
FREE_SHARE = 0.25


def blocked_map(body: Callable, n: int, block: int, device=None):
    """Run ``body(idx_block)`` over ceil(n / block) index blocks and
    concatenate the results. ``body`` receives an int64 index tensor of
    length ``block`` (tail indices clamped to n - 1, their rows dropped)
    and returns a tensor or a tuple of tensors with leading dim ``block``.
    Returns the same structure with leading dim n."""
    outs = []
    for b0 in range(0, n, block):
        idx = torch.arange(b0, b0 + block, device=device).clamp_max(n - 1)
        outs.append(body(idx))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:n] for parts in zip(*outs))
    return torch.cat(outs)[:n]


def free_bytes(device: torch.device) -> int:
    """Bytes the caching allocator could hand out on a CUDA device: the
    CUDA driver's free memory plus the allocator's reserved but unused blocks."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def device_sharers(device: torch.device) -> int:
    """Processes whose blocks share ``device``'s free memory: the ranks of
    a gloo process group on a CUDA device (parallel/mesh.py puts every
    gloo rank on the current card), else 1."""
    import torch.distributed as dist

    if device.type == "cuda" and dist.is_available() and dist.is_initialized() \
            and dist.get_backend() == "gloo":
        return dist.get_world_size()
    return 1


def device_block(block: int, row_bytes: int, device: torch.device,
                 share: float = FREE_SHARE) -> int:
    """Rows a block takes on ``device``: ``block`` on the CPU; on a CUDA
    device the largest power of two of rows whose ``row_bytes`` each fit
    ``share`` of the free memory over the processes that share the card
    (``device_sharers``: each takes its part of what is free at the
    moment it asks, so that ranks asking at different moments cannot
    together take more than the share), never below ``block``. The
    results of a blocked op do not depend on it."""
    if device.type != "cuda":
        return block
    share = share / device_sharers(device)
    rows = max(1, int(share * free_bytes(device)) // max(1, row_bytes))
    return max(block, 1 << (rows.bit_length() - 1))
