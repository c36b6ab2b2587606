"""The list compaction of the gravity MAC classification
(sphexa_tpu/gravity/pallas_compact.py): per row of a packed int32 array
``(cls << IDX_BITS) | value``, the class-0 and class-1 values in candidate
order, truncated at fixed caps, with the unclipped true counts.

``compact_class_lists`` launches the CUDA kernel of
csrc/gravity_compact.cu for a CUDA tensor (one block per row, tiles of
1,024 candidates read as 16-byte words, ranked by warp scans with one
barrier per tile) and runs ``compact_class_lists_plain`` for a CPU
tensor; the plain version ranks each class by a cumulative sum.

``compact_row`` is the kernel's one-row form, the block-time-step
compaction of sph/blockdt.py (the JAX package runs the TPU kernel over
one (1, n) packed row there): it reads the (n,) due mask itself and
writes the due positions, tiles of ``compact_row_tile()`` flags spread
over every SM, a count launch, then each block's offset from the counts
before its tile and an in-order scatter; ``compact_row_plain`` for a CPU
tensor."""

import torch

from sphexa_torch.kernels import costs
from sphexa_torch.sph.pair_engine import LAUNCHES

IDX_BITS = 24
IDX_MASK = (1 << IDX_BITS) - 1
# padding slots: class 2 = pruned/dead, value 0
DEAD = 2 << IDX_BITS


def _check(packed: torch.Tensor, cap0: int, cap1: int) -> None:
    if packed.dtype != torch.int32 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError(f"packed: need a contiguous 2-D int32 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if cap0 < 1 or cap1 < 1:
        raise ValueError(f"caps must be positive, got {cap0}, {cap1}")


def compact_class_lists(packed: torch.Tensor, cap0: int, cap1: int):
    """Compact each row's class-0 and class-1 slots into fixed-cap lists.
    Returns ``(list0 (B, cap0), n0 (B,), list1 (B, cap1), n1 (B,))``, all
    int32: values in candidate order, slots past a count 0, counts
    unclipped (a list whose count passes its cap keeps its first entries)."""
    _check(packed, cap0, cap1)
    dev = packed.device
    # a cost tally charges the kernel's rule (kernels/costs.py), not the ops
    with costs.charging():
        if dev.type == "cpu":
            out = compact_class_lists_plain(packed, cap0, cap1)
        elif dev.type == "cuda":
            launch, out = compact_launcher(packed, cap0, cap1)
            launch()
            LAUNCHES["compact_class_lists"] += 1
        else:
            raise ValueError(f"unsupported device {dev}")
    costs.charge_compact(packed, cap0, cap1, outs=out)
    return out


def compact_launcher(packed: torch.Tensor, cap0: int, cap1: int):
    """The kernel's arguments checked and built once for a CUDA tensor.
    Returns (launch, (list0, n0, list1, n1)): each ``launch()`` runs the
    kernel on the current stream (no sync) into those outputs and raises
    on a launch error. ``compact_class_lists`` launches it once; a timing
    loop may launch it again without the argument building."""
    from sphexa_torch.kernels.build import load_library

    _check(packed, cap0, cap1)
    dev = packed.device
    B, C = packed.shape
    list0 = torch.empty(B, cap0, dtype=torch.int32, device=dev)
    list1 = torch.empty(B, cap1, dtype=torch.int32, device=dev)
    counts = torch.empty(B, 2, dtype=torch.int32, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):
            err = lib.launch_compact_class_lists(
                packed.data_ptr(), B, C, cap0, cap1, list0.data_ptr(), list1.data_ptr(),
                counts.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch_compact_class_lists failed: CUDA error {err} "
                               f"({lib.pair_engine_error_string(err).decode()})")

    return launch, (list0, counts[:, 0], list1, counts[:, 1])


def compact_class_lists_plain(packed: torch.Tensor, cap0: int, cap1: int):
    """Plain PyTorch version on any device: a value's slot is its rank in
    its class, the cumulative count of that class before it."""
    _check(packed, cap0, cap1)
    cls = packed >> IDX_BITS
    val = packed & IDX_MASK
    out = []
    for k, cap in ((0, cap0), (1, cap1)):
        hit = cls == k
        rank = torch.cumsum(hit, dim=1) - 1
        keep = hit & (rank < cap)
        # every slot that is not kept lands in column ``cap``, cut off below
        pos = torch.where(keep, rank, cap)
        lst = torch.zeros(packed.shape[0], cap + 1, dtype=torch.int32, device=packed.device)
        lst.scatter_(1, pos, torch.where(keep, val, 0))
        out += [lst[:, :cap].contiguous(), hit.sum(dim=1, dtype=torch.int32)]
    return tuple(out)


def _check_row(due: torch.Tensor) -> None:
    if due.dtype != torch.bool or due.dim() != 1 or not due.is_contiguous() \
            or not 0 < due.shape[0] <= 1 << 30:
        raise ValueError(f"due: need a contiguous 1-D bool tensor of 1 to 2**30 rows, got "
                         f"{due.dtype} {tuple(due.shape)}")


def compact_row(due: torch.Tensor):
    """The one-row form: the positions of ``due``'s set rows in row order,
    zeros after, and their count (the one-block kernel's list0 and n0 over
    the packed row ``(0 if due else 1) << IDX_BITS | arange(n)`` with cap0
    = n, without the packing or its 2**IDX_BITS limit). Returns (idx (n,)
    int32, n_active () int32)."""
    _check_row(due)
    dev = due.device
    with costs.charging():
        if dev.type == "cpu":
            out = compact_row_plain(due)
        elif dev.type == "cuda":
            launch, out = compact_row_launcher(due)
            launch()
            LAUNCHES["compact_row"] += 1
        else:
            raise ValueError(f"unsupported device {dev}")
    costs.charge_compact_row(due.shape[0], outs=out)
    return out


def compact_row_launcher(due: torch.Tensor):
    """The one-row kernel's arguments checked and built once for a CUDA
    tensor, its tile counts' scratch sized by the library's tile. Returns
    (launch, (idx, n_active)) as ``compact_launcher``."""
    from sphexa_torch.kernels.build import load_library

    _check_row(due)
    dev = due.device
    n = due.shape[0]
    lib = load_library()
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(-(-n // lib.compact_row_tile()), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    argv = (due.data_ptr(), n, idx.data_ptr(), count.data_ptr(), scratch.data_ptr(), stream)

    def launch():
        with torch.cuda.device(dev):
            err = lib.launch_compact_row(*argv)
        if err != 0:
            raise RuntimeError(f"launch_compact_row failed: CUDA error {err} "
                               f"({lib.pair_engine_error_string(err).decode()})")

    return launch, (idx, count)


def compact_row_plain(due: torch.Tensor):
    """Plain PyTorch version of the one-row form on any device: a due
    row's slot is the count of due rows before it."""
    _check_row(due)
    n = due.shape[0]
    rank = torch.cumsum(due, dim=0) - 1
    pos = torch.where(due, rank, n)
    idx = torch.zeros(n + 1, dtype=torch.int32, device=due.device)
    idx.scatter_(0, pos, torch.arange(n, dtype=torch.int32, device=due.device))
    return idx[:n].contiguous(), due.sum(dtype=torch.int32)
