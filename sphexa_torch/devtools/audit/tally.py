"""The port's counterpart of the JAX cost model's jaxpr walk: run a step
once under a tally.

``tallying(device)`` installs a ``TorchDispatchMode`` that charges every
aten op the code under it dispatches, below autograd (a backward's ops
too), to the innermost ``sphexa/<phase>`` scope open at that moment
(util/phases.py pushes its phases onto the tally's stack while one runs),
or to ``unattributed``. FLOPs come from costmodel.py's per-op rules; the
memory traffic is charged twice, the upper bound every operand and result
of every op, the lower bound each tensor once per phase, keyed by the
tensor (a view is a tensor of its own) and its version counter (an
in-place write makes a new value).

What is charged nothing:

- views, ``empty`` allocations and metadata ops (``detach``, ``item``
  reads, pinning);
- copies between devices (a pinned host buffer moved to the card, a read
  back): the tally counts device work, and a CPU tally of the same code
  sees no such copy;
- on the card, any op that touches no CUDA tensor: host-side CPU tensors
  are not device work (a CPU tally charges every op, so a step that did
  tensor work on the host would tally more on the CPU than on the card:
  chip_smoke's ``cost_path`` holds the registry's entries equal);
- the ops inside a kernel's dispatch (``kernels/costs.charging()``): the
  kernel launches through ctypes, which the dispatcher never sees, and
  its charge is its rule, given by the dispatch site after it
  (``Tally.charge_kernel``); the ops suppressed there are the plain
  version's on the CPU and the wrapper's on the card (its ``empty``
  outputs, K12's block order), so that both devices charge the same
  numbers.

Outside a tally the step's code pays three flag reads a scope and two a
kernel dispatch: nothing the card sees.
"""

import contextlib
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from sphexa_torch.devtools.audit.costmodel import _Acc, op_flops, op_name
from sphexa_torch.util import phases

__all__ = ["Tally", "tallying", "FREE_OPS", "COPY_OPS"]

#: metadata ops, allocations and host reads: charged nothing
FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "is_nonzero", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "set", "resize", "_resize_output", "resize_as", "record_stream", "_pin_memory",
    "is_pinned", "_assert_async", "_assert_scalar", "_assert_tensor_metadata",
    "_has_compatible_shallow_copy_type", "_version", "_nested_tensor_size",
})

#: the ops that move data; between two devices they are charged nothing
COPY_OPS = frozenset({"_to_copy", "copy", "_copy_from", "_copy_from_and_resize", "to"})

_FREE_CACHE: Dict[object, bool] = {}


def _is_free(func) -> bool:
    free = _FREE_CACHE.get(func)
    if free is None:
        free = _FREE_CACHE[func] = op_name(func) in FREE_OPS or bool(func.is_view)
    return free


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _version(t: torch.Tensor) -> int:
    try:
        return t._version
    except RuntimeError:  # an inference tensor keeps no version counter
        return 0


class Tally:
    """One tallied run: per-phase costs (``acc``, costmodel ``_Acc``), the
    open phases (``stack``), the kernel charges by ``LAUNCHES`` key
    (``kernels``), and per (phase, op) the ops charged, their FLOPs and
    upper-bound bytes (``ops``, for the comparison of two tallies).
    ``device``: "cuda" charges only ops that touch a CUDA tensor, "cpu"
    every op."""

    def __init__(self, device: str = "cpu"):
        self.device = torch.device(device).type
        self.acc = _Acc()
        self.stack = []
        self.suppress = 0
        self.kernels: Counter = Counter()
        #: every kernel charge: (phase, name, ops, bytes, its counts)
        self.kernel_log: list = []
        self.ops: Dict[Tuple[str, str], list] = {}
        #: the neighbour pairs of the step's last counting op (density),
        #: which the later pair ops of the step share (pair_engine.charge_pair)
        self.nb_pairs: Optional[int] = None
        self._ids = WeakIdKeyDictionary()
        self._next_id = 0

    @property
    def phase(self) -> str:
        return self.stack[-1] if self.stack else ""

    @contextlib.contextmanager
    def suppressed(self):
        """Charge nothing inside (a kernel's dispatch, its counts)."""
        self.suppress += 1
        try:
            yield self
        finally:
            self.suppress -= 1

    def _key(self, t: torch.Tensor, version: int):
        ident = self._ids.get(t)
        if ident is None:
            ident = self._ids[t] = self._next_id
            self._next_id += 1
        return ident, version

    def _note(self, phase: str, name: str, flops: float, nbytes: float) -> None:
        row = self.ops.get((phase, name))
        if row is None:
            row = self.ops[(phase, name)] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def charge_op(self, func, args, ins, in_keys, out) -> None:
        outs = [a for a in tree_leaves(out) if isinstance(a, torch.Tensor)]
        tensors = ins + outs
        devices = {a.device.type for a in tensors}
        if self.device not in devices:
            return
        name = op_name(func)
        if len(devices) > 1 and name in COPY_OPS:
            return
        flops = op_flops(func, ins, outs, args)
        dt = outs[0].dtype if outs else (ins[0].dtype if ins else torch.float32)
        io = list(zip(in_keys, (a.numel() * a.element_size() for a in ins)))
        io += [(self._key(a, _version(a)), a.numel() * a.element_size()) for a in outs]
        phase = self.phase
        self.acc.add(phase, flops, _dtype_name(dt), io)
        self._note(phase, name, flops, sum(nb for _, nb in io))

    def charge_kernel(self, name: str, ops: float, nbytes: float,
                      dtype: str = "float32", counts=None) -> None:
        """Charge one kernel launch to the phase open now: ``ops``
        operations of ``dtype``, ``nbytes`` of traffic in both bounds
        (``counts``: the data-dependent counts they came from, logged)."""
        phase = self.phase
        self.acc.add_fused(phase, float(ops), dtype, float(nbytes))
        self.kernels[name] += 1
        self.kernel_log.append((phase, name, float(ops), float(nbytes), counts))
        self._note(phase, f"kernel:{name}", float(ops), float(nbytes))


class _TallyMode(TorchDispatchMode):
    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        t = self.tally
        if t.suppress or _is_free(func):
            return func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        # the operands' versions before an in-place op bumps them
        in_keys = [t._key(a, _version(a)) for a in ins]
        out = func(*args, **kwargs)
        t.charge_op(func, args, ins, in_keys, out)
        return out


@contextlib.contextmanager
def tallying(device: str = "cpu"):
    """Tally the enclosed code (yields the ``Tally``): every aten op it
    dispatches on ``device``, by phase, and every kernel charge."""
    t = Tally(device)
    if phases.active_tally() is not None:
        raise RuntimeError("a cost tally is already running")
    phases.set_tally(t)
    try:
        with _TallyMode(t):
            yield t
    finally:
        phases.set_tally(None)
