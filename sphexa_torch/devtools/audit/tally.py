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

The record. Beside the charges a tally keeps one ordered log of the run,
``Tally.rows``, that the trace rules, the lowering lock and statecheck
read (the counterpart of the JAX audit's jaxpr): a row for every op the
tally charges, under the same two card rules and the same suppression
(so the card's log equals the CPU's), one ``kernel:<name>`` token a
kernel launch, and a row for every host boundary a ``TorchFunctionMode``
sees on either device (``item``, ``tolist``, ``numpy``, ``cpu``,
``to(<cpu>)``, ``__bool__`` / ``__int__`` / ``__float__`` / ``__index__``,
and ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` of host data: the
dispatcher sees none of these on the CPU). A row holds its phase and one
canonical line: the op, its operands and results by dtype, shape and a
first-seen tensor number (the run's dataflow, alpha-renamed), and whether
any of them is a view of a tensor the record knows (an argument, or a
row's operand: a plain version's outputs may be views where the kernel's
are not). Float scalars enter as their type only (they are
read from the device, and the two devices round them apart); integers,
which are sizes, enter as values. Rows that a rule reads carry a ``site``
(``file:line`` of the innermost frame outside the modes, the frame
``torch.cuda.set_sync_debug_mode`` names on the card) and a ``flag``:

- ``sync``: a host read of the device: the host boundaries above on a
  tensor the run did not already hold on the host, a ``torch.tensor`` /
  ``as_tensor`` of host data onto the entry's device, and the ops whose
  result size depends on the data (``nonzero``, boolean-mask indexing,
  ``masked_select``, ``unique``, ``bincount``, ``repeat_interleave``
  without ``output_size``);
- ``accumulate``: a float ``index_add`` / ``index_put(accumulate=True)``
  / ``scatter_add`` / ``scatter_reduce`` / ``put(accumulate=True)`` /
  ``index_reduce`` / weighted ``bincount`` whose sum depends on the
  order of its updates, with whether its indices repeat in this run
  (checked under the suppression);
- ``f64``: a float64 or complex128 result.

It also keeps the bytes that JXA105 budgets: host data made into tensors,
and device tensors the run read that neither its arguments hold nor one
of its ops made (keyed by storage).

Collectives. Every collective of parallel/mesh.py is one ``c10d::<op>``
row (``Tally.collective``, entered through ``kernels/costs.collective``):
its logical operand and result (the staging copies through pinned host
buffers of gloo ranks that share a card, the c10d dispatch itself and
the gather's stack are suppressed inside it, so the card's row equals
the CPU's), the mesh group (``p``, the port's one axis) and its size, and
a site outside parallel/mesh.py; the P - 1 rounds of ``exchange_rounds``
are one ``send`` and one ``recv`` row each, with their peers. A c10d op
dispatched outside those wrappers (a ``torch.distributed`` call made
directly) is a row of its own, its group read off the process group it
names. Each row has its ``Collective`` in ``Tally.collectives``, the
record JXA106 and JXA201-203 read; they are charged as link bytes.

Liveness. Each named tensor belongs to a buffer (itself, or the base a
view shares), whose element count and item size the tally keeps
(``buf_numel``, ``buf_itemsize``, ``tensor_buf``), with the buffers of
the run's arguments (``arg_bufs``) and outputs (``out_bufs``, after
``finish``); a kernel's outputs are born at its ``kernel:<name>`` token
(``births``). spmd.py sweeps the rows over these. A Tally pickles without
its weak maps (a rank's record crosses the process boundary).
"""

import contextlib
import dataclasses
import hashlib
import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from sphexa_torch.devtools.audit.costmodel import _Acc, op_flops, op_name
from sphexa_torch.util import phases

__all__ = ["Tally", "Row", "Collective", "tallying", "FREE_OPS", "COPY_OPS",
           "UNATTRIBUTED", "SYNC_OPS", "ACCUMULATE_OPS", "C10D_OPS"]

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

#: the phase key of rows outside every ``sphexa/<phase>`` scope (the JAX
#: lowering lock's)
UNATTRIBUTED = "(unattributed)"

#: aten ops that read the device on the host: a scalar read, or a result
#: whose size depends on the data (sized by a read of the card)
SYNC_OPS = {
    "_local_scalar_dense": "item", "is_nonzero": "item", "equal": "item",
    "allclose": "item", "nonzero": "data-dependent size",
    "masked_select": "data-dependent size",
    "unique": "data-dependent size", "_unique": "data-dependent size",
    "_unique2": "data-dependent size", "unique_dim": "data-dependent size",
    "unique_consecutive": "data-dependent size", "bincount": "data-dependent size",
}

#: aten accumulates whose float sum depends on the order of the updates
#: (the card adds them with atomics)
ACCUMULATE_OPS = frozenset({"index_add", "scatter_add", "scatter_reduce", "index_reduce",
                            "index_put", "put", "bincount"})
#: the reductions of scatter_reduce / index_reduce that depend on order
_ORDERED_REDUCE = frozenset({"sum", "mean", "prod"})

#: host boundaries the function mode records (the dispatcher never sees
#: them on the CPU)
_HOST_METHODS = frozenset({"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                           "__float__", "__index__"})
_FACTORIES = frozenset({"tensor", "as_tensor", "from_numpy"})
_HOST_CALLS = _HOST_METHODS | _FACTORIES | {"to"}

_F64 = (torch.float64, torch.complex128)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
#: torch's own frames between a call and the modes: skipped when naming a site
_MODE_FRAMES = tuple(os.path.join(_TORCH_DIR, p) for p in (
    "_dynamo", "_compile.py", "overrides.py", os.path.join("utils", "_python_dispatch.py")))

#: the frames of the mesh's collective wrappers: a collective's site is
#: the caller's line
_MESH_FILE = os.path.join(_REPO, "sphexa_torch", "parallel", "mesh.py")

#: c10d ops by the collective they are (a direct ``torch.distributed`` call)
C10D_OPS = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather", "alltoall_base_": "all_to_all",
    "alltoall_": "all_to_all", "broadcast_": "broadcast", "reduce_": "reduce",
    "reduce_scatter_": "reduce_scatter", "_reduce_scatter_base_": "reduce_scatter",
    "gather_": "gather", "scatter_": "scatter", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier", "monitored_barrier_": "barrier",
}

#: c10d's ReduceOp kinds by their number (``RedOpType``)
_REDUCE_OPS = {0: "sum", 1: "avg", 2: "product", 3: "min", 4: "max", 5: "band", 6: "bor",
               7: "bxor", 8: "premul_sum"}

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


def _site(skip: Tuple[str, ...] = (), skip_dirs: Tuple[str, ...] = ()) -> Tuple[str, str]:
    """(site, origin) of the call being recorded: ``site`` the
    repository-relative ``file:line`` of the innermost frame outside the
    tally, torch's mode machinery, the files ``skip`` and the directories
    ``skip_dirs`` (the frame a warning raised by the op names), ``origin`` the ``file:function`` of
    the innermost function of the repository (where dtypes.py declares a
    site; a generator expression counts as the function it is in)."""
    here = os.path.abspath(__file__)
    f = sys._getframe(1)
    site = origin = None
    while f is not None and origin is None:
        fn = f.f_code.co_filename
        if fn != here and fn not in skip and not fn.startswith(_MODE_FRAMES + skip_dirs):
            rel = os.path.relpath(fn, _REPO)
            if site is None:
                site = f"{rel}:{f.f_lineno}"
            # a generator expression's frame is its function's
            if not rel.startswith("..") and f.f_code.co_name != "<genexpr>":
                origin = f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return site or "?", origin or "?"


def _storage_key(t: torch.Tensor):
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    ptr = st.data_ptr()
    return (t.device.type, ptr) if ptr else None


@dataclasses.dataclass
class Row:
    """One entry of a run's record: its phase, its canonical line (op,
    operands, results), and for the rows a rule reads the source line of
    the call (``site``), the flag (``sync``, ``accumulate``, ``f64``), its
    detail (the sync's reason, the dtype, the op) and, for an accumulate,
    whether its indices repeat."""

    phase: str
    line: str
    site: str = ""
    origin: str = ""
    flag: str = ""
    detail: str = ""
    repeats: bool = False

    @property
    def op(self) -> str:
        return self.line.split("(", 1)[0]

    @property
    def text(self) -> str:
        return f"{self.phase}|{self.line}"


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a rank's run: its row in ``Tally.rows``, the
    collective (``all_gather``, ``all_reduce``, ``all_to_all``, ``send``,
    ``recv``, ...), the group (``p``: the mesh's; else the process group's
    name) and its size, the operand's dtype and shape, the bytes it moves
    on this rank (what arrives; for a send what leaves), the peer of a
    send or receive, the reduction of a reduce (``sum``, ``max``, ...),
    and the call's site."""

    row: int
    op: str
    group: str
    size: int
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    peer: Optional[int] = None
    reduce: str = ""
    site: str = ""


class Tally:
    """One tallied run: per-phase costs (``acc``, costmodel ``_Acc``), the
    open phases (``stack``), the kernel charges by ``LAUNCHES`` key
    (``kernels``), and per (phase, op) the ops charged, their FLOPs and
    upper-bound bytes (``ops``, for the comparison of two tallies); the
    ordered record (``rows``) and the bytes JXA105 budgets
    (``host_data``, ``captured``). ``device``: "cuda" charges only ops
    that touch a CUDA tensor, "cpu" every op."""

    def __init__(self, device: str = "cpu", args=()):
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
        self.rows: List[Row] = []
        self._names = WeakIdKeyDictionary()
        self._next_name = 0
        #: tensors the run holds on the host (a ``cpu()`` result, host data)
        self._host = WeakIdKeyDictionary()
        #: host data made into tensors: (site, dtype, shape, bytes)
        self.host_data: List[Tuple[str, str, tuple, int]] = []
        #: device storages read that the run neither got nor made:
        #: (site, dtype, shape, bytes), in order of first read
        self.captured: List[Tuple[str, str, tuple, int]] = []
        self._known = set()
        for a in _tensor_leaves(args):
            key = _storage_key(a)
            if key is not None:
                self._known.add(key)
        self._arg_keys = frozenset(self._known)
        self.host_call = 0
        #: the collectives of the run, in order (their rows are ``c10d::`` rows)
        self.collectives: List[Collective] = []
        #: the buffers of the liveness sweep: element count and item size of
        #: each, each named tensor's buffer (by its number), the kernel
        #: outputs' births (tensor number -> row of the launch's token)
        self.buf_numel: List[int] = []
        self.buf_itemsize: List[int] = []
        self.tensor_buf: List[int] = []
        self.births: Dict[int, int] = {}
        self._bufs = WeakIdKeyDictionary()
        self._born = WeakIdKeyDictionary()
        self.arg_bufs = frozenset(self._buf(a) for a in _tensor_leaves(args))
        self.out_bufs: frozenset = frozenset()

    _TRANSIENT = ("_ids", "_names", "_host", "_bufs", "_born", "_known", "_arg_keys")

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k not in self._TRANSIENT}

    def finish(self, out) -> None:
        """Note the run's outputs (live to its end)."""
        self.out_bufs = frozenset(self._buf(a) for a in _tensor_leaves(out))

    def _buf(self, t: torch.Tensor) -> int:
        """The buffer of ``t``: its base's if it is a view, else its own."""
        base = t._base if t._is_view() and t._base is not None else t
        b = self._bufs.get(base)
        if b is None:
            b = self._bufs[base] = len(self.buf_numel)
            self.buf_numel.append(base.numel())
            self.buf_itemsize.append(base.element_size())
        return b

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

    # -- the record --------------------------------------------------------

    def _name(self, t: torch.Tensor) -> str:
        """The tensor's number in order of first sight (never reused: a
        freed tensor's number does not pass to the next, which the two
        devices free at different moments)."""
        n = self._names.get(t)
        if n is None:
            idx = self._next_name
            n = self._names[t] = f"t{idx}"
            self._next_name += 1
            self.tensor_buf.append(self._buf(t))
            born = self._born.get(t)
            if born is not None:
                self.births[idx] = born
        return n

    def _operand(self, a) -> str:
        if isinstance(a, torch.Tensor):
            return f"{self._name(a)}:{_dtype_name(a.dtype)}{list(a.shape)}"
        if isinstance(a, bool) or a is None or isinstance(a, int):
            return repr(a)
        if isinstance(a, float):
            return "f"
        if isinstance(a, torch.device):
            return "dev"
        return str(a).replace("torch.", "")

    def _view(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is a view of a tensor the record knows (an argument's
        storage, or a tensor a row has named): a view made inside a kernel's
        dispatch (the plain version's, not the kernel's) is not one."""
        if not t._is_view():
            return False
        base = t._base
        return base in self._names or _storage_key(base) in self._arg_keys

    def made(self, out) -> None:
        """Note the storages an op produced (JXA105's "made in the run")."""
        for a in _tensor_leaves(out):
            key = _storage_key(a)
            if key is not None:
                self._known.add(key)

    def _read(self, ins, site_fn) -> None:
        for a in ins:
            key = _storage_key(a)
            if key is None or key in self._known:
                continue
            self._known.add(key)
            if a.device.type == self.device:
                st = a.untyped_storage()
                self.captured.append((site_fn(), _dtype_name(a.dtype), tuple(a.shape),
                                      st.nbytes()))

    def record_op(self, func, args, kwargs, ins, outs) -> Row:
        phase = self.phase or UNATTRIBUTED
        name = f"{op_name(func)}.{func._overloadname}"
        if func.namespace != "aten":
            name = f"{func.namespace}::{name}"
        operands = ",".join(self._operand(a) for a in tree_leaves((args, kwargs)))
        results = ",".join(self._operand(a) for a in outs)
        view = any(self._view(a) for a in ins + outs)
        row = Row(phase, f"{name}({operands})->({results}){' view' if view else ''}")
        where = None

        def site_fn():
            nonlocal where
            if where is None:
                where = _site()
            return where[0]

        self._read(ins, site_fn)
        base = op_name(func)
        reason = SYNC_OPS.get(base)
        if reason is None and base == "index" and _bool_index(args):
            reason = "boolean-mask index"
        if reason is None and base == "index_put" and _bool_index(args):
            reason = "boolean-mask index"
        if reason is None and base == "repeat_interleave" and \
                kwargs.get("output_size") is None and isinstance(args[0], torch.Tensor) \
                and (len(args) < 2 or isinstance(args[1], torch.Tensor)):
            reason = "data-dependent size"
        if reason:
            row.flag, row.detail = "sync", reason
        elif base in ACCUMULATE_OPS and _ordered_accumulate(base, args, kwargs):
            row.flag, row.detail = "accumulate", name
            with self.suppressed():
                row.repeats = _repeats(base, args)
        elif any(a.dtype in _F64 for a in outs):
            row.flag, row.detail = "f64", _dtype_name(next(a.dtype for a in outs
                                                           if a.dtype in _F64))
        if row.flag:
            row.site = site_fn()
            row.origin = where[1]
        self.rows.append(row)
        return row

    def note_host_data(self, out: torch.Tensor) -> None:
        """JXA105's "host data made into a tensor": ``out``, at the site of
        the host row just recorded."""
        self.host_data.append((self.rows[-1].site, _dtype_name(out.dtype), tuple(out.shape),
                               out.numel() * out.element_size()))

    def record_host(self, name: str, detail: str, sync: bool, t=None) -> None:
        """One host boundary the function mode saw: ``name`` its call,
        ``sync`` whether it reads the device."""
        phase = self.phase or UNATTRIBUTED
        operand = self._operand(t) if isinstance(t, torch.Tensor) else ""
        site, origin = _site()
        row = Row(phase, f"host:{name}({operand})", site=site, origin=origin,
                  flag="sync" if sync else "", detail=detail)
        self.rows.append(row)

    # -- the collectives ------------------------------------------------------

    def collective(self, mesh, op: str, ins, reduce: str = "") -> "_CollectiveScope":
        """The scope of one collective wrapper of parallel/mesh.py (``op``
        on ``mesh``'s group, the logical operands ``ins``): nothing inside
        is charged; its ``done`` records the row(s)."""
        return _CollectiveScope(self, mesh, op, ins, reduce)

    def record_collective(self, op: str, group: str, size: int, ins, outs, nbytes: int,
                          peer: Optional[int] = None, reduce: str = "") -> None:
        """One collective row and its ``Collective`` (``ins``/``outs``: its
        logical operands and results, ``nbytes`` the bytes that arrive, or
        leave for a send; what arrives is charged as link bytes)."""
        phase = self.phase or UNATTRIBUTED
        operands = ",".join(self._operand(a) for a in ins)
        results = ",".join(self._operand(a) for a in outs)
        tail = "" if peer is None else f" peer={peer}"
        # the caller's line: neither the mesh's wrapper nor torch.distributed
        site = _site(skip=(_MESH_FILE,), skip_dirs=(_TORCH_DIR,))
        row = Row(phase, f"c10d::{op}[{group}/{size}]({operands})->({results}){tail}",
                  site=site[0], origin=site[1], flag="collective", detail=op)
        first = ins[0] if ins else (outs[0] if outs else None)
        self.collectives.append(Collective(
            row=len(self.rows), op=op, group=group, size=int(size),
            dtype=_dtype_name(first.dtype) if first is not None else "",
            shape=tuple(first.shape) if first is not None else (), nbytes=int(nbytes),
            peer=peer, reduce=reduce, site=site[0]))
        self.rows.append(row)
        arrives = 0.0 if op == "send" else float(nbytes)
        self.acc.add(self.phase, 0.0, "float32", [], ici=arrives)
        self._note(self.phase, f"c10d::{op}", 0.0, arrives)

    def record_c10d(self, func, args, out) -> None:
        """A c10d op dispatched outside the mesh's wrappers, as a row of its
        own: its group read off the process group among its arguments."""
        import torch.distributed as dist

        raw = func.overloadpacket.__name__
        op = C10D_OPS.get(raw, raw)
        group, size, peer, reduce = "?", 0, None, ""
        for i, a in enumerate(args):
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except RuntimeError:
                    if a._has_method("op"):  # a ReduceOp
                        reduce = _REDUCE_OPS.get(int(a.op()), "?")
                    continue
                size = pg.size()
                group = "p" if pg is dist.group.WORLD else f"group:{pg.group_name}"
                if op in ("send", "recv") and i + 1 < len(args) and \
                        isinstance(args[i + 1], int):
                    peer = int(args[i + 1])
        ts = [a for a in tree_leaves(args[0]) if isinstance(a, torch.Tensor)] if args else []
        if op == "all_gather" and len(args) > 1:
            ins = [a for a in tree_leaves(args[1]) if isinstance(a, torch.Tensor)]
            outs = ts
        elif op in ("all_to_all", "reduce_scatter") and len(args) > 1:
            ins = [a for a in tree_leaves(args[1]) if isinstance(a, torch.Tensor)]
            outs = ts
        elif op == "send":
            ins, outs = ts, []
        else:
            ins, outs = ts, ts
        nbytes = sum(a.numel() * a.element_size() for a in (ins if op == "send" else outs))
        self.record_collective(op, group, size, ins, outs, nbytes, peer, reduce)

    # -- the charges ---------------------------------------------------------

    def charge_op(self, func, args, kwargs, ins, in_keys, out) -> None:
        outs = [a for a in tree_leaves(out) if isinstance(a, torch.Tensor)]
        tensors = ins + outs
        devices = {a.device.type for a in tensors}
        if self.device not in devices:
            return
        name = op_name(func)
        if len(devices) > 1 and name in COPY_OPS:
            return
        self.record_op(func, args, kwargs, ins, outs)
        flops = op_flops(func, ins, outs, args)
        dt = outs[0].dtype if outs else (ins[0].dtype if ins else torch.float32)
        io = list(zip(in_keys, (a.numel() * a.element_size() for a in ins)))
        io += [(self._key(a, _version(a)), a.numel() * a.element_size()) for a in outs]
        phase = self.phase
        self.acc.add(phase, flops, _dtype_name(dt), io)
        self._note(phase, name, flops, sum(nb for _, nb in io))

    def charge_kernel(self, name: str, ops: float, nbytes: float,
                      dtype: str = "float32", counts=None, outs=None) -> None:
        """Charge one kernel launch to the phase open now: ``ops``
        operations of ``dtype``, ``nbytes`` of traffic in both bounds
        (``counts``: the data-dependent counts they came from, logged).
        The record gets its one ``kernel:<name>`` token, where the
        launch's outputs ``outs`` are born."""
        for a in _tensor_leaves(outs):
            self._born[a] = len(self.rows)
        phase = self.phase
        self.acc.add_fused(phase, float(ops), dtype, float(nbytes))
        self.kernels[name] += 1
        self.kernel_log.append((phase, name, float(ops), float(nbytes), counts))
        self._note(phase, f"kernel:{name}", float(ops), float(nbytes))
        self.rows.append(Row(phase or UNATTRIBUTED, f"kernel:{name}"))


def _tensor_leaves(obj, depth: int = 0) -> List[torch.Tensor]:
    """The tensors of ``obj``, looked for through tuples, lists, dicts and
    dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if depth > 6:
        return []
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    else:
        return []
    out = []
    for a in items:
        out += _tensor_leaves(a, depth + 1)
    return out


def _bool_index(args) -> bool:
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in (idx if isinstance(idx, (list, tuple)) else (idx,)))


def _ordered_accumulate(base: str, args, kwargs) -> bool:
    """Whether an accumulate op sums floats in the order of its updates."""
    if base == "bincount":
        w = args[1] if len(args) > 1 else kwargs.get("weights")
        return isinstance(w, torch.Tensor) and w.is_floating_point()
    if not args[0].is_floating_point() and not args[0].is_complex():
        return False
    if base in ("index_put", "put"):
        return bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))
    if base in ("scatter_reduce", "index_reduce"):
        return (args[4] if len(args) > 4 else kwargs.get("reduce")) in _ORDERED_REDUCE
    return True


def _repeats(base: str, args) -> bool:
    """Whether the accumulate's updates land on some element twice."""
    if base == "bincount":
        idx = args[0].reshape(-1)
    elif base == "index_put":
        ind = [i for i in args[1] if i is not None]
        ind = torch.broadcast_tensors(*ind) if ind else []
        if not ind:
            return False
        idx = torch.stack([i.reshape(-1).to(torch.int64) for i in ind], dim=1)
        return torch.unique(idx, dim=0).shape[0] < idx.shape[0]
    elif base == "put":
        idx = args[1].reshape(-1)
    elif base in ("scatter_add", "scatter_reduce"):
        dim, index = args[1], args[2]
        # the written position: the index along ``dim``, the element's own
        # coordinates along the others
        coords = torch.meshgrid(*[torch.arange(s, device=index.device)
                                  for s in index.shape], indexing="ij")
        coords = list(coords)
        coords[dim % index.dim()] = index.to(torch.int64)
        idx = torch.stack([c.reshape(-1) for c in coords], dim=1)
        return torch.unique(idx, dim=0).shape[0] < idx.shape[0]
    else:  # index_add, index_reduce: whole slices along dim
        idx = args[2].reshape(-1)
    return torch.unique(idx).numel() < idx.numel()


class _CollectiveScope:
    """``Tally.collective``'s scope: the ops inside are not charged (the
    staging copies, the c10d dispatch, a gather's stack); ``done`` records
    the collective with its logical result, ``done_p2p`` a batch of sends
    and receives."""

    def __init__(self, tally: Tally, mesh, op: str, ins, reduce: str):
        self.tally, self.mesh, self.op, self.ins, self.reduce = tally, mesh, op, ins, reduce

    def __enter__(self):
        self.tally.suppress += 1
        return self

    def __exit__(self, *exc):
        self.tally.suppress -= 1
        return False

    def done(self, out, peer: Optional[int] = None):
        outs = [a for a in _tensor_leaves(out)]
        nbytes = sum(a.numel() * a.element_size() for a in outs)
        self.tally.record_collective(self.op, self.mesh.axis, self.mesh.size, self.ins, outs,
                                     nbytes, peer, self.reduce)
        return out

    def done_p2p(self, sends, recvs):
        """``sends`` and ``recvs``: (peer, tensor) pairs, in the order the
        batch issues them (send then receive, a round at a time)."""
        m = self.mesh
        for (dst, s), (src, r) in zip(sends, recvs):
            self.tally.record_collective("send", m.axis, m.size, [s], [],
                                         s.numel() * s.element_size(), dst)
            self.tally.record_collective("recv", m.axis, m.size, [], [r],
                                         r.numel() * r.element_size(), src)
        return [r for _, r in recvs]


class _TallyMode(TorchDispatchMode):
    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        t = self.tally
        if t.suppress or t.host_call:
            out = func(*args, **kwargs)
            t.made(out)
            return out
        if func.namespace == "c10d":
            out = func(*args, **kwargs)
            t.record_c10d(func, args, out)
            return out
        if _is_free(func):
            out = func(*args, **kwargs)
            t.made(out)
            name = op_name(func)
            if name in ("_local_scalar_dense", "is_nonzero"):
                ins = [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
                if ins and ins[0].device.type == t.device:
                    t.record_op(func, args, kwargs, ins, [])
            return out
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        # the operands' versions before an in-place op bumps them
        in_keys = [t._key(a, _version(a)) for a in ins]
        out = func(*args, **kwargs)
        t.charge_op(func, args, kwargs, ins, in_keys, out)
        t.made(out)
        return out


def _to_target(args, kwargs):
    """(device, non_blocking) of a ``Tensor.to`` call."""
    try:
        device, _dtype, non_blocking, _fmt = torch._C._nn._parse_to(*args[1:], **kwargs)
    except (TypeError, RuntimeError):
        return None, False
    return device, bool(non_blocking)


class _HostMode(TorchFunctionMode):
    """The host boundaries (``Tally.record_host``), on either device."""

    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        t = self.tally
        name = getattr(func, "__name__", "")
        if t.suppress or t.host_call or name not in _HOST_CALLS:
            return func(*args, **kwargs)
        row = self._classify(name, args, kwargs)
        if row is None:
            return func(*args, **kwargs)
        label, detail, sync, operand = row
        t.record_host(label, detail, sync, operand)
        t.host_call += 1
        try:
            out = func(*args, **kwargs)
        finally:
            t.host_call -= 1
        t.made(out)
        if isinstance(out, torch.Tensor):
            if detail in ("d2h", "host data"):
                t._host[out] = True
            if name in _FACTORIES:
                t.note_host_data(out)
        return out

    def _classify(self, name, args, kwargs):
        """(label, detail, sync, tensor) of a host boundary, or None: a
        cast, a copy on the device, a factory given a tensor already there,
        a read of a tensor the run already holds on the host."""
        t = self.tally
        if name in _FACTORIES:
            data = args[0] if args else kwargs.get("data")
            dev = kwargs.get("device")
            onto = dev is not None and torch.device(dev).type == t.device
            if isinstance(data, torch.Tensor):
                held = bool(t._host.get(data))
                return (name, "host data onto the device", True, data) if held and onto \
                    else None
            return (name, "host data onto the device", True, None) if onto \
                else (name, "host data", False, None)
        src = args[0] if args else None
        if not isinstance(src, torch.Tensor):
            return None
        held = bool(t._host.get(src))
        if name == "to":
            device, non_blocking = _to_target(args, kwargs)
            if device is None:
                return None
            if device.type == "cpu":
                return None if held else ("to(cpu)", "d2h", not non_blocking, src)
            if held and device.type == t.device:
                return "to(device)", "host data onto the device", not non_blocking, src
            return None
        if name == "cpu":
            return None if held else ("cpu", "d2h", True, src)
        if name == "numpy":
            return "numpy", "d2h", not held, src
        return name, name, not held, src


def _from_numpy(tally: Tally, orig):
    """``torch.from_numpy``, which no mode sees, recorded as host data."""
    def from_numpy(a):
        out = orig(a)
        if not tally.suppress and not tally.host_call:
            tally.record_host("from_numpy", "host data", False)
            tally._host[out] = True
            tally.note_host_data(out)
        return out

    return from_numpy


@contextlib.contextmanager
def tallying(device: str = "cpu", args=(), x64: bool = False):
    """Tally the enclosed code (yields the ``Tally``): every aten op it
    dispatches on ``device``, by phase, every kernel charge and the
    record. ``args``: the run's arguments (their storages are not
    "captured"); ``x64``: run with float64 as torch's default dtype."""
    t = Tally(device, args)
    if phases.active_tally() is not None:
        raise RuntimeError("a cost tally is already running")
    phases.set_tally(t)
    orig = torch.from_numpy
    default = torch.get_default_dtype()
    torch.from_numpy = _from_numpy(t, orig)
    if x64:
        torch.set_default_dtype(torch.float64)
    try:
        with _HostMode(t), _TallyMode(t):
            yield t
    finally:
        torch.from_numpy = orig
        torch.set_default_dtype(default)
        phases.set_tally(None)

