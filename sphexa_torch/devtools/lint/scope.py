"""Which functions of a module are step code, and which of their names
hold tensor-derived values: the scope model behind JXL002 (the torch
counterpart of the JAX package's lint/trace_scope.py).

torch traces nothing, so the JAX model's "jit-reachable" becomes "step
code", computed per module, syntactically:

1. roots: the functions that the audit registry's step entries run
   (devtools/audit/registry.py), by dotted path in ``STEP_ROOTS``: the
   propagator's steps and sharded stages, the gravity solve, the ledger
   and snapshot taps, the halo exchange stages, the list build, the
   distributed sort and the sharded sizing. A root's parameters are
   dynamic unless ``STATIC_PARAMS`` names them or their annotation names
   no tensor-carrying type (``TENSOR_TYPES``). A function outside the
   registry declares itself a root with ``# torchlint: step-root`` on its
   ``def`` line (``ROOT_MARK``).
2. propagation: a plain-name call in step code makes the same-module
   function of that name step code, and maps the call's arguments onto
   its parameters: a parameter is dynamic only where some call site feeds
   it a tensor-derived value. Functions nested in step code are step code
   and see their enclosing function's dynamic names.
3. inside a function, a name is dynamic when an assignment, a loop or a
   comprehension binds it to a dynamic expression (flow-insensitive, to a
   fixed point; a comprehension's names are its own). A parameter annotated
   with a type that carries no tensor (``bool``, a config class) is never
   dynamic. An expression is dynamic when it reads a dynamic name,
   calls a ``torch`` function that makes a tensor, or calls anything on a
   dynamic argument; shapes and sizes (``t.shape[0]``, ``t.numel()``,
   ``len``), dtypes and devices stay static, and so does the result of a
   host read (``.item()``, ``.tolist()``, ``int(t)``): it is a host value.

Cross-module reach is out of scope, as in the JAX model: each module is
analyzed against its own roots, which is why ``STEP_ROOTS`` names the
entry functions of every module that the step entries run into. The model
errs toward under-reporting; the fixtures pin the contract, and
tests/test_torch_lint.py holds it against the audit's runtime record
(JXA104): every explicit host read the step entries make is reported.
"""

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Union

from sphexa_torch.devtools.lint.core import ModuleInfo

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

#: the functions the audit registry's entries run, by module and qualified
#: name (a method as ``Class.method``)
STEP_ROOTS = (
    # the step entries: propagator.step_sim_state over the steps
    "sphexa_torch.propagator.step_sim_state",
    "sphexa_torch.propagator._step_hydro_std",
    "sphexa_torch.propagator._step_hydro_ve",
    "sphexa_torch.propagator._step_nbody",
    "sphexa_torch.propagator._step_turb_ve",
    "sphexa_torch.propagator._step_hydro_std_cooling",
    "sphexa_torch.propagator._step_hydro_std_blockdt",
    "sphexa_torch.propagator._step_hydro_ve_blockdt",
    # the sharded stages (registry.py: halo, gravity and step entries)
    "sphexa_torch.propagator._gravity_sharded_stage",
    "sphexa_torch.propagator._std_forces_sharded",
    "sphexa_torch.propagator._ve_forces_sharded",
    "sphexa_torch.propagator._sort_by_keys_sharded",
    "sphexa_torch.propagator._shard_tail",
    "sphexa_torch.parallel.exchange.shard_halo_stage",
    "sphexa_torch.parallel.exchange.shard_halo_stage_sparse",
    "sphexa_torch.parallel.sort.distributed_sort",
    "sphexa_torch.parallel.sort.sort_slabs",
    # the list-mode entries: the rebuild and its build
    "sphexa_torch.simulation.Simulation._rebuild_lists",
    "sphexa_torch.propagator.rebuild_pair_lists",
    "sphexa_torch.sph.pair_lists.build_pair_lists",
    # gravity_solve
    "sphexa_torch.gravity.traversal.compute_gravity",
    # the observable taps, on one device and on ranks
    "sphexa_torch.observables.ledger.ledger_diagnostics",
    "sphexa_torch.observables.snapshot.snapshot_diagnostics",
    # tree_build_sizing
    "sphexa_torch.parallel.sizing.sizing_stats",
    "sphexa_torch.parallel.sizing.key_histogram",
)

#: a function whose ``def`` line carries this comment is a root as well:
#: step code outside the registry declares itself
ROOT_MARK = re.compile(r"#\s*torchlint:\s*step-root\b")

#: root parameters that carry no tensor: configs, the mesh, constants
STATIC_PARAMS = frozenset({
    "cfg", "config", "aux_cfg", "mesh", "const", "spec", "curve", "step_fn", "telemetry",
    "log", "meta", "nbr", "gcfg", "level", "group", "key_bits",
})

#: an annotated parameter may carry a tensor when a name in its annotation
#: ends in one of these (a tensor, or a container of tensors)
TENSOR_TYPES = ("Tensor", "State", "Box", "Tree", "Lists", "Ranges")

#: attributes that are static on a tensor (and a state's row count ``n``)
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                          "requires_grad", "n"})

#: methods whose result is static on a tensor (sizes, layout)
STATIC_METHODS = frozenset({"numel", "dim", "size", "element_size", "stride",
                            "is_floating_point", "is_contiguous", "data_ptr",
                            "get_device", "nelement"})

#: torch functions that make no tensor
STATIC_TORCH = frozenset({
    "torch.device", "torch.Size", "torch.finfo", "torch.iinfo", "torch.is_tensor",
    "torch.get_default_dtype", "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.get_num_threads", "torch.is_floating_point",
})

#: host reads: their result is a host value (the read itself is JXL002's)
HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_READ_CALLS = frozenset({"float", "int", "bool", "complex", "len",
                             "numpy.asarray", "numpy.array", "isinstance", "range",
                             "getattr", "hasattr", "callable", "type", "id", "repr", "str"})


def _is_torch_maker(q: Optional[str]) -> bool:
    return bool(q) and q.startswith("torch.") and q not in STATIC_TORCH \
        and not q.startswith("torch.distributed.")


def touches_dynamic(mod: ModuleInfo, expr: ast.AST, dyn: Set[str]) -> bool:
    """Does ``expr`` derive (syntactically) from a dynamic value?"""
    if isinstance(expr, ast.Name):
        return expr.id in dyn
    if isinstance(expr, ast.Attribute):
        if expr.attr in STATIC_ATTRS:
            return False
        return touches_dynamic(mod, expr.value, dyn)
    if isinstance(expr, (ast.Lambda, ast.Constant)):
        return False
    if isinstance(expr, ast.Compare) and all(isinstance(o, (ast.Is, ast.IsNot))
                                             for o in expr.ops):
        return False  # identity: ``t is None`` reads no value
    if isinstance(expr, ast.IfExp):
        return touches_dynamic(mod, expr.body, dyn) or touches_dynamic(mod, expr.orelse, dyn)
    if isinstance(expr, ast.Call):
        q = mod.qualname(expr.func)
        if q in HOST_READ_CALLS or q in STATIC_TORCH:
            return False
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in HOST_READ_METHODS or expr.func.attr in STATIC_METHODS:
                return False
        if _is_torch_maker(q):
            return True
        args = list(expr.args) + [kw.value for kw in expr.keywords]
        if isinstance(expr.func, ast.Attribute):
            args.append(expr.func.value)  # a method of a tensor makes a tensor
        return any(touches_dynamic(mod, a, dyn) for a in args)
    return any(touches_dynamic(mod, c, dyn) for c in ast.iter_child_nodes(expr))


def _target_names(target: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


@dataclasses.dataclass
class StepFunction:
    node: FunctionNode
    name: str                      # qualified within the module ("<lambda>")
    dynamic: Set[str]              # parameters that carry tensors
    via: str                       # how it became step code (for messages)
    local: Set[str] = dataclasses.field(default_factory=set)  # dynamic locals


def _param_names(fn: FunctionNode) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _params(fn: FunctionNode) -> List[ast.arg]:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs + [p for p in (a.vararg, a.kwarg) if p]


def _tensor_annotation(ann: ast.AST) -> bool:
    return any((isinstance(n, ast.Name) and n.id.endswith(TENSOR_TYPES))
               or (isinstance(n, ast.Attribute) and n.attr.endswith(TENSOR_TYPES))
               or (isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and n.value.endswith(TENSOR_TYPES))
               for n in ast.walk(ann))


def _static_params(fn: FunctionNode) -> Set[str]:
    """Parameters annotated with a type that carries no tensor."""
    return {p.arg for p in _params(fn)
            if p.annotation is not None and not _tensor_annotation(p.annotation)}


def _root_dynamic(fn: FunctionNode) -> Set[str]:
    """A root's dynamic parameters: those annotated with a tensor-carrying
    type, and the unannotated ones not in ``STATIC_PARAMS``."""
    return {p.arg for p in _params(fn)
            if (p.annotation is None and p.arg not in STATIC_PARAMS)
            or (p.annotation is not None and _tensor_annotation(p.annotation))}


class StepScopes:
    """The step functions of one module. Query with ``owner``."""

    def __init__(self, mod: ModuleInfo, roots=STEP_ROOTS):
        self.mod = mod
        self.steps: Dict[FunctionNode, StepFunction] = {}
        self._by_name: Dict[str, List[FunctionNode]] = {}
        self._qual: Dict[FunctionNode, str] = {}
        self._parent: Dict[FunctionNode, Optional[FunctionNode]] = {}
        self._collect(mod.tree, None, "")
        prefix = mod.name + "."
        for fn, q in self._qual.items():
            if prefix + q in roots or self._declared_root(fn):
                self._mark(fn, "a step root", _root_dynamic(fn))
        self._propagate()

    def _declared_root(self, fn: FunctionNode) -> bool:
        """A ``def`` line that carries ``ROOT_MARK``."""
        if isinstance(fn, ast.Lambda) or fn.lineno > len(self.mod.lines):
            return False
        return bool(ROOT_MARK.search(self.mod.lines[fn.lineno - 1]))

    def _collect(self, node: ast.AST, parent: Optional[FunctionNode], prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                name = getattr(child, "name", "<lambda>")
                self._parent[child] = parent
                self._qual[child] = prefix + name
                if name != "<lambda>":
                    self._by_name.setdefault(name, []).append(child)
                self._collect(child, child, prefix + name + ".")
            elif isinstance(child, ast.ClassDef):
                self._collect(child, parent, prefix + child.name + ".")
            else:
                self._collect(child, parent, prefix)

    def _mark(self, fn: FunctionNode, via: str, dynamic: Set[str]) -> bool:
        dynamic = dynamic - _static_params(fn)
        sf = self.steps.get(fn)
        if sf is None:
            self.steps[fn] = StepFunction(fn, self._qual[fn], set(dynamic), via)
            return True
        if not dynamic <= sf.dynamic:
            sf.dynamic |= dynamic
            return True
        return False

    def env(self, fn: FunctionNode) -> Set[str]:
        """The dynamic names visible in ``fn``: its own and those of the
        step functions it is nested in."""
        dyn: Set[str] = set()
        cur: Optional[FunctionNode] = fn
        while cur is not None:
            sf = self.steps.get(cur)
            if sf is not None:
                dyn |= sf.dynamic | sf.local
            cur = self._parent.get(cur)
        return dyn

    def _own_nodes(self, fn: FunctionNode):
        """The nodes of ``fn``'s body, not those of functions nested in it."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    def _locals(self, fn: FunctionNode) -> None:
        """The dynamic locals of ``fn``, to a fixed point."""
        sf = self.steps[fn]
        while True:
            dyn = self.env(fn)
            new: Set[str] = set()
            for node in self._own_nodes(fn):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)) \
                        and node.value is not None:
                    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                    if touches_dynamic(self.mod, node.value, dyn):
                        for t in targets:
                            new.update(_target_names(t))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    if touches_dynamic(self.mod, node.iter, dyn):
                        new.update(_target_names(node.target))
                elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                    if touches_dynamic(self.mod, node.context_expr, dyn):
                        new.update(_target_names(node.optional_vars))
                elif isinstance(node, ast.NamedExpr):
                    if touches_dynamic(self.mod, node.value, dyn):
                        new.add(node.target.id)
            if new <= sf.local:
                return
            sf.local |= new

    def _site_dynamic(self, call: ast.Call, callee: FunctionNode, dyn: Set[str]) -> Set[str]:
        """The callee's parameters that this call site feeds a dynamic
        value. Positions before a ``*`` splat and keywords map exactly; a
        dynamic ``*`` splat (or a dynamic argument after it) reaches every
        position from the splat on, a dynamic ``**`` splat every parameter
        that no explicit argument binds."""
        a = callee.args
        positional = [p.arg for p in a.posonlyargs + a.args]
        names = _param_names(callee)

        def dynamic(v):
            return touches_dynamic(self.mod, v, dyn)

        out: Set[str] = set()
        bound: Set[str] = set()
        star = next((i for i, x in enumerate(call.args) if isinstance(x, ast.Starred)), None)
        for i, arg in enumerate(call.args[:star]):
            name = positional[i] if i < len(positional) else (a.vararg.arg if a.vararg else None)
            bound.add(name)
            if name and dynamic(arg):
                out.add(name)
        if star is not None and any(dynamic(x.value if isinstance(x, ast.Starred) else x)
                                    for x in call.args[star:]):
            out.update(positional[star:])
            if a.vararg:
                out.add(a.vararg.arg)
        for kw in call.keywords:
            if kw.arg is not None:
                bound.add(kw.arg)
                if dynamic(kw.value):
                    out.add(kw.arg if kw.arg in names else (a.kwarg.arg if a.kwarg else kw.arg))
        if any(kw.arg is None and dynamic(kw.value) for kw in call.keywords):
            out.update(n for n in names if n not in bound)
        return out

    def _propagate(self) -> None:
        work = list(self.steps)
        while work:
            fn = work.pop()
            sf = self.steps[fn]
            self._locals(fn)
            dyn = self.env(fn)
            changed: Set[FunctionNode] = set()
            for node in ast.walk(fn):
                if node is not fn and self._parent.get(node) is fn:
                    # nested step code, revisited: it sees fn's dynamic names
                    self._mark(node, f"nested in step code {sf.name}", set())
                    changed.add(node)
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    for callee in self._by_name.get(node.func.id, []):
                        if self._parent.get(callee) is not None and \
                                self._parent.get(callee) is not fn and \
                                not self._encloses(self._parent[callee], fn):
                            continue  # a nested function out of this one's reach
                        site = self._site_dynamic(node, callee, dyn)
                        if self._mark(callee, f"called from step code {sf.name}", site):
                            changed.add(callee)
            work.extend(changed)

    def _encloses(self, outer: FunctionNode, inner: FunctionNode) -> bool:
        cur = self._parent.get(inner)
        while cur is not None:
            if cur is outer:
                return True
            cur = self._parent.get(cur)
        return False

    def env_at(self, node: ast.AST, owner: StepFunction,
               parents: Dict[ast.AST, ast.AST]) -> Set[str]:
        """The dynamic names at ``node`` in ``owner``: the function's, with
        the names of the comprehensions around ``node`` bound by their own
        iterables (outermost first)."""
        dyn = self.env(owner.node)
        comps = []
        cur = parents.get(node)
        while cur is not None and cur is not owner.node:
            if isinstance(cur, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
                comps.append(cur)
            cur = parents.get(cur)
        for comp in reversed(comps):
            for gen in comp.generators:
                names = set(_target_names(gen.target))
                dyn = (dyn | names) if touches_dynamic(self.mod, gen.iter, dyn) \
                    else (dyn - names)
        return dyn

    def owner(self, node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> Optional[StepFunction]:
        """The innermost step function whose body holds ``node``."""
        cur = parents.get(node)
        while cur is not None:
            if cur in self.steps:
                return self.steps[cur]
            cur = parents.get(cur)
        return None


def build_parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents
