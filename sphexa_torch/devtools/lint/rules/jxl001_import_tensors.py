"""JXL001: a tensor built at import time.

A tensor made in a module body, a class body or a default argument is made
when the module is imported, before ``--device`` is parsed: on the card
it pins the card (``--device cpu`` on a card machine then mixes devices),
and on the CPU every later use on the card pays a copy from the host. A
``torch.cuda.*`` call at import does the same to the driver. Dtype aliases
(``COORD_DTYPE = torch.float32``) are not calls and are fine. Code in a
function body or a lambda runs when called and is exempt.
"""

import ast
from typing import List

from sphexa_torch.devtools.lint.core import Finding, ModuleInfo, register

#: the torch functions that make a tensor
CONSTRUCTORS = frozenset({
    "tensor", "as_tensor", "asarray", "from_numpy", "frombuffer", "zeros", "ones", "full",
    "arange", "empty", "empty_strided", "zeros_like", "ones_like", "full_like",
    "empty_like", "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
})


def _is_maker(mod: ModuleInfo, call: ast.Call) -> bool:
    q = mod.qualname(call.func) or ""
    head, _, name = q.rpartition(".")
    return (head == "torch" and name in CONSTRUCTORS) or q.startswith("torch.cuda.")


def _scan_expr(mod: ModuleInfo, expr: ast.AST, out: List[Finding]) -> None:
    """Tensors made by an expression evaluated at import (lambda bodies
    run later). A ``.to(...)`` / ``.cuda()`` on one is the same finding."""
    if isinstance(expr, ast.Lambda):
        return
    if isinstance(expr, ast.Call) and _is_maker(mod, expr):
        q = mod.qualname(expr.func)
        out.append(mod.finding(
            "JXL001", expr,
            f"`{q}(...)` runs at import time: it makes a tensor (or touches the card) "
            f"before --device is parsed. Build it inside the function that uses it, on "
            f"the device it is given, or keep a Python/numpy constant."))
    for child in ast.iter_child_nodes(expr):
        _scan_expr(mod, child, out)


def _scan_children(mod: ModuleInfo, node: ast.AST, out: List[Finding]) -> None:
    for sub in ast.iter_child_nodes(node):
        if isinstance(sub, ast.stmt):
            _scan_body(mod, [sub], out)
        elif isinstance(sub, ast.expr):
            _scan_expr(mod, sub, out)
        else:
            _scan_children(mod, sub, out)


def _scan_body(mod: ModuleInfo, body: List[ast.stmt], out: List[Finding]) -> None:
    for st in body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # decorators and defaults run when the def runs
            for dec in st.decorator_list:
                _scan_expr(mod, dec, out)
            for d in st.args.defaults + [d for d in st.args.kw_defaults if d]:
                _scan_expr(mod, d, out)
            continue
        if isinstance(st, ast.ClassDef):
            for dec in st.decorator_list:
                _scan_expr(mod, dec, out)
            _scan_body(mod, st.body, out)
            continue
        if isinstance(st, (ast.If, ast.Try, ast.With, ast.For, ast.While)):
            _scan_children(mod, st, out)
            continue
        _scan_expr(mod, st, out)


@register(
    "JXL001",
    "import-time-tensor",
    "a tensor built at import time (module body, class body, default argument) or a "
    "torch.cuda call there: it pins a device before --device is parsed",
)
def check(mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    _scan_body(mod, mod.tree.body, out)
    return out
