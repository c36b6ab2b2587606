"""JXL003: a literal torch dtype where the dtype policy names one.

``sphexa_torch/dtypes.py`` is the port's one switch for its precision
policy (int64 keys, float32 coordinates and fields, int32 indices): the
modules where particle state, keys and dumps are born spell dtypes
through its names, so that a change of policy is one edit. A literal
``torch.float32`` there pins the old policy. The check covers init/,
sfc/, io/ and sph/particles.py; ``dtypes.py`` itself is exempt, and so
are the functions ``dtypes.F64_SITES`` declares float64 sites (read from
the file, not imported). Numerics modules keep their explicit working
precisions and are not checked.
"""

import ast
from functools import lru_cache
from pathlib import Path, PurePosixPath
from typing import FrozenSet, List, Optional

from sphexa_torch.devtools.lint.core import Finding, ModuleInfo, register

#: path fragments of the modules the policy covers
POLICY_PATHS = (
    "sphexa_torch/init/",
    "sphexa_torch/sfc/",
    "sphexa_torch/io/",
    "sphexa_torch/sph/particles.py",
    "torch_lint_fixtures/numerics/",   # the fixture of tests/test_torch_lint.py
)

EXEMPT_PATHS = ("sphexa_torch/dtypes.py",)

_SUGGESTION = {
    "float32": "COORD_DTYPE / HYDRO_DTYPE",
    "int32": "INDEX_DTYPE",
    "int64": "KEY_DTYPE (keys) or INDEX_DTYPE",
    "uint32": "KEY_DTYPE (the port's keys are int64)",
    "float64": "a policy dtype, or an entry of dtypes.F64_SITES with its reason",
}


def applies_to(path: str) -> bool:
    if any(path.endswith(e) for e in EXEMPT_PATHS):
        return False
    return any(frag in path for frag in POLICY_PATHS)


@lru_cache(maxsize=None)
def _f64_sites(dtypes_path: str) -> FrozenSet[str]:
    """The keys of ``F64_SITES`` in ``dtypes_path`` (``file:function``)."""
    try:
        tree = ast.parse(Path(dtypes_path).read_text())
    except (OSError, SyntaxError):
        return frozenset()
    for node in tree.body:
        target = node.target if isinstance(node, ast.AnnAssign) else (
            node.targets[0] if isinstance(node, ast.Assign) else None)
        if isinstance(target, ast.Name) and target.id == "F64_SITES" and \
                isinstance(node.value, ast.Dict):
            return frozenset(k.value for k in node.value.keys
                             if isinstance(k, ast.Constant) and isinstance(k.value, str))
    return frozenset()


def _site_prefix(path: str) -> Optional[str]:
    """(``sphexa_torch/...py`` of ``path``, the dtypes.py beside it)."""
    parts = PurePosixPath(path).parts
    if "sphexa_torch" not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index("sphexa_torch")
    return "/".join(parts[i:])


@register(
    "JXL003",
    "dtype-policy-bypass",
    "literal torch dtype (torch.float32/int32/int64/float64/uint32) in a module where "
    "particle state is born, instead of the sphexa_torch/dtypes.py policy names",
)
def check(mod: ModuleInfo) -> List[Finding]:
    if not applies_to(mod.path):
        return []
    rel = _site_prefix(mod.path)
    sites: FrozenSet[str] = frozenset()
    if rel is not None:
        root = mod.path[: len(mod.path) - len(rel)]
        sites = _f64_sites(str(Path(root or ".") / "sphexa_torch" / "dtypes.py"))
    exempt = {s.split(":", 1)[1] for s in sites if rel and s.split(":", 1)[0] == rel}
    out: List[Finding] = []

    def visit(node: ast.AST, fn: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Attribute) and child.attr in _SUGGESTION \
                    and mod.qualname(child) == f"torch.{child.attr}" and fn not in exempt:
                out.append(mod.finding(
                    "JXL003", child,
                    f"literal `torch.{child.attr}` where particle state is born bypasses "
                    f"the dtype policy; use {_SUGGESTION[child.attr]} from "
                    f"sphexa_torch.dtypes."))
            visit(child, fn)

    visit(mod.tree, None)
    return out
