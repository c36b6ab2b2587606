"""JXL002: a host sync in step code.

A read of a device value on the host (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize``,
``float()`` / ``int()`` / ``bool()`` / ``np.asarray`` of a tensor-derived
value) stalls the host until the card has caught up: a step that makes
one can no longer run ahead of its kernels (the deferred windows' one
read a window). The scope is lint/scope.py's step code; a conversion is
reported only where its argument derives from a tensor (``int(n)`` of a
Python int, ``float(cfg.x)`` and ``int(t.shape[0])`` stay legal).

The audit's JXA104 counts the syncs a run makes; this rule names their
lines before a run. Data-dependent sizes (``nonzero``, boolean masks,
``bincount``) are JXA104's alone. A sync the step needs is suppressed
with its reason (the audit registry declares it in ``host_syncs``).
"""

import ast
from typing import List

from sphexa_torch.devtools.lint.core import Finding, ModuleInfo, register
from sphexa_torch.devtools.lint.scope import StepScopes, build_parent_map, touches_dynamic

_CONVERTERS = {"float", "int", "bool", "complex"}
_NP_MATERIALIZERS = {"numpy.asarray", "numpy.array", "numpy.asanyarray",
                     "numpy.ascontiguousarray"}
_ALWAYS_BAD_CALLS = {"torch.cuda.synchronize"}
_ALWAYS_BAD_METHODS = {"item", "tolist", "cpu", "numpy"}


def _to_host(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``."""
    vals = list(call.args) + [kw.value for kw in call.keywords if kw.arg in (None, "device")]
    for v in vals:
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
    return False


@register(
    "JXL002",
    "host-sync-in-step",
    "host sync in step code (.item(), .tolist(), .cpu(), .numpy(), .to('cpu'), "
    "torch.cuda.synchronize, float()/int()/bool()/np.asarray of a tensor-derived value)",
)
def check(mod: ModuleInfo) -> List[Finding]:
    scopes = StepScopes(mod)
    if not scopes.steps:
        return []
    parents = build_parent_map(mod.tree)
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        owner = scopes.owner(node, parents)
        if owner is None:
            continue
        where = f"step code `{owner.name}` ({owner.via})"
        if isinstance(node.func, ast.Attribute) and (
                (node.func.attr in _ALWAYS_BAD_METHODS and not node.args)
                or (node.func.attr == "to" and _to_host(node))):
            out.append(mod.finding(
                "JXL002", node,
                f"`.{node.func.attr}(...)` in {where} reads the card on the host: the "
                f"step waits for every kernel before it; keep the value on the device, "
                f"or suppress with the reason the step needs it."))
            continue
        q = mod.qualname(node.func)
        if q in _ALWAYS_BAD_CALLS:
            out.append(mod.finding(
                "JXL002", node,
                f"`{q}()` in {where} waits for the card; step code never needs it."))
            continue
        if (q in _CONVERTERS or q in _NP_MATERIALIZERS) and node.args:
            if touches_dynamic(mod, node.args[0], scopes.env_at(node, owner, parents)):
                out.append(mod.finding(
                    "JXL002", node,
                    f"`{q}(...)` of a tensor-derived value in {where} reads the card on "
                    f"the host; keep it a tensor, or suppress with the reason the step "
                    f"needs it."))
    return out
