"""JXL006: a torch.distributed collective outside the mesh's wrappers.

Collectives rendezvous in program order: each rank must issue the same
ones in the same order, and a gloo rank sharing a card must copy through
host buffers. The port keeps both in one place: every collective goes
through the wrappers of ``parallel/mesh.py`` (and the exchange built on
them, ``parallel/exchange.py``), which the audit's record reads
(``kernels/costs.collective``). The port has no ``chain_after`` (torch
issues collectives in program order), so no other module is trusted.
Queries of the process group (``is_initialized``, ``get_rank``,
``get_world_size``, ``get_backend``, ``ProcessGroup.unbox``) are not
collectives.
"""

import ast
from pathlib import PurePosixPath
from typing import List

from sphexa_torch.devtools.lint.core import Finding, ModuleInfo, register

#: the modules the collectives live in
ALLOWED = (("parallel", "mesh.py"), ("parallel", "exchange.py"))

COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "scatter", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "barrier",
})


@register(
    "JXL006",
    "collective-outside-mesh",
    "torch.distributed collective outside parallel/mesh.py and parallel/exchange.py",
)
def check(mod: ModuleInfo) -> List[Finding]:
    if PurePosixPath(mod.path).parts[-2:] in ALLOWED:
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        q = mod.qualname(node.func) or ""
        head, _, op = q.rpartition(".")
        if head == "torch.distributed" and op in COLLECTIVES:
            out.append(mod.finding(
                "JXL006", node,
                f"`{q}(...)` outside parallel/mesh.py: the ranks' collective order and "
                f"a shared card's host staging live in the mesh's wrappers "
                f"(all_gather, all_reduce_sum, reduce_scalars, ...); call one of them."))
    return out
