"""JXA401: float accumulates whose sum depends on the order of updates.

The lowering lock pins what a run does; this rule pins that it can be
replayed bit for bit on the card. A float ``index_add_``,
``index_put_(accumulate=True)``, ``scatter_add``, ``scatter_reduce`` or
``index_reduce`` with "sum", "mean" or "prod", ``put_(accumulate=True)``
or a weighted ``bincount`` whose indices repeat adds the colliding
updates with atomics, in no fixed order, and float addition does not
associate: two runs differ in the last bits. The record checks the
indices of each such op in the run (under the tally's suppression), so
the rule fires on the CPU too: the finding is about what the card would
do. Integer accumulates, ``amin`` / ``amax`` reductions and float
accumulates onto distinct elements do not depend on order and stay
silent. The fix: sort by target and sum each segment in a fixed order
(``gravity.multipole.edge_segment_sum``), or add the children one at a
time (``gravity.tree.level_add_``).

A float collective that reduces (an ``all_reduce`` sum, a reduce or a
reduce-scatter of floats) is the same hazard across ranks: the backend
picks the order of the ranks' terms. The proven order is the mesh's
``reduce_scalars``: one all_gather, then the sum in rank order on every
rank. (The mesh's ``all_reduce_sum`` refuses floats.)
"""

from typing import Dict, List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


#: the collective reductions whose float result depends on the order of
#: the ranks' terms
_ORDERED = frozenset({"sum", "avg", "product", "premul_sum"})


@register(
    "JXA401", "nondeterminism",
    "float accumulate on repeated indices (added by atomics in no fixed "
    "order on the card): replays are not bit for bit",
)
def check(trace: EntryTrace) -> List[Finding]:
    sites: Dict[str, List[str]] = {}
    for row in trace.tally.rows:
        if row.flag == "accumulate" and row.repeats:
            sites.setdefault(row.site, []).append(row.detail)
    reducing = [c for c in trace.tally.collectives if c.reduce in _ORDERED
                and c.dtype.startswith(("float", "bfloat", "complex"))]
    out = [
        trace.finding(
            "JXA401",
            f"float `{c.op}` ({c.reduce}) of {c.dtype}{list(c.shape)} at {c.site} — "
            f"the backend adds the ranks' terms in an order of its own, so runs differ in "
            f"the last bits. All-gather the terms and sum them in rank order "
            f"(parallel.mesh.reduce_scalars).",
        )
        for c in reducing
    ]
    return out + [
        trace.finding(
            "JXA401",
            f"{len(ops)} float {ops[0]} on repeated indices at {site} — the card adds "
            f"colliding updates in no fixed order, so runs differ in the last bits. "
            f"Sort by target and sum each segment in a fixed order.",
        )
        for site, ops in sites.items()
    ]
