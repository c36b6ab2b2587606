"""JXA201: collective order across the ranks.

torch issues each rank's collectives in program order, so the XLA
rendezvous race of the JAX rule is not the hazard here: a rank-dependent
order is. Every rank must issue the same collectives in the same order,
(op, group, dtype, site) for (op, group, dtype, site); a collective that
needs one shape on every rank (all_reduce, all_gather, broadcast, reduce,
gather) must get it; and each send of a P2P batch must meet the peer's
receive of the same bytes. Two same-shape all_reduces issued from two
sites in an order that depends on the rank complete on gloo, with their
payloads cross-wired: the record shows the sites swapped. A mismatch of
ops or shapes hangs or fails at run time instead; this rule names it
before a campaign does (spmd.order_problems).
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.spmd import spmd_report
from sphexa_torch.devtools.common import Finding


@register(
    "JXA201", "collective-order",
    "the ranks issue different collectives, in another order, with other "
    "shapes, or sends without their receives",
    spmd=True,
)
def check(trace: EntryTrace) -> List[Finding]:
    rep = spmd_report(trace, audit_context())
    if not rep.order_problems:
        return []
    more = len(rep.order_problems) - 3
    return [trace.finding(
        "JXA201",
        f"{len(rep.order_problems)} collective-order problem(s) over {rep.mesh_size} ranks: "
        + "; ".join(rep.order_problems[:3]) + (f"; +{more} more" if more > 0 else "")
        + " — every rank must issue the same collectives in the same order: take the "
          "order from replicated values, never from the rank.",
    )]
