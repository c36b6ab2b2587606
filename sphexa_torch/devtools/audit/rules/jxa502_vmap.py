"""JXA502: vmap batchability (an ensemble's admission check).

An ensemble runs the step over a member axis with ``torch.func.vmap``.
Each entry runs under ``vmap`` over ``vmap_members`` members (every
tensor of its args stacked) and what breaks batching is a finding, not a
crash: a failure (an op with no batching rule, a host read of a batched
value, a kernel given a batched tensor's pointer) or a kernel launch
inside the vmapped body (a launch sees one member, not the batch).

Off by default (``vmap_members=0``): ``schema --vmap`` turns it on; it is
not part of the default gate.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA502", "vmap-batchability",
    "entry fails or launches a kernel under torch.func.vmap over a member "
    "axis: not admissible to an ensemble",
)
def check(trace: EntryTrace) -> List[Finding]:
    from sphexa_torch.devtools.audit import statecheck

    members = audit_context().vmap_members
    if members <= 0:
        return []
    report = statecheck.vmap_probe(trace, members)
    out: List[Finding] = []
    if report["error"] is not None:
        out.append(trace.finding(
            "JXA502",
            f"does not run under torch.func.vmap over {members} members: "
            f"{report['error']} — the entry cannot serve an ensemble.",
        ))
    if report["launches"]:
        out.append(trace.finding(
            "JXA502",
            f"kernel launches inside the vmapped body: {report['launches']} — a "
            f"kernel sees one member, not the batch.",
        ))
    return out
