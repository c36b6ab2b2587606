"""JXA303: declared-compute-bound phase sitting below the ridge point.

The roofline's qualitative claim per phase (compute- or memory-bound) is
what a measurement acts on: fuse the memory-bound phases, tune block
shapes on the compute-bound ones. The full memory-bound ranking is a
REPORT (``python -m sphexa_torch.devtools.audit cost`` prints it). The
rule has teeth only where an entry DECLARES an expectation: a phase
listed in ``expect_compute_bound`` whose arithmetic intensity sits below
the device ridge point means the interaction kernel degraded into a
bandwidth-bound gather loop.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.costmodel import cost_report, predict
from sphexa_torch.devtools.audit.devices import get_device
from sphexa_torch.devtools.common import Finding


@register(
    "JXA303", "memory-bound-phase",
    "a phase the entry declares compute-bound has arithmetic intensity "
    "below the device-model ridge point",
)
def check(trace: EntryTrace) -> List[Finding]:
    expect = trace.entry.expect_compute_bound
    if not expect:
        return []
    ctx = audit_context()
    dev = get_device(ctx.cost_device)
    pred = predict(cost_report(trace, ctx), dev)
    out: List[Finding] = []
    for phase in expect:
        row = pred.row(phase)
        if row is None:
            out.append(trace.finding(
                "JXA303",
                f"phase {phase!r} is declared compute-bound but no op "
                f"attributes to it — the scope vanished or the declaration "
                f"is stale.",
            ))
            continue
        ridge = dev.ridge(row.dtype)
        if row.ai < ridge:
            out.append(trace.finding(
                "JXA303",
                f"phase {phase!r} is declared compute-bound but its "
                f"arithmetic intensity {row.ai:.3g} FLOPs/B sits below the "
                f"{dev.name} ridge point {ridge:.3g} ({row.dtype}) — the "
                f"kernel moves more HBM bytes than its FLOPs can hide "
                f"(predicted {row.ms:.4g}ms, {row.bound}-bound); check for "
                f"a lost blocking/reuse structure in the traversal.",
            ))
    return out
