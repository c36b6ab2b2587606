"""JXA301: static phase-attribution coverage.

The cost model (and the ``--trace-dir`` attribution it predicts) is only
as good as the ``sphexa/<phase>`` scopes: an op outside every scope rolls
into the unattributed bucket, invisible to both the static ranking and
the measured per-phase table. Two ways the scopes rot land here:

- the entry's **attributed-FLOP share** falls below the threshold
  (``AuditContext.phase_coverage_min``, or the entry's own
  ``phase_coverage_min``: a reconfigure-time program outside the step
  taxonomy declares 0.0);
- an op lands in a ``sphexa/<x>`` scope with **x outside the
  util/phases.py taxonomy** — a typo'd or ad-hoc scope name that
  traceview would silently bucket as a brand-new phase.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.costmodel import cost_report
from sphexa_torch.devtools.common import Finding


@register(
    "JXA301", "phase-coverage",
    "attributed-FLOP share below the per-entry threshold, or an op "
    "stamped with a scope outside the util/phases.py taxonomy",
)
def check(trace: EntryTrace) -> List[Finding]:
    ctx = audit_context()
    rep = cost_report(trace, ctx)
    out: List[Finding] = []

    if rep.unknown_scopes:
        out.append(trace.finding(
            "JXA301",
            f"ops charged to scope(s) outside the util/phases.py "
            f"taxonomy: {', '.join(rep.unknown_scopes)} — traceview would "
            f"bucket these as brand-new phases; use util.phases.named_phase "
            f"(or extend PHASES) instead of ad-hoc scope strings.",
        ))

    floor = trace.entry.phase_coverage_min
    if floor is None:
        floor = ctx.phase_coverage_min
    if rep.total_flops > 0 and rep.coverage < floor:
        out.append(trace.finding(
            "JXA301",
            f"only {rep.coverage:.1%} of static FLOPs attribute to named "
            f"phases (threshold {floor:.0%}) — "
            f"{rep.unattributed.flops:.3g} FLOPs run outside every "
            f"sphexa/<phase> scope and will be invisible in captures; "
            f"wrap the unattributed stages with util.phases.named_phase.",
        ))
    return out
