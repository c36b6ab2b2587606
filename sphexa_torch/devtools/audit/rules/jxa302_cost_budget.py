"""JXA302: predicted per-phase step time vs the committed budget file.

The static analog of a telemetry lock: ``COST_BUDGET_TORCH.json``
commits, per audited entry, a per-phase predicted-ms ceiling (and
optionally a total) at a named device model. A refactor that balloons a
phase's FLOPs or HBM traffic moves the prediction past its ceiling and
fails HERE — before any chip time — the way the telemetry lock catches
a measured regression after the fact.

Resolution order: the entry's own ``cost_budget_file`` (fixtures pin
doctored budgets this way), else ``AuditContext.cost_budget_path``.
A missing DEFAULT file skips the gate quietly (out-of-repo audit runs);
a missing or invalid DECLARED file is a finding — a broken gate must
not pass silently. Entries absent from the file are not gated.
"""

import os
from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.costmodel import (
    cost_report,
    load_budget,
    predict,
)
from sphexa_torch.devtools.common import Finding


@register(
    "JXA302", "cost-budget",
    "predicted per-phase (or total) step ms exceeds the committed "
    "COST_BUDGET_TORCH.json ceiling for this entry",
)
def check(trace: EntryTrace) -> List[Finding]:
    ctx = audit_context()
    declared = trace.entry.cost_budget_file
    path = declared or ctx.cost_budget_path
    if not path or (declared is None and not os.path.exists(path)):
        return []
    try:
        budget = load_budget(path)
    except (OSError, ValueError) as e:
        return [trace.finding(
            "JXA302",
            f"cost budget file unusable: {e} — fix or regenerate it "
            f"(python -m sphexa_torch.devtools.audit cost validates it).",
        )]
    spec = (budget.get("entries") or {}).get(trace.entry.name)
    if not spec:
        return []

    pred = predict(cost_report(trace, ctx), str(budget["device"]))
    out: List[Finding] = []
    for phase, ceiling in sorted((spec.get("phases") or {}).items()):
        row = pred.row(phase)
        got = row.ms if row is not None else 0.0
        if got > float(ceiling):
            out.append(trace.finding(
                "JXA302",
                f"predicted {phase} time {got:.4g}ms exceeds the committed "
                f"budget {float(ceiling):.4g}ms on {pred.device} — the "
                f"phase's static FLOP/HBM cost grew; optimize it back or "
                f"re-derive the budget (the prediction x 1.25) with the "
                f"regression understood.",
            ))
    total = spec.get("total_ms")
    if total is not None and pred.total_ms > float(total):
        out.append(trace.finding(
            "JXA302",
            f"predicted total step time {pred.total_ms:.4g}ms exceeds the "
            f"committed budget {float(total):.4g}ms on {pred.device}.",
        ))
    return out
