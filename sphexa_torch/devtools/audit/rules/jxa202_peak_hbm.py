"""JXA202: the static peak memory of a rank against the card's.

A liveness sweep over each rank's record (``spmd.liveness``) bounds what
the card must hold at once: the run's arguments and outputs throughout,
every other buffer from the first row that names it to the last, a
kernel's outputs from its launch. Two numbers come out:

- the **toy peak** at the recorded size (every entry), and
- for a sharded entry, the **campaign peak**: each buffer that is a whole
  number of slabs rescaled to ``campaign_n / campaign_devices`` rows a
  rank, the rest at its recorded size.

Either over the budget (the entry's ``hbm_budget``, else ``--hbm-budget``,
else the card's memory from devices.py: 80 GB for the H100) is a finding:
the campaign would run out of memory at launch, found without the card.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.spmd import format_bytes, spmd_report
from sphexa_torch.devtools.common import Finding


@register(
    "JXA202", "peak-hbm-liveness",
    "donation-aware static peak-HBM estimate (toy N and campaign "
    "rescale) exceeds the per-device budget",
    spmd=True,
)
def check(trace: EntryTrace) -> List[Finding]:
    ctx = audit_context()
    rep = spmd_report(trace, ctx)
    budget = trace.entry.hbm_budget or ctx.hbm_budget_bytes
    over = []
    if rep.toy_peak_bytes > budget:
        over.append(f"recorded size: {format_bytes(rep.toy_peak_bytes)}")
    if rep.campaign_peak_bytes is not None and rep.campaign_peak_bytes > budget:
        slab = ctx.campaign_n // max(ctx.campaign_devices, 1)
        over.append(f"campaign N={ctx.campaign_n} / P={ctx.campaign_devices} ({slab} rows a "
                    f"rank): {format_bytes(rep.campaign_peak_bytes)}")
    if not over:
        return []
    return [trace.finding(
        "JXA202",
        f"static peak memory of a rank exceeds the budget {format_bytes(budget)}: "
        f"{'; '.join(over)} — shrink the live buffers (narrower halos, staged gravity "
        f"arrays, freeing before the next stage) or raise the budget if the card has "
        f"the room.",
    )]
