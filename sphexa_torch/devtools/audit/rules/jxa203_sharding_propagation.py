"""JXA203: particle fields replicated onto every rank, and exchange
volume beyond the analytic budget.

Two ways a sharded program ships more than its design:

- a collective whose result holds the **global N rows of a particle
  field on every rank** (an all_gather of a slab-shaped operand, an
  all_reduce or broadcast of an N-row one): every rank materializes all
  N rows, the gather the halo exchange exists to avoid. A finding when
  its bytes at campaign N clear ``repl_threshold_bytes``; the small
  tables and the O(tree) arrays the ranks replicate by design do not
  have N rows.
- a rank's **summed collective bytes** (what arrives through its
  collectives in a run) above the budget its builder declares
  (``exchange_budget_bytes``: the JAX builder's, from the sizing's caps,
  plus ``sort_bytes`` where the port's step runs its distributed sort)
  times ``exchange_slack``: a collective is shipping rows the explicit
  exchange does not account for. Entries without a budget skip the gate.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.spmd import format_bytes, spmd_report
from sphexa_torch.devtools.common import Finding


@register(
    "JXA203", "sharding-propagation",
    "particle-shaped operand replicated into a shard_map, or cross-shard "
    "collective volume beyond the sizing-derived expectation",
    spmd=True,
)
def check(trace: EntryTrace) -> List[Finding]:
    ctx = audit_context()
    rep = spmd_report(trace, ctx)
    out: List[Finding] = []
    big = [r for r in rep.replicated if r.campaign_bytes >= ctx.repl_threshold_bytes]
    if big:
        desc = "; ".join(
            f"rank {r.rank} `{r.op}` at {r.site} {r.dtype}{list(r.shape)} "
            f"({format_bytes(r.toy_bytes)} recorded, {format_bytes(r.campaign_bytes)} at "
            f"campaign N)" for r in big[:4])
        more = len(big) - min(len(big), 4)
        out.append(trace.finding(
            "JXA203",
            f"{len(big)} collective result(s) hold the global N rows of a particle field "
            f"on every rank: {desc}" + (f"; +{more} more" if more > 0 else "")
            + ". Exchange the halo rows a rank needs instead.",
        ))
    budget = trace.case.exchange_budget_bytes
    if budget:
        budget += trace.case.sort_bytes
        allowed = int(budget * ctx.exchange_slack)
        worst = max(rep.ranks, key=lambda r: r.exchange_bytes)
        if worst.exchange_bytes > allowed:
            out.append(trace.finding(
                "JXA203",
                f"rank {worst.rank}'s collectives ship {format_bytes(worst.exchange_bytes)}, "
                f"above the analytic budget {format_bytes(budget)} x slack "
                f"{ctx.exchange_slack:g} = {format_bytes(allowed)} — a collective is shipping "
                f"rows the explicit exchange does not account for (check the halo caps and "
                f"the gathers of the stage).",
            ))
    return out
