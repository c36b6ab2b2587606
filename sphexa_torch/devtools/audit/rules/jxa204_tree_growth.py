"""JXA204: the two-point growth probe behind JXA202's rescale exemption.

JXA202's campaign peak rescales only the extensive buffers (whole slabs);
cell tables, tree arrays and work buffers stay at their recorded size. A
buffer that grows faster than N would hide there. Entries with a grow
probe (``EntryPoint.grow``, statecheck's second point: the entry rebuilt
larger) are recorded at both sizes, and the summed bytes of the
non-extensive buffers (``spmd.non_extensive_bytes``: neither a whole
number of the slab rows nor of their power-of-two padding) may grow at
most as the particle count does, times ``tree_growth_slack``.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.audit.spmd import format_bytes, non_extensive_bytes, slab_rows
from sphexa_torch.devtools.common import Finding


@register(
    "JXA204", "tree-growth",
    "rescale-exempt (non-slab) buffer bytes grow superlinearly in N "
    "between the entry's two growth-probe trace points",
    spmd=True,
)
def check(trace: EntryTrace) -> List[Finding]:
    grown = trace.grown()
    if grown is None:
        return []
    ctx = audit_context()
    s1, s2 = slab_rows(trace.case.args), slab_rows(grown.case.args)
    if not s1 or s2 == s1:
        return []
    e1 = non_extensive_bytes(trace.tally, s1)
    e2 = non_extensive_bytes(grown.tally, s2)
    if e1 <= 0:
        return []
    n_ratio = s2 / s1
    growth = e2 / e1
    allowed = n_ratio * ctx.tree_growth_slack
    if growth <= allowed:
        return []
    return [trace.finding(
        "JXA204",
        f"rescale-exempt buffers grew {growth:.2f}x ({format_bytes(e1)} -> "
        f"{format_bytes(e2)}) across a {n_ratio:.2f}x N growth probe (allowed <= "
        f"{allowed:.2f}x = linear x slack {ctx.tree_growth_slack:g}) — a table or work "
        f"buffer grows faster than N, so JXA202's recorded-size exemption under-estimates "
        f"its campaign memory; make the buffer extensive or cap its growth.",
    )]
