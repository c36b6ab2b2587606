"""Plain-text tables of the port's CLIs (the JAX package's
``devtools/common.render_table``, copied: the port imports nothing of
it)."""

from typing import List, Optional, Tuple


def render_table(rows: List[Tuple], headers: Optional[Tuple] = None) -> str:
    """Column-aligned plain-text table (cells str()-ed, left-justified)."""
    srows = [tuple(str(c) for c in r) for r in rows]
    if headers is not None:
        srows = [tuple(str(c) for c in headers)] + srows
    if not srows:
        return ""
    ncol = max(len(r) for r in srows)
    srows = [r + ("",) * (ncol - len(r)) for r in srows]
    widths = [max(len(r[i]) for r in srows) for i in range(ncol)]
    lines = [
        "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
        for r in srows
    ]
    if headers is not None:
        lines.insert(1, "  ".join("-" * w for w in widths).rstrip())
    return "\n".join(lines)
