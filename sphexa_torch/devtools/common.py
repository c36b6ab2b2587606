"""Machinery the port's devtools share (the JAX package's
devtools/common.py; the port imports nothing of it): the ``Finding``
shape, the table renderer and the CLIs' findings report, text or JSON
(exit codes 0 clean, 1 findings or errors, 2 usage).

The JAX module's inline suppression grammar and snippet-hash baseline
are not here: no finding of the port is grandfathered, so its gates run
at zero findings with nothing to suppress. The JSON report keeps the JAX
keys (``baselined`` and ``suppressed`` stay empty lists).
"""

import dataclasses
import json
from typing import List, Optional, Tuple

__all__ = ["Finding", "render_table", "render_text", "render_json", "finish_cli"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # "JXA301"
    path: str          # posix path as given to the analyzer
    line: int          # 1-based
    col: int           # 0-based
    message: str
    snippet: str = ""  # stripped source line, for reports

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def render_table(rows: List[Tuple], headers: Optional[Tuple] = None) -> str:
    """Column-aligned plain-text table (cells str()-ed, left-justified):
    the one table renderer of the port's CLIs (the cost CLI here, the
    telemetry reader's views)."""
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


def render_text(new: List[Finding], errors: List[Finding], tool: str) -> str:
    """The findings report: each error and finding, then the count."""
    lines: List[str] = [f.format() for f in errors]
    for f in new:
        lines.append(f.format())
        if f.snippet:
            lines.append(f"    {f.snippet}")
    lines.append(f"{tool}: {len(new) + len(errors)} finding(s)")
    return "\n".join(lines)


def render_json(new: List[Finding], errors: List[Finding]) -> str:
    """The JSON findings report, under the JAX CLI's keys."""
    return json.dumps({
        "findings": [f.to_json() for f in new],
        "errors": [f.to_json() for f in errors],
        "baselined": [],
        "suppressed": [],
    }, indent=2)


def finish_cli(tool: str, fmt: str, active: List[Finding], errors: List[Finding]) -> int:
    """The CLIs' tail: the report in ``fmt`` ("text" or "json") and the
    exit code, 0 clean or 1 findings or errors."""
    print(render_json(active, errors) if fmt == "json" else render_text(active, errors, tool))
    return 1 if (active or errors) else 0
