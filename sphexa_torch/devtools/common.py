"""Machinery the port's devtools share (the JAX package's
devtools/common.py, as far as the cost CLI needs it; the port imports
nothing of it): the ``Finding`` shape, the table renderer and the CLI's
findings report (exit codes 0 clean, 1 findings or errors, 2 usage).

The JAX module's inline suppression grammar and snippet-hash baseline
are not here: the port commits no baseline and no suppression comment
yet (ROADMAP Queue 1, the trace rules, brings them with the first).
"""

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["Finding", "render_table", "render_text"]


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
