"""Machinery the port's devtools share (the JAX package's
devtools/common.py; the port imports nothing of it): the ``Finding``
shape, the inline suppression grammar, the table renderer and the CLIs'
findings report, text or JSON (exit codes 0 clean, 1 findings or errors,
2 usage).

Suppressions (the lint's: ``# torchlint: disable=JXL002 -- reason`` on the
finding's line or in the run of comment lines right above it,
``# torchlint: disable-file=JXL001 -- reason`` anywhere in the file) are
the JAX grammar with the tool's name. A directive with no reason after
``--`` suppresses nothing. The JAX module's snippet-hash baseline is not
here: no finding of the port is grandfathered. The JSON report keeps the
JAX keys (``baselined`` stays an empty list; ``suppressed`` lists the
suppressed findings when they are asked for).
"""

import dataclasses
import io
import json
import re
import tokenize
from typing import Dict, List, Optional, Pattern, Sequence, Tuple

__all__ = ["Finding", "make_disable_re", "SuppressionTable", "parse_suppressions",
           "render_table", "render_text", "render_json", "finish_cli"]


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


def make_disable_re(tool: str) -> Pattern:
    """Compiled ``# <tool>: disable[-file]=CODES [-- reason]`` directive."""
    return re.compile(
        rf"#\s*{re.escape(tool)}:\s*disable(?P<file>-file)?\s*=\s*"
        r"(?P<codes>[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
        r"(?:\s*--\s*(?P<reason>.*))?"
    )


@dataclasses.dataclass
class SuppressionTable:
    """Per-line and file-wide ``disable=`` directives (the JAX table's
    fields), with each directive's reason.

    A finding at line L is suppressed when its rule code is in a directive
    that carries a reason on line L itself, in a comment-only line of the
    run of comment-only lines right above L, or in a ``disable-file=``
    directive anywhere in the file."""

    by_line: Dict[int, set]          # line -> codes of the directive on it
    comment_only: Dict[int, set]     # the comment-only directive lines
    comment_lines: set               # every comment-only line
    file_wide: set
    #: line -> the reason of the directive on it ("" when it has none)
    reasons: Dict[int, str] = dataclasses.field(default_factory=dict)
    #: file-wide code -> its directive's reason
    file_reasons: Dict[str, str] = dataclasses.field(default_factory=dict)

    def reason(self, code: str, line: int) -> Optional[str]:
        """The reason of the directive that names ``code`` for ``line``
        ("" for one without a reason), or None when none does."""
        if code in self.file_wide:
            return self.file_reasons.get(code, "")
        if code in self.by_line.get(line, ()):
            return self.reasons.get(line, "")
        lookup = line - 1
        while lookup in self.comment_lines:
            if code in self.comment_only.get(lookup, ()):
                return self.reasons.get(lookup, "")
            lookup -= 1
        return None

    def is_suppressed(self, code: str, line: int) -> bool:
        """Named by a directive that gives its reason."""
        return bool(self.reason(code, line))

    def unreasoned(self) -> List[int]:
        """Lines of the directives that give no reason."""
        return sorted(line for line, why in self.reasons.items() if not why)


def parse_suppressions(source: str, directive_re: Pattern) -> SuppressionTable:
    """The directives of ``source`` (comment tokens only: a directive in a
    string does not count)."""
    by_line: Dict[int, set] = {}
    comment_only: Dict[int, set] = {}
    comment_lines: set = set()
    file_wide: set = set()
    reasons: Dict[int, str] = {}
    file_reasons: Dict[str, str] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        line = tok.start[0]
        standalone = tok.line[: tok.start[1]].strip() == ""
        if standalone:
            comment_lines.add(line)
        m = directive_re.search(tok.string)
        if not m:
            continue
        codes = {c.strip() for c in m.group("codes").split(",")}
        why = (m.group("reason") or "").strip()
        reasons[line] = why
        if m.group("file"):
            file_wide |= codes
            for c in codes:
                file_reasons[c] = why
            continue
        by_line.setdefault(line, set()).update(codes)
        if standalone:
            comment_only.setdefault(line, set()).update(codes)
    return SuppressionTable(by_line, comment_only, comment_lines, file_wide, reasons,
                            file_reasons)


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


def render_text(new: List[Finding], errors: List[Finding], tool: str,
                suppressed: Sequence[Finding] = (), show_suppressed: bool = False) -> str:
    """The findings report: each error and finding, the suppressed ones
    when asked for, then the count."""
    lines: List[str] = [f.format() for f in errors]
    for f in new:
        lines.append(f.format())
        if f.snippet:
            lines.append(f"    {f.snippet}")
    if show_suppressed:
        lines += [f"[suppressed] {f.format()}" for f in suppressed]
    lines.append(f"{tool}: {len(new) + len(errors)} finding(s)"
                 + (f", {len(suppressed)} suppressed inline" if suppressed else ""))
    return "\n".join(lines)


def render_json(new: List[Finding], errors: List[Finding],
                suppressed: Sequence[Finding] = ()) -> str:
    """The JSON findings report, under the JAX CLI's keys."""
    return json.dumps({
        "findings": [f.to_json() for f in new],
        "errors": [f.to_json() for f in errors],
        "baselined": [],
        "suppressed": [f.to_json() for f in suppressed],
    }, indent=2)


def finish_cli(tool: str, fmt: str, active: List[Finding], errors: List[Finding],
               suppressed: Sequence[Finding] = (), show_suppressed: bool = False) -> int:
    """The CLIs' tail: the report in ``fmt`` ("text" or "json") and the
    exit code, 0 clean or 1 findings or errors. The suppressed findings
    are listed only with ``show_suppressed``."""
    shown = list(suppressed) if show_suppressed else []
    print(render_json(active, errors, shown) if fmt == "json"
          else render_text(active, errors, tool, suppressed, show_suppressed))
    return 1 if (active or errors) else 0
