"""JXA105: large constants in a run.

The torch meaning of a closure-baked jaxpr constant, on the same per-entry
budget (``const_bytes_limit``, 1 MiB: lookup tables are fine, particle
arrays are not):

- host data made into a tensor inside the run (``torch.tensor``,
  ``as_tensor``, ``from_numpy``): copied from the host every step;
- a device tensor the run reads that neither its arguments hold nor one
  of its ops made: a closure capture, the "frozen step-1 array" that
  silently feeds old data into every later step.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA105", "const-bloat",
    "host data made into a tensor, or a captured device tensor, above the "
    "entry's size budget inside a run",
)
def check(trace: EntryTrace) -> List[Finding]:
    t = trace.tally
    limit = trace.entry.const_bytes_limit
    out: List[Finding] = []
    for kind, items, fix in (
            ("host data made into a tensor", t.host_data,
             "make it once outside the step and pass it in"),
            ("device tensor read but neither passed in nor made", t.captured,
             "pass it as an argument instead of closing over it")):
        for site, dtype, shape, nbytes in items:
            if nbytes > limit:
                out.append(trace.finding(
                    "JXA105",
                    f"{kind}: {dtype}{list(shape)} of {nbytes} bytes at {site} "
                    f"(budget {limit}); {fix}.",
                ))
    return out
