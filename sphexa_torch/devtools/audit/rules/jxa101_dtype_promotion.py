"""JXA101: a 64-bit value made on the entry's device inside the run.

The port's dtype policy (sphexa_torch/dtypes.py) is float32 fields and
int32 counts and indices on the device, with int64 where torch needs it
(SFC keys, the index operands of gather and scatter). A float64 or
complex128 tensor made by an op of the run (a ``row`` of the record with
the ``f64`` flag) is either a deliberate wide sum, which dtypes.py
declares with its reason (``F64_SITES``, by file and function), or a
silent promotion (a float64 numpy scalar, a ``.double()`` left behind):
on the card float64 runs at a fraction of the float32 rate, and it doubles
the bytes. An int64 leaf among the entry's outputs is the other breach:
the outputs' integers are int32 (``INDEX_DTYPE``), as in the JAX lock,
but for the keys dtypes.py declares (``INT64_OUTPUTS``).

One finding per offending dtype per entry, naming its first op and site:
a single upcast usually cascades through the rest of the step.
"""

from typing import Dict, List, Tuple

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA101", "dtype-promotion",
    "64-bit value made on the device in a run, outside the sites dtypes.py "
    "declares (the policy is 32-bit on device)",
)
def check(trace: EntryTrace) -> List[Finding]:
    from sphexa_torch.devtools.audit.statecheck import flatten
    from sphexa_torch.dtypes import F64_SITES, INT64_OUTPUTS

    hits: Dict[str, Tuple[str, int]] = {}
    for row in trace.tally.rows:
        if row.flag != "f64" or row.origin in F64_SITES:
            continue
        first, n = hits.get(row.detail, (f"`{row.op}` at {row.site} ({row.origin})", 0))
        hits[row.detail] = (first, n + 1)
    for path, leaf in flatten(trace.out):
        if getattr(leaf, "dtype", None) is not None and str(leaf.dtype) == "torch.int64" \
                and path.rsplit("[", 1)[-1].strip("]'.") not in INT64_OUTPUTS:
            first, n = hits.get("int64", (f"output leaf {path}", 0))
            hits["int64"] = (first, n + 1)
    return [
        trace.finding(
            "JXA101",
            f"{dtype} in the run ({n} value(s); first at {first}) above the 32-bit "
            f"dtypes.py policy. Keep the value in a policy dtype, or declare a "
            f"deliberate site in dtypes.F64_SITES with its reason.",
        )
        for dtype, (first, n) in sorted(hits.items())
    ]
