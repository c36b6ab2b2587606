"""JXA106: collectives over a group outside the entry's declared mesh.

Every collective of the record names its group (``Tally.collectives``:
``p`` for the mesh's, the port's one axis, else the process group's
name), and the registry entry declares the axes its sharding provides
(``mesh_axes=("p",)``). A group outside the declaration means the code
and the registry disagree about the mesh: a collective on a subgroup the
entry does not know reduces over other ranks than its slabs', and one
that escaped into an entry registered as one-device (no ``mesh_axes``)
runs a collective a single process cannot complete.
"""

from typing import Dict, List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA106", "collective-axis",
    "collective over an axis name outside the entry's declared mesh "
    "sharding",
    spmd=True,
)
def check(trace: EntryTrace) -> List[Finding]:
    declared = set(trace.entry.mesh_axes)
    unknown: Dict[str, str] = {}  # group -> first collective and site
    for view in trace.ranks:
        for c in view.tally.collectives:
            if c.group not in declared and c.group not in unknown:
                unknown[c.group] = f"`{c.op}` at {c.site}"
    return [
        trace.finding(
            "JXA106",
            f"{first} runs over group {group!r} but the registry declares "
            f"mesh_axes={tuple(sorted(declared))} for this entry — the code and the "
            f"declared sharding disagree; fix the group or the registration.",
        )
        for group, first in sorted(unknown.items())
    ]
