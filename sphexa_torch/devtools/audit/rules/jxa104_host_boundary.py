"""JXA104: host syncs inside a run, against the entry's declared count.

A read of the card on the host (``.item()``, ``.tolist()``, ``.cpu()``,
``bool(t)``, a host array copied onto the device, or an op whose result
size depends on the data: ``nonzero``, boolean-mask indexing,
``masked_select``, ``unique``, ``bincount``, ``repeat_interleave``
without ``output_size``) stalls the host until the card drains its queue,
every step: the step can no longer run ahead of the card. The record
(tally.py) flags each such row on either device with the source line
that made it, the line ``torch.cuda.set_sync_debug_mode`` names on the
card (chip_smoke.py holds the two equal, entry by entry). An entry
declares the syncs its code needs (``host_syncs``, 0 unless declared);
more or fewer is a finding that names every site.
"""

from collections import Counter
from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


def sync_sites(trace: EntryTrace) -> Counter:
    """{"file:line (reason)": count} of the run's host syncs."""
    return Counter(f"{r.site} ({r.detail})" for r in trace.tally.rows if r.flag == "sync")


@register(
    "JXA104", "host-boundary",
    "host syncs inside a run (reads of the card on the host, data-dependent "
    "sizes) other than the entry's declared count",
)
def check(trace: EntryTrace) -> List[Finding]:
    sites = sync_sites(trace)
    n, want = sum(sites.values()), trace.entry.host_syncs
    if n == want:
        return []
    listed = ", ".join(f"{s} x{c}" if c > 1 else s for s, c in sites.items())
    return [trace.finding(
        "JXA104",
        f"{n} host sync(s) in the run, {want} declared"
        + (f": {listed}" if listed else "")
        + " — each stalls the host on the card every step. Keep the value on "
          "the device (a 0-d tensor, a static size), or declare the sync on the "
          "entry with the reason the code needs it.",
    )]
