"""JXA501: state-schema drift from the committed STATE_SCHEMA_TORCH.json.

The output schema of every entry (paths, dtypes, each axis a polynomial
in N: statecheck.entry_schema) is a contract: the restart format, the
telemetry rows and the drivers read it. This rule pins the live schema
against the committed lock, so that a carry change (a new diagnostics
key, a float32 leaf widening, a padded axis becoming extensive) lands as
a reviewed lock diff.

It skips quietly when the default lock file is absent (fixtures, a
checkout elsewhere); a corrupt lock is a finding. A sharded entry's ranks
are each held to their own locked row, at the lock's mesh size. Entries missing from
the lock are the CLI's business (``schema --write``).
"""

from pathlib import Path
from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, audit_context, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA501", "state-schema-drift",
    "entry output schema (paths, dtypes, axis polynomials in N) drifted from "
    "the committed STATE_SCHEMA_TORCH.json",
)
def check(trace: EntryTrace) -> List[Finding]:
    from sphexa_torch.devtools.audit import statecheck

    path = audit_context().state_schema_path
    if not Path(path).exists():
        return []
    try:
        locked = statecheck.load_lock(path)
    except statecheck.LockError as e:
        return [trace.finding("JXA501", f"schema lock unreadable: {e} — fix or regenerate "
                                        f"it with `schema --write`.")]
    row = locked.get(trace.entry.name)
    if row is None:
        return []
    name = trace.entry.name
    if "ranks" in row:
        # a sharded entry's locked row: this rank's, at the lock's mesh size
        if row.get("mesh") != audit_context().mesh_size or trace.rank >= len(row["ranks"]):
            return []
        row, name = row["ranks"][trace.rank], f"{name}[rank {trace.rank}]"
    current = statecheck.entry_schema(trace)
    if row == current:
        return []
    diff = statecheck.schema_diff(name, row, current)
    return [trace.finding(
        "JXA501",
        "; ".join(line.strip() for line in diff[1:])
        + " — review the change and re-lock with `schema --write`.",
    )]
