"""The port's audit package (the JAX package's devtools/audit): the entry
registry (registry.py), the static roofline cost layer, the trace rules,
the lowering lock and statecheck, and the SPMD layer.

A torch step has no jaxpr: an entry is RUN once under a tally (tally.py,
a dispatch mode charging every aten op to its ``sphexa/<phase>`` scope,
and kernels/costs.py, the five CUDA kernels' rules charged at their
dispatch sites), and costmodel.py predicts its per-phase time on a device
model (devices.py: ``h100``, ``cpu-smoke``); a sharded entry runs on P
rank processes, one record each (core.run_sharded, spmd.py). The rules
keep the JAX ids (``--list-rules``): JXA101-JXA106 on the record,
JXA201-JXA204 across the ranks, JXA301-JXA303 on the cost model,
JXA401-JXA402, JXA501-JXA503.

Usage::

    python -m sphexa_torch.devtools.audit [--cpu]
    python -m sphexa_torch.devtools.audit cost [--cpu] [--device h100]
    python -m sphexa_torch.devtools.audit preflight [--cpu] [--mesh P]
    python -m sphexa_torch.devtools.audit --list-rules
    python -m sphexa_torch.telemetry trace <capture> --predict
"""

from sphexa_torch.devtools.audit.core import (  # noqa: F401
    AuditContext,
    Auditor,
    EntryCase,
    EntryPoint,
    EntrySkip,
    all_rules,
    audit_context,
    entries_from_namespace,
    entrypoint,
    set_audit_context,
)
from sphexa_torch.devtools.common import Finding  # noqa: F401
