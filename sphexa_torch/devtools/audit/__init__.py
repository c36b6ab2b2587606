"""The port's audit package (the JAX package's devtools/audit): the entry
registry (registry.py) and the static roofline cost layer.

A torch step has no jaxpr: an entry is RUN once under a tally (tally.py,
a dispatch mode charging every aten op to its ``sphexa/<phase>`` scope,
and kernels/costs.py, the five CUDA kernels' rules charged at their
dispatch sites), and costmodel.py predicts its per-phase time on a device
model (devices.py: ``h100``, ``cpu-smoke``). The rules keep the JAX ids:

- JXA301  static FLOPs falling outside the phase taxonomy
- JXA302  predicted per-phase ms above the committed COST_BUDGET_TORCH.json
- JXA303  a declared-compute-bound phase below the device ridge point

Usage::

    python -m sphexa_torch.devtools.audit cost [--cpu] [--device h100]
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
