"""JXA105 fixtures: 1.2 MB of host data made into a tensor in the run,
and a 2 MB device tensor read that the run neither got nor made (fires);
the same tensors passed in (clean)."""

import numpy as np
import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint

_TABLE = torch.ones(500_000, dtype=torch.float32)


def _x():
    return torch.arange(8, dtype=torch.float32)


@entrypoint("jxa105_fires", phase_coverage_min=0.0)
def jxa105_fires():
    host = np.ones(300_000, dtype=np.float32)
    return EntryCase(fn=lambda x: x.sum() + torch.as_tensor(host).sum() + _TABLE.sum(),
                     args=(_x(),))


@entrypoint("jxa105_clean", phase_coverage_min=0.0)
def jxa105_clean():
    host = torch.ones(300_000, dtype=torch.float32)
    return EntryCase(fn=lambda x, h, t: x.sum() + h.sum() + t.sum(), args=(_x(), host, _TABLE))
