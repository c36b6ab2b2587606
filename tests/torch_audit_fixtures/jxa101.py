"""JXA101 fixtures: a float64 value made in the run (fires), the same
arithmetic in float32 (clean)."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint


def _x():
    return torch.arange(8, dtype=torch.float32)


@entrypoint("jxa101_fires", phase_coverage_min=0.0)
def jxa101_fires():
    return EntryCase(fn=lambda x: (x.to(torch.float64) * 2.0).to(torch.float32), args=(_x(),))


@entrypoint("jxa101_x64", x64=True, phase_coverage_min=0.0)
def jxa101_x64():
    # float64 as the default dtype: a Python float makes a float64 tensor
    return EntryCase(fn=lambda x: x * torch.full((), 2.0), args=(_x(),))


@entrypoint("jxa101_clean", phase_coverage_min=0.0)
def jxa101_clean():
    return EntryCase(fn=lambda x: x * 2.0, args=(_x(),))
