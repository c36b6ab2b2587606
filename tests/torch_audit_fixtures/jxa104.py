"""JXA104 fixtures: four host syncs (``.item()``, ``.tolist()``,
``nonzero``, a boolean mask) on lines that end in ``# sync``, none
declared (fires); the same reductions kept on the device (clean)."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint


def _syncs(x):
    top = x.max().item()  # sync
    first = x[:2].tolist()  # sync
    idx = torch.nonzero(x > 2.0)  # sync
    pos = x[x > 1.0]  # sync
    return top + first[0] + idx.sum() + pos.sum()


def _device_only(x):
    return x.max() + x[0] + (x > 2.0).sum() + torch.where(x > 1.0, x, 0.0).sum()


def _x():
    return torch.arange(8, dtype=torch.float32)


@entrypoint("jxa104_fires", phase_coverage_min=0.0)
def jxa104_fires():
    return EntryCase(fn=_syncs, args=(_x(),))


@entrypoint("jxa104_declared", host_syncs=4, phase_coverage_min=0.0)
def jxa104_declared():
    return EntryCase(fn=_syncs, args=(_x(),))


@entrypoint("jxa104_clean", phase_coverage_min=0.0)
def jxa104_clean():
    return EntryCase(fn=_device_only, args=(_x(),))
