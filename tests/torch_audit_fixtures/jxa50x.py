"""statecheck fixtures: JXA501 (``jxa50x_lock.json`` pins ``jxa501_fires``
as int32 where it returns float32: fires; ``jxa501_clean`` as it is),
JXA502 (a host read inside the vmapped body: fires; plain arithmetic:
clean) and JXA503 (a step whose aux slot flips from None to a tensor and
whose x leaf turns int32: fires; a closed step: clean)."""

import dataclasses
from typing import Optional

import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint


@dataclasses.dataclass
class _State:
    x: torch.Tensor
    aux: Optional[torch.Tensor] = None


def _state():
    return _State(x=torch.arange(8, dtype=torch.float32))


def _open_step(s):
    return _State(x=(s.x * 2.0).to(torch.int32), aux=s.x.sum())


def _closed_step(s):
    return _State(x=s.x * 2.0, aux=None)


@entrypoint("jxa501_fires", phase_coverage_min=0.0)
def jxa501_fires():
    return EntryCase(fn=lambda x: x * 2.0, args=(torch.ones(8),))


@entrypoint("jxa501_clean", phase_coverage_min=0.0)
def jxa501_clean():
    return EntryCase(fn=lambda x: x * 2.0, args=(torch.ones(8),))


@entrypoint("jxa502_fires", phase_coverage_min=0.0)
def jxa502_fires():
    return EntryCase(fn=lambda x: x * x.sum().item(), args=(torch.ones(8),))


@entrypoint("jxa503_fires", phase_coverage_min=0.0)
def jxa503_fires():
    return EntryCase(fn=_open_step, args=(_state(),), carry=lambda args, out: (out,))


@entrypoint("jxa503_clean", phase_coverage_min=0.0)
def jxa503_clean():
    return EntryCase(fn=_closed_step, args=(_state(),), carry=lambda args, out: (out,))
