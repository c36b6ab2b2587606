"""JXA202 fixtures: the same elementwise program against the same entry
budget: out of place its input and output coexist and bust it; in place
(the torch counterpart of the JAX fixture's donation) the output is the
input's buffer and the entry fits."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint

_N = 1 << 16                      # 256 KiB of float32
_BYTES = _N * 4
_BUDGET = _BYTES + _BYTES // 2    # one buffer and some slack, not two


@entrypoint("out_of_place_over_budget", hbm_budget=_BUDGET, phase_coverage_min=0.0)  # expect: JXA202
def out_of_place_over_budget():
    return EntryCase(fn=lambda x: x + 1.0, args=(torch.zeros(_N),))


@entrypoint("in_place_within_budget", hbm_budget=_BUDGET, phase_coverage_min=0.0)
def in_place_within_budget():
    return EntryCase(fn=lambda x: x.add_(1.0), args=(torch.zeros(_N),))
