"""JXA204 fixtures: two-point growth probes over the non-extensive
buffers. The quadratic entry makes an (n^2 + 1)-element work buffer, a
size that is no whole number of the rows, their power-of-two padding or
their blocks of 64, so it stays out of JXA202's rescale while growing as
N^2; the linear twin's scratch grows as N and passes."""

import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint

_N, _N_GROWN = 12, 24  # a 2x N probe


def _quad(x):
    n = x.shape[0]
    pair = torch.zeros(n * n + 1) + x.sum()
    return pair.sum() + x.sum()


def _lin(x):
    n = x.shape[0]
    scratch = torch.zeros(n + 1) + x.sum()
    return scratch.sum() + x.sum()


def _case(fn, n):
    return EntryCase(fn=fn, args=(torch.zeros(n),))


@entrypoint("quadratic_scratch", phase_coverage_min=0.0,  # expect: JXA204
            grow=lambda: _case(_quad, _N_GROWN))
def quadratic_scratch():
    return _case(_quad, _N)


@entrypoint("linear_scratch", phase_coverage_min=0.0, grow=lambda: _case(_lin, _N_GROWN))
def linear_scratch():
    return _case(_lin, _N)
