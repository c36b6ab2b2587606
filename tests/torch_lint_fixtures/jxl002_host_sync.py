"""JXL002 fixture: host syncs in step code vs. legal static uses. ``step``
and ``Stepper.step`` declare themselves roots (lint/scope.py ROOT_MARK)."""

import numpy as np
import torch


def _helper(v, cfg):
    scale = float(cfg.scale)                 # ok: cfg is static at the call site
    return float(v) * scale                  # expect: JXL002


def _shapes(t, k: int):
    rows = int(t.shape[0])                   # ok: shapes are static
    total = float(t.numel())                 # ok
    return rows * total + int(k) + len(t)    # ok: k is annotated int


def step(x, cfg, flags: bool = False):  # torchlint: step-root
    a = x.item()                             # expect: JXL002
    b = x.sum().tolist()                     # expect: JXL002
    c = x.cpu()                              # expect: JXL002
    d = x.detach().numpy()                   # expect: JXL002
    e = x.to("cpu")                          # expect: JXL002
    torch.cuda.synchronize()                 # expect: JXL002
    y = x * 2
    f = int(y.max())                         # expect: JXL002
    g = bool(y.any())                        # expect: JXL002
    h = np.asarray(y)                        # expect: JXL002
    i = float(torch.ones(()))                # expect: JXL002
    ok = int(flags) + int(cfg.level)         # ok: a bool flag, a config
    host = [float(v) for v in b]             # ok: b is a host list already
    dev = [float(v) for v in y]              # expect: JXL002
    if y is None:                            # ok: identity reads nothing
        return None
    n = x.shape[0] if x is not None else 0
    width = int(n)                           # ok: a shape
    _shapes(y, width)
    # torchlint: disable=JXL002 -- deliberate: the suppression test's sync
    kept = int(y.sum())
    return _helper(y, cfg), a, c, d, e, f, g, h, i, ok, host, dev, kept


class Stepper:
    def step(self, state):  # torchlint: step-root
        return int(state.count)              # expect: JXL002

    def configure(self, state):
        return int(state.count)              # ok: not step code


def driver(x):
    return float(x.sum())                    # ok: host code, not a step
