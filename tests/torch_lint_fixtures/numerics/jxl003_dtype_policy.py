"""JXL003 fixture: literal dtypes in a module where state is born (the
rule's fixture hook puts this directory under the policy)."""

import torch

from sphexa_torch.dtypes import COORD_DTYPE, KEY_DTYPE


def make(n):
    x = torch.zeros(n, dtype=torch.float32)  # expect: JXL003
    k = torch.zeros(n, dtype=torch.int64)    # expect: JXL003
    i = torch.arange(n).to(torch.int32)      # expect: JXL003
    d = x.to(torch.float64)                  # expect: JXL003
    u = torch.uint32                         # expect: JXL003
    ok = torch.zeros(n, dtype=COORD_DTYPE)   # ok: the policy's name
    key = k.to(KEY_DTYPE)                    # ok
    b = torch.zeros(n, dtype=torch.bool)     # ok: no policy dtype for bool
    return x, k, i, d, u, ok, key, b
