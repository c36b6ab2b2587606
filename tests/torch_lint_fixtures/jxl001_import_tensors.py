"""JXL001 fixture: tensors built at import time vs. legal lazy ones."""

import numpy as np
import torch
from torch import zeros

COORD = torch.float32                        # ok: a dtype alias, no call
TABLE = torch.tensor([1.0, 2.0])             # expect: JXL001
ONES = torch.ones(3).cuda()                  # expect: JXL001
RANGE = torch.arange(8).to("cpu")            # expect: JXL001
Z = zeros(4)                                 # expect: JXL001
HOST = np.zeros(4)                           # ok: a numpy constant
READY = torch.cuda.is_available()            # expect: JXL001

if True:
    GUARDED = torch.full((2,), 1.5)          # expect: JXL001


class Config:
    scale = torch.as_tensor(2.0)             # expect: JXL001
    name = "cfg"


def with_default(x, w=torch.empty(2)):       # expect: JXL001
    return x * w


def lazy(device):
    return torch.zeros(3, device=device)     # ok: built when called


LATER = lambda d: torch.ones(2, device=d)    # noqa: E731 - ok: a lambda body
