"""O(N^2) direct-sum gravity (sphexa_tpu/gravity/direct.py): the accuracy
oracle of the tree solver in the tests and on the card, with the same
h_i + h_j softening as the near field."""

from typing import Optional

import torch

from sphexa_torch.gravity import multipole as mp


def direct_gravity(x, y, z, m, h, G: float = 1.0, targets: Optional[torch.Tensor] = None):
    """Returns (ax, ay, az, egrav), summing every pair exactly. With
    ``targets`` (an index tensor) only those particles' accelerations are
    computed against all sources, and egrav covers only them (half the sum
    of m phi over the targets). Targets go in blocks whose (block, n) pair
    temporaries stay near 2^26 elements."""
    n = x.shape[0]
    block = max(1, min(1024, (1 << 26) // max(n, 1)))
    idx = torch.arange(n, device=x.device) if targets is None else targets
    src = torch.arange(n, device=x.device)
    out = [[], [], [], []]
    for b0 in range(0, idx.shape[0], block):
        bi = idx[b0: b0 + block]
        mask = src[None, :] != bi[:, None]
        for o, a in zip(out, mp.p2p(x[bi], y[bi], z[bi], h[bi], x, y, z, m, h, mask)):
            o.append(a)
    ax, ay, az, phi = (torch.cat(o) * G for o in out)
    return ax, ay, az, 0.5 * torch.sum(m[idx] * phi)
