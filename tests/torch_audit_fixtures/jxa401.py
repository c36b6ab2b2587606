"""JXA401 fixtures: the snapshot deposit's old form, a float ``index_add_``
of the particles' weights on their (repeated) cells (fires), the deposit as
it is now, an integer ``index_add_``, an ``amax`` reduce and a float
``index_add_`` onto distinct rows (clean)."""

import numpy as np
import torch

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint
from sphexa_torch.observables import snapshot


def _cells_and_weights():
    rng = np.random.default_rng(401)
    flat = torch.from_numpy(rng.integers(0, 16, 64).astype(np.int64))
    w = torch.from_numpy(rng.random((2, 64)).astype(np.float32))
    return flat, w


def _old_deposit(flat, w):
    return torch.zeros((w.shape[0], 16), dtype=w.dtype).index_add_(1, flat, w)


def _order_free(flat, w):
    counts = torch.zeros(16, dtype=torch.int32).index_add_(0, flat, torch.ones_like(
        flat, dtype=torch.int32))
    peak = torch.full((2, 16), -1.0).scatter_reduce_(1, flat.expand(2, -1), w, "amax")
    rows = torch.zeros(64).index_add_(0, torch.arange(64), w[0])
    return counts, peak, rows


@entrypoint("jxa401_fires", phase_coverage_min=0.0)
def jxa401_fires():
    return EntryCase(fn=_old_deposit, args=_cells_and_weights())


@entrypoint("jxa401_snapshot", phase_coverage_min=0.0)
def jxa401_snapshot():
    from sphexa_torch.init import init_sedov

    state, box, _ = init_sedov(6, device="cpu")
    spec = snapshot.SnapshotSpec(fields=("rho", "temp"), grid=8)
    return EntryCase(fn=lambda s, rho: snapshot.deposit(s, rho, box, spec),
                     args=(state, torch.ones_like(state.m)))


@entrypoint("jxa401_clean", phase_coverage_min=0.0)
def jxa401_clean():
    return EntryCase(fn=_order_free, args=_cells_and_weights())
