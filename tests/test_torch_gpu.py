"""Kernel-vs-plain checks of the port's CUDA pair engine. They need an
NVIDIA card (marker ``gpu``) and skip without one; on the card run

    python -m pytest tests/test_torch_gpu.py -q

Each kernel and its plain PyTorch version get the same sorted Sedov state
on the card, on the fold case (side 12) and the shift case (side 24,
cell_target=16), with the JAX package's tolerances. The lattice is
jittered from a seed (``jitter_sedov``) so that every term of each pair
body, the viscosity and the IAD off-diagonals included, is non-zero."""

import pytest
import torch

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_sedov, jitter_sedov
from sphexa_torch.propagator import _force_stage_prologue
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std

pytestmark = pytest.mark.gpu

CASES = {"fold": (12, None), "shift": (24, 16)}


@pytest.fixture(params=list(CASES))
def case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    side, ct = CASES[request.param]
    fields, box, const = state_to_numpy(*init_sedov(side, device="cpu"))
    state, box, const = state_from_numpy(jitter_sedov(fields, side, seed=side), box,
                                         const, device="cuda")
    cfg = make_propagator_config(state, box, const, cell_target=ct)
    assert pe.engine_fold(box, cfg.nbr) == (request.param == "fold")
    ss, box, keys = _force_stage_prologue(state, box, cfg)
    ranges = pe.group_cell_ranges(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr)
    return ss, box, const, cfg.nbr, keys, ranges


def test_kernels_match_plain(case):
    ss, box, const, nbr, keys, ranges = case
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    pe.reset_launches()
    rho_k, nc_k, _ = pe.pallas_density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    rho_p, nc_p, _ = pe.density_plain(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
    assert torch.equal(nc_k, nc_p)
    torch.testing.assert_close(rho_k, rho_p, rtol=1e-5, atol=0.0)

    p, c = compute_eos_std(ss.temp, rho_k, const)
    vol = m / rho_k
    cs_k, _ = pe.pallas_iad(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)
    cs_p, _ = pe.iad_plain(x, y, z, h, vol, keys, box, const, nbr, ranges=ranges)
    scale = float(cs_p[0].abs().max())
    for a, b in zip(cs_k, cs_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)

    args = (x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho_k, p, c, *cs_k, keys, box, const, nbr)
    out_k = pe.pallas_momentum_energy_std(*args, ranges=ranges)
    out_p = pe.momentum_energy_std_plain(*args, ranges=ranges)
    for a, b in zip(out_k[:4], out_p[:4]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-6 * float(b.abs().max()) + 1e-12)
    assert float(out_k[4]) == pytest.approx(float(out_p[4]), rel=1e-5)
    assert pe.LAUNCHES == {"density": 1, "iad": 1, "momentum_energy_std": 1}


def test_wrapper_rejects_bad_input(case):
    ss, box, const, nbr, keys, ranges = case
    with pytest.raises(ValueError):
        pe.pallas_density(ss.x, ss.y, ss.z, ss.h, ss.m.double(), keys, box, const,
                          nbr, ranges=ranges)
