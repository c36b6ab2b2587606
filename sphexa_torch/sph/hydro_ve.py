"""VE equation of state (sphexa_tpu/sph/hydro_ve.py:compute_eos_ve). The
VE pair ops themselves are the fused search+op kernels of
sph/pair_engine.py."""

import torch

from sphexa_torch.sph.particles import SimConstants


def compute_eos_ve(temp: torch.Tensor, m: torch.Tensor, kx: torch.Tensor,
                   xm: torch.Tensor, gradh: torch.Tensor, const: SimConstants):
    """VE ideal-gas EOS (hydro_ve/eos.hpp:52-77): returns (prho, c, rho, p),
    where prho = p / (kx m^2 gradh) enters the momentum sum."""
    rho = kx * m / xm
    tmp = const.cv * temp * (const.gamma - 1.0)
    p = rho * tmp
    c = torch.sqrt(tmp)
    prho = p / (kx * m * m * gradh)
    return prho, c, rho, p
