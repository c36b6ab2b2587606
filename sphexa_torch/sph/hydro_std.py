"""Standard-SPH EOS (sphexa_tpu/sph/hydro_std.py:compute_eos_std)."""

import torch

from sphexa_torch.sph.particles import SimConstants


def compute_eos_std(temp: torch.Tensor, rho: torch.Tensor, const: SimConstants):
    """Ideal-gas EOS from temperature (eos.hpp idealGasEOS): returns (p, c)."""
    tmp = const.cv * temp * (const.gamma - 1.0)
    return rho * tmp, torch.sqrt(tmp)
