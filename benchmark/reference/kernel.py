"""The SPH smoothing kernel in closed form (SPH-EXA sph/kernels.hpp,
sph_kernel_tables.hpp): W(v) = sinc(pi v / 2)^n on v = d / h < 2, its
grad-h term dterh(v) = -(3 W + v dW/dv), and the 3-D normalisation K
with K h^-3 integral of W over space = 1."""

import math

import numpy as np
import torch

SUPPORT = 2.0


def sinc_w(v: torch.Tensor, n: float) -> torch.Tensor:
    """W(v), 0 at and beyond the support."""
    pv = (0.5 * math.pi) * v
    s = torch.where(pv > 0, torch.sin(pv) / torch.where(pv > 0, pv, 1.0), 1.0)
    return torch.where(v < SUPPORT, s**n, 0.0)


def sinc_dterh(v: torch.Tensor, n: float) -> torch.Tensor:
    """dterh(v) = -(3 W + v dW/dv); v dW/dv = n sinc^(n-1) (cos(pv) - sinc(pv))."""
    pv = (0.5 * math.pi) * v
    s = torch.where(pv > 0, torch.sin(pv) / torch.where(pv > 0, pv, 1.0), 1.0)
    vdw = n * s ** (n - 1.0) * (torch.cos(pv) - s)
    return torch.where(v < SUPPORT, -(3.0 * s**n + vdw), 0.0)


def kernel_norm(n: float) -> float:
    """K = 1 / integral_0^2 4 pi v^2 W(v) dv (Gauss-Legendre, float64)."""
    xg, wg = np.polynomial.legendre.leggauss(400)
    v = (xg + 1.0)
    pv = 0.5 * np.pi * v
    w = (np.sin(pv) / pv) ** n
    return float(1.0 / np.sum(wg * 4.0 * np.pi * v * v * w))
