"""Smoothing kernel fit, the gather ops' per-pair closed forms (W,
dterh, the artificial viscosity, the Courant dt) and the smoothing-length
update (sphexa_tpu/sph/kernels.py, the parts the std and VE pipelines
read).

W is a degree-13 polynomial in s = v^2/2 - 1 fitted with the same numpy
Chebyshev fit as the JAX package, so the 14 coefficients are identical;
the VE grad-h term's dterh = -(3 W + v dW/dv) is derived from them.
"""

import functools

import numpy as np
import torch

SUPPORT = 2.0  # kernel support radius in units of h
KERNEL_CHOICES = ("sinc", "sinc-n1-n2", "wendland-c6")


def _kernel_samples(v: np.ndarray, n: float, kind: str) -> np.ndarray:
    """W(v) on v in [0, 2] in float64 (fit/normalization reference)."""
    def sincn(e):
        pv = 0.5 * np.pi * v
        s = np.ones_like(v)
        nz = v > 0
        s[nz] = np.sin(pv[nz]) / pv[nz]
        return s ** float(e)

    if kind == "sinc":
        return sincn(n)
    if kind == "sinc-n1-n2":
        return 0.9 * sincn(4.0) + 0.1 * sincn(9.0)
    if kind == "wendland-c6":
        q = np.clip(v / 2.0, 0.0, 1.0)
        return (1.0 - q) ** 8 * (1.0 + 8.0 * q + 25.0 * q**2 + 32.0 * q**3)
    raise ValueError(f"unknown kernel kind {kind!r} (choices: {KERNEL_CHOICES})")


@functools.lru_cache(maxsize=None)
def kernel_poly_coeffs(n: float, kind: str = "sinc", degree: int = 0) -> tuple:
    """Power coefficients (float64) of W as a polynomial in s = v^2/2 - 1,
    from a Chebyshev fit on u = v^2 in [0, 4]."""
    if degree == 0:
        degree = 13 if kind.startswith("sinc") else 19
    t = np.cos(np.linspace(0.0, np.pi, 4000))
    u = 2.0 * (t + 1.0)
    w = _kernel_samples(np.sqrt(u), float(n), kind)
    cheb = np.polynomial.chebyshev.Chebyshev.fit(t, w, degree, domain=[-1, 1])
    coeffs = cheb.convert(kind=np.polynomial.Polynomial).coef
    return tuple(float(c) for c in coeffs)


def sinc_poly_eval(u: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner evaluation of W from the squared normalized distance u,
    clamped to the support and floored at 0. Each coefficient enters as a
    Python float and is rounded to float32 by the op, as in JAX."""
    s = torch.clamp(u * 0.5 - 1.0, -1.0, 1.0)
    acc = torch.full_like(s, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * s + c
    return torch.clamp_min(acc, 0.0)


@functools.lru_cache(maxsize=None)
def kernel_dterh_coeffs(n: float, kind: str = "sinc", degree: int = 0) -> tuple:
    """Coefficients of dterh(v) = -(3 W + v dW/dv) in s = v^2/2 - 1,
    derived from the W fit: with W = p(s), v dW/dv = 2 (s + 1) p'(s), so
    dterh = -(3 p + 2 (s + 1) p')."""
    c = kernel_poly_coeffs(n, kind, degree)
    d = []
    for k in range(len(c)):
        v = (3.0 + 2.0 * k) * c[k]
        if k + 1 < len(c):
            v += 2.0 * (k + 1) * c[k + 1]
        d.append(-v)
    return tuple(d)


def dterh_poly_eval(u: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner evaluation of dterh from u = (d/h)^2, clamped to the support
    like ``sinc_poly_eval`` but with no zero floor (dterh is negative
    inside the support)."""
    s = torch.clamp(u * 0.5 - 1.0, -1.0, 1.0)
    acc = torch.full_like(s, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * s + c
    return acc


def sinc_kernel_u(u: torch.Tensor, n: float = 6.0, kind: str = "sinc") -> torch.Tensor:
    """W from the squared normalized distance u = (d/h)^2."""
    return sinc_poly_eval(u, kernel_poly_coeffs(float(n), kind))


def sinc_dterh_u(u: torch.Tensor, n: float = 6.0, kind: str = "sinc") -> torch.Tensor:
    """dterh = -(3 W + v dW/dv) from the squared normalized distance."""
    return dterh_poly_eval(u, kernel_dterh_coeffs(float(n), kind))


def artificial_viscosity(alpha_i, alpha_j, c_i, c_j, w_ij, beta: float = 2.0):
    """Monaghan signal-velocity artificial viscosity (kernels.hpp:60-84):
    only approaching pairs (w_ij < 0) dissipate."""
    v_signal = 0.25 * (alpha_i + alpha_j) * (c_i + c_j) - beta * w_ij
    return torch.where(w_ij < 0.0, -v_signal * w_ij, 0.0)


def ts_k_courant(maxvsignal, h, c, k_cour):
    """Courant time step from the max signal velocity (kernels.hpp:9-16)."""
    return k_cour * h / torch.where(maxvsignal > 0.0, maxvsignal, c)


def kernel_norm_3d(n: float = 6.0, kind: str = "sinc",
                   support: float = SUPPORT, num: int = 20001) -> float:
    """3D normalization K with integral K W(|x|/h) h^-3 d^3x = 1 (Simpson)."""
    if num % 2 == 0:
        num += 1
    x = np.linspace(0.0, support, num)
    f = 4.0 * np.pi * x**2 * _kernel_samples(x, n, kind)
    dx = x[1] - x[0]
    integral = dx / 3.0 * (f[0] + f[-1] + 4.0 * f[1:-1:2].sum() + 2.0 * f[2:-1:2].sum())
    return float(1.0 / integral)


def update_h(ng0: int, nc: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Nudge h so the neighbour count (self included) drifts toward ng0."""
    c0 = 1023.0
    return h * 0.5 * (1.0 + c0 * ng0 / torch.clamp_min(nc, 1)) ** 0.1
