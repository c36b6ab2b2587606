"""Gresho-Chan vortex comparator.

Counterpart of the reference's ``main/src/analytical_solutions/
compare_gresho_chan.py``: the stationary triangular azimuthal-velocity
profile (Gresho & Chan 1990) evaluated at each particle's cylindrical
radius, and the same mean-absolute-deviation L1 metric.

The JAX package's sphexa_tpu/analysis/gresho_chan.py, copied: numpy and scipy
only, so that the port imports nothing of that package.
"""

from typing import Dict

import numpy as np


def gresho_chan_vphi(r: np.ndarray) -> np.ndarray:
    """Analytic azimuthal velocity: 5r inside r=0.2, 2-5r to r=0.4, 0
    beyond (compare_gresho_chan.py analyticalVelocity)."""
    r = np.asarray(r, np.float64)
    return np.where(
        r < 0.2, 5.0 * r, np.where(r < 0.4, 2.0 - 5.0 * r, 0.0)
    )


def gresho_chan_pressure(r: np.ndarray, p0: float = 5.0) -> np.ndarray:
    """Analytic pressure profile of the stationary vortex."""
    r = np.asarray(r, np.float64)
    inner = p0 + 12.5 * r**2
    mid = p0 + 12.5 * r**2 + 4.0 * (1.0 - 5.0 * r - np.log(0.2) + np.log(r))
    outer = p0 - 2.0 + 4.0 * np.log(2.0)
    return np.where(r < 0.2, inner, np.where(r < 0.4, mid, outer))


def cylindrical_vt(x, y, vx, vy) -> Dict[str, np.ndarray]:
    """Per-particle cylindrical radius + tangential velocity component
    (compare_gresho_chan.py compute2DRadiiAndVt)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    vx, vy = np.asarray(vx, np.float64), np.asarray(vy, np.float64)
    r = np.sqrt(x * x + y * y)
    rs = np.maximum(r, 1e-12)
    vt = (x * vy - y * vx) / rs
    return {"r": r, "vt": vt}


def gresho_chan_l1(x, y, vx, vy) -> float:
    """Mean absolute deviation of the tangential velocity from the
    analytic profile (compare_gresho_chan.py computeL1Error)."""
    d = cylindrical_vt(x, y, vx, vy)
    return float(np.mean(np.abs(d["vt"] - gresho_chan_vphi(d["r"]))))
