"""Evrard-collapse normalized-unit profiles.

Counterpart of the reference's ``main/src/analytical_solutions/
compare_evrard.py``: there is no closed-form solution — the comparator
converts a state into the normalized units of Evrard (1988) /
Steinmetz & Muller (1993) and produces binned radial profiles for
comparison against published curves (the reference CI runs evrard as
sanity-only, with L1 placeholders of 0.0, .jenkins/reframe_ci.py:364-369).

The JAX package's sphexa_tpu/analysis/evrard.py, copied: numpy and scipy
only, so that the port imports nothing of that package.
"""

from typing import Dict

import numpy as np


def evrard_norms(R: float = 1.0, M: float = 1.0, G: float = 1.0) -> Dict[str, float]:
    """Normalization constants (compare_evrard.py header): time, density,
    internal energy and velocity units of the collapse problem."""
    return {
        "time": float(np.sqrt(np.pi**2 / 8.0) * R**1.5 / np.sqrt(G * M)),
        "rho": float(3.0 * M / (4.0 * np.pi * R**3)),
        "u": float(G * M / R),
        "vel": float(np.sqrt(G * M / R)),
    }


def radial_profile(r, values, bins: int = 50, r_max=None) -> Dict[str, np.ndarray]:
    """Mass-less radial binning: mean of ``values`` per logarithmic-ish
    radius bin, the 1-D profile the reference's plots draw."""
    r = np.asarray(r, np.float64)
    values = np.asarray(values, np.float64)
    if r_max is None:
        r_max = float(r.max())
    edges = np.linspace(0.0, r_max, bins + 1)
    idx = np.clip(np.digitize(r, edges) - 1, 0, bins - 1)
    count = np.bincount(idx, minlength=bins).astype(np.float64)
    mean = np.bincount(idx, weights=values, minlength=bins)
    mean = np.divide(mean, count, out=np.zeros(bins), where=count > 0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return {"r": centers, "mean": mean, "count": count}


def evrard_normalized_profiles(
    fields: Dict[str, np.ndarray], time: float,
    R: float = 1.0, M: float = 1.0, G: float = 1.0, bins: int = 50,
) -> Dict[str, np.ndarray]:
    """Radial rho/u/vel profiles in normalized units at normalized time
    t' = t / timeNorm — directly comparable to the published curves
    (Steinmetz & Muller 1993, fig. 10; the collapse bounce is at
    t' ~ 0.77)."""
    norms = evrard_norms(R, M, G)
    out = {"t_norm": np.float64(time / norms["time"])}
    for key, norm in (("rho", norms["rho"]), ("u", norms["u"]),
                      ("vel", norms["vel"])):
        prof = radial_profile(fields["r"], fields[key] / norm, bins=bins,
                              r_max=R)
        out[f"{key}_profile"] = prof["mean"]
        out["r_bins"] = prof["r"]
    return out
