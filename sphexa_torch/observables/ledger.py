"""The science ledger computed inside the step
(sphexa_tpu/observables/ledger.py): conservation and numerics-health
reductions over the post-integration state, riding the step's
diagnostics (``OBS_DIAG_KEYS`` / ``NUM_DIAG_KEYS``) so that the driver
reads them with the rest of its scalars at a check or flush boundary:
no read of its own, and a science row for every step even under
``check_every`` > 1.

Stacked reductions, as in the JAX package: a (9, N) float sum
(``conserved.conserved_quantities``), a (5, N)
int sum, and the extrema (a (2, N) min and max |du|, the JAX package's
(3, N) min of rho, h and -|du|). The float sum accumulates in float64
on the device (the JAX package does when x64 is on; the reference
reduces in double). One CUDA stream orders them: no ``chain_after``.
"""

import dataclasses
from typing import Dict, Optional

import torch

from sphexa_torch.observables.conserved import conserved_from_sums, conserved_sums
from sphexa_torch.observables.extras import kh_growth_rate, mach_rms, wind_bubble_fraction
from sphexa_torch.observables.factory import make_observable
from sphexa_torch.util.phases import named_phase

#: conservation scalars of the step tail whenever PropagatorConfig.obs is
#: set, over the post-integration state; ``obs_extra`` (the case
#: observable) only when the spec names an ``extra``
OBS_DIAG_KEYS = ("obs_ttot", "obs_etot", "obs_ecin", "obs_eint",
                 "obs_egrav", "obs_linmom", "obs_angmom")

#: numerics-health scalars: the timestep limiter (``propagator.DT_LIMITERS``
#: names the index; the step produces it, always), the neighbour-cap clip
#: and h-saturation counts, nonfinite counts and extrema of rho/h/du
NUM_DIAG_KEYS = ("dt_limiter", "n_nc_clip", "n_h_sat", "n_bad_rho",
                 "n_bad_h", "n_bad_du", "rho_min", "h_min", "du_max")

#: constants.txt column name per case-extra kind (the factory
#: observables' ``extra_columns``)
EXTRA_COLUMNS = {"kh": "khGrowthRate", "mach": "machRMS",
                 "wind": "survivorFraction"}


@dataclasses.dataclass(frozen=True)
class ObservableSpec:
    """Static selection of the case observable computed in the step.
    ``extra`` is one of ``""`` (energies only), ``"kh"``, ``"mach"``,
    ``"wind"``; the threshold fields are read by the wind-bubble
    observable only."""

    extra: str = ""
    rho_bubble: float = 0.0
    temp_wind: float = 0.0
    initial_mass: float = 1.0

    def __post_init__(self):
        if self.extra not in ("",) + tuple(EXTRA_COLUMNS):
            raise ValueError(f"unknown observable extra {self.extra!r}; "
                             f"choices: {sorted(EXTRA_COLUMNS)}")


def make_observable_spec(case: str, overrides: Optional[Dict] = None) -> ObservableSpec:
    """ObservableSpec for a test case, derived through the factory
    observable (its case keying, columns and thresholds). A factory
    observable whose extra column has no ledger form raises."""
    obs = make_observable(case, overrides=overrides)
    cols = obs.extra_columns
    if not cols:
        return ObservableSpec()
    kinds = {col: kind for kind, col in EXTRA_COLUMNS.items()}
    if len(cols) != 1 or cols[0] not in kinds:
        raise ValueError(
            f"case observable {type(obs).__name__} (columns {cols}) has no ledger "
            f"implementation; add it to observables/ledger.py EXTRA_COLUMNS + "
            f"ledger_diagnostics")
    kind = kinds[cols[0]]
    if kind == "wind":
        return ObservableSpec(extra="wind", rho_bubble=float(obs.rho_bubble),
                              temp_wind=float(obs.temp_wind),
                              initial_mass=float(obs.initial_mass))
    return ObservableSpec(extra=kind)


@named_phase("ledger")
def ledger_diagnostics(state, rho, nc, const, ngmax: int,
                       spec: Optional[ObservableSpec] = None, egrav=None,
                       box=None, c=None, smoothing: bool = True,
                       mesh=None) -> Dict[str, torch.Tensor]:
    """The per-step science scalars (``OBS_DIAG_KEYS`` and the
    ``NUM_DIAG_KEYS`` this function owns) as 0-d device tensors.

    ``rho``/``c`` are the force stage's density and sound speed in the
    step's order; ``nc`` the neighbour count excluding self, as the force
    stage returns it (the counts use nc + 1, like the reference).
    ``egrav``: the force stage's 0-d
    gravitational energy, or None. The energies and momenta are
    ``conserved.conserved_quantities``'s. ``smoothing`` False (a step that
    never iterates h: N-body) reports zero cap-clip and h-saturation
    counts. ``mesh``: the state is this rank's slab; the sums, counts and
    extrema are reduced over the ranks (in one all_gather, sums in rank
    order), and every rank returns the same scalars."""
    sums = conserved_sums(state, const)

    # one (5, N) int sweep: cap clip, h saturation (a count off the ng0
    # target by more than half of it: the single nudge of update_h is far
    # from its fixed point) and the nonfinite counts of rho, h, du
    nc1 = nc + 1
    fields = torch.stack([rho, state.h, state.du])
    counts = torch.stack([nc1 >= ngmax, torch.abs(nc1 - const.ng0) > 0.5 * const.ng0])
    if not smoothing:
        counts = torch.zeros_like(counts)
    irows = torch.cat([counts, ~torch.isfinite(fields)])
    isum = torch.sum(irows, dim=1, dtype=torch.int32)
    # the field extrema: a (2, N) min and max |du|
    mins = torch.amin(fields[:2], dim=1)
    du_max = torch.amax(torch.abs(fields[2]))
    if mesh is not None:
        from sphexa_torch.parallel.mesh import reduce_scalars

        (sums, isum), (du_max,), (mins,) = reduce_scalars(mesh, sums=[sums, isum],
                                                          maxes=[du_max], mins=[mins])
    cq = conserved_from_sums(sums, egrav)
    out = {"obs_ttot": state.ttot, **{f"obs_{k}": cq[k] for k in (
        "etot", "ecin", "eint", "egrav", "linmom", "angmom")}}
    for k, name in enumerate(("n_nc_clip", "n_h_sat", "n_bad_rho", "n_bad_h", "n_bad_du")):
        out[name] = isum[k]
    out["rho_min"] = mins[0]
    out["h_min"] = mins[1]
    out["du_max"] = du_max

    if spec is not None and spec.extra:
        kw = {}
        if mesh is not None:
            from sphexa_torch.parallel.mesh import reduce_scalars

            kw["total"] = lambda t: reduce_scalars(mesh, sums=[t])[0][0]
        if spec.extra == "kh":
            out["obs_extra"] = kh_growth_rate(state.x, state.y, state.vy, state.m / rho, box,
                                              **kw)
        elif spec.extra == "mach":
            cs = c if c is not None else torch.full_like(rho, float("nan"))
            out["obs_extra"] = mach_rms(state.vx, state.vy, state.vz, cs, **kw)
        else:  # wind
            out["obs_extra"] = wind_bubble_fraction(rho, state.temp, state.m,
                                                    spec.rho_bubble, spec.temp_wind,
                                                    spec.initial_mass, **kw)
    return out
