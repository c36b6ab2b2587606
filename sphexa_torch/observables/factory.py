"""Observable selection and constants.txt output
(sphexa_tpu/observables/factory.py; the reference's
``observables/factory.hpp:46-70`` and ``iobservables.hpp``). The base row
is iteration, time, minDt, etot, ecin, eint, egrav; case observables
append their own columns. The observables here name the columns (and
hold the wind bubble's thresholds): the values come from the science
ledger computed in the step (observables/ledger.py)."""

import math
import os
from typing import Dict, List, Optional

from sphexa_torch.init.wind_shock import wind_shock_constants
from sphexa_torch.sph.particles import ideal_gas_cv

BASE_COLUMNS = ["iteration", "time", "minDt", "etot", "ecin", "eint", "egrav"]


class TimeAndEnergy:
    """Default observable: energies only (time_energies.hpp)."""

    extra_columns: List[str] = []


class TimeEnergyGrowth:
    """KH growth-rate column (time_energy_growth.hpp)."""

    extra_columns = ["khGrowthRate"]


class TurbulenceMachRMS:
    """RMS Mach number column (turbulence_mach_rms.hpp)."""

    extra_columns = ["machRMS"]


class WindBubble:
    """Surviving cloud-mass fraction column (wind_bubble_fraction.hpp) and
    its thresholds."""

    extra_columns = ["survivorFraction"]

    def __init__(self, settings: Dict[str, float]):
        cv = ideal_gas_cv(settings["mui"], settings["gamma"])
        self.rho_bubble = settings["rhoInt"]
        self.temp_wind = settings["uExt"] / cv
        self.initial_mass = 4.0 / 3.0 * math.pi * settings["rSphere"] ** 3 * settings["rhoInt"]


def make_observable(case: str, overrides: Optional[Dict[str, float]] = None):
    """Observable for a test case, keyed like the reference factory
    (factory.hpp:46-70: 'kelvin-helmholtz', 'wind-shock', 'turbulence').
    ``overrides`` are the case's settings overrides, so threshold-bearing
    observables match the actual setup."""
    if case == "kelvin-helmholtz":
        return TimeEnergyGrowth()
    if case == "wind-shock":
        return WindBubble(dict(wind_shock_constants(), **(overrides or {})))
    if case == "turbulence":
        return TurbulenceMachRMS()
    return TimeAndEnergy()


class ConstantsWriter:
    """Append one observable row per iteration to constants.txt
    (iobservables.hpp / fileutils::writeColumns), byte for byte the JAX
    package's format. The rows are the ledger's, read by the Simulation
    at its check or flush boundaries (``drain_science``).
    ``restart_iteration``: a restarted run appends to the file it finds,
    after dropping the rows past that iteration."""

    def __init__(self, path: str, observable=None, restart_iteration: Optional[int] = None):
        self.path = path
        self.observable = observable or TimeAndEnergy()
        # appending to an existing file (restart) writes no second header
        self._wrote_header = os.path.exists(path) and os.path.getsize(path) > 0
        if restart_iteration is not None and self._wrote_header:
            self._truncate_after(restart_iteration)

    def _truncate_after(self, iteration: int) -> None:
        """Drop the rows with iteration > the restart point, so that a run
        resumed from an older dump leaves a monotonic series."""
        with open(self.path) as f:
            lines = f.readlines()
        kept = [ln for ln in lines
                if ln.startswith("#") or not ln.strip() or float(ln.split()[0]) <= iteration]
        if len(kept) != len(lines):
            with open(self.path, "w") as f:
                f.writelines(kept)

    def write_row(self, values) -> List[float]:
        """Append one row (no device read here)."""
        row = [float(v) for v in values]
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write("# " + " ".join(BASE_COLUMNS + self.observable.extra_columns) + "\n")
                self._wrote_header = True
            f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
        return row
