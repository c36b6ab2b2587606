"""Per-step analysis reductions (sphexa_tpu/observables): conserved
quantities, the science ledger computed inside the step, the case
observables and constants.txt output."""

from sphexa_torch.observables.conserved import conserved_quantities
from sphexa_torch.observables.extras import kh_growth_rate, mach_rms, wind_bubble_fraction
from sphexa_torch.observables.factory import BASE_COLUMNS, ConstantsWriter, make_observable
from sphexa_torch.observables.ledger import (
    NUM_DIAG_KEYS,
    OBS_DIAG_KEYS,
    ObservableSpec,
    ledger_diagnostics,
    make_observable_spec,
)

__all__ = [
    "conserved_quantities",
    "kh_growth_rate",
    "mach_rms",
    "wind_bubble_fraction",
    "make_observable",
    "make_observable_spec",
    "ObservableSpec",
    "ledger_diagnostics",
    "ConstantsWriter",
    "BASE_COLUMNS",
    "OBS_DIAG_KEYS",
    "NUM_DIAG_KEYS",
]
