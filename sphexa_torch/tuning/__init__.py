"""Autotuning of the port (sphexa_tpu/tuning): the observe -> decide loop
over the telemetry stack. A typed knob registry (knobs.py), a workload
replay harness scored by the Simulation's own window clock (replay.py), a
budgeted search driver (search.py), and the port's committed
per-(workload, N bucket, P, backend) table (table.py,
``TUNING_TABLE_TORCH.json``) that ``Simulation(tuned=...)`` resolves at
configuration time. ``python -m sphexa_torch.tuning`` runs a sweep.

Importing this package validates the knob registry against the live
config dataclasses and signatures: a renamed field fails here, at the
first ``import sphexa_torch.tuning``, instead of a committed table
silently de-tuning every later run.
"""

from sphexa_torch.tuning.knobs import (
    BLOCKDT_KNOBS,
    COST_RECONFIGURE,
    COST_STATIC,
    GRAVITY_KNOBS,
    KNOBS,
    NEIGHBOR_KNOBS,
    SIMULATION_KNOBS,
    KnobSpec,
    knob_names,
    validate_registry,
)

validate_registry()

from sphexa_torch.tuning.replay import (  # noqa: E402
    ReplaySpec,
    build_case,
    measure_candidate,
    spec_from_manifest,
    static_cost_candidate,
)
from sphexa_torch.tuning.search import domains_for, run_sweep  # noqa: E402
from sphexa_torch.tuning.table import (  # noqa: E402
    TABLE_SCHEMA,
    coverage,
    default_table_path,
    load_table,
    make_entry,
    n_bucket,
    new_table,
    resolve_entry,
    resolve_knobs,
    save_table,
    upsert_entry,
    validate_table,
)

__all__ = [
    "KnobSpec", "KNOBS", "knob_names", "validate_registry",
    "COST_STATIC", "COST_RECONFIGURE",
    "GRAVITY_KNOBS", "NEIGHBOR_KNOBS", "SIMULATION_KNOBS",
    "BLOCKDT_KNOBS",
    "ReplaySpec", "spec_from_manifest", "build_case", "measure_candidate",
    "static_cost_candidate",
    "domains_for", "run_sweep",
    "TABLE_SCHEMA", "default_table_path", "n_bucket", "new_table",
    "load_table", "save_table", "validate_table", "resolve_entry",
    "resolve_knobs", "upsert_entry", "make_entry", "coverage",
]
