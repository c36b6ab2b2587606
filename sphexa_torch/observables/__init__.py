"""Conservation diagnostics (sphexa_tpu/observables)."""
