"""Device-side sizing (sphexa_tpu/parallel, the single-device parts)."""
