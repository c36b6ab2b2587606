"""SPH physics of the port (sphexa_tpu/sph)."""
