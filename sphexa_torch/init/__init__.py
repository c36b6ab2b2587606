"""Initial conditions of the port (sphexa_tpu/init, the Sedov case)."""

from sphexa_torch.init.sedov import init_sedov, jitter_sedov

__all__ = ["init_sedov", "jitter_sedov"]
