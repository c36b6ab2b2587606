"""Initial conditions of the port (sphexa_tpu/init: the Sedov and Noh cases)."""

from sphexa_torch.init.noh import init_noh
from sphexa_torch.init.sedov import init_sedov, jitter_sedov

__all__ = ["init_noh", "init_sedov", "jitter_sedov"]
