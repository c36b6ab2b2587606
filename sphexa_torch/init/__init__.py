"""Initial conditions of the port (sphexa_tpu/init: the Sedov, Noh and
Gresho-Chan cases)."""

from sphexa_torch.init.gresho_chan import init_gresho_chan
from sphexa_torch.init.noh import init_noh
from sphexa_torch.init.sedov import init_sedov, jitter_sedov

__all__ = ["init_gresho_chan", "init_noh", "init_sedov", "jitter_sedov"]
