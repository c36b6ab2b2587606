"""Initial conditions of the port (sphexa_tpu/init: the Sedov, Noh,
Gresho-Chan and Evrard cases)."""

from sphexa_torch.init.evrard import init_evrard
from sphexa_torch.init.gresho_chan import init_gresho_chan
from sphexa_torch.init.noh import init_noh
from sphexa_torch.init.sedov import init_sedov, jitter_sedov, stretch_box

__all__ = ["init_evrard", "init_gresho_chan", "init_noh", "init_sedov", "jitter_sedov",
           "stretch_box"]
