"""Space-filling-curve keys and the global box (sphexa_tpu/sfc)."""

from sphexa_torch.sfc.box import BoundaryType, Box, apply_pbc_xyz, make_global_box, put_in_box
from sphexa_torch.sfc.hilbert import hilbert_decode, hilbert_encode
from sphexa_torch.sfc.keys import compute_sfc_keys, coords_to_igrid
from sphexa_torch.sfc.morton import morton_decode, morton_encode

__all__ = [
    "BoundaryType", "Box", "apply_pbc_xyz", "make_global_box", "put_in_box",
    "hilbert_encode", "hilbert_decode", "morton_encode", "morton_decode", "compute_sfc_keys", "coords_to_igrid",
]
