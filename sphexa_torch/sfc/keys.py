"""Float coordinates -> integer grid -> SFC keys (sphexa_tpu/sfc/keys.py)."""

import torch

from sphexa_torch.dtypes import INDEX_DTYPE, KEY_BITS, KEY_DTYPE
from sphexa_torch.sfc.box import Box
from sphexa_torch.sfc.hilbert import hilbert_encode
from sphexa_torch.sfc.morton import morton_encode


def coords_to_igrid(v, vmin, vmax, bits: int = KEY_BITS) -> torch.Tensor:
    """Map float32 coordinates in [vmin, vmax] to integers in [0, 2**bits).

    The same float32 steps as the JAX package, ``(v - vmin) / (vmax -
    vmin) * n``, then truncation toward zero, then the clip, so keys
    agree bitwise on cell edges and box faces."""
    n = 1 << bits
    scaled = (v - vmin) / (vmax - vmin) * n
    return torch.clamp(scaled.to(INDEX_DTYPE), 0, n - 1).to(KEY_DTYPE)


def compute_sfc_keys(x, y, z, box: Box, bits: int = KEY_BITS,
                     curve: str = "hilbert") -> torch.Tensor:
    """SFC keys (int64) of particle positions under the global box."""
    ix = coords_to_igrid(x, box.lo[0], box.hi[0], bits)
    iy = coords_to_igrid(y, box.lo[1], box.hi[1], bits)
    iz = coords_to_igrid(z, box.lo[2], box.hi[2], bits)
    if curve == "hilbert":
        return hilbert_encode(ix, iy, iz, bits)
    if curve == "morton":
        return morton_encode(ix, iy, iz, bits)
    raise ValueError(f"unknown curve {curve!r}")
