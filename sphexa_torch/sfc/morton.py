"""3D Morton key codec on int64 tensors (sphexa_tpu/sfc/morton.py)."""

import torch

from sphexa_torch.dtypes import KEY_DTYPE


def _spread_bits_3d(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits of ``v``."""
    v = v.to(KEY_DTYPE) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_encode(ix, iy, iz, bits: int = 10) -> torch.Tensor:
    """Interleave grid coordinates into 30-bit Morton keys, x most significant."""
    del bits
    return (_spread_bits_3d(ix) << 2) | (_spread_bits_3d(iy) << 1) | _spread_bits_3d(iz)


def _compact_bits_3d(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_spread_bits_3d`: extract every third bit."""
    v = v.to(KEY_DTYPE) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton_decode(key: torch.Tensor, bits: int = 10):
    """Recover (ix, iy, iz) grid coordinates from Morton keys."""
    del bits
    key = key.to(KEY_DTYPE)
    return _compact_bits_3d(key >> 2), _compact_bits_3d(key >> 1), _compact_bits_3d(key)
