"""3D Hilbert key codec on int64 tensors (sphexa_tpu/sfc/hilbert.py).

Skilling's transpose algorithm ("Programming the Hilbert curve", AIP
Conf. Proc. 707, 2004), step for step as the JAX package, so keys agree
bitwise. Values stay below 2**30, so int64 holds the uint32 keys exactly.
"""

import torch

from sphexa_torch.dtypes import KEY_BITS, KEY_DTYPE
from sphexa_torch.sfc.morton import _compact_bits_3d, _spread_bits_3d


def _axes_to_transpose(x0, x1, x2, bits):
    """Grid coords -> Hilbert transpose form (Skilling AxestoTranspose)."""
    X = [x0.to(KEY_DTYPE), x1.to(KEY_DTYPE), x2.to(KEY_DTYPE)]
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            cond = (X[i] & q) != 0
            t = (X[0] ^ X[i]) & p
            x0_new = torch.where(cond, X[0] ^ p, X[0] ^ t)
            xi_new = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0_new
            if i != 0:
                X[i] = xi_new
        q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return [X[0] ^ t, X[1] ^ t, X[2] ^ t]


def _transpose_to_axes(x0, x1, x2, bits):
    """Inverse of :func:`_axes_to_transpose` (Skilling TransposetoAxes)."""
    X = [x0.to(KEY_DTYPE), x1.to(KEY_DTYPE), x2.to(KEY_DTYPE)]
    t = X[2] >> 1
    X[2] = X[2] ^ X[1]
    X[1] = X[1] ^ X[0]
    X[0] = X[0] ^ t
    q = 2
    while q != (1 << bits):
        p = q - 1
        for i in (2, 1, 0):
            cond = (X[i] & q) != 0
            t = (X[0] ^ X[i]) & p
            x0_new = torch.where(cond, X[0] ^ p, X[0] ^ t)
            xi_new = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0_new
            if i != 0:
                X[i] = xi_new
        q <<= 1
    return X


def hilbert_encode(ix, iy, iz, bits: int = KEY_BITS) -> torch.Tensor:
    """Encode grid coordinates in ``[0, 2**bits)`` into Hilbert keys."""
    x0, x1, x2 = _axes_to_transpose(ix, iy, iz, bits)
    return (_spread_bits_3d(x0) << 2) | (_spread_bits_3d(x1) << 1) | _spread_bits_3d(x2)


def hilbert_decode(key: torch.Tensor, bits: int = KEY_BITS):
    """Decode Hilbert keys back into (ix, iy, iz) grid coordinates."""
    key = key.to(KEY_DTYPE)
    X = _transpose_to_axes(_compact_bits_3d(key >> 2), _compact_bits_3d(key >> 1),
                           _compact_bits_3d(key), bits)
    return X[0], X[1], X[2]
