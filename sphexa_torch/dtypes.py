"""Dtype policy of the port (counterpart of sphexa_tpu/dtypes.py).

- SFC keys: 30-bit values (10 octree levels x 3 bits) held in int64.
  torch's uint32 coverage (shifts, comparisons, sort) is partial, and the
  key values never reach the sign bit, so int64 orders them exactly as
  the JAX package's uint32 keys.
- coordinates and hydro fields: float32.
"""

import torch

KEY_DTYPE = torch.int64
KEY_BITS = 10  # octree levels encodable in a key
KEY_MAX = 1 << (3 * KEY_BITS)

COORD_DTYPE = torch.float32
HYDRO_DTYPE = torch.float32
INDEX_DTYPE = torch.int32
