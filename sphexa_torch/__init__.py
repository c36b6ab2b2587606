"""PyTorch/CUDA port of sphexa-tpu for NVIDIA Hopper GPUs.

The JAX package ``sphexa_tpu`` stays the reference; this package is its
counterpart in PyTorch. Module names and public signatures follow the JAX
package so each function's counterpart is easy to find. Per-particle
fields are 1-D float32 tensors in SFC order, as there.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the pair-engine wrappers launch hand-written CUDA
kernels for CUDA tensors and run their plain PyTorch versions for CPU
tensors.
"""

from sphexa_torch.device import resolve_device

__all__ = ["resolve_device"]
