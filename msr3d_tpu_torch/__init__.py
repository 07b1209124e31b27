"""PyTorch/CUDA port of msr3d_tpu for NVIDIA Hopper (H100).

The JAX package ``msr3d_tpu`` is the reference this package is held
against; nothing here imports it. Plain tensor code is PyTorch; the Pallas
kernels of the serving and training paths are hand-written CUDA under
``csrc/`` (FPS, the flash-attention forward and its backward), built with
``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from msr3d_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
