"""scan_tpu_torch: the PyTorch/CUDA port of ``scan_tpu`` for NVIDIA Hopper.

The layout mirrors ``scan_tpu`` module for module, so each counterpart is
easy to find. Public functions keep ``scan_tpu``'s NHWC layout; inside,
tensors are ``torch.channels_last`` NCHW, so the permute between the two is
a free view. The kernels ``scan_tpu`` wrote in Pallas are hand-written CUDA
C++ for ``sm_90a`` under ``csrc/``, built at first use (``ops/cuda/build.py``).

It covers the SCAN detector's eval forward (VGG16-FPN, condgraph, FCOS head
in all three ``TEST.MODE``s, the postprocess) in fp32/bf16 and w8a8 int8,
and its float32 domain-adaptive training step and loop. It imports
``torch``, ``numpy`` and ``yaml``; never JAX, flax or ``scan_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
