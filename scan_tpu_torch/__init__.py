"""scan_tpu_torch: the PyTorch/CUDA port of ``scan_tpu`` for NVIDIA Hopper.

The layout mirrors ``scan_tpu`` module for module, so each counterpart is
easy to find. Public functions keep ``scan_tpu``'s NHWC layout; inside,
tensors are ``torch.channels_last`` NCHW, so the permute between the two is
a free view. The kernels ``scan_tpu`` wrote in Pallas are hand-written CUDA
C++ for ``sm_90a`` under ``csrc/``, built at first use (``ops/cuda/build.py``).

This first slice covers the fp32/bf16 eval forward of the SCAN detector
(VGG16-FPN, condgraph inference, FCOS head in all three ``TEST.MODE``s and
the postprocess). It imports ``torch``, ``numpy`` and ``yaml``; never JAX,
flax or ``scan_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
