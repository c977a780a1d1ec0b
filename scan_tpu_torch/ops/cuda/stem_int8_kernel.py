"""All of int8 VGG16 stage 1 in one kernel: kernel K5 and its plain version.

Counterpart of ``scan_tpu/ops/pallas/stem_int8_kernel.py::fused_stem_int8``.
``fused_stem_int8`` launches ``csrc/stem_int8.cu`` for CUDA tensors and runs
``fused_stem_int8_plain`` for CPU tensors, never one in place of the other.
It counts its launches in ``fused_stem_int8.launches``.

Arithmetic, as ``scan_tpu``'s (``stem_int8_kernel.py:115-157``), with both
weights quantized per output channel from float32 and s0, s1, s_out
clamped at 1e-8:

    y_q = clip(round(relu(conv(x_q, w0_q) * (s0 * w0_s) + b0) / s1), 0, 127)
    z_q = clip(round((conv(y_q, w1_q) * (s1 * w1_s) + b1) / s_out), 0, 127)
    out = maxpool2x2(z_q)

Both convs are 3x3 with zero padding 1, so conv1_2 sees zeros outside the
image. The plain version requantizes, then pools, as the TPU kernel does;
the CUDA kernel pools the s32 sums, then requantizes once, which gives the
same bytes (see ``csrc/stem_int8.cu``). Both convs run on the tensor cores
(conv1_1 in K3's fragment layout, conv1_2 through ``csrc/stem_mma.cuh``);
s32 sums are exact in any order. Both requants (at s1 and at s_out)
divide only where a product lies within 2^-14 of a half-integer
(``tests/test_torch_stem_int8_mma.py`` proves that guard).

Layout: x_q (B, H, W, 3) s8 NHWC at scale s0; w0 (3, 3, 3, 64) and w1 (3, 3,
64, 64) HWIO float; returns (B, H/2, W/2, 64) s8 at scale s_out.

``pack_weights`` quantizes w0 and w1 and lays them out for the kernel; a
caller that runs the kernel many times on one pair packs it once and passes
it in.
"""

import ctypes

import torch

from ..quant import (clamp_scale, conv_s32, max_pool_2x2, prepare_weight,
                     quantize_weight)
from . import build, refuse_autograd
from .conv0_kernel import pack_weight

CH = 64


def fused_stem_int8_plain(x_q, w0, b0, w1, b1, s0, s1, s_out):
    """Plain PyTorch K5: the ``int8_conv`` chain of ``STEM_S8_EPILOGUE``."""
    s0, s1, so = (clamp_scale(s, x_q) for s in (s0, s1, s_out))
    w0_q, w0_s = quantize_weight(w0)
    w1_q, w1_s = quantize_weight(w1)
    pad = ((1, 1), (1, 1))
    acc0 = conv_s32(x_q, prepare_weight(w0_q, w0_s), (1, 1), pad)
    y = torch.clamp_min(acc0.float() * (s0 * w0_s) + b0.float(), 0.0)
    y_q = torch.clamp(torch.round(y / s1), 0, 127).to(torch.int8)
    acc1 = conv_s32(y_q, prepare_weight(w1_q, w1_s), (1, 1), pad)
    z = acc1.float() * (s1 * w1_s) + b1.float()
    z_q = torch.clamp(torch.round(z / so), 0, 127).to(torch.int8)
    return max_pool_2x2(z_q)


def _lib():
    fn = build.load("stem_int8").scan_stem_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pack_weights(w0, w1):
    """-> (w0 words (64, 16), w0 scale (64,), w1 (64, 9, 64) s8, w1 scale
    (64,)): both kernels quantized per output channel from float32. w0 in
    K3's layout (``conv0_kernel.pack_weight``), the B operand of conv1_1's
    m16n8k32 GEMM: int32 words [co][4 ky + kx] of the three input channels
    (c0, c1, c2, 0), zero for kx = 3 or ky = 3; w1 as [co][tap][ci], K
    contiguous, the B operand of conv1_2's."""
    w0k, w0_s = pack_weight(w0)
    w1_q, w1_s = quantize_weight(w1)
    w1k = w1_q.permute(3, 0, 1, 2).reshape(CH, 9, CH).contiguous()
    return w0k, w0_s, w1k, w1_s


def fused_stem_int8(x_q, w0, b0, w1, b1, s0, s1, s_out, packed=None):
    """x_q (B, H, W, 3) int8 at scale s0 -> (B, H/2, W/2, 64) int8 at s_out.

    ``packed`` is ``pack_weights(w0, w1)`` (made here when None); the plain
    version quantizes the weights itself. Raises under autograd
    (``refuse_autograd``): the kernel is for inference."""
    refuse_autograd("fused_stem_int8", x_q, w0, b0, w1, b1)
    if x_q.device.type == "cpu":
        return fused_stem_int8_plain(x_q, w0, b0, w1, b1, s0, s1, s_out)
    if x_q.device.type != "cuda":
        raise ValueError(f"fused_stem_int8: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or x_q.shape[-1] != 3:
        raise ValueError(f"fused_stem_int8: x_q must be (B, H, W, 3) int8, "
                         f"got {tuple(x_q.shape)} {x_q.dtype}")
    if (tuple(w0.shape) != (3, 3, 3, CH) or tuple(w1.shape) != (3, 3, CH, CH)
            or tuple(b0.shape) != (CH,) or tuple(b1.shape) != (CH,)):
        raise ValueError(
            f"fused_stem_int8: the kernel takes the full-width VGG16 stem "
            f"(w0 (3, 3, 3, 64), w1 (3, 3, 64, 64)); got {tuple(w0.shape)}, "
            f"{tuple(w1.shape)}")
    dev = x_q.device
    s0, s1, so = (clamp_scale(s, x_q) for s in (s0, s1, s_out))
    w0k, w0_s, w1k, w1_s = pack_weights(w0, w1) if packed is None else packed
    a0 = s0 * w0_s
    a1 = s1 * w1_s
    b0f = b0.float().contiguous()
    b1f = b1.float().contiguous()
    x_q = x_q.contiguous()
    b, h, w, _ = x_q.shape
    out = torch.empty((b, h // 2, w // 2, CH), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib()(x_q.data_ptr(), w0k.data_ptr(), w1k.data_ptr(),
                     a0.data_ptr(), b0f.data_ptr(), a1.data_ptr(),
                     b1f.data_ptr(), s1.data_ptr(), so.data_ptr(),
                     out.data_ptr(), b, h, w,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stem_int8 launch failed: CUDA error {err}")
    fused_stem_int8.launches += 1
    return out


fused_stem_int8.launches = 0
