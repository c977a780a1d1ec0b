"""conv1_1 of the int8 stem fused with its successor's quantize: kernel K3
and its plain version.

Counterpart of ``scan_tpu/ops/pallas/conv0_kernel.py::conv0_s8`` (and its
oracle ``reference_conv0_s8``). ``conv0_s8`` launches ``csrc/conv0.cu`` for
CUDA tensors and runs ``conv0_s8_plain`` for CPU tensors, never one in
place of the other. It counts its launches in ``conv0_s8.launches``.

Arithmetic, as ``scan_tpu``'s: w0 is quantized per output channel from the
float32 weights; the s32 3x3 conv (zero padding 1) is dequantized by
``s0 * w_scale``, the bias added, the result rounded to bf16, ReLU'd and
quantized at s1 with round-half-even and a clip to [-127, 127].

Layout: x_q (B, H, W, 3) s8 NHWC in, (B, H, W, 64) s8 NHWC out. The TPU
kernel's (B, H, W/2, 128) output is a reshape of the same bytes. w0 is HWIO
(3, 3, 3, 64). s0 and s1 are f32 scalar tensors; both are clamped at 1e-8,
as ``quantize_activation`` clamps a static scale.

``pack_weight`` quantizes w0 and lays it out for the kernel; a caller that
runs the kernel many times on one weight packs it once and passes it in.

The kernel runs the conv on the tensor cores and its epilogue without a
division: it multiplies by r = 1 / s1 (correctly rounded, as
``torch.reciprocal`` gives it). Each block first tries the 1,280 bf16
values that can give a byte other than 0 or 127 at this s1 against the
division; where one disagrees (1 of 2,000 seeded scales, and round ones
such as 7.0 or 0.9 more often), a second, guarded kernel
does the launch and divides wherever a product lies within 2**-14 of a
half-integer. ``csrc/conv0.cu`` says why that is exact;
``tests/test_torch_conv0_mma.py`` proves it on the CPU.
"""

import ctypes

import torch

from ..quant import clamp_scale, conv_s32, f32, prepare_weight, quantize_weight
from . import build, refuse_autograd

CH = 64


def conv0_s8_plain(x_q, w0, b0, s0, s1):
    """Plain PyTorch K3 (``reference_conv0_s8`` in NHWC)."""
    s0, s1 = clamp_scale(s0, x_q), clamp_scale(s1, x_q)
    w_q, w_scale = quantize_weight(w0)
    acc = conv_s32(x_q, prepare_weight(w_q, w_scale), (1, 1), ((1, 1), (1, 1)))
    y = (acc.float() * (w_scale * s0) + b0.float()).to(torch.bfloat16)
    y = torch.clamp_min(y.float(), 0.0)
    return torch.clamp(torch.round(y / s1), -127, 127).to(torch.int8)


def _lib():
    fn = build.load("conv0").scan_conv0_s8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pack_weight(w0):
    """w0 (3, 3, 3, 64) float HWIO -> (words (64, 16) int32, w_scale (64,)
    f32): quantized per output channel from float32. Row co holds the GEMM's
    K = 64 bytes of that channel: word 4 ky + kx is the bytes (w_c0, w_c1,
    w_c2, 0) of tap (ky, kx); the words with kx = 3 or ky = 3 are zero."""
    w_q, w_scale = quantize_weight(w0)
    wk = torch.zeros((CH, 4, 4, 4), dtype=torch.int8, device=w0.device)
    wk[:, :3, :3, :3] = w_q.permute(3, 0, 1, 2)
    return wk.view(torch.int32).reshape(CH, 16), w_scale


def conv0_s8(x_q, w0, b0, s0, s1, packed=None):
    """quantize(relu(bf16(conv3x3(x_q, quantize(w0)) * s0 * w_scale + b0)), s1).

    x_q (B, H, W, 3) int8 at scale s0; w0 (3, 3, 3, 64) float HWIO; b0 (64,).
    Returns (B, H, W, 64) int8 at scale s1. ``packed`` is ``pack_weight(w0)``
    (made here when None); the plain version quantizes w0 itself. Raises
    under autograd (``refuse_autograd``): the kernel is for inference."""
    refuse_autograd("conv0_s8", x_q, w0, b0)
    if x_q.device.type == "cpu":
        return conv0_s8_plain(x_q, w0, b0, s0, s1)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv0_s8: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or x_q.shape[-1] != 3:
        raise ValueError(f"conv0_s8: x_q must be (B, H, W, 3) int8, got "
                         f"{tuple(x_q.shape)} {x_q.dtype}")
    if tuple(w0.shape) != (3, 3, 3, CH) or tuple(b0.shape) != (CH,):
        raise ValueError(f"conv0_s8: the kernel takes the full-width conv1_1 "
                         f"(w0 (3, 3, 3, 64)); got {tuple(w0.shape)}")
    # the kernel floors s0 and s1 at 1e-8 and forms s0 * w_scale and 1 / s1
    # itself: a device float32 scalar passes with no copy and no launch
    s0, s1 = f32(s0, x_q).reshape(()), f32(s1, x_q).reshape(())
    wk, w_scale = pack_weight(w0) if packed is None else packed
    bias = b0.float().contiguous()
    x_q = x_q.contiguous()
    b, h, w, _ = x_q.shape
    out = torch.empty((b, h, w, CH), dtype=torch.int8, device=x_q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        err = _lib()(x_q.data_ptr(), wk.data_ptr(), w_scale.data_ptr(),
                     s0.data_ptr(), bias.data_ptr(), s1.data_ptr(),
                     out.data_ptr(), b, h, w,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv0_s8 launch failed: CUDA error {err}")
    conv0_s8.launches += 1
    return out


conv0_s8.launches = 0
