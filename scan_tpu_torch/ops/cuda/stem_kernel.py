"""Fused VGG16 stage 1 (conv1_1, ReLU, conv1_2, ReLU, 2x2 max-pool):
kernel K2 and its plain version.

Counterpart of ``scan_tpu/ops/pallas/stem_kernel.py::fused_s2d_stem`` (and
its oracle ``reference_stem``). ``fused_stem`` launches ``csrc/stem.cu`` for
CUDA tensors and runs ``reference_stem`` for CPU tensors; it never falls
back from one to the other. The source note in ``csrc/stem.cu`` says what
bounds the kernel and what its design does about it: in bfloat16 both
convs run on the tensor cores (conv1_2 through ``csrc/stem_mma.cuh``), in
float32 on the CUDA cores.

Layout: x and the output are NHWC, as in ``scan_tpu``; the weights are
PyTorch's (O, I, kh, kw). ``pack_weights`` lays them out for the kernel; a
caller that runs it many times on one set of weights packs once and passes
the pack in.
"""

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build, refuse_autograd

STEM_IN = 3
STEM_CH = 64
W0_TAPS = 14  # bf16 w0: 9 taps padded with zeros (K 48 read, 112-byte rows)


def reference_stem(x, w0, b0, w1, b1, out_dtype=torch.float32):
    """Plain PyTorch stage 1: conv2d -> relu -> conv2d -> relu -> max_pool2d.

    x (B, H, W, 3) NHWC float; returns (B, H/2, W/2, C) NHWC in out_dtype.
    In bfloat16 every operand is cast first, as ``scan_tpu``'s bf16 stem
    does (``reference_stem(dtype=bfloat16)``).
    """
    dt = out_dtype
    xc = x.permute(0, 3, 1, 2).to(dt)
    y = F.relu(F.conv2d(xc, w0.to(dt), b0.to(dt), padding=1))
    z = F.relu(F.conv2d(y, w1.to(dt), b1.to(dt), padding=1))
    return F.max_pool2d(z, 2, 2).permute(0, 2, 3, 1)


class StemPack(NamedTuple):
    """The weights in the kernel's layouts, for one output dtype.

    bfloat16 (both convs on the tensor cores, K contiguous for their B
    operands): w0 (C, 14, 4) [co][tap][ci], taps 9-13 and ci 3 zero; w1
    (C, 9, C) [co][tap][ci]; b0, b1 (C,) float32 holding bfloat16 values, as
    the plain version's casts round them.
    float32: w0 (9, 3, C) [tap][ci][co]; w1 (C, 9, C) [ci][tap][co]; b0, b1
    (C,).
    """
    dtype: torch.dtype
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor


def pack_weights(w0, b0, w1, b1, out_dtype=None) -> StemPack:
    """w0 (C, 3, 3, 3), w1 (C, C, 3, 3) and the biases, in the kernel's
    layouts for ``out_dtype`` (default: the weights' dtype)."""
    dt = out_dtype or w0.dtype
    cout, cin = w1.shape[:2]

    def rounded(t):
        return t.to(dt).to(torch.float32).contiguous()

    if dt == torch.bfloat16:
        w0k = w0.new_zeros((cout, W0_TAPS, 4), dtype=dt)
        w0k[:, :9, :w0.shape[1]] = w0.to(dt).permute(0, 2, 3, 1).reshape(
            cout, 9, w0.shape[1])
        w1k = w1.to(dt).permute(0, 2, 3, 1).reshape(cout, 9, cin)
    else:
        w0k = w0.to(dt).permute(2, 3, 1, 0).reshape(9, w0.shape[1], cout)
        w1k = w1.to(dt).permute(1, 2, 3, 0).reshape(cin, 9, cout)
    return StemPack(dt, w0k.contiguous(), rounded(b0), w1k.contiguous(),
                    rounded(b1))


def _lib():
    fn = build.load("stem").scan_stem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def fused_stem(x, w0, b0, w1, b1, out_dtype=torch.float32, packed=None):
    """relu(maxpool2x2(conv3x3(relu(conv3x3(x, w0) + b0), w1) + b1)).

    x (B, H, W, 3) NHWC; w0 (64, 3, 3, 3), w1 (64, 64, 3, 3); returns
    (B, H // 2, W // 2, 64) NHWC in out_dtype (float32 or bfloat16). CPU
    tensors take the plain version; CUDA tensors launch kernel K2 or raise.
    ``packed`` is ``pack_weights(w0, b0, w1, b1, out_dtype)``, made here
    when None.

    K2 has no backward. With grad mode on, an input that requires grad
    makes this raise on every device (``refuse_autograd``) rather than give
    an output autograd would treat as a constant: training runs it on the
    frozen stem (``VGG16`` builds conv0..conv3 with ``requires_grad``
    False).
    """
    refuse_autograd("fused_stem", x, w0, b0, w1, b1)
    if x.device.type == "cpu":
        return reference_stem(x, w0, b0, w1, b1, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_stem: unsupported out_dtype {out_dtype}")
    if x.dim() != 4 or x.shape[-1] != STEM_IN:
        raise ValueError(f"fused_stem: x must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if (tuple(w0.shape) != (STEM_CH, STEM_IN, 3, 3)
            or tuple(w1.shape) != (STEM_CH, STEM_CH, 3, 3)):
        raise ValueError(
            f"fused_stem: the kernel takes the full-width VGG16 stem "
            f"(w0 (64,3,3,3), w1 (64,64,3,3)); got {tuple(w0.shape)}, "
            f"{tuple(w1.shape)}"
        )
    if packed is None:
        packed = pack_weights(w0, b0, w1, b1, out_dtype)
    elif packed.dtype != out_dtype:
        raise ValueError(f"fused_stem: weights packed for {packed.dtype}, "
                         f"called for {out_dtype}")
    b, h, w, _ = x.shape
    x = x.to(torch.float32).contiguous()
    out = torch.empty((b, h // 2, w // 2, STEM_CH), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), packed.w0.data_ptr(), packed.b0.data_ptr(),
            packed.w1.data_ptr(), packed.b1.data_ptr(), out.data_ptr(), b, h,
            w, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
