"""The stem's pooled tails on the int8 path: kernels K4 and K6 and their
plain versions.

Counterparts of ``scan_tpu/ops/pallas/phase_max_kernel.py``:

* ``phase_max_requant`` (K4, ``csrc/phase_max.cu``): 2x2 max, ReLU and the
  successor's requant, ``clip(round(relu(max) / s_out), -127, 127)`` as s8.
  The max and ReLU run in the input dtype (bf16 or f32), the division in
  f32.
* ``pair_phase_max_s8`` (K6, ``csrc/pair_phase_max.cu``): the 2x2 max of an
  s8 tensor that the conv epilogue has already ReLU'd and requantized.

Layout: ``scan_tpu``'s kernels read the TPU's phase-major outputs, (B, H/2,
W/2, 4C) for K4 and two (B, H/2, W/2, 2C) row-phase pairs for K6, where
channel ``(qy * 2 + qx) * C + c`` (K4) or ``qx * C + c`` of pair ``qy`` (K6)
is the full-resolution pixel ``(2i + qy, 2j + qx)``. The port's conv1_2
writes that full-resolution (B, H, W, C) NHWC tensor itself, so both
kernels take it and pool the 2x2 windows; the tests map one layout onto the
other.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. Each wrapper counts its launches in ``.launches``.
"""

import ctypes

import torch

from ..quant import max_pool_2x2
from . import build, refuse_autograd


def phase_max_requant_plain(z, s_out):
    """Plain PyTorch K4: z (B, H, W, C) bf16/f32 NHWC, s_out a f32 scalar
    tensor (already clamped at 1e-8). Returns (B, H/2, W/2, C) int8."""
    m = torch.clamp_min(max_pool_2x2(z), 0)
    q = torch.round(m.float() / s_out.to(device=z.device, dtype=torch.float32))
    return torch.clamp(q, -127, 127).to(torch.int8)


def pair_phase_max_s8_plain(z):
    """Plain PyTorch K6: the 2x2 max of z (B, H, W, C) int8 NHWC."""
    return max_pool_2x2(z)


def _fn(lib, name, n_ptr, n_int):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, z, dtypes, multiple):
    if z.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {z.device}")
    if z.dtype not in dtypes:
        raise ValueError(f"{name}: unsupported dtype {z.dtype}")
    if z.dim() != 4 or z.shape[-1] % multiple:
        raise ValueError(f"{name}: z must be (B, H, W, C) with C a multiple "
                         f"of {multiple}, got {tuple(z.shape)}")
    return z.contiguous()


def phase_max_requant(z, s_out):
    """K4: clip(round(relu(maxpool2x2(z)) / s_out), -127, 127) as int8.

    z (B, H, W, C) NHWC bf16 or f32; s_out a f32 scalar tensor, already
    clamped at 1e-8 (``vgg.py`` clamps it, as ``scan_tpu`` does). Raises
    under autograd (``refuse_autograd``): the kernel is for inference."""
    refuse_autograd("phase_max_requant", z)
    if z.device.type == "cpu":
        return phase_max_requant_plain(z, s_out)
    z = _check("phase_max_requant", z, (torch.bfloat16, torch.float32), 8)
    b, h, w, c = z.shape
    s = s_out.to(device=z.device, dtype=torch.float32).reshape(())
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8, device=z.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(z.device):
        err = _fn("phase_max", "scan_phase_max_requant", 3, 5)(
            z.data_ptr(), s.data_ptr(), out.data_ptr(), b, h, w, c,
            int(z.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase_max_requant launch failed: CUDA error {err}")
    phase_max_requant.launches += 1
    return out


def pair_phase_max_s8(z):
    """K6: the 2x2 max-pool of z (B, H, W, C) int8 NHWC, C a multiple of
    16 (the full-width stem has 64). Raises under autograd."""
    refuse_autograd("pair_phase_max_s8", z)
    if z.device.type == "cpu":
        return pair_phase_max_s8_plain(z)
    z = _check("pair_phase_max_s8", z, (torch.int8,), 16)
    b, h, w, c = z.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8, device=z.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(z.device):
        err = _fn("pair_phase_max", "scan_pair_phase_max_s8", 2, 4)(
            z.data_ptr(), out.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_phase_max_s8 launch failed: CUDA error {err}")
    pair_phase_max_s8.launches += 1
    return out


phase_max_requant.launches = 0
pair_phase_max_s8.launches = 0
