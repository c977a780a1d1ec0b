"""The inference tail of a VGG conv, ``relu(y + bias)`` and at a stage's last
conv also the 2x2/2 max-pool, over the conv's NHWC output in one
hand-written kernel (``csrc/bias_relu.cu``), and its plain version.

No TPU kernel corresponds: XLA fuses ``scan_tpu``'s bias, ReLU and pool by
itself. On the card cuDNN returns a conv without its bias, PyTorch adds the
bias in a separate pass, ``F.relu`` reads and writes the tensor again and
``F.max_pool2d`` reads it once more; the kernel reads the conv's output
once and writes the result once (in place), or only the pooled quarter.

The bias is added in float32 and rounded once to ``y``'s dtype, as
PyTorch's bias add rounds it; ReLU and max are exact on the rounded
values, so the kernel's output equals the module path's (conv, bias add,
``F.relu``, ``F.max_pool2d``) but for the sign of a zero, NaNs included.
``VGG16.forward`` calls the kernel for a CUDA input of its fp convs when
nothing needs a gradient (``vgg.fuses_bias_relu``); the CPU and the
trainable stages of a training forward run the modules as they are. The
wrapper launches the kernel or raises; it counts its calls in ``.launches``.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build, current_raw_stream, refuse_autograd

VECTOR = {torch.bfloat16: 8, torch.float32: 4}  # channels a 16-byte load
THREADS = 256  # a block's threads at most; C / vector must not pass it
BLOCKS_PER_SM = 8  # a wave of 256-thread blocks
PIXEL_LIMIT = 1 << 31  # B * H * W, for the kernel's 32-bit pixel indices


def bias_relu_plain(y, bias, pool=False):
    """``relu(y + bias)`` of NHWC ``y``, then the 2x2/2 max-pool (odd sizes
    floored) where ``pool``: the module path's ops, in ``y``'s dtype.
    Returns a contiguous NHWC tensor."""
    x = F.relu(y + bias)
    if pool:
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return x.contiguous()


def _shape_error(shape, dtype, pool):
    """Why the kernel does not take a (B, H, W, C) input of ``shape`` in
    ``dtype`` (``pool``: with the 2x2 pool), or None where it does."""
    if dtype not in VECTOR:
        return f"unsupported dtype {dtype}"
    if len(shape) != 4:
        return f"y must be a (B, H, W, C) tensor, got {tuple(shape)}"
    b, h, w, c = shape
    vec = VECTOR[dtype]
    if c % vec or c // vec > THREADS:
        return (f"C = {c} must be a multiple of {vec} ({dtype}) and at most "
                f"{THREADS * vec}")
    if b * h * w >= PIXEL_LIMIT:
        return f"B * H * W = {b * h * w} must be below 2^31"
    if pool and (h < 2 or w < 2):
        return f"a 2x2 pool needs H, W >= 2, got {h}x{w}"
    return None


def supports(shape, dtype, pool=False):
    """Whether ``bias_relu`` takes a (B, H, W, C) input of ``shape`` in
    ``dtype`` (with the pool where ``pool``): the shape rules it enforces."""
    return _shape_error(shape, dtype, pool) is None


@functools.lru_cache(maxsize=None)
def _max_blocks(index):
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point with its argument types bound, loaded once."""
    fn = build.load("bias_relu").scan_bias_relu
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y, bias, pool):
    name = "bias_relu"
    if not y.is_cuda:
        raise ValueError(f"{name}: unsupported device {y.device}; the CPU "
                         "runs bias_relu_plain")
    err = _shape_error(y.shape, y.dtype, pool)
    if err is not None:
        raise ValueError(f"{name}: {err}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be a contiguous, 16-byte aligned "
                         f"(B, H, W, C) tensor, got {tuple(y.shape)} with "
                         f"strides {y.stride()}")
    if (bias.dtype != y.dtype or bias.shape != (y.shape[3],)
            or bias.get_device() != y.get_device()
            or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous ({y.shape[3]},) "
                         f"tensor of {y.dtype} on {y.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")


def bias_relu(y, bias, pool=False):
    """``relu(y + bias)`` on the card, then the 2x2/2 max-pool where
    ``pool``.

    ``y`` (B, H, W, C) NHWC contiguous bf16 or float32, a conv's fresh
    output without its bias, with C a multiple of 8 (bf16) or 4 (float32);
    ``bias`` (C,) in ``y``'s dtype (the conv's bias cast as ``Conv`` casts
    it). Without ``pool`` the result is written into ``y`` and ``y`` is
    returned; with it a new (B, H // 2, W // 2, C) tensor is returned and
    ``y`` is left as it was. Raises on a CPU tensor, a layout or shape it
    does not take, and under autograd (``refuse_autograd``)."""
    refuse_autograd("bias_relu", y, bias)
    _check(y, bias, pool)
    index = y.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return bias_relu(y, bias, pool)
    b, h, w, c = y.shape
    out = y.new_empty((b, h // 2, w // 2, c)) if pool else None
    err = _fn()(y.data_ptr(), bias.data_ptr(),
                None if out is None else out.data_ptr(), b, h, w, c,
                int(y.dtype == torch.bfloat16), _max_blocks(index),
                current_raw_stream(index))
    if err != 0:
        raise RuntimeError(f"bias_relu launch failed: CUDA error {err}")
    bias_relu.launches += 1
    return y if out is None else out


bias_relu.launches = 0
