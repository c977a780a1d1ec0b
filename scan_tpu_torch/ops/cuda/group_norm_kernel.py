"""The inference tail of a tower block, ``relu(GroupNorm(y + bias))`` over a
conv's NHWC output, in one hand-written kernel (``csrc/group_norm.cu``) and
its plain version.

No TPU kernel corresponds: XLA fuses ``scan_tpu``'s bias, norm and ReLU by
itself. On the card a bf16 conv's bias is a separate broadcast add after
cuDNN, ``group_norm`` copies its channels_last input to NCHW and reads it
twice more, and the ReLU reads and writes it again; the kernel reads the
conv's output twice (statistics, then the apply) and writes once.

The statistics are float32 (the biased variance, ``eps`` 1e-5 as
``GroupNorm32``), the conv's bias is added in float32 before them, and the
output is in ``y``'s dtype. ``ConvTower`` calls the kernel for a CUDA
input of its fp convs when nothing needs a gradient; the CPU and every
training forward run the modules as they are. The wrapper launches the
kernel or raises; it counts its calls in ``.launches``.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build, current_raw_stream, refuse_autograd

VECTOR = {torch.bfloat16: 8, torch.float32: 4}  # channels a 16-byte load
THREADS = 256
COUNT_LIMIT = 1 << 24  # a group's count, exact in float32


def group_norm_relu_plain(y, bias, weight, gn_bias, groups, eps=1e-5):
    """``relu(group_norm(y + bias))`` of NHWC ``y`` computed in float32 from
    its values (``bias`` (C,) or None, the affine ``weight`` and
    ``gn_bias``, in any float dtype), returned NHWC in ``y``'s dtype."""
    x = y.float()
    if bias is not None:
        x = x + bias.float()
    out = F.group_norm(x.permute(0, 3, 1, 2), groups, weight.float(),
                       gn_bias.float(), eps)
    return F.relu(out).permute(0, 2, 3, 1).to(y.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chunks(b, hw, sms):
    """(chunks a sample, pixels a chunk), the same for both passes: about
    four blocks an SM over the batch, at least 128 pixels a chunk."""
    n = max(1, min(-(-4 * sms // b), -(-hw // 128)))
    px = -(-hw // n)
    return -(-hw // px), px


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry point with its argument types bound, loaded once."""
    fn = build.load("group_norm").scan_group_norm_relu
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _shape_error(shape, dtype, groups):
    """Why the kernel does not take a (B, H, W, C) input of ``shape`` in
    ``dtype`` with ``groups`` groups, or None where it does."""
    if dtype not in VECTOR:
        return f"unsupported dtype {dtype}"
    if len(shape) != 4:
        return f"y must be a (B, H, W, C) tensor, got {tuple(shape)}"
    _, h, w, c = shape
    vec = VECTOR[dtype]
    if groups <= 0 or c % groups or (c // groups) % vec:
        return (f"the group width C / G = {c} / {groups} must be a multiple "
                f"of {vec} ({dtype})")
    if THREADS % (c // vec):
        return f"C / {vec} = {c // vec} must divide {THREADS}"
    if h * w * (c // groups) >= COUNT_LIMIT:
        return (f"a group of {h * w * (c // groups)} values is past "
                "float32's exact counts")
    return None


def supports(shape, dtype, groups):
    """Whether ``group_norm_relu`` takes a (B, H, W, C) input of ``shape``
    in ``dtype`` with ``groups`` groups: the shape rules it enforces."""
    return _shape_error(shape, dtype, groups) is None


def _check(y, bias, weight, gn_bias, groups):
    name = "group_norm_relu"
    if not y.is_cuda:
        raise ValueError(f"{name}: unsupported device {y.device}; the CPU "
                         "runs group_norm_relu_plain")
    err = _shape_error(y.shape, y.dtype, groups)
    if err is not None:
        raise ValueError(f"{name}: {err}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be a contiguous, 16-byte aligned "
                         f"(B, H, W, C) tensor, got {tuple(y.shape)} with "
                         f"strides {y.stride()}")
    c = y.shape[3]
    params = [(weight, "weight", (torch.bfloat16, torch.float32)),
              (gn_bias, "gn_bias", (weight.dtype,))]
    if bias is not None:
        params.append((bias, "bias", (y.dtype,)))
    index = y.get_device()
    for t, what, dtypes in params:
        if (t.get_device() != index or t.dtype not in dtypes
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous ({c},) "
                             f"tensor of {dtypes} on {y.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def group_norm_relu(y, bias, weight, gn_bias, groups, eps=1e-5):
    """``relu(GroupNorm(y + bias))`` on the card.

    ``y`` (B, H, W, C) NHWC contiguous bf16 or float32, a conv's output
    without its bias; ``bias`` (C,) in ``y``'s dtype (the conv's bias cast as
    ``Conv`` casts it) or None; ``weight``, ``gn_bias`` (C,) the norm's
    affine, float32 or bf16; ``groups`` G with C / G a multiple of 8 (bf16)
    or 4 (float32). Returns a new NHWC tensor in ``y``'s dtype. Raises on a
    CPU tensor, a layout or shape it does not take, and under autograd
    (``refuse_autograd``)."""
    refuse_autograd("group_norm_relu", y, bias, weight, gn_bias)
    _check(y, bias, weight, gn_bias, groups)
    index = y.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return group_norm_relu(y, bias, weight, gn_bias, groups, eps)
    b, h, w, c = y.shape
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    hw = h * w
    n, px = _chunks(b, hw, _sm_count(index))
    part = y.new_empty((b, n, groups, 3), dtype=torch.float32)
    err = _fn()(
        y.data_ptr(), None if bias is None else bias.data_ptr(),
        weight.data_ptr(), gn_bias.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, hw, c, groups, n, px,
        int(y.dtype == torch.bfloat16),
        int(weight.dtype == torch.bfloat16), float(eps),
        current_raw_stream(index))
    if err != 0:
        raise RuntimeError(f"group_norm_relu launch failed: CUDA error {err}")
    group_norm_relu.launches += 1
    return out


group_norm_relu.launches = 0
