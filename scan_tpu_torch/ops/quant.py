"""Int8 quantized convolution for the inference path (counterpart of
``scan_tpu/ops/quant.py``).

The scheme is ``scan_tpu``'s: symmetric per-output-channel weight scales and
a symmetric per-tensor activation scale, either dynamic (one |x|max per
call) or static (a calibrated scalar, see ``modeling/layers.Conv``). The s8
products are summed in int32, and the f32 epilogue runs in the order of
``_dequant_epilogue``: ``acc * (x_scale * w_scale)``, then ``+ bias``, then
either ``round(y / s)`` clipped to s8 or a cast to ``out_dtype``.

Public functions keep ``scan_tpu``'s layouts: activations NHWC, kernels
HWIO ``(kh, kw, cin, cout)``.

``scan_tpu`` leaves these convolutions to XLA, outside any Pallas kernel.
Here the int32 convolution is an explicit im2col, a ``(B, Ho, Wo,
kh*kw*Cin)`` s8 tensor, contracted with the ``(kh*kw*Cin, Cout)`` s8 weight
by ``torch._int_mm``. That is cuBLASLt's s8 x s8 -> s32 on the card and
PyTorch's own on the CPU; the sums are exact on both. The card wants more
than 16 rows and a depth and width that are multiples of 8. So the depth and
width are padded with zeros to a multiple of 8 and the rows to at least 32.
Zero padding adds nothing to an integer sum.

Every division by a scale divides by a float32 tensor on the operand's
device. PyTorch's CUDA division by a CPU scalar multiplies by the
reciprocal instead, which can differ from IEEE division in the last bit.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_MIN_ROWS = 32


class QuantizedActivation(NamedTuple):
    """An int8 activation and the f32 scalar scale that dequantizes it
    (``fp ~= q * scale``). Stem variants that fold their successor's
    requant into their own epilogue return one; ``Conv`` (quant) consumes
    it without quantizing again."""

    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32 scalar

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype):
        return (self.q.float() * self.scale).to(dtype)


class QuantizedWeight(NamedTuple):
    """A quantized kernel laid out for ``torch._int_mm``: ``mat`` is the
    zero-padded ``(Kp, Np)`` s8 matrix, column-major; ``scale`` the
    ``(cout,)`` f32 weight scales; ``shape`` the HWIO kernel shape."""

    mat: torch.Tensor
    scale: torch.Tensor
    shape: tuple


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device. A number is
    filled in on the device, with no copy from the host."""
    if isinstance(value, torch.Tensor):
        return value.to(like.device, torch.float32)
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def clamp_scale(scale, like: torch.Tensor) -> torch.Tensor:
    """A given activation scale as a float32 scalar on ``like``'s device,
    floored at 1e-8 as ``scan_tpu`` floors a static scale."""
    return torch.clamp_min(f32(scale, like), 1e-8).reshape(())


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def quantize_weight(w: torch.Tensor):
    """(kh, kw, cin, cout) fp -> (int8 kernel, (cout,) f32 scale)."""
    w = w.float()
    amax = w.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp_min(amax, 1e-8) / f32(127.0, w)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def prepare_weight(w_q: torch.Tensor, scale: torch.Tensor) -> QuantizedWeight:
    """Lay an HWIO s8 kernel out as ``_int_mm``'s right operand."""
    kh, kw, cin, cout = w_q.shape
    k = kh * kw * cin
    mat = w_q.new_zeros((_round8(cout), _round8(k)))
    mat[:cout, :k] = w_q.reshape(k, cout).t()
    return QuantizedWeight(mat.t(), scale, tuple(w_q.shape))


def quantize_activation(x: torch.Tensor, act_scale=None):
    """Per-tensor symmetric quantization -> (int8, f32 scalar scale).

    With ``act_scale`` (a calibrated static scale, already /127) the |x|max
    reduce is skipped."""
    xf = x.float()
    if act_scale is None:
        scale = torch.clamp_min(xf.abs().amax(), 1e-8) / f32(127.0, x)
    else:
        scale = clamp_scale(act_scale, x)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _explicit_padding(padding, h, w, kh, kw, stride):
    if padding == "SAME":
        pads = []
        for size, k, s in ((h, kh, stride[0]), (w, kw, stride[1])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple(tuple(int(v) for v in p) for p in padding)


def conv_s32(x_q: torch.Tensor, wq: QuantizedWeight, stride=(1, 1),
             padding=((0, 0), (0, 0))) -> torch.Tensor:
    """int32 convolution of an s8 NHWC tensor with a prepared s8 kernel:
    im2col, then one ``torch._int_mm``. Returns (B, Ho, Wo, cout) int32."""
    kh, kw, cin, cout = wq.shape
    sh, sw = stride
    (pt, pb), (pl, pr) = padding
    b, h, w, c = x_q.shape
    if c != cin:
        raise ValueError(f"conv_s32: input has {c} channels, kernel {cin}")
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w + pl + pr - kw) // sw + 1
    m, k = b * ho * wo, kh * kw * cin
    kp = wq.mat.shape[0]
    rows = max(m, _MIN_ROWS)
    if (kh, kw, sh, sw, pt, pb, pl, pr) == (1, 1, 1, 1, 0, 0, 0, 0) \
            and kp == k and rows == m:
        a = x_q.reshape(m, k)
    else:
        a = torch.empty((rows, kp), dtype=torch.int8, device=x_q.device)
        if kp != k:
            a[:, k:].zero_()
        if rows != m:
            a[m:].zero_()
        xp = F.pad(x_q, (0, 0, pl, pr, pt, pb)) if pt or pb or pl or pr \
            else x_q
        av = a[:m].view(b, ho, wo, kp)
        for dy in range(kh):
            for dx in range(kw):
                t = (dy * kw + dx) * cin
                av[..., t:t + cin] = xp[:, dy:dy + sh * (ho - 1) + 1:sh,
                                        dx:dx + sw * (wo - 1) + 1:sw, :]
    acc = torch._int_mm(a, wq.mat)
    return acc[:m, :cout].reshape(b, ho, wo, cout)


def int8_conv(x, kernel, bias=None, stride=1, padding="SAME",
              out_dtype: Optional[torch.dtype] = None, act_scale=None,
              out_quant_scale=None, fold_relu: bool = False):
    """w8a8 conv: int32 accumulation, f32 dequant epilogue (+bias).

    x: (B, H, W, Cin) float, or int8 already quantized, in which case
    ``act_scale`` is required and taken as its scale. kernel: (kh, kw,
    Cin, Cout) float, quantized here. Returns float (``out_dtype`` or
    x.dtype), or int8 at ``out_quant_scale`` (ReLU folded into the 0 clip
    bound when ``fold_relu``), as ``scan_tpu``'s ``int8_conv`` does.
    """
    return int8_conv_q(x, prepare_weight(*quantize_weight(kernel)), bias,
                       stride, padding, out_dtype, act_scale,
                       out_quant_scale, fold_relu)


def int8_conv_q(x, wq: QuantizedWeight, bias=None, stride=1, padding="SAME",
                out_dtype: Optional[torch.dtype] = None, act_scale=None,
                out_quant_scale=None, fold_relu: bool = False):
    """``int8_conv`` with the kernel already quantized (``prepare_weight``)."""
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError("int8 input requires its scale")
        x_q, x_scale = x, clamp_scale(act_scale, x)
    else:
        x_q, x_scale = quantize_activation(x, act_scale)
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    pads = _explicit_padding(padding, x.shape[1], x.shape[2], wq.shape[0],
                             wq.shape[1], strides)
    acc = conv_s32(x_q, wq, strides, pads)
    return _dequant_epilogue(acc, x_scale * wq.scale, bias, out_quant_scale,
                             fold_relu, out_dtype or x.dtype)


def _dequant_epilogue(acc, scale, bias, out_quant_scale, fold_relu,
                      out_dtype):
    """Shared int32 -> output epilogue: dequant scale, +bias, then either
    requant to int8 (ReLU folded into the 0 lower clip bound) or a cast."""
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()
    if out_quant_scale is not None:
        lo = 0.0 if fold_relu else -127.0
        q = torch.clamp(torch.round(y / f32(out_quant_scale, y)), lo, 127.0)
        return q.to(torch.int8)
    if fold_relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype)


def int8_conv_im2col(x, kernel, bias=None,
                     out_dtype: Optional[torch.dtype] = None, act_scale=None,
                     out_quant_scale=None, fold_relu: bool = False):
    """``int8_conv`` for a 3x3 kernel, stride 1, SAME padding (raises for
    another kernel size). In ``scan_tpu`` it is a second XLA strategy for
    the stem's conv1_1 (``TPU.STEM_IM2COL_CONV0``, not ported); here
    ``int8_conv`` is an im2col already. Only the parity test calls it."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError("int8_conv_im2col is for the 3x3 stem conv")
    return int8_conv(x, kernel, bias, 1, ((1, 1), (1, 1)), out_dtype,
                     act_scale, out_quant_scale, fold_relu)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of an NHWC tensor of any dtype (floor on odd
    sizes, as flax's VALID pooling)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
