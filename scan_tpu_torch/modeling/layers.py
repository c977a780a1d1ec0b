"""Shared building blocks (counterpart of ``scan_tpu/modeling/layers.py``, fp path).

Every module's forward takes and returns NHWC tensors, as ``scan_tpu``'s do.
Inside, convolutions see the same memory as ``torch.channels_last`` NCHW, so
the permutes at the edges are free views.

Initialisation follows ``scan_tpu`` (and the reference): head convs
Normal(0.01) with zero bias (``fcos.py:67-73``), FPN convs
kaiming_uniform(a=1), VGG convs kaiming normal (fan_out, ReLU gain),
GroupNorm(32, eps=1e-5) with unit weight. ``init_parameters`` applies these
from a ``torch.Generator``, so a seed gives the same weights on any device.

``Conv(quant=True)`` is the w8a8 int8 branch (``scan_tpu``'s ``Conv`` with
``quant``, ``layers.py:59-137``) over the same float32 parameters; see
``ops/quant.py``. Its static activation scale is a running |x|max buffer,
``amax`` (``scan_tpu``'s ``act_scales/amax``), divided by 127 when used.
The buffer holds ``NO_SCALE`` until a calibration pass (``calibration``),
the weight bridge or ``load_state_dict`` stores a value; without one the
scale is dynamic, one |x|max per batch, as in ``scan_tpu``. Which buffers
hold a value is read once at each of those points into the module's
``calibrated`` set, so the forward decides static or dynamic without
reading the device.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import (QuantizedActivation, f32, int8_conv_q, prepare_weight,
                         quantize_weight)

NO_SCALE = -1.0  # an |x|max buffer that holds no value (an |x|max is >= 0)


def add_scales(module: nn.Module, names):
    """Give ``module`` the |x|max buffers ``names``, holding no value yet."""
    module.scale_names = tuple(names)
    module.calibrated = set()
    for name in names:
        module.register_buffer(name, torch.tensor(NO_SCALE))
    module.register_load_state_dict_post_hook(_read_own_scales)


def _read_own_scales(module: nn.Module, incompatible_keys=None):
    module.calibrated = {n for n in module.scale_names
                         if float(getattr(module, n)) >= 0}


def read_scales(module: nn.Module):
    """Note which scale buffers of ``module`` and its submodules hold a
    value (one host read each)."""
    for m in module.modules():
        if hasattr(m, "scale_names"):
            _read_own_scales(m)


def stored_scale(module: nn.Module, name: str):
    """The static scale ``amax / 127`` of the buffer ``name``, computed on
    its device, or None when the buffer holds no value."""
    if name not in getattr(module, "calibrated", ()):
        return None
    buf = getattr(module, name)
    return buf / f32(127.0, buf)


def record_amax(module: nn.Module, name: str, x: torch.Tensor):
    """Calibration: fold |x|max into the running maximum in buffer ``name``."""
    buf = getattr(module, name)
    buf.copy_(torch.maximum(buf, x.float().abs().amax()))


@contextlib.contextmanager
def calibration(module: nn.Module):
    """Run ``module`` as ``scan_tpu`` runs a calibration pass (``apply`` with
    ``mutable=["act_scales"]``): every int8 conv quantizes dynamically and
    records its input's |x|max; the int8 stem returns fp."""
    mods = [m for m in module.modules() if hasattr(m, "calibrating")]
    for m in mods:
        m.calibrating = True
    try:
        yield module
    finally:
        for m in mods:
            m.calibrating = False
        read_scales(module)


def to_nchw(x):
    """NHWC -> NCHW view (channels_last memory when x is contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """kxk conv with 'same' padding over NHWC tensors.

    ``kernel_init`` names the init rule (``normal`` with ``std``, ``vgg``,
    ``kaiming_uniform_a1`` or ``lecun_normal``); ``bias_value`` is the
    constant bias init.

    ``quant=True`` runs the int8 branch. Its parameters stay float32 (the
    weights it quantizes are the float32 masters, as in ``scan_tpu``), its
    output is in ``dtype`` (the compute dtype, set by the detector) or the
    input's, and it keeps an ``amax`` buffer unless ``act_scale=False``
    (the stem's convs, whose scales live on the stem). A
    ``QuantizedActivation`` input is taken as it is, at its own scale.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bias=True, kernel_init="normal", std=0.01, bias_value=0.0,
                 quant=False, act_scale=True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)
        self.kernel_init = kernel_init
        self.std = std
        self.bias_value = bias_value
        self.quant = quant
        if quant:
            self.dtype = None
            self.calibrating = False
            self._wq = (None, None)
            if act_scale:
                add_scales(self, ("amax",))

    def hwio(self):
        """The weight in ``scan_tpu``'s (kh, kw, cin, cout) layout (a view)."""
        return self.weight.permute(2, 3, 1, 0)

    def quantized_weight(self):
        """The int8 kernel, quantized once per weight version."""
        key = (self.weight.data_ptr(), self.weight._version)
        if self._wq[0] != key:
            with torch.no_grad():
                self._wq = (key, prepare_weight(*quantize_weight(self.hwio())))
        return self._wq[1]

    def forward(self, x):
        if not self.quant:
            if isinstance(x, QuantizedActivation):
                x = x.dequantize(self.weight.dtype)
            return to_nhwc(super().forward(to_nchw(x)))
        p = self.kernel_size[0] // 2
        kw = dict(stride=self.stride, padding=((p, p), (p, p)))
        if isinstance(x, QuantizedActivation):
            return int8_conv_q(x.q, self.quantized_weight(), self.bias,
                               out_dtype=self.dtype or torch.float32,
                               act_scale=x.scale, **kw)
        act_scale = None
        if self.calibrating:
            record_amax(self, "amax", x)
        else:
            act_scale = stored_scale(self, "amax")
        return int8_conv_q(x, self.quantized_weight(), self.bias,
                           out_dtype=self.dtype or x.dtype,
                           act_scale=act_scale, **kw)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        w = self.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        if self.kernel_init == "normal":
            w.copy_(torch.randn(w.shape, generator=gen) * self.std)
        elif self.kernel_init == "vgg":
            w.copy_(torch.randn(w.shape, generator=gen)
                    * math.sqrt(2.0 / fan_out))
        elif self.kernel_init == "kaiming_uniform_a1":
            bound = math.sqrt(3.0 / fan_in)
            w.copy_(torch.rand(w.shape, generator=gen) * (2 * bound) - bound)
        else:
            raise KeyError(self.kernel_init)
        if self.bias is not None:
            self.bias.fill_(self.bias_value)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-5) over NHWC tensors."""

    def __init__(self, channels, num_groups=32):
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


class ConvTower(nn.Module):
    """num_convs x [conv3x3 -> (GN) -> ReLU]; the FCOS/condgraph tower.
    Submodules are named ``conv{i}`` / ``gn{i}`` as in ``scan_tpu``; with
    ``quant`` the convs run the int8 branch."""

    def __init__(self, num_convs, in_channels, features, norm="GN",
                 quant=False):
        super().__init__()
        self.num_convs = num_convs
        self.norm = norm
        for i in range(num_convs):
            cin = in_channels if i == 0 else features
            self.add_module(f"conv{i}", Conv(cin, features, 3, quant=quant))
            if norm == "GN":
                self.add_module(f"gn{i}", GroupNorm32(features))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
            if self.norm == "GN":
                x = getattr(self, f"gn{i}")(x)
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (reference ``layers/scale.py:5-11``)."""

    def __init__(self, init_value=1.0):
        super().__init__()
        self.init_value = init_value
        self.scale = nn.Parameter(torch.tensor([init_value], dtype=torch.float32))

    def forward(self, x):
        return x * self.scale

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.scale.fill_(self.init_value)


class Linear(nn.Linear):
    """Dense layer with ``scan_tpu``'s init: flax's default lecun_normal
    (truncated normal, std sqrt(1/fan_in)) or Normal(std), zero bias."""

    def __init__(self, in_features, out_features, kernel_init="lecun_normal",
                 std=0.01):
        super().__init__(in_features, out_features)
        self.kernel_init = kernel_init
        self.std = std

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        w = self.weight
        if self.kernel_init == "normal":
            w.copy_(torch.randn(w.shape, generator=gen) * self.std)
        elif self.kernel_init == "lecun_normal":
            # truncated to 2 std, rescaled to unit variance (flax's rule)
            t = torch.randn(w.shape, generator=gen)
            out = t.abs() > 2.0
            while out.any():
                t[out] = torch.randn(int(out.sum()), generator=gen)
                out = t.abs() > 2.0
            w.copy_(t * (math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978))
        else:
            raise KeyError(self.kernel_init)
        self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    """LayerNorm(eps=1e-5) with unit weight and zero bias."""

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


def safe_l2_norm(x, dim=None, keepdim=False, eps: float = 1e-8):
    """L2 norm with a finite gradient at 0 (``scan_tpu/layers.py:43-50``):
    empty prototype slots and masked nodes are exactly-zero rows."""
    sq = x * x
    s = sq.sum() if dim is None else sq.sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(s + eps * eps)


def dropout(x, rate: float, generator=None):
    """Inverted dropout drawn from ``generator``; the identity without one
    (flax's ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    by 1 / (1 - rate))."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention over the sampled graph nodes
    (``scan_tpu/modeling/layers.py:207-268``; reference
    ``layers/transformer.py:36-91``), with its peculiarities kept:

    * the head split is a raw view, (N, D) -> (heads, N, D / heads) in
      row-major order, not the usual per-channel split;
    * the scale is ``(dh // heads) ** -0.5``;
    * under that view key m of head h holds a slice of node (h * N + m) //
      heads, so the validity mask of the keys is remapped accordingly;
    * dropout on the attention weights and on the output of
      ``linear_final``, before the residual and the post-residual LayerNorm.

    Dropout is drawn from the ``generator`` passed to ``forward``; without
    one the module is deterministic, as ``scan_tpu``'s is without a
    dropout rng. It is not ``nn.MultiheadAttention``, which splits heads
    and scales differently.
    """

    def __init__(self, model_dim=256, num_heads=4, dropout=0.0):
        super().__init__()
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.dropout = dropout
        for name in ("linear_q", "linear_k", "linear_v", "linear_final"):
            self.add_module(name, Linear(model_dim, model_dim))
        self.layer_norm = LayerNorm(model_dim, eps=1e-5)

    def forward(self, x, mask=None, generator=None):
        """x (N, D) nodes; mask (N,) bool validity."""
        d, h = self.model_dim, self.num_heads
        dh = d // h
        n = x.shape[0]
        q = self.linear_q(x).reshape(h, n, dh)
        k = self.linear_k(x).reshape(h, n, dh)
        v = self.linear_v(x).reshape(h, n, dh)
        scale = float(max(dh // h, 1)) ** -0.5
        attn = torch.matmul(q, k.transpose(1, 2)) * scale
        if mask is not None:
            pos = (torch.arange(h, device=x.device)[:, None] * n
                   + torch.arange(n, device=x.device)[None, :])
            pos_mask = mask[pos // h]  # (h, n)
            attn = torch.where(pos_mask[:, None, :], attn,
                               torch.full_like(attn, -1e30))
        attn = dropout(torch.softmax(attn, dim=-1), self.dropout, generator)
        ctx = torch.matmul(attn, v).reshape(n, d)
        out = dropout(self.linear_final(ctx), self.dropout, generator)
        return self.layer_norm(x + out)


def init_parameters(module: nn.Module, gen: torch.Generator):
    """Apply every submodule's ``init_parameters`` in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_parameters"):
            m.init_parameters(gen)
