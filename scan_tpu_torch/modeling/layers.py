"""Shared building blocks (counterpart of ``scan_tpu/modeling/layers.py``, fp path).

Every module's forward takes and returns NHWC tensors, as ``scan_tpu``'s do.
Inside, convolutions see the same memory as ``torch.channels_last`` NCHW, so
the permutes at the edges are free views.

Initialisation follows ``scan_tpu`` (and the reference): head convs
Normal(0.01) with zero bias (``fcos.py:67-73``), FPN convs
kaiming_uniform(a=1), VGG convs kaiming normal (fan_out, ReLU gain),
GroupNorm(32, eps=1e-5) with unit weight. ``init_parameters`` applies these
from a ``torch.Generator``, so a seed gives the same weights on any device.

Compute dtype: ``Conv`` and ``GroupNorm32`` compute in ``compute_dtype``
(set by the detector; None means the weight's dtype), as flax's ``dtype=``
does in ``scan_tpu``. Their parameters may stay float32, the masters a bf16
training step updates: the conv casts its input, weight and bias to the
compute dtype at use, and GroupNorm takes its statistics and affine in
float32 and casts its output (flax's ``GroupNorm(dtype=...)``), so the
gradients reach the masters in float32. ``Linear`` has no compute dtype,
as flax's ``Dense`` without ``dtype=`` has none: it computes in its
weight's dtype (float32), which is where JAX's promotion puts a bf16
input. ``promoted_matmul`` is a matmul with that promotion, which torch
does not do on its own.

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

from ..ops.cuda import group_norm_kernel
from ..ops.quant import (QuantizedActivation, f32, int8_conv_q, prepare_weight,
                         quantize_weight)
from ..utils.profiler import count

NO_SCALE = -1.0  # an |x|max buffer that holds no value (an |x|max is >= 0)


def is_scale_key(key: str) -> bool:
    """A state-dict key of an |x|max buffer: a conv's ``<name>.amax`` or
    one of the stem's ``*_act``."""
    return key.endswith(".amax") or key.endswith("_act")


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


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal truncated to 2 std, rescaled to
    unit variance, times sqrt(1 / fan_in)."""
    t = torch.randn(w.shape, generator=gen)
    out = t.abs() > 2.0
    while out.any():
        t[out] = torch.randn(int(out.sum()), generator=gen)
        out = t.abs() > 2.0
    w.copy_(t * (math.sqrt(1.0 / fan_in) / 0.87962566103423978))


def to_nchw(x):
    """NHWC -> NCHW view (channels_last memory when x is contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """kxk conv with 'same' padding over NHWC tensors.

    ``kernel_init`` names the init rule (``normal`` with ``std``, ``vgg``
    (normal, std sqrt(2 / fan_out): flax's ``variance_scaling(2, "fan_out",
    "normal")``), ``kaiming_uniform_a1`` or ``lecun_normal``, flax's
    default); ``bias_value`` is the constant bias init.

    The fp branch computes in ``compute_dtype`` (see the module
    docstring), casting its input and, when they differ, its weight and
    bias. ``float_output`` is for a prediction conv whose output the
    caller takes in float32 (``scan_tpu``'s ``.astype(jnp.float32)``):
    under ``jax.jit`` XLA keeps such a conv's float32 sum and bias and never
    rounds them to bf16 (its excess-precision rule), so over float32
    masters (a detector that trains) the result is float32
    (``float_output_conv``). A detector for evaluation only, whose
    parameters are bf16, rounds the result to bf16: the float32 result put
    its FCOS head at 16.29 ms against 13.40 (batch 8, 800x1344, H100;
    ``chip_smoke.py``'s ``timing``), more than the forward's run-to-run
    spread. In float32 it changes nothing. On the CPU every other bf16 conv
    runs as a float32 conv of its bf16 operands, rounded back: the same
    arithmetic (exact products, float32 sums, one rounding) without
    oneDNN's bf16 kernels, whose weight gradient has come back NaN for the
    OUT discriminators' stride-2 convs on 1x1 maps.

    ``groups`` makes a grouped conv (the mobile bodies' depthwise convs,
    flax's ``feature_group_count``); it takes every fp path above, the
    float32 result included, and has no int8 branch.

    ``quant=True`` runs the int8 branch. Its parameters stay float32 (the
    weights it quantizes are the float32 masters, as in ``scan_tpu``), its
    output is in ``dtype`` (the compute dtype, set by the detector) or the
    input's, and it keeps an ``amax`` buffer unless ``act_scale=False``
    (the stem's convs, whose scales live on the stem). A
    ``QuantizedActivation`` input is taken as it is, at its own scale.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bias=True, kernel_init="normal", std=0.01, bias_value=0.0,
                 quant=False, act_scale=True, float_output=False, groups=1):
        if quant and groups != 1:
            raise NotImplementedError("an int8 Conv has no grouped branch")
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias, groups=groups)
        self.kernel_init = kernel_init
        self.std = std
        self.bias_value = bias_value
        self.quant = quant
        self.float_output = float_output
        self.compute_dtype = None  # set by the detector
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

    def _fp_operands(self, x):
        """(NCHW input, weight, bias, compute dtype, masters) of the fp
        branch, each cast to the compute dtype."""
        dt = self.compute_dtype or self.weight.dtype
        if isinstance(x, QuantizedActivation):
            x = x.dequantize(dt)
        w, b = self.weight, self.bias
        masters = w.dtype != dt
        if masters:  # float32 masters, cast at use
            w = w.to(dt)
            b = None if b is None else b.to(dt)
        return to_nchw(x.to(dt)), w, b, dt, masters

    def forward_unbiased(self, x):
        """The fp branch on the card without its bias: (NHWC output in the
        compute dtype, the bias cast as ``forward`` casts it), for a caller
        that adds the bias itself (``ConvTower``'s fused GroupNorm)."""
        x, w, b, _, _ = self._fp_operands(x)
        return to_nhwc(self._conv_forward(x, w, None)), b

    def forward(self, x):
        if not self.quant:
            x, w, b, dt, masters = self._fp_operands(x)
            if dt == torch.float32:
                return to_nhwc(self._conv_forward(x, w, b))
            if self.float_output and masters:
                return to_nhwc(float_output_conv(x, w, b, self.stride,
                                                 self.padding, self.groups))
            if x.device.type == "cpu":
                # float32 sums of the bf16 products, rounded back
                y = self._conv_forward(x.float(), w.float(),
                                       None if b is None else b.float())
                return to_nhwc(y.to(dt))
            return to_nhwc(self._conv_forward(x, w, b))
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
        elif self.kernel_init == "lecun_normal":
            lecun_normal_(w, fan_in, gen)
        else:
            raise KeyError(self.kernel_init)
        if self.bias is not None:
            self.bias.fill_(self.bias_value)


class ConvTranspose(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) over NHWC
    tensors: a kxk kernel at stride s, ``VALID`` (padding 0) or ``SAME``
    (padding (k - s) / 2, so the output is s times the input).

    flax runs the kernel unflipped over the dilated input; torch's
    ``conv_transpose2d`` runs the gradient of a conv, whose kernel is the
    flipped one. So the weight here, (in, out, k, k), is flax's (k, k, in,
    out) kernel permuted and flipped in both spatial axes
    (``utils/jax_weights.py`` converts it so, by this module's type).
    Compute dtype and float32 masters as ``Conv`` (cast at use). Init:
    flax's default, lecun_normal over fan_in = k * k * in, zero bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=2,
                 padding="VALID"):
        if padding == "VALID":
            pad = 0
        elif padding == "SAME" and (kernel_size - stride) % 2 == 0:
            pad = (kernel_size - stride) // 2
        else:
            raise ValueError(f"ConvTranspose: padding {padding!r} with k="
                             f"{kernel_size}, s={stride} is not supported")
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=pad)
        self.compute_dtype = None  # set by the detector

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        x = to_nchw(x.to(dt))
        if dt != torch.float32 and x.device.type == "cpu":
            # float32 sums of the bf16 products, rounded back (see Conv)
            y = F.conv_transpose2d(x.float(), w.float(), b.float(),
                                   self.stride, self.padding)
            return to_nhwc(y.to(dt))
        return to_nhwc(F.conv_transpose2d(x, w, b, self.stride, self.padding))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        w = self.weight  # (in, out, k, k)
        lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], gen)
        self.bias.zero_()


class _FloatOutputConv(torch.autograd.Function):
    """conv2d of compute-dtype (bf16) operands with a float32 result: the
    float32 sum of exact products plus the bias, never rounded to bf16.

    The forward runs as a float32 conv with TF32 allowed: TF32 holds a bf16
    value exactly, so the tensor cores' products are exact and their sums
    float32, as a bf16 conv's are; only the result's rounding is skipped.
    The backward takes the cotangent in the compute dtype (the transpose of
    JAX's convert) and runs the conv's backward there, on the tensor cores;
    on the CPU in float32, its results rounded back (see ``Conv``)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups, None if b is None else b.shape)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return F.conv2d(x.float(), w.float(),
                            None if b is None else b.float(), stride,
                            padding, 1, groups)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, groups, bias_shape = ctx.conf
        dt = x.dtype
        g = gy.to(dt)
        if x.device.type == "cpu":
            g, x, w = g.float(), x.float(), w.float()
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_shape is not None and ctx.needs_input_grad[2]]
        grads = torch.ops.aten.convolution_backward(
            g, x, w, list(bias_shape) if bias_shape is not None else None,
            list(stride), list(padding), [1, 1], False, [0, 0], groups, mask)
        gx, gw, gb = (None if t is None else t.to(dt) for t in grads)
        return gx, gw, gb, None, None, None


def float_output_conv(x, w, b, stride=(1, 1), padding=(1, 1), groups=1):
    """NCHW ``conv2d`` with a float32 result from compute-dtype operands
    (``_FloatOutputConv``)."""
    return _FloatOutputConv.apply(x, w, b, tuple(stride), tuple(padding),
                                  groups)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-5) over NHWC tensors, in ``compute_dtype``."""

    def __init__(self, channels, num_groups=32):
        super().__init__(num_groups, channels, eps=1e-5)
        self.compute_dtype = None  # set by the detector

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        if self.weight.dtype == dt:
            return to_nhwc(super().forward(to_nchw(x.to(dt))))
        # float32 masters: statistics and affine in float32, output in dt
        y = F.group_norm(to_nchw(x).float(), self.num_groups, self.weight,
                         self.bias, self.eps)
        return to_nhwc(y.to(dt))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


def clip(x, hi):
    """``jnp.clip(x, 0, hi)`` with its gradient: a maximum and a minimum,
    which split the gradient at a tie, where ``clamp`` passes all of it (a
    norm's output is exactly its bias, 0 at init, on a constant channel; a
    deformable-conv sample on the border). ``clip(x, 6)`` is relu6."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())),
                         x.new_full((), float(hi)))


def channel_norm(x, weight, bias, eps):
    """Per-channel norm of NHWC ``x`` over H and W as flax computes it:
    the variance as E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance``),
    then ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. The int8
    VGG16-BN needs flax's rounding here: with ``F.group_norm``'s two-pass
    variance its C1 lay 1.4e-2 of ``scan_tpu``'s apart (an int8 step moved),
    with this 3e-6."""
    mean = x.mean((1, 2), keepdim=True)
    var = ((x * x).mean((1, 2), keepdim=True) - mean * mean).clamp_min(0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


class ChannelNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups=None, group_size=1, epsilon=1e-5)``
    without ``dtype``, over NHWC tensors: one group per channel, the norm
    of ``scan_tpu``'s MobileNetV2 and FBNet bodies. flax takes the output
    dtype from the input and its float32 parameters, so the statistics,
    the affine and the output are float32 whatever the input's dtype (a
    bf16 conv's output comes back float32). Its parameters stay float32 in
    a detector for evaluation too: ``set_compute_dtype`` leaves this class
    alone, as it leaves ``FrozenBatchNorm``."""

    def __init__(self, channels):
        super().__init__(channels, channels, eps=1e-5)

    def forward(self, x):
        return channel_norm(x.float(), self.weight.float(), self.bias.float(),
                            self.eps)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


class ChannelGroupNorm(GroupNorm32):
    """flax's ``nn.GroupNorm(num_groups=None, group_size=1, epsilon=1e-5,
    dtype=...)``, VGG16-BN's ``bn{idx}``: the statistics and affine of
    ``channel_norm`` in float32, the output in ``compute_dtype``, as
    ``GroupNorm32`` (which ``set_compute_dtype`` sets and casts). The
    statistics must be flax's: in the int8 body a quantize follows each
    norm, and a variance that differs in its last bits moves values across
    its rounding steps, which the next norm spreads over the channel."""

    def __init__(self, channels):
        super().__init__(channels, num_groups=channels)

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        y = channel_norm(x.float(), self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(dt)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (``scan_tpu/modeling/layers.py:185-204``;
    reference ``layers/batch_norm.py:6-25``) over NHWC tensors.

    ``weight``, ``bias``, ``running_mean`` and ``running_var`` are float32
    buffers under ``scan_tpu``'s names: they are loaded, never trained, and
    ``set_compute_dtype`` leaves them float32. The output is
    ``x * (w * rsqrt(var + 1e-5)) + (b - mean * scale)``; on a bf16 input it
    is float32, as JAX's promotion against the float32 parameters makes it,
    so the ReLUs and residual adds of a bf16 ResNet run in float32 and the
    next ``Conv`` casts down. ``scan_tpu`` adds ``eps`` 1e-5, which
    maskrcnn-benchmark's ``FrozenBatchNorm2d`` does not; the port follows
    ``scan_tpu`` (ROADMAP queue C)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), value))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * scale + (self.bias - self.running_mean * scale)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            getattr(self, name).fill_(value)


def fuses_group_norm(x, conv, gn):
    """Whether a tower block takes the fused kernel
    (``ops/cuda/group_norm_kernel.py``): a CUDA input of an fp conv whose
    output the kernel takes (``supports``: bf16 or float32, the group width
    and the group's size; the tower's 3x3 'same' conv keeps H and W), and
    nothing that needs a gradient. Training forwards, the int8 convs, the
    CPU and the shapes the kernel does not take run the modules as they
    are."""
    if isinstance(x, QuantizedActivation) or conv.quant or not x.is_cuda:
        return False
    out = (*x.shape[:3], conv.out_channels)
    if not group_norm_kernel.supports(
            out, conv.compute_dtype or conv.weight.dtype, gn.num_groups):
        return False
    return not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad
        for t in (x, conv.weight, conv.bias, gn.weight, gn.bias))


class ConvTower(nn.Module):
    """num_convs x [conv3x3 -> (GN) -> ReLU]; the FCOS/condgraph tower.
    Submodules are named ``conv{i}`` / ``gn{i}`` as in ``scan_tpu``; with
    ``quant`` the convs run the int8 branch.

    Where ``fuses_group_norm`` holds, a GN block runs the conv without its
    bias and one kernel for the bias, the norm and the ReLU
    (``group_norm_relu``): the same arithmetic, but the bias is added to the
    conv's output in float32 before the statistics rather than rounded with
    it to the compute dtype. The profiler's counters ``gn.calls`` and
    ``gn.fused`` count the GN blocks and those that took the kernel."""

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
            conv = getattr(self, f"conv{i}")
            gn = getattr(self, f"gn{i}") if self.norm == "GN" else None
            if gn is not None:
                count("gn.calls", 1)
                if fuses_group_norm(x, conv, gn):
                    count("gn.fused", 1)
                    y, b = conv.forward_unbiased(x)
                    x = group_norm_kernel.group_norm_relu(
                        y.contiguous(), b, gn.weight, gn.bias, gn.num_groups,
                        gn.eps)
                    continue
            x = conv(x)
            if gn is not None:
                x = gn(x)
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

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        w = self.weight
        if self.kernel_init == "normal":
            w.copy_(torch.randn(w.shape, generator=gen) * self.std)
        elif self.kernel_init == "lecun_normal":
            lecun_normal_(w, w.shape[1], gen)
        else:
            raise KeyError(self.kernel_init)
        self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    """LayerNorm(eps=1e-5) with unit weight and zero bias."""

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


def promoted_matmul(a, b):
    """``a @ b`` in the dtype JAX's promotion gives (bf16 @ float32 runs in
    float32); torch refuses mixed dtypes in a matmul."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


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
