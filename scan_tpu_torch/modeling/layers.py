"""Shared building blocks (counterpart of ``scan_tpu/modeling/layers.py``, fp path).

Every module's forward takes and returns NHWC tensors, as ``scan_tpu``'s do.
Inside, convolutions see the same memory as ``torch.channels_last`` NCHW, so
the permutes at the edges are free views.

Initialisation follows ``scan_tpu`` (and the reference): head convs
Normal(0.01) with zero bias (``fcos.py:67-73``), FPN convs
kaiming_uniform(a=1), VGG convs kaiming normal (fan_out, ReLU gain),
GroupNorm(32, eps=1e-5) with unit weight. ``init_parameters`` applies these
from a ``torch.Generator``, so a seed gives the same weights on any device.
The int8 branch of ``Conv`` belongs to a later slice.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


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
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bias=True, kernel_init="normal", std=0.01, bias_value=0.0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)
        self.kernel_init = kernel_init
        self.std = std
        self.bias_value = bias_value

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))

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
    Submodules are named ``conv{i}`` / ``gn{i}`` as in ``scan_tpu``."""

    def __init__(self, num_convs, in_channels, features, norm="GN"):
        super().__init__()
        self.num_convs = num_convs
        self.norm = norm
        for i in range(num_convs):
            cin = in_channels if i == 0 else features
            self.add_module(f"conv{i}", Conv(cin, features, 3))
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


def init_parameters(module: nn.Module, gen: torch.Generator):
    """Apply every submodule's ``init_parameters`` in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_parameters"):
            m.init_parameters(gen)
