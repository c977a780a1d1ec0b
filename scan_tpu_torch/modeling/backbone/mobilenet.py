"""MobileNetV2 body over NHWC tensors (counterpart of
``scan_tpu/modeling/backbone/mobilenet.py``; reference
``fcos_core/modeling/backbone/mobilenet.py``).

A 3x3/2 stem, then inverted-residual blocks: a 1x1 expansion (skipped at
expansion 1), a depthwise 3x3 (``groups`` = its width) carrying the stride,
and a 1x1 projection, each followed by a per-channel GroupNorm
(``ChannelNorm``), relu6 (``layers.clip(x, 6)``) after the first two, and the
residual only when the stride is 1 and the widths match. Returns the
standard C2..C5 endpoints (24, 32, 96, 320 channels at strides 4, 8, 16,
32). Names follow ``scan_tpu``'s tree (``stem``, ``stem_bn``,
``stage{s}_block{b}`` with ``expand``, ``depthwise``, ``project`` and their
``_bn``), so weights carry over; the convs have no bias and flax's default
lecun-normal init, whose fan-in is per group (k * k for a depthwise conv).

``scan_tpu`` stands a per-channel GroupNorm (an instance norm) where the
reference has (Sync)BN (ROADMAP queue C). Its solver excludes every body
parameter whose name starts with ``stem_bn`` from the optimizer (the
FrozenBatchNorm rule of ``_frozen_checker``, ``solver/build.py:81-84``),
so the stem's norm never trains; here it is built with ``requires_grad``
False, as the port's solver takes the parameters that require grad.

bf16: the norms return float32 (flax's promotion against their float32
parameters), so the relu6s and residual adds run in float32 and each conv
casts its input to the compute dtype. Every conv feeds a norm that converts
its output to float32, and under ``jax.jit`` XLA keeps the conv's float32
sum there, as for the ResNet body: so over float32 masters (a detector that
trains) the convs give float32 results (``float_output``), which puts the
port's bf16 body next to ``scan_tpu``'s jitted one
(``tests/test_torch_mobile_backbones.py`` measures both). A detector for
evaluation only holds bf16 conv parameters and rounds each conv's result.
"""

from torch import nn

from ..layers import ChannelNorm, Conv, clip

# (expansion, out_channels, num_blocks, stride)
MNV2_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
# stage indices whose LAST block output is an FPN endpoint (C2..C5)
ENDPOINT_STAGES = (1, 2, 4, 6)


def mobile_conv(cin, cout, k, stride=1, groups=1):
    """A bias-free conv of the mobile bodies: flax's ``nn.Conv`` default
    init, a float32 result over float32 masters (see the docstring)."""
    return Conv(cin, cout, k, stride=stride, bias=False,
                kernel_init="lecun_normal", float_output=True, groups=groups)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise kxk (stride) -> project 1x1, each normed;
    relu6 after the first two; the residual at stride 1 and equal widths."""

    CONVS = ("expand", "depthwise", "project")
    NORMS = ("expand_bn", "dw_bn", "project_bn")

    def __init__(self, in_channels, expansion, out_channels, stride=1,
                 kernel=3):
        super().__init__()
        hidden = in_channels * expansion
        layers = [(0, mobile_conv(in_channels, hidden, 1))] if expansion != 1 \
            else []
        layers += [(1, mobile_conv(hidden, hidden, kernel, stride, hidden)),
                   (2, mobile_conv(hidden, out_channels, 1))]
        self.steps = []
        for i, conv in layers:
            self.add_module(self.CONVS[i], conv)
            self.add_module(self.NORMS[i], ChannelNorm(conv.out_channels))
            self.steps.append((self.CONVS[i], self.NORMS[i], i < 2))
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x):
        y = x
        for conv, norm, relu in self.steps:
            y = getattr(self, norm)(getattr(self, conv)(y))
            if relu:
                y = clip(y, 6)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = mobile_conv(3, 32, 3, stride=2)
        self.stem_bn = ChannelNorm(32)
        self.stem_bn.requires_grad_(False)  # scan_tpu's solver freezes it
        cin, channels = 32, []
        for si, (t, c, n, s) in enumerate(MNV2_SETTINGS):
            for bi in range(n):
                self.add_module(f"stage{si}_block{bi}", InvertedResidual(
                    cin, t, c, s if bi == 0 else 1))
                cin = c
            if si in ENDPOINT_STAGES:
                channels.append(c)
        self.channels = tuple(channels)  # C2..C5

    def forward(self, x):
        """x (B, H, W, 3) NHWC float32 -> tuple of C2..C5, NHWC float32."""
        y = clip(self.stem_bn(self.stem(x)), 6)
        outs = []
        for si, (_, _, n, _) in enumerate(MNV2_SETTINGS):
            for bi in range(n):
                y = getattr(self, f"stage{si}_block{bi}")(y)
            if si in ENDPOINT_STAGES:
                outs.append(y)
        return tuple(outs)
