"""ResNet-50/101 body over NHWC tensors (counterpart of
``scan_tpu/modeling/backbone/resnet.py``; reference
``fcos_core/modeling/backbone/resnet.py:80-418``).

Caffe-style stem (7x7/2 conv, FrozenBatchNorm, ReLU, 3x3/2 max-pool over a
``-inf`` border), bottleneck blocks with FrozenBatchNorm and the stride on
the 1x1 conv under ``STRIDE_IN_1X1``, and stage freezing at
``FREEZE_CONV_BODY_AT``. Returns C2..C5. Names follow ``scan_tpu``'s tree
(``stem_conv1``, ``stem_bn1``, ``layer{s}_block{b}`` with ``conv1-3``,
``bn1-3``, ``downsample_conv``, ``downsample_bn``), so weights carry over.

``scan_tpu`` stops the gradient after the stem when ``freeze_at >= 1`` and
after stage k when ``freeze_at >= k + 1`` (``resnet.py:73-74, 96-97``),
and its solver freezes those parameters (``solver/build.py:59-97``). Here
the frozen convs are built with ``requires_grad`` False (FrozenBatchNorm
holds buffers, which never train) and the output is detached at the same
points, as ``VGG16`` freezes its stages 1-2.

bf16: the convs take bf16 operands (``layers.Conv``), and each
FrozenBatchNorm returns float32, so the ReLUs, the pool and the residual
adds run in float32, as in ``scan_tpu``. Every conv here feeds a
FrozenBatchNorm, whose float32 parameters promote its input; under
``jax.jit`` XLA then keeps the conv's float32 sum and never rounds it to
bf16 (the excess precision of ``layers.Conv``'s ``float_output``). So over
float32 masters (a detector that trains) the convs give float32 results
(``float_output``): on the CPU the port's bf16 body then equals
``scan_tpu``'s jitted one to 2e-7 of the largest feature, against 2.4e-2
when it rounds each conv to bf16, which is ``scan_tpu``'s own distance
from its op-by-op run (``tests/test_torch_resnet.py``). A detector for
evaluation only holds bf16 parameters and rounds, as its VGG counterpart
does.
"""

import torch.nn.functional as F
from torch import nn

from ..layers import Conv, FrozenBatchNorm, to_nchw, to_nhwc

RESNET_STAGES = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottleneck(nn.Module):
    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, stride_in_1x1=True):
        super().__init__()
        stride_1x1, stride_3x3 = ((stride, 1) if stride_in_1x1
                                  else (1, stride))
        self.has_downsample = in_channels != out_channels or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv(in_channels, out_channels, 1,
                                        stride=stride, bias=False,
                                        float_output=True)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        self.conv1 = Conv(in_channels, bottleneck_channels, 1,
                          stride=stride_1x1, bias=False, float_output=True)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3,
                          stride=stride_3x3, bias=False, float_output=True)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, bias=False,
                          float_output=True)
        self.bn3 = FrozenBatchNorm(out_channels)

    def forward(self, x):
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth=50, freeze_at=2, num_stages=4,
                 stride_in_1x1=True, res2_out_channels=256,
                 stem_out_channels=64):
        super().__init__()
        self.freeze_at = freeze_at
        self.stage_blocks = RESNET_STAGES[depth][:num_stages]
        self.stem_conv1 = Conv(3, stem_out_channels, 7, stride=2, bias=False,
                               float_output=True)
        self.stem_bn1 = FrozenBatchNorm(stem_out_channels)
        if freeze_at >= 1:
            self.stem_conv1.requires_grad_(False)
        channels = []
        cin, out_ch = stem_out_channels, res2_out_channels
        bott_ch = res2_out_channels // 4
        for s, n_blocks in enumerate(self.stage_blocks, 1):
            for b in range(n_blocks):
                block = Bottleneck(cin, bott_ch, out_ch,
                                   stride=(1 if s == 1 else 2) if b == 0 else 1,
                                   stride_in_1x1=stride_in_1x1)
                if freeze_at >= s + 1:
                    block.requires_grad_(False)
                self.add_module(f"layer{s}_block{b}", block)
                cin = out_ch
            channels.append(out_ch)
            out_ch *= 2
            bott_ch *= 2
        self.channels = tuple(channels)  # C2..C5

    def forward(self, x):
        """x (B, H, W, 3) NHWC float32 -> tuple of C2..C5, NHWC."""
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        # max_pool2d pads with -inf, as scan_tpu's explicit -inf border
        x = to_nhwc(F.max_pool2d(to_nchw(x), 3, 2, padding=1))
        if self.freeze_at >= 1:
            x = x.detach()
        outs = []
        for s, n_blocks in enumerate(self.stage_blocks, 1):
            for b in range(n_blocks):
                x = getattr(self, f"layer{s}_block{b}")(x)
            if self.freeze_at >= s + 1:
                x = x.detach()
            outs.append(x)
        return tuple(outs)
