"""Feature Pyramid Network over NHWC tensors (counterpart of
``scan_tpu/modeling/backbone/fpn.py``).

1x1 lateral and 3x3 output convs (kaiming_uniform a=1 init), nearest x2
top-down upsample, and ``LastLevelP6P7`` (3x3 stride-2 convs, P7 from
relu(P6)); SCAN configs take P6 from P5 (USE_C5=False). Submodule names
follow ``scan_tpu`` (``fpn_inner{i}``, ``fpn_layer{i}``, their ``_gn``, ``p6``, ``p7``).
With ``quant`` every conv, P6 and P7 included, runs the int8 branch
(``scan_tpu/modeling/backbone/fpn.py:38-76``).
"""

import torch.nn.functional as F
from torch import nn

from ..layers import Conv, GroupNorm32


def upsample_nearest_2x(x):
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


class FPN(nn.Module):
    def __init__(self, in_channels, in_features, out_channels=256,
                 top_block="p6p7", use_gn=False, use_relu=False,
                 use_c5_for_p6=False, quant=False):
        super().__init__()
        self.in_features = tuple(in_features)
        self.out_channels = out_channels
        self.top_block = top_block
        self.use_gn = use_gn
        self.use_relu = use_relu
        self.use_c5_for_p6 = use_c5_for_p6
        n = len(self.in_features)
        for i, f in enumerate(self.in_features):
            for name, cin, k in ((f"fpn_inner{i + 1}", in_channels[f], 1),
                                 (f"fpn_layer{i + 1}", out_channels, 3)):
                self.add_module(name, Conv(
                    cin, out_channels, k, bias=not use_gn,
                    kernel_init="kaiming_uniform_a1", quant=quant))
                if use_gn:
                    self.add_module(name + "_gn", GroupNorm32(out_channels))
        self.n = n
        if top_block == "p6p7":
            p6_in = in_channels[self.in_features[-1]] if use_c5_for_p6 \
                else out_channels
            self.p6 = Conv(p6_in, out_channels, 3, stride=2,
                           kernel_init="kaiming_uniform_a1", quant=quant)
            self.p7 = Conv(out_channels, out_channels, 3, stride=2,
                           kernel_init="kaiming_uniform_a1", quant=quant)

    def _block(self, name, x):
        """conv -> (GN) -> (ReLU), the FPN's ``block`` (``fpn.py:46-55``)."""
        y = getattr(self, name)(x)
        if self.use_gn:
            y = getattr(self, name + "_gn")(y)
        return F.relu(y) if self.use_relu else y

    def forward(self, inputs):
        feats = [inputs[i] for i in self.in_features]
        n = self.n
        laterals = [self._block(f"fpn_inner{i + 1}", f)
                    for i, f in enumerate(feats)]
        results = [None] * n
        last_inner = laterals[-1]
        results[-1] = self._block(f"fpn_layer{n}", last_inner)
        for i in range(n - 2, -1, -1):
            last_inner = laterals[i] + upsample_nearest_2x(last_inner)
            results[i] = self._block(f"fpn_layer{i + 1}", last_inner)
        if self.top_block == "p6p7":
            src = feats[-1] if self.use_c5_for_p6 else results[-1]
            p6 = self.p6(src)
            p7 = self.p7(F.relu(p6))
            results.extend([p6, p7])
        return tuple(results)
