"""FCOS detection head over NHWC tensors (counterpart of
``scan_tpu/modeling/fcos/head.py``).

Separate cls/bbox towers of NUM_CONVS_{CLS,REG} x [3x3 conv, GN(32), ReLU]
shared across levels, 3x3 prediction convs (Normal(0.01), zero bias), the
focal prior bias on ``cls_logits``, a learnable Scale per level on the box
regression followed by exp (clamped at 25, ``head.py:73-77``), centerness
off the regression tower when REG_CTR_ON (reference ``fcos.py:13-114``).
``in_channels`` is the towers' width (256, ``scan_tpu``'s field of that
name) and ``input_channels`` the input's (the FPN's), which flax infers. With ``quant`` the two
towers run the int8 branch; ``cls_logits``,
``bbox_pred`` and ``centerness`` stay fp (``scan_tpu/modeling/fcos/head.py:29-50``)
and give float32 outputs from compute-dtype operands, as ``scan_tpu``'s
jitted ``.astype(jnp.float32)`` does.
"""

import math

import torch
from torch import nn

from ..layers import Conv, ConvTower, Scale


class FCOSHead(nn.Module):
    def __init__(self, num_classes, num_convs_cls=4, num_convs_reg=4,
                 in_channels=256, prior_prob=0.01, with_reg_ctr=True,
                 num_levels=5, quant=False, input_channels=None):
        super().__init__()
        self.with_reg_ctr = with_reg_ctr
        cin = input_channels or in_channels
        self.cls_tower = ConvTower(num_convs_cls, cin, in_channels,
                                   quant=quant)
        self.bbox_tower = ConvTower(num_convs_reg, cin, in_channels,
                                    quant=quant)
        cls_ch = in_channels if num_convs_cls else cin
        reg_ch = in_channels if num_convs_reg else cin
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        # float32 outputs (see layers.Conv's float_output)
        self.cls_logits = Conv(cls_ch, num_classes - 1, 3,
                               bias_value=bias_value, float_output=True)
        self.bbox_pred = Conv(reg_ch, 4, 3, float_output=True)
        self.centerness = Conv(reg_ch if with_reg_ctr else cls_ch, 1, 3,
                               float_output=True)
        for l in range(num_levels):
            self.add_module(f"scale{l}", Scale(1.0))

    def forward(self, features, compute_cls: bool = True):
        """features: list of NHWC maps. Returns (logits, bbox_reg,
        centerness) lists of float32 NHWC maps; logits is empty when
        compute_cls is False (TEST.MODE 'light' skips the cls tower,
        reference ``fcos.py:97-99``)."""
        logits, bbox_reg, ctrness = [], [], []
        for l, feature in enumerate(features):
            if compute_cls or not self.with_reg_ctr:
                c = self.cls_tower(feature)
            if compute_cls:
                logits.append(self.cls_logits(c).float())
            r = self.bbox_tower(feature)
            ctrness.append(self.centerness(r if self.with_reg_ctr else c).float())
            reg = getattr(self, f"scale{l}")(self.bbox_pred(r).float())
            bbox_reg.append(torch.exp(torch.clamp(reg, max=25.0)))
        return logits, bbox_reg, ctrness
