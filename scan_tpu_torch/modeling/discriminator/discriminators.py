"""Adversarial domain discriminators (counterpart of
``scan_tpu/modeling/discriminator/discriminators.py``).

* ``FCOSDiscriminator`` (global alignment, GA; reference
  ``fcos_head_discriminator.py:11-74``): GRL, a conv + GN tower, 1-channel
  logits, BCE against the domain label.
* ``FCOSDiscriminatorCA`` (center-aware; reference
  ``fcos_head_discriminator_CA.py:7-124``): the GA discriminator weighted by
  the attention map ``sigmoid(w * max_c sigmoid(cls) * sigmoid(ctr))`` of
  the detached score maps, in one of three types: ``ca_feature`` (the
  attention scales the feature, under the GRL), ``ca_loss`` (it weights the
  BCE map) and ``focal`` (``ca_feature`` with a (1 - p_t)^5 focal BCE).
* ``FCOSDiscriminatorOut`` (output-space; reference
  ``fcos_head_discriminator_out.py:14-186``): aligns the concatenated
  (reg, cls, ctr) prediction maps after an ``outmap_op`` (``sigmoid``,
  ``maxpool``, ``attreg`` or ``none``) through a GN tower
  (``base_dis_tower``) or stride-2 convs with ReLU, with a ``ce`` or
  ``focal`` loss, not scaled by ``out_weight`` (which weights only the
  ``attreg`` attention map). The maps keep their gradient.
* ``FCOSDiscriminatorCon`` (Conditional-Kernel-guided Alignment, CKA, the
  SCAN one; reference ``fcos_head_discriminator_con.py:12-127``): a shared
  GN tower and one small conv classifier per foreground class, the feature
  fused with that class's act map (``concat``, ``mul`` or ``mul_detached``),
  a BCE weighted by the detached act maps; with GRL_APPLIED_DOMAIN ``both``
  the reversal applies to the features and to the act maps.

Both return scalar losses; the GRL lambda is a constructor argument. The
per-class heads keep ``scan_tpu``'s parameter names
(``classifier_cls_{c}_{0,1}``) and execute as ``scan_tpu``'s do: one wide
conv over the features plus a grouped conv (``groups = num_fg``) for the
act-map tap, or one grouped conv over the class-stacked product, then a
grouped conv for the 128 -> 1 logits. ``scan_tpu``'s CKA field
``with_ga`` (MODEL.ADV.CON_WITH_GA) changes nothing there and is not
ported.

Parameter names are ``scan_tpu``'s (``dis_tower``, ``cls_logits``,
``dis_conv{i}``), so its trees carry over (``utils/jax_weights.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (Conv, ConvTower, float_output_conv, to_nchw,
                      to_nhwc)
from .grl import gradient_reversal


def _bce_with_logits(logits, target: float):
    return (logits.clamp_min(0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


class FCOSDiscriminator(nn.Module):
    """Global alignment discriminator (GA, ``discriminators.py:58-80``)."""

    def __init__(self, num_convs=2, in_channels=256, grl_lambda=0.1,
                 grl_applied_domain="both", patch_stride=None,
                 input_channels=None):
        super().__init__()
        self.grl_lambda = grl_lambda
        self.grl_applied_domain = grl_applied_domain
        self.patch_stride = patch_stride
        cin = input_channels or in_channels
        self.dis_tower = ConvTower(num_convs, cin, in_channels)
        self.cls_logits = Conv(in_channels if num_convs else cin, 1, 3,
                               float_output=True)

    def forward(self, feature, target: float, domain: str = "source"):
        if self.grl_applied_domain == "both" or domain == "target":
            feature = gradient_reversal(feature, self.grl_lambda)
        if self.patch_stride:
            feature = to_nhwc(F.avg_pool2d(to_nchw(feature), 3,
                                           self.patch_stride, padding=1))
        x = self.cls_logits(self.dis_tower(feature)).float()
        return _bce_with_logits(x, target).mean()


def _focal_bce(logits, target: float):
    """The (1 - p_t)^5-weighted BCE of the CA ``focal`` type and the OUT
    ``focal`` loss, as a mean."""
    bce = _bce_with_logits(logits, target)
    return ((1 - torch.exp(-bce)) ** 5.0 * bce).mean()


class FCOSDiscriminatorCA(nn.Module):
    """Center-aware discriminator (CA, ``discriminators.py:83-127``)."""

    TYPES = ("ca_feature", "ca_loss", "focal")

    def __init__(self, num_convs=2, in_channels=256, grl_lambda=0.1,
                 center_aware_weight=20.0, center_aware_type="ca_feature",
                 grl_applied_domain="both", input_channels=None):
        super().__init__()
        if center_aware_type not in self.TYPES:
            raise KeyError(f"Unknown center-aware type: {center_aware_type}")
        self.grl_lambda = grl_lambda
        self.center_aware_weight = center_aware_weight
        self.center_aware_type = center_aware_type
        self.grl_applied_domain = grl_applied_domain
        cin = input_channels or in_channels
        self.dis_tower = ConvTower(num_convs, cin, in_channels)
        self.cls_logits = Conv(in_channels if num_convs else cin, 1, 3,
                               float_output=True)

    def forward(self, feature, target: float, score_map, domain="source"):
        """feature (B, H, W, C) NHWC; score_map holds this level's
        ``box_cls`` (B, H, W, C_fg) and ``centerness`` (B, H, W, 1)."""
        cls_prob = torch.sigmoid(score_map["box_cls"].detach())
        ctr_prob = torch.sigmoid(score_map["centerness"].detach())
        atten = torch.sigmoid(self.center_aware_weight
                              * cls_prob.amax(dim=-1, keepdim=True) * ctr_prob)
        apply_grl = self.grl_applied_domain == "both" or domain == "target"
        if self.center_aware_type == "ca_loss":
            f = gradient_reversal(feature, self.grl_lambda) if apply_grl \
                else feature
            x = self.cls_logits(self.dis_tower(f)).float()
            return (atten * _bce_with_logits(x, target)).mean()
        f = atten * feature  # float32, as JAX promotes a bf16 feature
        if apply_grl:
            f = gradient_reversal(f, self.grl_lambda)
        x = self.cls_logits(self.dis_tower(f)).float()
        if self.center_aware_type == "focal":
            return _focal_bce(x, target)
        return _bce_with_logits(x, target).mean()


class FCOSDiscriminatorOut(nn.Module):
    """Output-space discriminator (OUT, ``discriminators.py:130-201``).
    Its input width follows from the maps it aligns: reg (4), cls
    (num_classes - 1) and ctr (1) as selected, or 6 for ``maxpool`` (reg,
    the pooled cls, ctr) and 5 for ``attreg`` (the attention map, reg)."""

    OPS = ("sigmoid", "maxpool", "attreg", "none")

    def __init__(self, num_convs=2, grl_lambda=0.1, out_weight=0.5,
                 out_loss="ce", outmap_op="sigmoid", use_reg=True,
                 use_cls=True, use_ctr=True, num_classes=9,
                 base_dis_tower=False, grl_applied_domain="both"):
        super().__init__()
        if outmap_op not in self.OPS:
            raise NotImplementedError(outmap_op)
        if out_loss not in ("ce", "focal"):
            raise KeyError(f"Unknown output-space loss: {out_loss}")
        used = (use_reg, use_cls, use_ctr)
        if outmap_op == "attreg" and not all(used):
            raise ValueError("attreg must align cls, reg, ctr")
        self.grl_lambda = grl_lambda
        self.out_weight = out_weight
        self.out_loss = out_loss
        self.outmap_op = outmap_op
        self.used = used
        self.grl_applied_domain = grl_applied_domain
        self.num_convs = num_convs
        self.base_dis_tower = base_dis_tower
        ch = {"maxpool": 6, "attreg": 5}.get(
            outmap_op, 4 * use_reg + (num_classes - 1) * use_cls + use_ctr)
        if base_dis_tower:
            self.dis_tower = ConvTower(num_convs, ch, ch)
        else:
            for i in range(num_convs):
                self.add_module(f"dis_conv{i}", Conv(ch, ch, 3, stride=2))
        self.cls_logits = Conv(ch, 1, 3, float_output=True)

    def forward(self, score_map, target: float, domain: str = "source"):
        reg = score_map["box_regression"]
        cls = score_map["box_cls"]
        ctr = score_map["centerness"]
        if self.outmap_op == "maxpool":
            # max over the cls channels, then (reg, pooled, ctr) and sigmoid
            x = torch.sigmoid(torch.cat(
                [reg, cls.amax(dim=-1, keepdim=True), ctr], dim=-1))
        elif self.outmap_op == "attreg":
            pooled = torch.sigmoid(cls).amax(dim=-1, keepdim=True)
            att = torch.sigmoid(self.out_weight * pooled * torch.sigmoid(ctr))
            x = torch.cat([att, torch.sigmoid(reg)], dim=-1)
        else:
            x = torch.cat([m for m, u in zip((reg, cls, ctr), self.used) if u],
                          dim=-1)
            if self.outmap_op == "sigmoid":
                x = torch.sigmoid(x)
        if self.grl_applied_domain == "both" or domain == "target":
            x = gradient_reversal(x, self.grl_lambda)
        if self.base_dis_tower:
            x = self.dis_tower(x)
        else:
            for i in range(self.num_convs):
                x = F.relu(getattr(self, f"dis_conv{i}")(x))
        x = self.cls_logits(x).float()
        # not scaled by out_weight (discriminators.py:194-196)
        if self.out_loss == "focal":
            return _focal_bce(x, target)
        return _bce_with_logits(x, target).mean()


class FCOSDiscriminatorCon(nn.Module):
    """Conditional-kernel-guided alignment (CKA, ``discriminators.py:204-299``)."""

    def __init__(self, num_convs=4, in_channels=256, num_classes=9,
                 fusion_cfg="concat", grl_lambda=0.02,
                 grl_applied_domain="both"):
        super().__init__()
        if fusion_cfg not in ("concat", "mul", "mul_detached"):
            raise KeyError(f"Unknown fusion config: {fusion_cfg}")
        self.num_fg = num_classes - 1
        self.fusion_cfg = fusion_cfg
        self.grl_lambda = grl_lambda
        self.grl_applied_domain = grl_applied_domain
        self.dis_tower = ConvTower(num_convs, in_channels, in_channels)
        extra = 1 if fusion_cfg == "concat" else 0
        for c in range(self.num_fg):
            self.add_module(f"classifier_cls_{c}_0",
                            Conv(in_channels + extra, 128, 3))
            self.add_module(f"classifier_cls_{c}_1", Conv(128, 1, 3))

    def _heads(self, i):
        return [getattr(self, f"classifier_cls_{c}_{i}")
                for c in range(self.num_fg)]

    def forward(self, feature, target: float, act_maps, domain: str = "source"):
        """feature (B, H, W, C) and act_maps (B, H, W, C_used), NHWC."""
        n = self.num_fg
        if self.grl_applied_domain == "both":
            feature = gradient_reversal(feature, self.grl_lambda)
            act_maps = gradient_reversal(act_maps, self.grl_lambda)
        elif domain == "target":
            feature = gradient_reversal(feature, self.grl_lambda)
        x = to_nchw(self.dis_tower(feature))
        cin, dt = x.shape[1], x.dtype
        amaps = act_maps[..., 1:n + 1]  # skip the background channel
        head0, head1 = self._heads(0), self._heads(1)
        if self.fusion_cfg == "concat":
            # h_c = relu(x (*) W_c[:, :cin] + amap_c (*) W_c[:, cin:] + b_c)
            wx = torch.cat([m.weight[:, :cin] for m in head0])
            wa = torch.cat([m.weight[:, cin:] for m in head0])
            h = F.conv2d(x, wx.to(dt), padding=1) + F.conv2d(
                to_nchw(amaps.to(dt)), wa.to(dt), padding=1, groups=n)
        else:
            amaps_f = amaps.detach() if self.fusion_cfg == "mul_detached" \
                else amaps
            # x * amap_c differs per class: a grouped conv over the
            # class-stacked input (B, H, W, N * cin)
            xs = to_nhwc(x)[..., None, :] * amaps_f[..., :, None].to(dt)
            xs = xs.reshape(xs.shape[:3] + (n * cin,))
            h = F.conv2d(to_nchw(xs), torch.cat([m.weight for m in head0]).to(dt),
                         padding=1, groups=n)
        b0 = torch.cat([m.bias for m in head0]).to(dt)
        h = F.relu(h + b0[None, :, None, None])
        # the logits in float32 from compute-dtype operands, as the
        # prediction convs of layers.Conv (float_output)
        w1 = torch.cat([m.weight for m in head1]).to(dt)
        b1 = torch.cat([m.bias for m in head1]).to(dt)
        if dt == torch.float32:
            logits = F.conv2d(h, w1, b1, padding=1, groups=n)
        else:
            logits = float_output_conv(h, w1, b1, groups=n)
        logits = to_nhwc(logits)  # (B, H, W, N) float32

        w = amaps.detach().float()
        bce = _bce_with_logits(logits, target)
        if n > 1:
            # act-map-weighted BCE normalised by the act-map mass, per class
            # (reference con.py:119-121)
            per_cls = (bce * w).sum(dim=(0, 1, 2)) / w.sum(
                dim=(0, 1, 2)).clamp_min(1e-6)
        else:
            per_cls = bce.mean(dim=(0, 1, 2))
        return per_cls.sum() / n
