"""Adversarial domain discriminators (counterpart of
``scan_tpu/modeling/discriminator/discriminators.py``).

* ``FCOSDiscriminator`` (global alignment, GA; reference
  ``fcos_head_discriminator.py:11-74``): GRL, a conv + GN tower, 1-channel
  logits, BCE against the domain label.
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
ported. The center-aware (CA) and output-space (OUT) discriminators are
not ported; the C2F config uses neither.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv, ConvTower, to_nchw, to_nhwc
from .grl import gradient_reversal


def _bce_with_logits(logits, target: float):
    return (logits.clamp_min(0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


class FCOSDiscriminator(nn.Module):
    """Global alignment discriminator (GA, ``discriminators.py:58-80``)."""

    def __init__(self, num_convs=2, in_channels=256, grl_lambda=0.1,
                 grl_applied_domain="both", patch_stride=None):
        super().__init__()
        self.grl_lambda = grl_lambda
        self.grl_applied_domain = grl_applied_domain
        self.patch_stride = patch_stride
        self.dis_tower = ConvTower(num_convs, in_channels, in_channels)
        self.cls_logits = Conv(in_channels, 1, 3)

    def forward(self, feature, target: float, domain: str = "source"):
        if self.grl_applied_domain == "both" or domain == "target":
            feature = gradient_reversal(feature, self.grl_lambda)
        if self.patch_stride:
            feature = to_nhwc(F.avg_pool2d(to_nchw(feature), 3,
                                           self.patch_stride, padding=1))
        x = self.cls_logits(self.dis_tower(feature)).float()
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
        logits = F.conv2d(h, torch.cat([m.weight for m in head1]).to(dt),
                          padding=1, groups=n)
        b1 = torch.cat([m.bias for m in head1]).to(dt)
        logits = to_nhwc(logits + b1[None, :, None, None]).float()  # (B,H,W,N)

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
