"""RetinaNet head, IoU matcher and losses over NHWC tensors (counterpart of
``scan_tpu/modeling/retinanet.py``).

Reference ``fcos_core/modeling/rpn/retinanet/`` (``retinanet.py:13-151``,
``loss.py``): shared 4-conv towers without norm, A = ratios x
scales_per_octave anchors a cell, the IoU matcher (fg 0.5 / bg 0.4, with
low-quality matches), the sigmoid focal loss normalised by the positives,
and smooth-L1 on Faster R-CNN deltas. ``matcher_assign`` also serves the
ATSS head's ``IoU`` positive type and the two-stage detector's RPN and box
head; ``smooth_l1`` their box losses.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.focal_loss import sigmoid_focal_loss
from ..structures.boxes import box_iou, encode_boxes
from .layers import Conv


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    num_classes: int = 81
    num_convs: int = 4
    prior_prob: float = 0.01
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    strides: tuple = (8, 16, 32, 64, 128)
    octave: float = 2.0
    scales_per_octave: int = 3
    fg_iou: float = 0.5
    bg_iou: float = 0.4
    loss_gamma: float = 2.0
    loss_alpha: float = 0.25
    bbox_reg_weight: float = 4.0
    bbox_reg_beta: float = 0.11

    @property
    def num_anchors(self):
        return len(self.aspect_ratios) * self.scales_per_octave

    @staticmethod
    def from_cfg(cfg):
        r = cfg.MODEL.RETINANET
        return RetinaNetConfig(
            num_classes=r.NUM_CLASSES,
            num_convs=r.NUM_CONVS,
            prior_prob=r.PRIOR_PROB,
            anchor_sizes=tuple(r.ANCHOR_SIZES),
            aspect_ratios=tuple(r.ASPECT_RATIOS),
            strides=tuple(r.ANCHOR_STRIDES),
            octave=r.OCTAVE,
            scales_per_octave=r.SCALES_PER_OCTAVE,
            fg_iou=r.FG_IOU_THRESHOLD,
            bg_iou=r.BG_IOU_THRESHOLD,
            loss_gamma=r.LOSS_GAMMA,
            loss_alpha=r.LOSS_ALPHA,
            bbox_reg_weight=r.BBOX_REG_WEIGHT,
            bbox_reg_beta=r.BBOX_REG_BETA,
        )


class RetinaNetHead(nn.Module):
    """cls and box towers of ``num_convs`` x [3x3 conv, ReLU] (no norm,
    reference ``retinanet.py:36-56``), shared across levels, then
    ``cls_logits`` (A x (classes - 1), the focal prior bias) and
    ``bbox_pred`` (A x 4), 3x3. Convs Normal(0.01), zero bias.
    ``in_channels`` is the towers' width (``scan_tpu``'s field),
    ``input_channels`` the FPN's, which flax infers. The two prediction
    convs give float32 from compute-dtype operands (``float_output``), as
    ``scan_tpu``'s jitted ``.astype(jnp.float32)`` keeps them."""

    def __init__(self, cfg: RetinaNetConfig, in_channels=256,
                 input_channels=None):
        super().__init__()
        self.cfg = cfg
        cin = input_channels or in_channels
        for i in range(cfg.num_convs):
            c = cin if i == 0 else in_channels
            self.add_module(f"cls_conv{i}", Conv(c, in_channels, 3))
            self.add_module(f"box_conv{i}", Conv(c, in_channels, 3))
        last = in_channels if cfg.num_convs else cin
        na = cfg.num_anchors
        bias_value = -math.log((1 - cfg.prior_prob) / cfg.prior_prob)
        self.cls_logits = Conv(last, na * (cfg.num_classes - 1), 3,
                               bias_value=bias_value, float_output=True)
        self.bbox_pred = Conv(last, na * 4, 3, float_output=True)

    def forward(self, features):
        logits, bbox_reg = [], []
        for f in features:
            ct, bt = f, f
            for i in range(self.cfg.num_convs):
                ct = F.relu(getattr(self, f"cls_conv{i}")(ct))
                bt = F.relu(getattr(self, f"box_conv{i}")(bt))
            logits.append(self.cls_logits(ct).float())
            bbox_reg.append(self.bbox_pred(bt).float())
        return logits, bbox_reg


def matcher_assign(ious, fg_thresh, bg_thresh, allow_low_quality=True):
    """Reference Matcher semantics (``modeling/matcher.py``) over ious
    (..., L, G): each anchor's best gt; below ``bg_thresh`` -> -1
    (background), in [bg, fg) -> -2 (ignored); low-quality matches force
    each gt's best anchors positive. Returns the matched gt index (or -1 /
    -2), int64. Ties go to the first maximum, as ``jnp.argmax``'s."""
    vals = ious.amax(dim=-1)
    idx = ious.argmax(dim=-1)
    minus = lambda v: torch.full_like(idx, v)  # noqa: E731
    matches = torch.where(vals >= fg_thresh, idx, minus(-1))
    matches = torch.where((vals >= bg_thresh) & (vals < fg_thresh),
                          minus(-2), matches)
    if allow_low_quality:
        best_per_gt = ious.amax(dim=-2, keepdim=True)  # (..., 1, G)
        is_best = ious >= best_per_gt.clamp_min(1e-5)
        matches = torch.where(is_best.any(dim=-1), idx, matches)
    return matches


def smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def take_rows(values, idx):
    """values (B, G, ...) gathered at idx (B, N) along G -> (B, N, ...)."""
    shape = idx.shape + values.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    expand = flat.reshape(flat.shape + (1,) * (values.dim() - 2)).expand(
        flat.shape + values.shape[2:])
    return torch.gather(values, 1, expand).reshape(shape)


def retinanet_losses(cfg: RetinaNetConfig, anchors_levels, box_cls,
                     box_regression, gt_boxes, gt_labels, gt_mask):
    """Focal classification over every matched anchor (ignored ones out),
    normalised by max(positives + anchors / 1000, 1), and smooth-L1 box
    regression on the positives (``retinanet.py:121-166``)."""
    num_fg = cfg.num_classes - 1
    anchors = torch.cat(anchors_levels, 0)
    b = gt_boxes.shape[0]
    ious = box_iou(anchors.expand(b, -1, -1), gt_boxes) * gt_mask[:, None, :]
    matches = matcher_assign(ious, cfg.fg_iou, cfg.bg_iou)
    matches = torch.where(gt_mask.any(dim=1, keepdim=True), matches,
                          torch.full_like(matches, -1))
    safe = matches.clamp_min(0)
    cls = torch.where(matches >= 0, take_rows(gt_labels, safe).long(),
                      torch.zeros_like(matches))
    cls = torch.where(matches == -2, torch.full_like(cls, -1), cls)
    reg_t = encode_boxes(take_rows(gt_boxes, safe), anchors[None])

    cls_flat = torch.cat([m.reshape(m.shape[0], -1, num_fg) for m in box_cls],
                         1).reshape(-1, num_fg)
    reg_flat = torch.cat([m.reshape(m.shape[0], -1, 4)
                          for m in box_regression], 1).reshape(-1, 4)
    labels = cls.reshape(-1)
    pos = labels > 0
    valid = labels >= 0
    num_pos = pos.float().sum().clamp_min(1.0)
    cls_loss = sigmoid_focal_loss(
        cls_flat, labels, cfg.loss_gamma, cfg.loss_alpha, valid_mask=valid
    ) / (num_pos + cls_flat.shape[0] / 1000.0).clamp_min(1.0)
    reg_loss = (smooth_l1(reg_flat - reg_t.reshape(-1, 4),
                          cfg.bbox_reg_beta).sum(1) * pos).sum() \
        / (num_pos * 4.0) * cfg.bbox_reg_weight
    return {"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss}
