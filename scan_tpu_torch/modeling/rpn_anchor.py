"""Anchor-based RPN over NHWC tensors (counterpart of
``scan_tpu/modeling/rpn_anchor.py``).

Reference ``fcos_core/modeling/rpn/rpn.py:16-198``, ``rpn/loss.py`` and
``rpn/inference.py``: a single 3x3 conv head with per-anchor objectness and
4-delta regression, the IoU matcher (0.7 / 0.3, with low-quality matches),
a balanced binary objectness loss and smooth-L1 (beta 1/9) on the
positives, and per-level top-k + NMS proposal selection. As in
``scan_tpu`` the shapes are fixed: proposals are (B, POST_NMS_TOP_N, 4)
with a validity mask, and the balanced subset is deterministic (every
positive, then the hardest negatives).

Ties: ``lax.top_k`` returns the lower index first among equal values, and
``stable_top_k`` (a stable descending sort, its first k) does the same;
``torch.topk`` promises no order. That matters for the pre-NMS top-k, the
post-NMS top-k over the -1 of suppressed entries (which decides the boxes
in invalid slots only) and the hard negatives.

``rpn_proposals`` runs K1 (``ops/nms.py::nms_keep_mask``) once a level,
over every image of the batch in one launch, at K = min(PRE_NMS_TOP_N,
H x W x A): 6000 a level at ``scan_tpu``'s test default, 12,000 at its
train default.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_keep_mask
from ..structures.boxes import box_iou, clip_boxes, decode_boxes, encode_boxes
from .layers import Conv
from .retinanet import matcher_assign, smooth_l1, take_rows


def stable_top_k(x, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first, as ``jax.lax.top_k``."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    strides: tuple = (4, 8, 16, 32, 64)
    fg_iou: float = 0.7
    bg_iou: float = 0.3
    batch_per_image: int = 256
    positive_fraction: float = 0.5
    pre_nms_top_n: int = 2000
    post_nms_top_n: int = 1000
    nms_thresh: float = 0.7
    min_size: float = 0.0

    @property
    def num_anchors(self):
        return len(self.aspect_ratios)

    @staticmethod
    def from_cfg(cfg, is_train: bool):
        r = cfg.MODEL.RPN
        strides = tuple(r.ANCHOR_STRIDE) if len(r.ANCHOR_STRIDE) > 1 else (
            tuple(r.ANCHOR_STRIDE) * len(r.ANCHOR_SIZES)
            if r.USE_FPN else tuple(r.ANCHOR_STRIDE)
        )
        return RPNConfig(
            anchor_sizes=tuple(r.ANCHOR_SIZES),
            aspect_ratios=tuple(r.ASPECT_RATIOS),
            strides=strides,
            fg_iou=r.FG_IOU_THRESHOLD,
            bg_iou=r.BG_IOU_THRESHOLD,
            batch_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION,
            pre_nms_top_n=(r.PRE_NMS_TOP_N_TRAIN if is_train
                           else r.PRE_NMS_TOP_N_TEST),
            post_nms_top_n=(r.POST_NMS_TOP_N_TRAIN if is_train
                            else r.POST_NMS_TOP_N_TEST),
            nms_thresh=r.NMS_THRESH,
            min_size=r.MIN_SIZE,
        )


class RPNHead(nn.Module):
    """SingleConvRPNHead (reference ``rpn.py:60-87``): conv 3x3 to
    ``in_channels`` (256, ``scan_tpu``'s field, whatever the input's width
    ``input_channels``), ReLU, then 1x1 ``cls_logits`` (A) and
    ``bbox_pred`` (4A); every conv Normal(0.01), zero bias. In bf16 the two
    1x1 convs round to bf16 before the cast to float32: so does
    ``scan_tpu``'s jitted step (unlike its FCOS logits, XLA keeps no float32
    sum here; on its features the port's rounding convs give its RPN losses
    within rtol 1e-6, float32 results ~2e-4 away,
    ``tests/test_torch_two_stage_bf16.py``)."""

    def __init__(self, num_anchors, in_channels=256, input_channels=None):
        super().__init__()
        self.conv = Conv(input_channels or in_channels, in_channels, 3)
        self.cls_logits = Conv(in_channels, num_anchors, 1)
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 1)

    def forward(self, features):
        logits, bbox_reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.cls_logits(t).float())
            bbox_reg.append(self.bbox_pred(t).float())
        return logits, bbox_reg


def _flat(maps, width):
    """Per-level (B, H, W, A * width) maps -> (B, sum H W A, width)."""
    return torch.cat([m.reshape(m.shape[0], -1, width) for m in maps], 1)


def rpn_losses(cfg: RPNConfig, anchors_levels, objectness, box_regression,
               gt_boxes, gt_mask):
    """Binary objectness over the sampled anchors and smooth-L1 on the
    positives, both over the sampled count (``rpn_anchor.py:91-143``). The
    hard negatives are the highest-scoring ``batch_per_image`` over the
    whole flattened batch, not per image, as in ``scan_tpu``."""
    anchors = torch.cat(anchors_levels, 0)
    b = gt_boxes.shape[0]
    ious = box_iou(anchors.expand(b, -1, -1), gt_boxes) * gt_mask[:, None, :]
    matches = matcher_assign(ious, cfg.fg_iou, cfg.bg_iou)
    matches = torch.where(gt_mask.any(dim=1, keepdim=True), matches,
                          torch.full_like(matches, -1))
    reg_t = encode_boxes(take_rows(gt_boxes, matches.clamp_min(0)),
                         anchors[None])

    obj = _flat(objectness, 1).reshape(-1)
    reg = _flat(box_regression, 4).reshape(-1, 4)
    m = matches.reshape(-1)
    pos = m >= 0
    neg = m == -1
    n_pos = pos.float().sum()
    n_neg_want = cfg.batch_per_image - n_pos.clamp(
        max=cfg.batch_per_image * cfg.positive_fraction)
    neg_scores = torch.where(neg, obj.detach(),
                             torch.full_like(obj, -float("inf")))
    k = min(cfg.batch_per_image, neg_scores.shape[0])
    _, hard = stable_top_k(neg_scores, k)
    neg_sel = torch.zeros_like(neg).index_fill(0, hard, True) & neg
    rank = torch.cumsum(neg_sel.long(), 0) - 1
    neg_sel = neg_sel & (rank < n_neg_want)

    sampled = (pos | neg_sel).float()
    tgt = pos.float()
    bce = obj.clamp_min(0) - obj * tgt + torch.log1p(torch.exp(-obj.abs()))
    denom = sampled.sum().clamp_min(1.0)
    obj_loss = (bce * sampled).sum() / denom
    reg_loss = (smooth_l1(reg - reg_t.reshape(-1, 4), 1.0 / 9).sum(1)
                * pos).sum() / denom.clamp_min(1.0)
    return {"loss_objectness": obj_loss, "loss_rpn_box_reg": reg_loss}


def rpn_proposals(cfg: RPNConfig, anchors_levels, objectness, box_regression,
                  image_sizes):
    """Fixed-shape proposals (``rpn_anchor.py:146-192``): per level, the
    top ``pre_nms_top_n`` sigmoid scores, their decoded boxes clipped to
    the image, the ``min_size`` test, and NMS (K1, the whole batch in one
    launch); then the top ``post_nms_top_n`` over the levels' survivors.
    Returns dict(boxes (B, N, 4), scores (B, N), valid (B, N))."""
    heights = image_sizes[:, 0].float()
    widths = image_sizes[:, 1].float()
    boxes_all, scores_all = [], []
    for anchors, obj, reg in zip(anchors_levels, objectness, box_regression):
        b = obj.shape[0]
        scores = torch.sigmoid(obj.reshape(b, -1))
        k = min(cfg.pre_nms_top_n, scores.shape[1])
        top, idx = stable_top_k(scores, k)
        deltas = take_rows(reg.reshape(b, -1, 4), idx)
        props = decode_boxes(deltas, anchors[idx])
        props = clip_boxes(props, heights, widths)
        ok = ((props[..., 2] - props[..., 0] >= cfg.min_size)
              & (props[..., 3] - props[..., 1] >= cfg.min_size))
        keep = nms_keep_mask(props, top, ok, cfg.nms_thresh)
        boxes_all.append(props)
        scores_all.append(torch.where(keep, top, torch.full_like(top, -1.0)))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    n = min(cfg.post_nms_top_n, scores.shape[1])
    top, idx = stable_top_k(scores, n)
    return dict(boxes=take_rows(boxes, idx), scores=top.clamp_min(0.0),
                valid=top > 0)
