"""RoI heads of the two-stage detector over NHWC tensors (counterpart of
``scan_tpu/modeling/roi_heads.py``).

Reference ``fcos_core/modeling/roi_heads/`` and ``modeling/poolers.py``:
the FPN pooler with the canonical LevelMapper (k = floor(4 +
log2(sqrt(area) / 224))), the box head (FPN2MLP: ROIAlign, fc6 and fc7,
then the cls and per-class box predictors), its CE + smooth-L1 losses and
per-class NMS postprocess; the mask head (4 x conv3x3 + ReLU, a 2x2
stride-2 deconv, per-class 1x1 logits, BCE on the positives) and the
keypoint head (8 x conv3x3 + ReLU, a 4x4 stride-2 deconv, a 2x bilinear
upscale, CE over the heatmap cells). Proposals come in as a fixed (B, N, 4)
masked array, as in ``scan_tpu``.

``fpn_pooler`` pools each RoI only at its own level
(``ops/roi_align.py::roi_align_levels``); ``scan_tpu`` pools at every
level and sums the masked results, which is the same for finite features.
``RoIBoxHead`` flattens the pooled (R, res, res, C) map in NHWC order, as
flax does, so ``fc6``'s rows carry over unpermuted.

Ties: ``roi_box_postprocess``'s top-k over the -1 of invalid entries and
its final top-k take a stable sort's first k, as ``lax.top_k`` does; only
invalid slots can differ from ``scan_tpu``'s.

bf16: the box head's Dense layers have no dtype in ``scan_tpu`` and stay
float32; the mask head's convs and deconv compute in bf16 and its 1x1
logits round to bf16 before the cast to float32; the keypoint head's deconv
computes in bf16 and its 2x resize rounds to bf16 after each axis. Both
heads equal ``scan_tpu``'s bf16 heads bit for bit on the CPU, jitted or
not (``tests/test_torch_roi_heads.py``).
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_keep_mask
from ..ops.roi_align import roi_align_levels
from ..structures.boxes import box_iou, clip_boxes, decode_boxes, encode_boxes
from .layers import Conv, ConvTranspose, Linear, to_nchw, to_nhwc
from .retinanet import matcher_assign, smooth_l1, take_rows
from .rpn_anchor import stable_top_k


@dataclasses.dataclass(frozen=True)
class RoIBoxConfig:
    num_classes: int = 81
    pooler_resolution: int = 7
    pooler_scales: tuple = (0.25, 0.125, 0.0625, 0.03125)
    sampling_ratio: int = 2
    mlp_dim: int = 1024
    fg_iou: float = 0.5
    bg_iou: float = 0.5
    batch_per_image: int = 512
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    bbox_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)

    @staticmethod
    def from_cfg(cfg):
        h = cfg.MODEL.ROI_HEADS
        b = cfg.MODEL.ROI_BOX_HEAD
        return RoIBoxConfig(
            num_classes=b.NUM_CLASSES,
            pooler_resolution=b.POOLER_RESOLUTION,
            pooler_scales=tuple(b.POOLER_SCALES),
            sampling_ratio=b.POOLER_SAMPLING_RATIO or 2,
            mlp_dim=b.MLP_HEAD_DIM,
            fg_iou=h.FG_IOU_THRESHOLD,
            bg_iou=h.BG_IOU_THRESHOLD,
            batch_per_image=h.BATCH_SIZE_PER_IMAGE,
            positive_fraction=h.POSITIVE_FRACTION,
            score_thresh=h.SCORE_THRESH,
            nms_thresh=h.NMS,
            detections_per_img=h.DETECTIONS_PER_IMG,
            bbox_reg_weights=tuple(h.BBOX_REG_WEIGHTS),
        )


def level_map(rois, num_levels, canonical_scale=224, canonical_level=4,
              min_level=2):
    """LevelMapper (reference ``poolers.py:11-43``): each RoI's level,
    0-based from ``min_level``."""
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(torch.clamp_min(w * h, 1e-6))
    lvl = torch.floor(canonical_level
                      + torch.log2(scale / canonical_scale + 1e-6))
    # a NaN RoI (a diverged step) maps to the first level, not to int32's
    # minimum; its pooled values are NaN at any level
    lvl = lvl.nan_to_num(min_level).clamp(min_level,
                                          min_level + num_levels - 1)
    return (lvl - min_level).int()


def fpn_pooler(cfg, features, rois, batch_indices):
    """Pool each RoI from its assigned level (``poolers.py:45-124``).
    ``cfg`` gives ``pooler_resolution``, ``pooler_scales`` and
    ``sampling_ratio``; features: NHWC maps, the first
    ``len(pooler_scales)`` used; rois (R, 4); batch_indices (R,). Returns
    (R, res, res, C) float32."""
    n = len(cfg.pooler_scales)
    if len(features) < n:
        raise ValueError(f"fpn_pooler: {n} scales but {len(features)} maps")
    levels = level_map(rois, n)
    return roi_align_levels(list(features[:n]), rois, batch_indices, levels,
                            cfg.pooler_scales, cfg.pooler_resolution,
                            cfg.sampling_ratio)


class RoIBoxHead(nn.Module):
    """FPN2MLP extractor + FastRCNNPredictor: the pooled (R, res, res, C)
    map flattened in NHWC order, ``fc6`` and ``fc7`` (lecun-normal, ReLU),
    ``cls_score`` Normal(0.01) and ``bbox_pred`` Normal(0.001), zero
    biases. float32 whatever the compute dtype (flax ``Dense`` without
    ``dtype``)."""

    def __init__(self, cfg: RoIBoxConfig, in_channels):
        super().__init__()
        self.cfg = c = cfg
        self.fc6 = Linear(in_channels * c.pooler_resolution ** 2, c.mlp_dim)
        self.fc7 = Linear(c.mlp_dim, c.mlp_dim)
        self.cls_score = Linear(c.mlp_dim, c.num_classes, "normal", 0.01)
        self.bbox_pred = Linear(c.mlp_dim, c.num_classes * 4, "normal", 0.001)

    def forward(self, pooled):
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return self.cls_score(x), self.bbox_pred(x)


def _select_class(values, labels, width):
    """values (N, C * width) per class -> (N, width) of each row's label."""
    n = values.shape[0]
    v = values.reshape(n, -1, width)
    idx = labels.clamp_min(0).long()[:, None, None].expand(n, 1, width)
    return torch.gather(v, 1, idx)[:, 0]


def roi_box_losses(cfg: RoIBoxConfig, cls_logits, bbox_pred, proposals,
                   prop_valid, matched_labels, reg_targets):
    """CE over the valid, non-ignored proposals and smooth-L1 (beta 1) of
    the matched class's deltas on the positives, both over the valid
    count (``roi_heads.py:124-148``)."""
    valid = (prop_valid & (matched_labels >= 0)).float()
    pos = (matched_labels > 0).float()
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -_select_class(logp, matched_labels, 1)[:, 0]
    denom = valid.sum().clamp_min(1.0)
    cls_loss = (ce * valid).sum() / denom
    sel = _select_class(bbox_pred, matched_labels, 4)
    reg_loss = (smooth_l1(sel - reg_targets, 1.0).sum(1) * pos).sum() / denom
    return {"loss_classifier": cls_loss, "loss_box_reg": reg_loss}


def match_proposals(cfg: RoIBoxConfig, proposals, prop_valid, gt_boxes,
                    gt_labels, gt_mask):
    """Second-stage targets (``box_head/loss.py`` semantics,
    ``roi_heads.py:151-174``): the IoU matcher without low-quality
    matches. Returns (matched_labels (B, N) int32: the class, 0 for
    background, -1 ignored; reg_targets (B, N, 4); matched_idx (B, N)
    int32: the GT row of each positive, -1 elsewhere)."""
    ious = box_iou(proposals, gt_boxes) * gt_mask[:, None, :]
    matches = matcher_assign(ious, cfg.fg_iou, cfg.bg_iou,
                             allow_low_quality=False)
    ok = gt_mask.any(dim=1, keepdim=True) & prop_valid
    matches = torch.where(ok, matches, torch.full_like(matches, -1))
    safe = matches.clamp_min(0)
    cls = torch.where(matches >= 0, take_rows(gt_labels, safe).long(),
                      torch.zeros_like(matches))
    cls = torch.where(matches == -2, torch.full_like(cls, -1), cls)
    reg = encode_boxes(take_rows(gt_boxes, safe), proposals,
                       cfg.bbox_reg_weights)
    idx = torch.where(cls > 0, safe, torch.full_like(safe, -1))
    return cls.int(), reg, idx.int()


def roi_box_postprocess(cfg: RoIBoxConfig, cls_logits, bbox_pred, proposals,
                        prop_valid, image_sizes):
    """Per image: softmax scores, per-class decode, the score threshold,
    the top 1024 candidates, ML-NMS (K1, every image in one launch) and the
    top ``detections_per_img`` (``box_head/inference.py``,
    ``roi_heads.py:177-233``). cls_logits (B, N, C), bbox_pred
    (B, N, 4C). Returns dict(boxes, scores, labels, valid), each
    (B, detections_per_img, ...)."""
    nc = cfg.num_classes
    b, n = cls_logits.shape[:2]
    probs = torch.softmax(cls_logits, dim=-1)
    boxes_all = decode_boxes(
        bbox_pred.reshape(b, n, nc, 4),
        proposals[:, :, None, :].expand(b, n, nc, 4),
        cfg.bbox_reg_weights)
    fg_scores = probs[:, :, 1:].reshape(b, -1)
    fg_boxes = boxes_all[:, :, 1:, :].reshape(b, -1, 4)
    fg_labels = torch.arange(1, nc, device=cls_logits.device).repeat(n)
    fg_valid = (prop_valid[:, :, None].expand(b, n, nc - 1).reshape(b, -1)
                & (fg_scores > cfg.score_thresh))
    fg_boxes = clip_boxes(fg_boxes, image_sizes[:, 0].float(),
                          image_sizes[:, 1].float())
    cap = min(1024, fg_scores.shape[1])
    ranked = torch.where(fg_valid, fg_scores, torch.full_like(fg_scores, -1.0))
    top, idx = stable_top_k(ranked, cap)
    boxes = take_rows(fg_boxes, idx)
    labels = fg_labels[idx]
    valid = top > 0
    keep = nms_keep_mask(boxes, top, valid, cfg.nms_thresh, labels=labels)
    final = torch.where(keep, top, torch.full_like(top, -1.0))
    nd = min(cfg.detections_per_img, final.shape[1])
    out_scores, out_idx = stable_top_k(final, nd)
    ov = out_scores > 0
    return dict(
        boxes=take_rows(boxes, out_idx),
        scores=out_scores.clamp_min(0.0),
        labels=torch.where(ov, torch.gather(labels, 1, out_idx),
                           torch.zeros_like(out_idx)),
        valid=ov,
    )


# ---------------------------------------------------------------------- #
# mask head (Mask R-CNN branch)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RoIMaskConfig:
    """Reference ``roi_heads/mask_head/*``: FPN pooler (14x14),
    MaskRCNNFPNFeatureExtractor (4 x [conv3x3 256 + ReLU]), a 2x deconv and
    per-class 1x1 mask logits, BCE on the positive proposals."""

    num_classes: int = 81
    pooler_resolution: int = 14
    pooler_scales: tuple = (0.25, 0.125, 0.0625, 0.03125)
    sampling_ratio: int = 2
    conv_layers: tuple = (256, 256, 256, 256)

    @staticmethod
    def from_cfg(cfg):
        m = cfg.MODEL.ROI_MASK_HEAD
        return RoIMaskConfig(
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            pooler_resolution=m.POOLER_RESOLUTION,
            pooler_scales=tuple(m.POOLER_SCALES),
            sampling_ratio=m.POOLER_SAMPLING_RATIO or 2,
            conv_layers=tuple(m.CONV_LAYERS),
        )


class RoIMaskHead(nn.Module):
    """``mask_fcn{i}``: conv3x3 + ReLU, variance-scaling(2, fan_out,
    normal) kernels; ``conv5_mask``: a 2x2 stride-2 deconv (flax's default
    init) + ReLU; ``mask_fcn_logits``: a 1x1 conv (lecun-normal), cast to
    float32. (R, 2 res, 2 res, num_classes) float32."""

    def __init__(self, cfg: RoIMaskConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        cin = in_channels
        for i, ch in enumerate(cfg.conv_layers):
            self.add_module(f"mask_fcn{i + 1}",
                            Conv(cin, ch, 3, kernel_init="vgg"))
            cin = ch
        self.conv5_mask = ConvTranspose(cin, cfg.conv_layers[-1], 2, 2,
                                        "VALID")
        self.mask_fcn_logits = Conv(cfg.conv_layers[-1], cfg.num_classes, 1,
                                    kernel_init="lecun_normal")

    def forward(self, pooled):
        x = pooled
        for i in range(len(self.cfg.conv_layers)):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x).float()


def _bce_with_logits(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def roi_mask_loss(mask_logits, matched_labels, mask_targets, pos_mask):
    """Per-class BCE over the positive proposals (``mask_head/loss.py``):
    each proposal's own class's logits against its (N, S, S) target."""
    n, s, _, nc = mask_logits.shape
    idx = matched_labels.clamp_min(0).long()[:, None, None, None].expand(
        n, s, s, 1)
    sel = torch.gather(mask_logits, 3, idx)[..., 0]
    bce = _bce_with_logits(sel, mask_targets.float())
    m = pos_mask.float()[:, None, None]
    return (bce * m).sum() / (m.sum() * s * s).clamp_min(1.0)


# ---------------------------------------------------------------------- #
# keypoint head (Keypoint R-CNN branch)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RoIKeypointConfig:
    """Reference ``roi_heads/keypoint_head/*``: KeypointRCNNFeatureExtractor
    (8 x [conv3x3 512 + ReLU]), a deconv and a 2x bilinear upscale to
    per-keypoint heatmaps, CE over each visible keypoint's cell."""

    num_keypoints: int = 17
    pooler_resolution: int = 14
    pooler_scales: tuple = (0.25, 0.125, 0.0625, 0.03125)
    sampling_ratio: int = 2
    conv_layers: tuple = tuple(512 for _ in range(8))

    @staticmethod
    def from_cfg(cfg):
        k = cfg.MODEL.ROI_KEYPOINT_HEAD
        return RoIKeypointConfig(
            num_keypoints=k.NUM_CLASSES,
            pooler_resolution=k.POOLER_RESOLUTION,
            pooler_scales=tuple(k.POOLER_SCALES),
            sampling_ratio=k.POOLER_SAMPLING_RATIO or 2,
            conv_layers=tuple(k.CONV_LAYERS),
        )


class RoIKeypointHead(nn.Module):
    """``conv_fcn{i}``: conv3x3 + ReLU (flax's default init, lecun-normal);
    ``kps_score_lowres``: a 4x4 stride-2 SAME deconv to the keypoints; then
    ``jax.image.resize``'s 2x bilinear (``F.interpolate`` with
    ``align_corners=False``, half-pixel centres, along H and then W, each
    pass rounded to the deconv's dtype as ``jax.image.resize`` rounds; in
    bf16 that equals it bit for bit, jitted or not) and float32.
    (R, 4 res, 4 res, num_keypoints)."""

    def __init__(self, cfg: RoIKeypointConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        cin = in_channels
        for i, ch in enumerate(cfg.conv_layers):
            self.add_module(f"conv_fcn{i + 1}",
                            Conv(cin, ch, 3, kernel_init="lecun_normal"))
            cin = ch
        self.kps_score_lowres = ConvTranspose(cin, cfg.num_keypoints, 4, 2,
                                              "SAME")

    def forward(self, pooled):
        x = pooled
        for i in range(len(self.cfg.conv_layers)):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = to_nchw(self.kps_score_lowres(x))
        h, w = x.shape[2:]
        dt = x.dtype
        # jax.image.resize is separable: H first, rounded to the input's
        # dtype, then W (a bf16 heatmap rounds twice, as scan_tpu's)
        for size in ((2 * h, w), (2 * h, 2 * w)):
            x = F.interpolate(x.float(), size=size, mode="bilinear",
                              align_corners=False).to(dt)
        return to_nhwc(x).float()


def keypoints_to_heatmap(keypoints, rois, heatmap_size):
    """Project (N, K, 3) [x, y, vis] keypoints into each RoI's heatmap grid
    (reference ``structures/keypoint.py:154-184``): floor-discretised,
    points on the max boundary in the last cell. Returns (targets (N, K)
    int32, the flat ``y * S + x`` cell; valid (N, K) float: in the grid
    and visible)."""
    keypoints = keypoints.float()
    rois = rois.float()
    offset = rois[:, None, :2]
    wh = rois[:, 2:] - rois[:, :2]
    scale = heatmap_size / torch.clamp_min(wh, 1e-6)[:, None, :]
    xy = torch.floor((keypoints[..., :2] - offset) * scale)
    on_edge = keypoints[..., :2] == rois[:, None, 2:]
    xy = torch.where(on_edge, torch.full_like(xy, heatmap_size - 1), xy)
    in_grid = ((xy >= 0) & (xy < heatmap_size)).all(dim=-1)
    vis = keypoints[..., 2] > 0
    xy = xy.clamp(0, heatmap_size - 1).int()
    targets = xy[..., 1] * heatmap_size + xy[..., 0]
    return targets, (in_grid & vis).float()


def roi_keypoint_decode(heatmaps, rois):
    """Heatmaps (N, H, W, K) and RoIs (N, 4) -> (xy (N, K, 3) [x, y, 1],
    scores (N, K)): the argmax cell, a quadratic sub-cell offset from its
    neighbours clipped to +-0.5, and the cell centre mapped back into the
    RoI (``roi_heads.py:346-395``; the reference's per-RoI cubic resize has
    data-dependent shapes, PARITY.md)."""
    heatmaps = heatmaps.float()
    rois = rois.float()
    n, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(n, h * w, k)
    pos = flat.argmax(dim=1)  # (N, K), the first maximum
    scores = torch.gather(flat, 1, pos[:, None, :])[:, 0, :]
    x_int = pos % w
    y_int = pos // w

    def at(yy, xx):
        yy = yy.clamp(0, h - 1)
        xx = xx.clamp(0, w - 1)
        return torch.gather(flat, 1, (yy * w + xx)[:, None, :])[:, 0, :]

    f0 = scores
    fxp, fxm = at(y_int, x_int + 1), at(y_int, x_int - 1)
    fyp, fym = at(y_int + 1, x_int), at(y_int - 1, x_int)
    dx = 0.5 * (fxp - fxm) / torch.clamp_min((fxp - 2 * f0 + fxm).abs(), 1e-6)
    dy = 0.5 * (fyp - fym) / torch.clamp_min((fyp - 2 * f0 + fym).abs(), 1e-6)
    dx = dx.clamp(-0.5, 0.5)
    dy = dy.clamp(-0.5, 0.5)
    wh = torch.clamp_min(rois[:, 2:] - rois[:, :2], 1.0)
    x = (x_int + 0.5 + dx) * (wh[:, None, 0] / w) + rois[:, None, 0]
    y = (y_int + 0.5 + dy) * (wh[:, None, 1] / h) + rois[:, None, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1), scores


def roi_keypoint_loss(heatmaps, kp_targets, kp_valid):
    """CE over the heatmap cells: kp_targets (N, K) each keypoint's flat
    cell, kp_valid (N, K) its weight (``keypoint_head/loss.py``)."""
    n, h, w, k = heatmaps.shape
    logits = heatmaps.reshape(n, h * w, k).transpose(1, 2)  # (N, K, HW)
    logp = F.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, 2, kp_targets.clamp_min(0).long()[..., None])
    m = kp_valid.float()
    return -(picked[..., 0] * m).sum() / m.sum().clamp_min(1.0)


def pool_branch(box_cfg, branch_cfg, features, rois, batch_indices):
    """The FPN pooler at a mask or keypoint branch's resolution, scales and
    sampling ratio (``generalized_rcnn.py:63-75``)."""
    cfg = dataclasses.replace(
        box_cfg, pooler_resolution=branch_cfg.pooler_resolution,
        pooler_scales=branch_cfg.pooler_scales,
        sampling_ratio=branch_cfg.sampling_ratio)
    return fpn_pooler(cfg, features, rois, batch_indices)

