"""ATSS head, box coder, sample assignment, losses and postprocess over
NHWC tensors (counterpart of ``scan_tpu/modeling/atss/atss.py``).

Reference ``fcos_core/modeling/rpn/atss/``: shared cls/box towers of
[conv, GN, ReLU] x NUM_CONVS, a per-level Scale on ``bbox_pred`` (ReLU'd
under POINT regression), centerness off the box tower, the focal-prior
``cls_logits`` bias (``atss.py:100-192``); the BOX coder (Faster R-CNN
deltas with the '+1' widths) and the POINT coder (ltrb in stride units,
``atss.py:14-98``); the positive types ATSS, ADAPT_ATSS, SSC, IoU and TOPK
(``loss.py:41-351``); focal / num_pos, centerness-weighted GIoU and BCE
centerness losses (``loss.py:292-339``); and the postprocess: per-level
threshold and top-k, decode, ML-NMS over ``NMS_CAP``, top-100
(``inference.py:11-127``). ``scan_tpu`` vmaps over images; here the batch
is a leading dimension, (B, L, G) masked broadcasts over the
``TPU.MAX_BOXES`` slots.

Ties: ``lax.top_k`` returns the lower index first among equal values;
``torch.topk`` promises no order. Anchor centres lie on a grid, so several
are often equally far from a gt centre, and the choice among them moves
the IoU threshold (mean + std over the candidates) and with it the
positives. So the candidate picks of ATSS, ADAPT_ATSS and TOPK take a
stable sort and its first k, which breaks ties as ``lax.top_k`` does. The
postprocess's top-k run over NEG_INF ties in their invalid slots, which
``torch.topk`` may order otherwise (harmless; compare valid slots).
"""

import dataclasses
import logging
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.focal_loss import sigmoid_focal_loss
from ...structures.boxes import box_iou, clip_boxes
from ..fcos.postprocess import NEG_INF, _gather_rows, select_detections
from ..fcos.targets import compute_targets, expand_soi
from ..layers import Conv, ConvTower, Scale
from ..retinanet import matcher_assign

INF = 100000000.0


@dataclasses.dataclass(frozen=True)
class ATSSConfig:
    num_classes: int = 81
    num_convs: int = 4
    prior_prob: float = 0.01
    regression_type: str = "BOX"
    anchor_sizes: tuple = (64, 128, 256, 512, 1024)
    aspect_ratios: tuple = (1.0,)
    strides: tuple = (8, 16, 32, 64, 128)
    octave: float = 2.0
    scales_per_octave: int = 1
    topk: int = 9
    positive_type: str = "ATSS"
    adapt_topk: tuple = None  # per-fg-class candidate counts (ADAPT_ATSS)
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.4
    loss_gamma: float = 2.0
    loss_alpha: float = 0.25
    reg_loss_weight: float = 2.0

    @property
    def num_anchors(self):
        return len(self.aspect_ratios) * self.scales_per_octave

    @staticmethod
    def from_cfg(cfg):
        a = cfg.MODEL.ATSS
        adapt_topk = None
        if a.POSITIVE_TYPE == "ADAPT_ATSS":
            adapt_topk = adapt_topk_from_cfg(cfg)
        return ATSSConfig(
            num_classes=a.NUM_CLASSES, num_convs=a.NUM_CONVS,
            prior_prob=a.PRIOR_PROB, regression_type=a.REGRESSION_TYPE,
            anchor_sizes=tuple(a.ANCHOR_SIZES),
            aspect_ratios=tuple(a.ASPECT_RATIOS),
            strides=tuple(a.ANCHOR_STRIDES), octave=a.OCTAVE,
            scales_per_octave=a.SCALES_PER_OCTAVE, topk=a.TOPK,
            positive_type=a.POSITIVE_TYPE, adapt_topk=adapt_topk,
            fg_iou_thresh=a.FG_IOU_THRESHOLD,
            bg_iou_thresh=a.BG_IOU_THRESHOLD, loss_gamma=a.LOSS_GAMMA,
            loss_alpha=a.LOSS_ALPHA, reg_loss_weight=a.REG_LOSS_WEIGHT)


class ATSSHead(nn.Module):
    """Towers (``in_channels`` wide over an ``input_channels``-wide input) and
    prediction convs; with ``quant`` the towers run the int8
    branch and the prediction convs stay fp (``atss.py:88-128``). The
    predictions come out float32, as ``scan_tpu``'s ``.astype(jnp.float32)``
    gives them (``layers.Conv``'s ``float_output``)."""

    def __init__(self, cfg: ATSSConfig, in_channels=256, num_levels=5,
                 quant=False, input_channels=None):
        super().__init__()
        self.point = cfg.regression_type == "POINT"
        na, num_fg = cfg.num_anchors, cfg.num_classes - 1
        cin = input_channels or in_channels
        self.cls_tower = ConvTower(cfg.num_convs, cin, in_channels,
                                   quant=quant)
        self.bbox_tower = ConvTower(cfg.num_convs, cin, in_channels,
                                    quant=quant)
        ch = in_channels if cfg.num_convs else cin
        bias_value = -math.log((1 - cfg.prior_prob) / cfg.prior_prob)
        self.cls_logits = Conv(ch, na * num_fg, 3, bias_value=bias_value,
                               float_output=True)
        self.bbox_pred = Conv(ch, na * 4, 3,
                              bias_value=4.0 if self.point else 0.0,
                              float_output=True)
        self.centerness = Conv(ch, na, 3, float_output=True)
        for l in range(num_levels):
            self.add_module(f"scale{l}", Scale(1.0))

    def forward(self, features):
        """features: list of NHWC maps -> (logits, bbox_reg, centerness),
        lists of float32 NHWC maps."""
        logits, bbox_reg, ctrness = [], [], []
        for l, f in enumerate(features):
            ct = self.cls_tower(f)
            bt = self.bbox_tower(f)
            logits.append(self.cls_logits(ct).float())
            pred = getattr(self, f"scale{l}")(self.bbox_pred(bt).float())
            bbox_reg.append(F.relu(pred) if self.point else pred)
            ctrness.append(self.centerness(bt).float())
        return logits, bbox_reg, ctrness


# ---------------------------------------------------------------------- #
# box coder; boxes (..., 4) against anchors broadcast to them
# ---------------------------------------------------------------------- #
def _anchor_geometry(anchors):
    aw = anchors[..., 2] - anchors[..., 0] + 1
    ah = anchors[..., 3] - anchors[..., 1] + 1
    cx = (anchors[..., 2] + anchors[..., 0]) / 2
    cy = (anchors[..., 3] + anchors[..., 1]) / 2
    return aw, ah, cx, cy


def atss_encode(cfg: ATSSConfig, gt_boxes, anchors):
    aw, ah, cx, cy = _anchor_geometry(anchors)
    if cfg.regression_type == "POINT":
        w = cfg.anchor_sizes[0] / cfg.strides[0]
        return torch.stack([w * (cx - gt_boxes[..., 0]) / aw,
                            w * (cy - gt_boxes[..., 1]) / ah,
                            w * (gt_boxes[..., 2] - cx) / aw,
                            w * (gt_boxes[..., 3] - cy) / ah], dim=-1)
    gw = gt_boxes[..., 2] - gt_boxes[..., 0] + 1
    gh = gt_boxes[..., 3] - gt_boxes[..., 1] + 1
    gcx = (gt_boxes[..., 2] + gt_boxes[..., 0]) / 2
    gcy = (gt_boxes[..., 3] + gt_boxes[..., 1]) / 2
    return torch.stack([10.0 * (gcx - cx) / aw, 10.0 * (gcy - cy) / ah,
                        5.0 * torch.log(torch.clamp_min(gw / aw, 1e-8)),
                        5.0 * torch.log(torch.clamp_min(gh / ah, 1e-8))],
                       dim=-1)


def atss_decode(cfg: ATSSConfig, preds, anchors):
    widths, heights, ctr_x, ctr_y = _anchor_geometry(anchors)
    if cfg.regression_type == "POINT":
        w = cfg.anchor_sizes[0] / cfg.strides[0]
        return torch.stack([ctr_x - preds[..., 0] / w * widths,
                            ctr_y - preds[..., 1] / w * heights,
                            ctr_x + preds[..., 2] / w * widths,
                            ctr_y + preds[..., 3] / w * heights], dim=-1)
    dx = preds[..., 0] / 10.0
    dy = preds[..., 1] / 10.0
    dw = torch.clamp_max(preds[..., 2] / 5.0, math.log(1000.0 / 16))
    dh = torch.clamp_max(preds[..., 3] / 5.0, math.log(1000.0 / 16))
    pcx = dx * widths + ctr_x
    pcy = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                        pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], dim=-1)


# ---------------------------------------------------------------------- #
# positive-sample selection (reference loss.py POSITIVE_TYPE), batched:
# anchors (L, 4); gt_boxes (B, G, 4), gt_labels and gt_mask (B, G).
# Each returns labels (B, L) int32 and the matched gt boxes (B, L, 4).
# ---------------------------------------------------------------------- #
def _centres(boxes):
    return (boxes[..., 2] + boxes[..., 0]) / 2, (boxes[..., 3] + boxes[..., 1]) / 2


def _gather_gt(gt, idx):
    """gt (B, G, ...) at idx (B, L) -> (B, L, ...)."""
    if gt.dim() == 2:
        return torch.gather(gt, 1, idx)
    return torch.gather(gt, 1, idx[..., None].expand(-1, -1, gt.shape[-1]))


def _first_k(values, k, descending=False):
    """Indices of the k smallest (or largest) of ``values`` along the last
    dim, ties to the lower index first, as ``lax.top_k`` breaks them."""
    return torch.sort(values, dim=-1, descending=descending,
                      stable=True).indices[..., :k]


def _centre_inside(cx, cy, boxes):
    """(L,) centres against boxes (B, L, 4) or (B, 1, G, 4)-broadcast: the
    smallest of l, t, r, b above the 0.01 margin."""
    return torch.minimum(torch.minimum(cx - boxes[..., 0], cy - boxes[..., 1]),
                         torch.minimum(boxes[..., 2] - cx,
                                       boxes[..., 3] - cy)) > 0.01


def _best_positive(is_pos, ious, gt_boxes, gt_labels):
    """Each anchor's max-IoU gt among its positive pairs (the first on a
    tie, as ``jnp.argmax``), label 0 where it has none."""
    ious_masked = torch.where(is_pos, ious, torch.full_like(ious, -INF))
    best_iou = ious_masked.amax(dim=-1)
    best_gt = ious_masked.argmax(dim=-1)
    labels = torch.where(best_iou > -INF / 2, _gather_gt(gt_labels, best_gt),
                         torch.zeros_like(best_gt, dtype=gt_labels.dtype))
    return labels.to(torch.int32), _gather_gt(gt_boxes, best_gt)


@lru_cache(maxsize=16)
def _int_table(values, device):
    return torch.tensor(values, dtype=torch.int64).to(device)


def ssc_assign(cfg: ATSSConfig, anchors, level_counts, gt_boxes, gt_labels,
               gt_mask):
    """'SSC': the FCOS size-of-interest assignment on anchor centres
    (reference loss.py:120-162); the matched box is the max-IoU gt."""
    cx, cy = _centres(anchors)
    points = torch.stack([cx, cy], dim=1)
    soi = expand_soi(level_counts, device=anchors.device)
    labels, _ = compute_targets(points, soi, gt_boxes, gt_labels, gt_mask)
    ious = box_iou(anchors, gt_boxes, plus_one=True)
    ious = torch.where(gt_mask[:, None, :], ious, torch.full_like(ious, -1.0))
    return labels, _gather_gt(gt_boxes, ious.argmax(dim=-1))


def iou_assign(cfg: ATSSConfig, anchors, level_counts, gt_boxes, gt_labels,
               gt_mask):
    """'IoU': RetinaNet's matcher and the centre-inside-gt filter
    (reference loss.py:321-351). Ignored anchors get label -1."""
    ious = box_iou(anchors, gt_boxes, plus_one=True) * gt_mask[:, None, :]
    matches = matcher_assign(ious, cfg.fg_iou_thresh, cfg.bg_iou_thresh)
    matches = torch.where(gt_mask.any(dim=1, keepdim=True), matches,
                          torch.full_like(matches, -1))
    m0 = matches.clamp_min(0)
    gl = _gather_gt(gt_labels, m0).to(torch.int32)
    labels = torch.where(matches >= 0, gl, torch.zeros_like(gl))
    labels = torch.where(matches == -2, torch.full_like(labels, -1), labels)
    matched = _gather_gt(gt_boxes, m0)
    cx, cy = _centres(anchors)
    inside = _centre_inside(cx, cy, matched)
    labels = torch.where((labels > 0) & ~inside, torch.full_like(labels, -1),
                         labels)
    return labels, matched


def topk_assign(cfg: ATSSConfig, anchors, level_counts, gt_boxes, gt_labels,
                gt_mask):
    """'TOPK': per gt the top k anchors by IoU less the normalised
    centre distance (reference loss.py:292-320)."""
    ious = box_iou(anchors, gt_boxes, plus_one=True)  # (B, L, G)
    cx, cy = _centres(anchors)
    gcx, gcy = _centres(gt_boxes)
    dist = torch.sqrt((cx[None, :, None] - gcx[:, None, :]) ** 2
                      + (cy[None, :, None] - gcy[:, None, :]) ** 2)
    dmax = dist.amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)
    score = ious - dist / dmax / 1000.0
    k = min(cfg.topk, score.shape[1])
    idx = _first_k(score.transpose(1, 2), k, descending=True)  # (B, G, k)
    is_pos = torch.zeros(score.transpose(1, 2).shape, dtype=torch.bool,
                         device=score.device).scatter(2, idx, True)
    inside = _centre_inside(cx[None, :, None], cy[None, :, None],
                            gt_boxes[:, None, :, :])
    is_pos = is_pos.transpose(1, 2) & inside & gt_mask[:, None, :]
    return _best_positive(is_pos, ious, gt_boxes, gt_labels)


def atss_assign(cfg: ATSSConfig, anchors, level_counts, gt_boxes, gt_labels,
                gt_mask):
    """'ATSS' (and 'ADAPT_ATSS' with ``cfg.adapt_topk``; reference
    loss.py:163-290): per level the k anchors nearest each gt centre, the
    IoU threshold mean + std over those candidates (Bessel's correction),
    the centre-inside-gt filter, the max-IoU gt on a tie. ADAPT_ATSS takes
    the per-level top-k at the largest class count and keeps each gt's
    first ``adapt_topk[label]`` ranks (a scatter-max, ``atss.py:384-386``)."""
    ious = box_iou(anchors, gt_boxes, plus_one=True)  # (B, L, G)
    gt_cx, gt_cy = _centres(gt_boxes)
    a_cx, a_cy = _centres(anchors)
    dist = torch.sqrt((a_cx[None, :, None] - gt_cx[:, None, :]) ** 2
                      + (a_cy[None, :, None] - gt_cy[:, None, :]) ** 2)
    b, _, g = ious.shape

    per_gt_topk = None
    if cfg.positive_type == "ADAPT_ATSS" and cfg.adapt_topk is not None:
        table = _int_table((cfg.topk,) + tuple(cfg.adapt_topk), ious.device)
        per_gt_topk = table[gt_labels.long().clamp(0, len(cfg.adapt_topk))]
        topk = max(cfg.adapt_topk) * cfg.num_anchors
    else:
        topk = cfg.topk * cfg.num_anchors

    levels, start = [], 0
    for n in level_counts:
        k = min(topk, n)
        idx = _first_k(dist[:, start:start + n].transpose(1, 2), k)  # (B, G, k)
        if per_gt_topk is not None:
            rank = torch.arange(k, device=idx.device)
            sel = (rank < per_gt_topk[..., None]).to(torch.uint8)
            lvl = torch.zeros((b, g, n), dtype=torch.uint8,
                              device=idx.device).scatter_reduce(
                2, idx, sel, "amax").bool()
        else:
            lvl = torch.zeros((b, g, n), dtype=torch.bool,
                              device=idx.device).scatter(2, idx, True)
        levels.append(lvl)
        start += n
    cand = torch.cat(levels, dim=2).transpose(1, 2)  # (B, L, G)

    zero = torch.zeros_like(ious)
    n_cand = cand.to(torch.float32).sum(dim=1)  # (B, G)
    mean = torch.where(cand, ious, zero).sum(dim=1) / n_cand.clamp_min(1.0)
    var = torch.where(cand, (ious - mean[:, None, :]) ** 2, zero).sum(dim=1) \
        / (n_cand - 1.0).clamp_min(1.0)
    thr = mean + torch.sqrt(var)

    in_gt = _centre_inside(a_cx[None, :, None], a_cy[None, :, None],
                           gt_boxes[:, None, :, :])
    is_pos = cand & (ious >= thr[:, None, :]) & in_gt & gt_mask[:, None, :]
    return _best_positive(is_pos, ious, gt_boxes, gt_labels)


ASSIGN = {"ATSS": atss_assign, "ADAPT_ATSS": atss_assign, "SSC": ssc_assign,
          "IoU": iou_assign, "TOPK": topk_assign}


# ---------------------------------------------------------------------- #
# ADAPT_ATSS's table
# ---------------------------------------------------------------------- #
def compute_adapt_topk(class_counts, base_topk: int = 9, cap: int = 17):
    """Per-class topk from training-set class frequencies (reference
    loss.py:41-60): rarer classes get more candidates,
    clip(max(topk, ceil(mean / count * topk)), <= cap)."""
    counts = np.asarray(class_counts, np.float64)
    adapt = np.ceil(counts.mean() / np.maximum(counts, 1) * base_topk)
    return tuple(int(v) for v in np.minimum(np.maximum(base_topk, adapt), cap))


def adapt_topk_from_cfg(cfg):
    """The ADAPT_ATSS table from the class frequencies of
    DATASETS.TRAIN_SOURCE (else TRAIN); None, with a warning, when the
    dataset files are not there (plain ATSS then), as ``scan_tpu`` does."""
    from ...data.build import build_datasets
    from ...data.stats import class_instance_counts

    names = cfg.DATASETS.TRAIN_SOURCE or cfg.DATASETS.TRAIN
    try:
        ds = build_datasets(names, is_train=True)
        counts = class_instance_counts(ds, cfg.MODEL.ATSS.NUM_CLASSES - 1)
    except Exception as e:  # dataset files absent on this host
        logging.getLogger("scan_tpu_torch.atss").warning(
            "ADAPT_ATSS: could not derive class frequencies from %s (%s); "
            "falling back to uniform TOPK=%d", names, e, cfg.MODEL.ATSS.TOPK)
        return None
    return compute_adapt_topk(counts, base_topk=cfg.MODEL.ATSS.TOPK, cap=17)


# ---------------------------------------------------------------------- #
# losses
# ---------------------------------------------------------------------- #
def atss_centerness(reg_targets, anchors, cfg: ATSSConfig):
    gts = atss_decode(cfg, reg_targets, anchors)
    cx, cy = _centres(anchors)
    l = cx - gts[..., 0]
    t = cy - gts[..., 1]
    r = gts[..., 2] - cx
    b = gts[..., 3] - cy
    lr = torch.minimum(l, r) / torch.maximum(l, r).clamp_min(1e-8)
    tb = torch.minimum(t, b) / torch.maximum(t, b).clamp_min(1e-8)
    return torch.sqrt((lr * tb).clamp_min(0.0))


def giou_loss(cfg: ATSSConfig, pred, target, anchors, weight, valid):
    """Sum of (1 - GIoU) * weight * valid over the rows. Masked rows are
    zeroed BEFORE the decode (``atss.py:433-441``): the final ``* valid``
    zeroes their loss, but an inf born in the decode of an untaken row
    would still make a NaN in the backward (0 * inf)."""
    vm = (valid > 0)[:, None]
    pred = torch.where(vm, pred, torch.zeros_like(pred))
    target = torch.where(vm, target, torch.zeros_like(target))
    pb = atss_decode(cfg, pred, anchors)
    px1, py1 = pb[:, 0], pb[:, 1]
    px2 = torch.maximum(px1, pb[:, 2])
    py2 = torch.maximum(py1, pb[:, 3])
    p_area = (px2 - px1) * (py2 - py1)
    gb = atss_decode(cfg, target, anchors)
    gx1, gy1, gx2, gy2 = gb.unbind(-1)
    g_area = (gx2 - gx1) * (gy2 - gy1)
    ix1 = torch.maximum(px1, gx1)
    iy1 = torch.maximum(py1, gy1)
    ix2 = torch.minimum(px2, gx2)
    iy2 = torch.minimum(py2, gy2)
    inter = torch.where((iy2 > iy1) & (ix2 > ix1), (ix2 - ix1) * (iy2 - iy1),
                        torch.zeros_like(ix1))
    enc_area = ((torch.maximum(px2, gx2) - torch.minimum(px1, gx1))
                * (torch.maximum(py2, gy2) - torch.minimum(py1, gy1)) + 1e-7)
    union = p_area + g_area - inter + 1e-7
    gious = inter / union - (enc_area - union) / enc_area
    return ((1.0 - gious) * weight * valid).sum()


def atss_losses(cfg: ATSSConfig, anchors_levels, box_cls, box_regression,
                centerness, gt_boxes, gt_labels, gt_mask):
    """The batch's ATSS losses (reference loss.py:292-339): ``loss_cls``
    (focal / num_pos), ``loss_reg`` (centerness-weighted GIoU / the
    centerness sum, times REG_LOSS_WEIGHT) and ``loss_centerness`` (BCE /
    num_pos). Maps are NHWC lists; gts padded (B, G, ...)."""
    num_fg = cfg.num_classes - 1
    level_counts = [a.shape[0] for a in anchors_levels]
    anchors = torch.cat(anchors_levels, dim=0)
    b = gt_boxes.shape[0]
    labels, matched = ASSIGN[cfg.positive_type](
        cfg, anchors, level_counts, gt_boxes, gt_labels, gt_mask)
    reg_targets = atss_encode(cfg, matched, anchors)  # (B, L, 4)

    cls_flat = torch.cat([m.reshape(b, -1, num_fg) for m in box_cls],
                         dim=1).reshape(-1, num_fg)
    reg_flat = torch.cat([m.reshape(b, -1, 4) for m in box_regression],
                         dim=1).reshape(-1, 4)
    ctr_flat = torch.cat([m.reshape(b, -1) for m in centerness],
                         dim=1).reshape(-1)
    labels_flat = labels.reshape(-1)
    reg_t_flat = reg_targets.reshape(-1, 4)
    anchors_flat = anchors.repeat(b, 1)

    pos = labels_flat > 0
    valid = labels_flat >= 0  # -1: ignored (the IoU positive type)
    num_pos = pos.to(torch.float32).sum().clamp_min(1.0)
    cls_loss = sigmoid_focal_loss(cls_flat, labels_flat, cfg.loss_gamma,
                                  cfg.loss_alpha, valid_mask=valid) / num_pos

    ctr_targets = atss_centerness(reg_t_flat, anchors_flat, cfg)
    ctr_targets = torch.where(pos, ctr_targets, torch.zeros_like(ctr_targets))
    sum_ctr = ctr_targets.sum().clamp_min(1e-6)
    reg_loss = giou_loss(cfg, reg_flat, reg_t_flat, anchors_flat, ctr_targets,
                         pos.to(torch.float32)) / sum_ctr

    bce = (ctr_flat.clamp_min(0) - ctr_flat * ctr_targets
           + torch.log1p(torch.exp(-ctr_flat.abs())))
    ctr_loss = (bce * pos).sum() / num_pos
    return {"loss_cls": cls_loss,
            "loss_reg": reg_loss * cfg.reg_loss_weight,
            "loss_centerness": ctr_loss}


# ---------------------------------------------------------------------- #
# inference
# ---------------------------------------------------------------------- #
def atss_postprocess(cfg: ATSSConfig, pp_cfg, anchors_levels, box_cls,
                     box_regression, centerness, image_sizes):
    """Batched postprocess (reference atss/inference.py:11-127): per level
    the candidates above INFERENCE_TH ranked by cls * ctr, the top
    PRE_NMS_TOP_N decoded from their anchors and clipped; then the FCOS
    postprocess's tail (``select_detections``: top NMS_CAP, ML-NMS, top
    DETECTIONS_PER_IMG, sqrt'd scores). Returns dict of (B, 100) tensors."""
    num_fg = cfg.num_classes - 1
    sizes = image_sizes.to(torch.float32)
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for anchors, bc, br, ct in zip(anchors_levels, box_cls, box_regression,
                                   centerness):
        b = bc.shape[0]
        scores = torch.sigmoid(bc.reshape(b, -1, num_fg))
        candidate = scores > pp_cfg.pre_nms_thresh
        ranked = scores * torch.sigmoid(ct.reshape(b, -1))[..., None]
        flat = torch.where(candidate, ranked,
                           torch.full_like(ranked, NEG_INF)).reshape(b, -1)
        k = min(pp_cfg.pre_nms_top_n, flat.shape[1])
        top_scores, top_idx = torch.topk(flat, k, dim=-1)
        loc_idx = top_idx // num_fg
        boxes = atss_decode(cfg, _gather_rows(br.reshape(b, -1, 4), loc_idx),
                            anchors[loc_idx])
        all_boxes.append(clip_boxes(boxes, sizes[:, 0], sizes[:, 1]))
        all_scores.append(top_scores.clamp(min=0.0))
        all_labels.append(top_idx % num_fg + 1)
        all_valid.append(top_scores > NEG_INF / 2)
    return select_detections(pp_cfg, torch.cat(all_boxes, 1),
                             torch.cat(all_scores, 1),
                             torch.cat(all_labels, 1), torch.cat(all_valid, 1))
