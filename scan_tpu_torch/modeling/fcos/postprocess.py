"""Fixed-shape FCOS post-processing: decode, NMS, top-k (counterpart of
``scan_tpu/modeling/fcos/postprocess.py``).

Reference ``fcos_core/modeling/rpn/fcos/inference.py:20-213``: per level,
threshold at INFERENCE_TH on the class score, keep the top PRE_NMS_TOP_N
candidates ranked by cls*ctr, decode l,t,r,b around the location and clip
to the image; across levels, per-class NMS at NMS_TH over the top NMS_CAP
candidates, then the top DETECTIONS_PER_IMG; the final score is
sqrt(cls * ctr). Every image yields DETECTIONS_PER_IMG slots with a validity
mask. ``scan_tpu`` vmaps over images; here the batch is an explicit leading
dimension.

Ties: ``torch.topk`` does not order equal values as ``jax.lax.top_k`` does.
The selections here run over many NEG_INF ties, so the boxes in INVALID
slots may differ from ``scan_tpu``'s; valid slots and the mask agree.
"""

import dataclasses

import torch

from ...ops.nms import nms_keep_mask
from ...structures.boxes import clip_boxes
from ...utils.profiler import count, span

NEG_INF = -1e10


@dataclasses.dataclass(frozen=True)
class PostProcessConfig:
    pre_nms_thresh: float = 0.05
    pre_nms_top_n: int = 1000
    nms_thresh: float = 0.6
    fpn_post_nms_top_n: int = 100
    min_size: float = 0.0
    num_classes: int = 81  # includes background
    apply_sigmoid: bool = True  # TEST.MODE == 'common'
    nms_cap: int = 1000  # combined candidates entering NMS


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _level_candidates(cfg, locations, box_cls, box_regression, centerness):
    """One level, batched: box_cls (B, L, C), box_regression (B, L, 4),
    centerness (B, L), locations (L, 2)."""
    scores = torch.sigmoid(box_cls) if cfg.apply_sigmoid else box_cls
    candidate = scores > cfg.pre_nms_thresh
    ctr = torch.sigmoid(centerness)
    ranked = scores * ctr[..., None]  # cls * ctr, the reference's ranking score
    masked = torch.where(candidate, ranked, torch.full_like(ranked, NEG_INF))
    b, num_loc, num_cls = scores.shape
    k = min(cfg.pre_nms_top_n, num_loc * num_cls)
    if num_loc > k and num_cls > 1:
        # exact two-stage top-k (postprocess.py:52-65): a (loc, cls) pair in
        # the global top-k has loc_max >= its score, so its location is in
        # the top-k locations by per-location class max
        loc_max = masked.max(dim=-1).values
        top_loc = torch.topk(loc_max, k, dim=-1).indices  # (B, k)
        sub = _gather_rows(masked, top_loc).reshape(b, -1)  # (B, k*C)
        top_scores, sub_idx = torch.topk(sub, k, dim=-1)
        loc_idx = torch.gather(top_loc, 1, sub_idx // num_cls)
        cls_idx = sub_idx % num_cls + 1  # 1-based labels
    else:
        top_scores, top_idx = torch.topk(masked.reshape(b, -1), k, dim=-1)
        loc_idx = top_idx // num_cls
        cls_idx = top_idx % num_cls + 1
    locs = locations[loc_idx]  # (B, k, 2)
    regs = _gather_rows(box_regression, loc_idx)  # (B, k, 4)
    boxes = torch.stack(
        [
            locs[..., 0] - regs[..., 0],
            locs[..., 1] - regs[..., 1],
            locs[..., 0] + regs[..., 2],
            locs[..., 1] + regs[..., 3],
        ],
        dim=-1,
    )
    valid = top_scores > NEG_INF / 2
    return boxes, top_scores.clamp(min=0.0), cls_idx, valid


def fcos_postprocess(cfg: PostProcessConfig, locations, box_cls,
                     box_regression, centerness, image_sizes):
    """Batched postprocess.

    Args:
      locations: list of (HW_l, 2).
      box_cls: list of (B, H, W, C-1) logits or pre-mixed probabilities.
      box_regression: list of (B, H, W, 4).
      centerness: list of (B, H, W, 1).
      image_sizes: (B, 2) int [h, w].

    Returns dict of (B, DETECTIONS_PER_IMG) tensors: boxes (…, 4), scores,
    labels, valid.
    """
    nc = cfg.num_classes - 1
    sizes = image_sizes.to(torch.float32)
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for loc, bc, br, ct in zip(locations, box_cls, box_regression, centerness):
        b = bc.shape[0]
        bx, s, l, v = _level_candidates(
            cfg, loc, bc.reshape(b, -1, nc), br.reshape(b, -1, 4),
            ct.reshape(b, -1))
        bx = clip_boxes(bx, sizes[:, 0], sizes[:, 1])
        if cfg.min_size > 0:
            # '+1' width convention (reference boxlist_ops.py:59-71)
            v = v & ((bx[..., 2] - bx[..., 0] + 1) >= cfg.min_size) & (
                (bx[..., 3] - bx[..., 1] + 1) >= cfg.min_size)
        all_boxes.append(bx)
        all_scores.append(s)
        all_labels.append(l)
        all_valid.append(v)
    return select_detections(cfg, torch.cat(all_boxes, 1),
                             torch.cat(all_scores, 1),
                             torch.cat(all_labels, 1), torch.cat(all_valid, 1))


def select_detections(cfg: PostProcessConfig, boxes, scores, labels, valid):
    """The candidates of every level, (B, N, ...), to the output: the top
    NMS_CAP by score, per-class NMS, then the top DETECTIONS_PER_IMG, the
    score sqrt'd (``postprocess.py``'s tail, which the ATSS postprocess
    shares, ``atss.py:580-609``)."""
    # cap the combined candidates before the O(K^2) NMS
    cap = min(cfg.nms_cap, boxes.shape[1])
    ranked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    keep_idx = torch.topk(ranked, cap, dim=-1).indices
    boxes = _gather_rows(boxes, keep_idx)
    scores = torch.gather(scores, 1, keep_idx)
    labels = torch.gather(labels, 1, keep_idx)
    valid = torch.gather(valid, 1, keep_idx)

    with span("nms"):
        keep = nms_keep_mask(boxes, scores, valid, cfg.nms_thresh,
                             labels=labels)
    count("nms.candidates", valid)
    count("nms.kept", keep)

    final_rank = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    n_det = min(cfg.fpn_post_nms_top_n, final_rank.shape[1])
    top_scores, top_idx = torch.topk(final_rank, n_det, dim=-1)
    out_valid = top_scores > NEG_INF / 2
    out_labels = torch.gather(labels, 1, top_idx)
    return dict(
        boxes=_gather_rows(boxes, top_idx),
        scores=torch.sqrt(top_scores.clamp(min=0.0)),
        labels=torch.where(out_valid, out_labels, torch.zeros_like(out_labels)),
        valid=out_valid,
    )
