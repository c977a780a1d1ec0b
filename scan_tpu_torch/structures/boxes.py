"""Box math of the port (counterpart of ``scan_tpu/structures/boxes.py``).

Pairwise IoU with the legacy '+1' pixel convention (reference
``structures/boxlist_ops.py:78-118`` and ``csrc/cuda/nms.cu:13-21``), the
clip-to-image of the postprocess, and the two-stage detector's '+1' area
and Faster R-CNN box coder (``scan_tpu/structures/boxes.py:89-162``; the
ATSS coders live in ``modeling/atss/atss.py``). The arithmetic order
matches ``scan_tpu``'s term for term, so the suppression matrix built from
``box_iou`` equals XLA's bit for bit.
"""

import math

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor, plus_one: bool = True) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M)."""
    off = 1.0 if plus_one else 0.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def clip_boxes(boxes: torch.Tensor, heights: torch.Tensor,
               widths: torch.Tensor) -> torch.Tensor:
    """Clamp (B, N, 4) xyxy boxes to [0, size - 1] per image (reference
    ``clip_to_image``); heights/widths are (B,) float."""
    w = (widths - 1)[:, None]
    h = (heights - 1)[:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.stack(
        [
            torch.minimum(torch.maximum(boxes[..., 0], zero), w),
            torch.minimum(torch.maximum(boxes[..., 1], zero), h),
            torch.minimum(torch.maximum(boxes[..., 2], zero), w),
            torch.minimum(torch.maximum(boxes[..., 3], zero), h),
        ],
        dim=-1,
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes with the legacy '+1' pixel convention
    (reference ``BoxList.area``, TO_REMOVE = 1)."""
    return (boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1)


def encode_boxes(reference_boxes, proposals, weights=(10.0, 10.0, 5.0, 5.0)):
    """Faster R-CNN box encoding (reference ``modeling/box_coder.py:28-53``,
    TO_REMOVE = 1): the deltas that take ``proposals`` to
    ``reference_boxes``, term for term as ``scan_tpu``'s ``encode_boxes``."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + 1.0
    ex_h = proposals[..., 3] - proposals[..., 1] + 1.0
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + 1.0
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + 1.0
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def decode_boxes(rel_codes, boxes, weights=(10.0, 10.0, 5.0, 5.0),
                 bbox_xform_clip=BBOX_XFORM_CLIP):
    """Inverse of ``encode_boxes`` (reference ``box_coder.py:55-87``): the
    width and height deltas clipped above at log(1000 / 16)."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx = rel_codes[..., 0] / wx
    dy = rel_codes[..., 1] / wy
    dw = (rel_codes[..., 2] / ww).clamp(max=bbox_xform_clip)
    dh = (rel_codes[..., 3] / wh).clamp(max=bbox_xform_clip)
    pred_cx = dx * widths + ctr_x
    pred_cy = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w - 1, pred_cy + 0.5 * pred_h - 1],
                       dim=-1)
