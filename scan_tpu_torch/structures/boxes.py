"""Box math the eval path needs (counterpart of ``scan_tpu/structures/boxes.py``).

Only pairwise IoU with the legacy '+1' pixel convention (reference
``structures/boxlist_ops.py:78-118`` and ``csrc/cuda/nms.cu:13-21``) and the
clip-to-image of the postprocess. The arithmetic order matches
``scan_tpu.structures.boxes.box_iou`` term for term, so the suppression
matrix built from it equals XLA's bit for bit.
"""

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
