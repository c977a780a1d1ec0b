"""Fixed-shape greedy NMS / multi-label NMS (counterpart of ``scan_tpu/ops/nms.py``).

Semantics of the reference CUDA kernels (``fcos_core/csrc/cuda/nms.cu`` and
``ml_nms.cu``): greedy suppression in descending score order, IoU with the
legacy '+1' convention, and in ML-NMS boxes suppress only boxes with the
same label. Survivors come back as a fixed-capacity keep mask in the
original box order.

The score sort is a stable sort (``jnp.argsort`` is stable); the greedy core
over the sorted boxes is ``ops/cuda/nms_kernel.py::nms_sorted``: kernel K1
for CUDA tensors, its plain version for CPU tensors. Every function takes
one image (K, ...) or a batch (B, K, ...).
"""

import torch

from .cuda.nms_kernel import nms_sorted

NEG_INF = -1e10


def nms_keep_mask(boxes, scores, valid, iou_threshold, labels=None,
                  plus_one: bool = True):
    """Exact greedy (ML-)NMS.

    Args:
      boxes: (K, 4) or (B, K, 4) xyxy.
      scores: (K,) or (B, K).
      valid: (K,) or (B, K) bool padding mask.
      iou_threshold: scalar.
      labels: optional (K,) or (B, K) int; if given, only same-label boxes suppress
        each other (multi-label NMS).

    Returns:
      keep: (K,) or (B, K) bool in the ORIGINAL box order.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
        labels = None if labels is None else labels[None]
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-masked, dim=-1, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)
    l = None if labels is None else torch.gather(labels, 1, order)
    keep_sorted = nms_sorted(b, v, l, iou_threshold, plus_one)
    keep = torch.zeros_like(valid).scatter(1, order, keep_sorted)
    return keep[0] if single else keep


def nms(boxes, scores, valid, iou_threshold, **kw):
    """Hard NMS keep mask (original order)."""
    return nms_keep_mask(boxes, scores, valid, iou_threshold, labels=None, **kw)


def ml_nms(boxes, scores, labels, valid, iou_threshold, **kw):
    """Multi-label NMS keep mask (original order)."""
    return nms_keep_mask(boxes, scores, valid, iou_threshold, labels=labels, **kw)
