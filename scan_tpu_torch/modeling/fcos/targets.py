"""FCOS target assignment, fixed-shape (counterpart of
``scan_tpu/modeling/fcos/targets.py``; reference ``rpn/fcos/loss.py:40-133``).

Per-level size-of-interest binning, the "inside box" test (strict > 0 on
the smallest ltrb), min-area assignment among the surviving GTs with the
reference's '+1' area, label 0 elsewhere. Instead of per-image loops over
dynamic GT counts, everything is a (B, L, G) masked broadcast over the
``TPU.MAX_BOXES`` slots and their ``mask``.
"""

import torch

INF = 100000000.0

OBJECT_SIZES_OF_INTEREST = (
    (-1.0, 64.0),
    (64.0, 128.0),
    (128.0, 256.0),
    (256.0, 512.0),
    (512.0, INF),
)


def expand_soi(num_points_per_level, device=None) -> torch.Tensor:
    """(L, 2) per-location size-of-interest bounds over the levels, filled
    on ``device`` (no host-to-device copy)."""
    return torch.cat([
        torch.stack([torch.full((n,), bound, device=device)
                     for bound in OBJECT_SIZES_OF_INTEREST[l]], dim=1)
        for l, n in enumerate(num_points_per_level)
    ])


def compute_targets(locations, soi, gt_boxes, gt_labels, gt_mask):
    """locations, soi (L, 2); gt_boxes (B, G, 4) xyxy; gt_labels, gt_mask
    (B, G). Returns labels (B, L) int32 and reg_targets (B, L, 4) float32
    (``targets.py:36-71``, batched over images)."""
    xs = locations[None, :, None, 0]
    ys = locations[None, :, None, 1]
    boxes = gt_boxes[:, None, :, :]
    reg = torch.stack([xs - boxes[..., 0], ys - boxes[..., 1],
                       boxes[..., 2] - xs, boxes[..., 3] - ys], dim=3)
    is_in_box = reg.amin(dim=3) > 0
    max_reg = reg.amax(dim=3)
    cared = (max_reg >= soi[None, :, 0:1]) & (max_reg <= soi[None, :, 1:2])
    # reference BoxList.area(): '+1' convention
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1)
            * (gt_boxes[..., 3] - gt_boxes[..., 1] + 1))
    valid = is_in_box & cared & gt_mask[:, None, :]
    loc_to_gt_area = torch.where(valid, area[:, None, :].expand_as(valid),
                                 torch.full_like(reg[..., 0], INF))
    min_area = loc_to_gt_area.amin(dim=2)
    gt_inds = loc_to_gt_area.argmin(dim=2)  # first minimum, as jnp.argmin
    labels = torch.gather(gt_labels.to(torch.int32), 1, gt_inds)
    labels = torch.where(min_area == INF, torch.zeros_like(labels), labels)
    idx = gt_inds[:, :, None, None].expand(-1, -1, 1, 4)
    reg_targets = torch.gather(reg, 2, idx)[:, :, 0, :]
    return labels, reg_targets


def centerness_targets(reg_targets):
    """sqrt((min_lr / max_lr) * (min_tb / max_tb)) (``targets.py:74-82``)."""
    l, t, r, b = reg_targets.unbind(-1)
    ratio = (torch.minimum(l, r) / torch.maximum(l, r).clamp_min(1e-12)) * (
        torch.minimum(t, b) / torch.maximum(t, b).clamp_min(1e-12))
    return torch.sqrt(ratio.clamp_min(0.0))
