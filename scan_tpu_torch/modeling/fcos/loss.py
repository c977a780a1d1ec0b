"""FCOS losses (counterpart of ``scan_tpu/modeling/fcos/loss.py``;
reference ``rpn/fcos/loss.py:168-230``).

The sigmoid focal loss summed over every (location, class), divided by
num_pos + batch size; the centerness-weighted IoU loss over the positives;
the BCE-with-logits centerness loss averaged over max(num_pos, 1). The
positives are a mask over the concatenated (B * L,) location axis, so
every shape is fixed and no value is read back to the host.
"""

import torch

from ...ops.focal_loss import sigmoid_focal_loss
from ...ops.iou_loss import iou_loss
from .targets import centerness_targets, compute_targets, expand_soi


def _flatten_levels(maps, channels):
    """list of (B, H, W, C) -> (B * sum(HW), C), level-major per image
    (reference ``loss.py:191-202``)."""
    return torch.cat([m.reshape(m.shape[0], -1, channels) for m in maps],
                     dim=1).reshape(-1, channels)


def fcos_losses(locations, box_cls, box_regression, centerness, gt_boxes,
                gt_labels, gt_mask, gamma=2.0, alpha=0.25):
    num_classes = box_cls[0].shape[-1]
    batch = box_cls[0].shape[0]
    num_points = [loc.shape[0] for loc in locations]
    locs_all = torch.cat(locations, dim=0)
    soi = expand_soi(num_points, device=locs_all.device)

    labels, reg_targets = compute_targets(locs_all, soi, gt_boxes, gt_labels,
                                          gt_mask)
    labels = labels.reshape(-1)
    reg_targets = reg_targets.reshape(-1, 4)
    cls_flat = _flatten_levels(box_cls, num_classes)
    reg_flat = _flatten_levels(box_regression, 4)
    ctr_flat = _flatten_levels(centerness, 1)[:, 0]

    pos = labels > 0
    num_pos = pos.float().sum()
    cls_loss = sigmoid_focal_loss(cls_flat, labels, gamma, alpha) / (
        num_pos + batch)

    ctr_targets = centerness_targets(reg_targets)
    reg_loss = iou_loss(reg_flat, reg_targets, weight=ctr_targets,
                        valid_mask=pos)
    bce = (ctr_flat.clamp_min(0) - ctr_flat * ctr_targets
           + torch.log1p(torch.exp(-ctr_flat.abs())))
    ctr_loss = (bce * pos).sum() / num_pos.clamp_min(1.0)

    has_pos = num_pos > 0
    zero = torch.zeros_like(reg_loss)
    return {
        "loss_cls": cls_loss,
        "loss_reg": torch.where(has_pos, reg_loss, zero),
        "loss_centerness": torch.where(has_pos, ctr_loss, zero),
    }
