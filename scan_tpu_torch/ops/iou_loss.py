"""IoU regression loss for FCOS ltrb offsets (counterpart of
``scan_tpu/ops/iou_loss.py``; reference ``layers/iou_loss.py:5-36``).

Log-IoU with the '+1' smoothing, optionally centerness-weighted. It stays
fixed-shape and mask-weights the reduction, so masked rows are sanitised
at entry by a double ``torch.where`` (PARITY #17): ``torch.where``, like
``jnp.where``, zeroes the cotangent of the untaken branch but not a NaN
made there, and ``0 * inf`` in the backward of an overflowed prediction at
an unsupervised location would poison every upstream gradient. Masked rows
take the neutral ratio 1 before the log for the same reason.
"""

import torch


def iou_loss(pred, target, weight=None, valid_mask=None):
    """pred, target (N, 4) ltrb distances. Returns a scalar."""
    if valid_mask is not None:
        vm = valid_mask[:, None]
        pred = torch.where(vm, pred, torch.zeros_like(pred))
        target = torch.where(vm, target, torch.zeros_like(target))
    pl, pt, pr, pb = pred.unbind(1)
    tl, tt, tr, tb = target.unbind(1)

    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_intersect = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect

    ratio = (area_intersect + 1.0) / (area_union + 1.0)
    if valid_mask is not None:
        m = valid_mask.to(ratio.dtype)
        ratio = torch.where(valid_mask, ratio, torch.ones_like(ratio))
    else:
        m = torch.ones_like(ratio)
    losses = -torch.log(ratio.clamp_min(1e-12))
    if weight is not None:
        w = weight * m
        return (losses * w).sum() / w.sum().clamp_min(1e-6)
    return (losses * m).sum() / m.sum().clamp_min(1.0)
