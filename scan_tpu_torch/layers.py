"""Public layer/op surface mirroring ``fcos_core.layers`` (counterpart of
``scan_tpu/layers.py``).

Every name of ``scan_tpu``'s ``__all__`` (``layers.py:111-119``), mapped onto
the port's implementation:

  nms / ml_nms / nms_keep_mask -> ops.nms (K1 on the card)
  roi_align / roi_pool    -> ops.roi_align
  sigmoid / softmax / bce / binary_adversarial focal losses -> ops.focal_loss
  iou_loss                -> ops.iou_loss
  Conv / ConvTower / FrozenBatchNorm / GroupNorm32 /
  MultiHeadSelfAttention / Scale -> modeling.layers
  deform_conv2d           -> ops.deform_conv
  meanshift_high_mode     -> modeling.condgraph.sampling
  interpolate_nearest_2x  -> modeling.backbone.fpn.upsample_nearest_2x
  smooth_l1_loss / kl_loss / cosine_loss / supcon_loss_with_prototype
                          -> the functions below (``layers.py:53-107``)
"""

import torch
import torch.nn.functional as F

from .modeling.backbone.fpn import upsample_nearest_2x
from .modeling.condgraph.sampling import meanshift_high_mode
from .modeling.layers import (Conv, ConvTower, FrozenBatchNorm, GroupNorm32,
                              MultiHeadSelfAttention, Scale, safe_l2_norm)
from .ops.deform_conv import deform_conv2d
from .ops.focal_loss import (bce_focal_loss, binary_adversarial_focal_loss,
                             sigmoid_focal_loss, softmax_focal_loss)
from .ops.iou_loss import iou_loss
from .ops.nms import ml_nms, nms, nms_keep_mask
from .ops.roi_align import roi_align, roi_pool


def smooth_l1_loss(input, target, beta: float = 1.0 / 9, size_average=True):
    """Reference ``layers/smooth_l1_loss.py`` semantics."""
    d = (input - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean() if size_average else loss.sum()


def kl_loss(batch, target):
    """Reference ``layers/KL_loss.py`` KLLoss.forward: F.kl_div over
    softmaxed rows, elementwise-mean reduction, detached target."""
    target = F.softmax(target, dim=-1).detach()
    logq = F.log_softmax(batch, dim=-1)
    kl = target * (torch.log(target.clamp_min(1e-12)) - logq)
    return kl.mean()


def cosine_loss(batch, glb, label_indx):
    """Reference ``layers/cosine_loss.py`` CosineLoss.forward: (1 - cos) on
    the selected rows, and the KL term; returns (sim_loss, kl_loss)."""
    mask = label_indx.bool()
    m = mask[:, None].to(batch.dtype)
    b = batch * m
    g = glb.detach() * m
    dot = (b * g).sum(1)
    denom = torch.clamp_min(safe_l2_norm(b, dim=1) * safe_l2_norm(g, dim=1),
                            1e-8)
    per_row = 1.0 - dot / denom
    n = mask.sum().to(batch.dtype).clamp_min(1.0)
    sim_loss = (per_row * mask).sum() / n
    return sim_loss, kl_loss(glb, batch)


def supcon_loss_with_prototype(features, labels, prototypes, proto_labels,
                               temperature: float = 0.07, valid_mask=None):
    """Supervised-contrastive loss against class prototypes (reference
    ``layers/contrastive_loss.py`` SupConLossWithPrototypeDA, reduced to its
    used core as in ``scan_tpu``: anchor-vs-prototype InfoNCE with
    same-class positives)."""
    f = features / safe_l2_norm(features, dim=1, keepdim=True)
    p = prototypes / safe_l2_norm(prototypes, dim=1, keepdim=True)
    logits = (f @ p.T) / temperature  # (N, P)
    pos = (labels[:, None] == proto_labels[None, :]).to(logits.dtype)
    logp = F.log_softmax(logits, dim=1)
    n_pos = pos.sum(1)
    per_anchor = -(logp * pos).sum(1) / n_pos.clamp_min(1.0)
    m = n_pos > 0
    if valid_mask is not None:
        m = m & valid_mask
    m = m.to(logits.dtype)
    return (per_anchor * m).sum() / m.sum().clamp_min(1.0)


def interpolate_nearest_2x(x):
    """Reference ``layers/misc.py`` interpolate (the FPN use case)."""
    return upsample_nearest_2x(x)


__all__ = [
    "nms", "ml_nms", "nms_keep_mask", "roi_align", "roi_pool",
    "sigmoid_focal_loss", "softmax_focal_loss", "bce_focal_loss",
    "binary_adversarial_focal_loss", "iou_loss", "smooth_l1_loss",
    "kl_loss", "cosine_loss", "supcon_loss_with_prototype",
    "deform_conv2d", "meanshift_high_mode", "interpolate_nearest_2x",
    "Conv", "ConvTower", "FrozenBatchNorm", "GroupNorm32",
    "MultiHeadSelfAttention", "Scale",
]
