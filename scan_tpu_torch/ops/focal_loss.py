"""Focal losses (counterpart of ``scan_tpu/ops/focal_loss.py``).

Plain PyTorch on tensors, as ``scan_tpu`` computes them in jnp: the FCOS
multi-class sigmoid focal loss (reference ``layers/sigmoid_focal_loss.py``),
the softmax focal loss of the condgraph act maps and ``BCEFocalLoss``
(reference ``layers/sigmoid_focal_loss_wbg.py``), and the discriminator's
binary focal loss (reference ``discriminator/layer.py:35-39``). Every one is
mask-aware, so padded rows contribute exactly zero.
"""

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits, targets, gamma=2.0, alpha=0.25, valid_mask=None):
    """logits (N, C) for C foreground classes; targets (N,) int in [0, C],
    0 = background, c > 0 selects column c - 1. Returns the sum over every
    (row, class) pair (``focal_loss.py:21-47``)."""
    num_classes = logits.shape[1]
    class_range = torch.arange(1, num_classes + 1, dtype=targets.dtype,
                               device=targets.device)[None, :]
    t = targets[:, None]
    p = torch.sigmoid(logits)
    term_pos = ((1 - p) ** gamma) * F.logsigmoid(logits)
    term_neg = (p ** gamma) * F.logsigmoid(-logits)
    pos_mask = (t == class_range).to(logits.dtype)
    neg_mask = ((t != class_range) & (t >= 0)).to(logits.dtype)
    loss = -pos_mask * term_pos * alpha - neg_mask * term_neg * (1 - alpha)
    if valid_mask is not None:
        loss = loss * valid_mask[:, None].to(logits.dtype)
    return loss.sum()


def softmax_focal_loss(logits, targets, gamma=2.0, valid_mask=None,
                       size_average=True, eps=1e-15):
    """``-(1 - p_t)^gamma * log(p_t)`` with p_t clamped at ``eps``, averaged
    (``focal_loss.py:50-67``, alpha 1)."""
    p = torch.softmax(logits, dim=1)
    pt = torch.gather(p, 1, targets[:, None].long())[:, 0].clamp_min(eps)
    loss = -((1 - pt) ** gamma) * torch.log(pt)
    if valid_mask is not None:
        m = valid_mask.to(logits.dtype)
        loss = loss * m
        denom = m.sum().clamp_min(1.0)
    else:
        denom = loss.shape[0]
    return loss.sum() / denom if size_average else loss.sum()


def bce_focal_loss(logits, targets, gamma=2.0, alpha=0.25, valid_mask=None,
                   reduction="mean"):
    """Binary focal loss over explicit one/zero targets, the probability
    clamped to [1e-5, 1 - 1e-5] (``focal_loss.py:70-89``)."""
    pt = torch.sigmoid(logits).clamp(1e-5, 1 - 1e-5)
    loss = -alpha * ((1 - pt) ** gamma) * targets * torch.log(pt) - (
        1 - alpha) * (pt ** gamma) * (1 - targets) * torch.log(1 - pt)
    if valid_mask is not None:
        m = valid_mask[..., None].expand(loss.shape).to(loss.dtype)
        loss = loss * m
        denom = m.sum().clamp_min(1.0)
    else:
        denom = loss.numel()
    return loss.sum() / denom if reduction == "mean" else loss.sum()


def binary_adversarial_focal_loss(logits, targets, gamma=5.0):
    """Discriminator focal loss (``focal_loss.py:92-96``)."""
    bce = (logits.clamp_min(0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    pt = torch.exp(-bce)
    return (((1 - pt) ** gamma) * bce).mean()
