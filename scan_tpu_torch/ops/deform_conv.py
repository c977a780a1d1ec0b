"""Deformable convolution (DCNv1/v2) as gather + einsum (counterpart of
``scan_tpu/ops/deform_conv.py``; reference ``fcos_core/layers/misc.py:109-184``,
``DFConv2d``).

Each kernel tap is sampled at its offset position by bilinear
interpolation and contracted with that tap's kernel slice. The border rule
is ``scan_tpu``'s (``deform_conv.py:14-32``), not torchvision's: a sample
counts when ``-1 < y < H`` and ``-1 < x < W``; its position is clipped to
the map, the four corners are clamped to it, and a sample outside is zero.
``scan_tpu`` runs this as XLA ops, not a Pallas kernel, so the plain
PyTorch form is the port. Nothing in either package calls it but the
``layers`` surface (``ATSS.USE_DCN_IN_TOWER`` is defined and never read).
"""

import torch

from ..modeling.layers import clip


def _bilinear_gather(feat, ys, xs):
    """feat (B, H, W, C); ys, xs (B, P) continuous positions -> (B, P, C),
    zero outside the map."""
    b, h, w, c = feat.shape
    inside = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    ys, xs = clip(ys, h - 1), clip(xs, w - 1)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    ly = (ys - y0)[..., None]
    lx = (xs - x0)[..., None]
    flat = feat.reshape(b, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    out = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
           + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    return out * inside[..., None]


def deform_conv2d(x, offsets, weight, bias=None, mask=None,
                  kernel_size: int = 3):
    """x (B, H, W, C); offsets (B, H, W, 2*k*k) as (dy, dx) per tap; weight
    (k, k, C, O); mask an optional (B, H, W, k*k) modulation (DCNv2).
    Stride 1, SAME padding. Returns (B, H, W, O) in float32 sums."""
    b, h, w, c = x.shape
    k = kernel_size
    pad = k // 2
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    acc = None
    for i in range(k):
        for j in range(k):
            t = i * k + j
            ys = (gy + (i - pad) + offsets[..., 2 * t]).reshape(b, -1)
            xs = (gx + (j - pad) + offsets[..., 2 * t + 1]).reshape(b, -1)
            samp = _bilinear_gather(x, ys, xs).reshape(b, h, w, c)
            if mask is not None:
                samp = samp * mask[..., t:t + 1]
            contrib = torch.einsum("bhwc,co->bhwo", samp, weight[i, j])
            acc = contrib if acc is None else acc + contrib
    if bias is not None:
        acc = acc + bias
    return acc
