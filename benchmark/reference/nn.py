"""Plain float32 building blocks of the reference detector.

Every module takes and returns NHWC tensors and computes in float32 with
``torch.nn.functional`` alone. Submodule and parameter names follow the
detector under test, so one state dict of seeded weights loads into both.
"""

import torch
import torch.nn.functional as F
from torch import nn


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """kxk conv, padding k // 2, over NHWC; float32."""

    def __init__(self, cin, cout, k=3, stride=1, bias=True, groups=1):
        super().__init__()
        self.stride, self.pad, self.groups = stride, k // 2, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return to_nhwc(F.conv2d(to_nchw(x.float()), self.weight, self.bias,
                                self.stride, self.pad, 1, self.groups))


class GroupNorm32(nn.Module):
    def __init__(self, channels, groups=32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return to_nhwc(F.group_norm(to_nchw(x), self.groups, self.weight,
                                    self.bias, 1e-5))


class FrozenBatchNorm(nn.Module):
    """x * w / sqrt(var + 1e-5) + (b - mean * scale), from buffers."""

    def __init__(self, channels):
        super().__init__()
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), value))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return x * scale + (self.bias - self.running_mean * scale)


class ConvTower(nn.Module):
    """n x [conv3x3 -> GN -> ReLU] (``conv{i}``, ``gn{i}``)."""

    def __init__(self, n, cin, ch, norm=True):
        super().__init__()
        self.n, self.norm = n, norm
        for i in range(n):
            self.add_module(f"conv{i}", Conv(cin if i == 0 else ch, ch))
            if norm:
                self.add_module(f"gn{i}", GroupNorm32(ch))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x)
            if self.norm:
                x = getattr(self, f"gn{i}")(x)
            x = F.relu(x)
        return x


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.float())


def safe_l2_norm(x, dim=None, keepdim=False, eps=1e-8):
    sq = x * x
    s = sq.sum() if dim is None else sq.sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(s + eps * eps)


def dropout(x, rate, generator):
    """Inverted dropout; one ``torch.rand`` of x's shape from ``generator``
    (the identity without one)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadSelfAttention(nn.Module):
    """SCAN's node attention: the raw (N, D) -> (heads, N, D / heads) view,
    scale (dh // heads) ** -0.5, key mask remapped through that view,
    dropout on the weights and on ``linear_final``'s output, residual and a
    post LayerNorm."""

    def __init__(self, dim=256, heads=4, rate=0.1):
        super().__init__()
        self.dim, self.heads, self.rate = dim, heads, rate
        for name in ("linear_q", "linear_k", "linear_v", "linear_final"):
            self.add_module(name, Linear(dim, dim))
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask, generator=None):
        d, h = self.dim, self.heads
        dh, n = d // h, x.shape[0]
        q = self.linear_q(x).reshape(h, n, dh)
        k = self.linear_k(x).reshape(h, n, dh)
        v = self.linear_v(x).reshape(h, n, dh)
        attn = (q @ k.transpose(1, 2)) * float(max(dh // h, 1)) ** -0.5
        pos = (torch.arange(h, device=x.device)[:, None] * n
               + torch.arange(n, device=x.device)[None, :])
        attn = torch.where(mask[pos // h][:, None, :], attn,
                           torch.full_like(attn, -1e30))
        attn = dropout(torch.softmax(attn, -1), self.rate, generator)
        out = dropout(self.linear_final((attn @ v).reshape(n, d)), self.rate,
                      generator)
        return self.layer_norm(x + out)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambd):
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambd * g, None


def grl(x, lambd):
    """Gradient reversal: identity forward, -lambd * g backward."""
    return _Reverse.apply(x, lambd)


def bce_with_logits(x, target):
    return x.clamp_min(0) - x * target + torch.log1p(torch.exp(-x.abs()))


def sigmoid_focal_loss(logits, targets, gamma, alpha):
    """Sum over (row, class) of the FCOS focal loss; targets 0 background,
    c > 0 the column c - 1."""
    c = logits.shape[1]
    cls = torch.arange(1, c + 1, device=logits.device)[None, :]
    t = targets[:, None].long()
    p = torch.sigmoid(logits)
    pos = (t == cls).float()
    neg = ((t != cls) & (t >= 0)).float()
    return (-pos * (1 - p) ** gamma * F.logsigmoid(logits) * alpha
            - neg * p ** gamma * F.logsigmoid(-logits) * (1 - alpha)).sum()


def softmax_focal_loss(logits, targets, gamma=2.0):
    p = torch.softmax(logits, 1)
    pt = torch.gather(p, 1, targets[:, None].long())[:, 0].clamp_min(1e-15)
    return (-((1 - pt) ** gamma) * torch.log(pt)).sum() / pt.shape[0]


def iou_loss(pred, target, weight, valid):
    vm = valid[:, None]
    pred = torch.where(vm, pred, torch.zeros_like(pred))
    target = torch.where(vm, target, torch.zeros_like(target))
    pl, pt, pr, pb = pred.unbind(1)
    tl, tt, tr, tb = target.unbind(1)
    inter = ((torch.minimum(pl, tl) + torch.minimum(pr, tr))
             * (torch.minimum(pb, tb) + torch.minimum(pt, tt)))
    union = (tl + tr) * (tt + tb) + (pl + pr) * (pt + pb) - inter
    ratio = torch.where(valid, (inter + 1.0) / (union + 1.0),
                        torch.ones_like(inter))
    w = weight * valid.float()
    return (-torch.log(ratio.clamp_min(1e-12)) * w).sum() / w.sum().clamp_min(1e-6)
