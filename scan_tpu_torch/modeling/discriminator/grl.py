"""Gradient reversal (counterpart of ``scan_tpu/modeling/discriminator/grl.py``;
reference ``discriminator/layer.py:6-33``): the identity forward, and
``-lambda * g`` backward."""

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambd: float):
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambd * g, None


def gradient_reversal(x, lambd: float):
    return _GradientReversal.apply(x, lambd)
