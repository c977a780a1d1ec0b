"""Gradient reversal (counterpart of ``scan_tpu/modeling/discriminator/grl.py``;
reference ``discriminator/layer.py:6-33``): the identity forward, and
``-lambda * g`` backward. As in JAX, where lambda is a weakly typed scalar,
lambda is first rounded to the gradient's dtype (bf16 on a bf16 tensor)."""

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambd: float):
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        lambd = float(torch.tensor(ctx.lambd, dtype=g.dtype))
        return -lambd * g, None


def gradient_reversal(x, lambd: float):
    return _GradientReversal.apply(x, lambd)
