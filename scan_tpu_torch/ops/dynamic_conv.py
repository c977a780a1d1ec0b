"""Per-class conditional 1x1 convolution ("kernel manifestation").

Counterpart of ``scan_tpu/ops/dynamic_conv.py`` (reference
``condgraph.dynamic_conv``, ``condgraph.py:619-629``): the manifested
prototype kernels (C_used, 256[+1]) act as a 1x1 conv over an NHWC feature
map, i.e. one matmul over the channel axis, computed in float32 as
``scan_tpu``'s einsum with ``preferred_element_type=float32`` is. XLA ran it
outside Pallas too, so it stays a plain matmul here.
"""

import torch


def dynamic_conv(features, kernel_par, with_bias: bool = False):
    """features (B, H, W, C_in); kernel_par (K, C_in) or (K, C_in + 1) with
    the bias in the last column. Returns (B, H, W, K) float32 logits."""
    if with_bias:
        weight, bias = kernel_par[:, :-1], kernel_par[:, -1]
    else:
        weight, bias = kernel_par, None
    out = torch.matmul(features.float(), weight.float().t())
    if bias is not None:
        out = out + bias.float()
    return out
