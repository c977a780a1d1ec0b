"""The port's ``deform_conv2d`` (``scan_tpu_torch/ops/deform_conv.py``)
against ``scan_tpu.ops.deform_conv.deform_conv2d``, on the CPU, float32.

(2, 9, 11, 6) -> 5 channels, 3x3 (and one 5x5 case), with the offsets zero
(the plain conv, which the output also equals), integer (samples on the
grid, the clip's ties on the border), fractional (within +-2 px) and far
outside the map (every sample of some taps zero, some in the -1 < y < 0
band); with and without the DCNv2 mask and the bias. ``scan_tpu`` runs op
by op (a jit per case costs more than it saves at this size). Forward
within 1e-5 of the output's largest value; the gradients of a weighted sum
with respect to x, the offsets, the weight, the mask and the bias against
``jax.grad`` within 1e-5 of each gradient's largest value. The clip's
gradient at a tie is split in both packages (``modeling.layers.clip``),
which the integer offsets, whose border samples sit on the tie, check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from scan_tpu_torch.ops.deform_conv import deform_conv2d

B, H, W, C, O = 2, 9, 11, 6, 5


def _offsets(kind, k, rng):
    shape = (B, H, W, 2 * k * k)
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "integer":
        return rng.randint(-2, 3, shape).astype(np.float32)
    if kind == "fractional":
        return rng.uniform(-2, 2, shape).astype(np.float32)
    off = rng.uniform(-2, 2, shape)
    off[..., :4] += np.asarray([-30, 25, 40, -50])  # taps 0, 1 off the map
    off[..., 4:6] += rng.choice([-1.5, 1.5], (B, H, W, 2)) * np.asarray(
        [H, W])  # tap 2: some samples in the -1 < y < 0 band, some outside
    return off.astype(np.float32)


CASES = [("zero", 3, False, False), ("integer", 3, True, True),
         ("fractional", 3, False, False), ("outside", 3, True, True),
         ("fractional", 5, True, False)]


@pytest.mark.parametrize("kind,k,use_mask,use_bias", CASES,
                         ids=[f"{c[0]}-k{c[1]}{'-mask' * c[2]}{'-bias' * c[3]}"
                              for c in CASES])
def test_deform_conv_matches_scan_tpu(kind, k, use_mask, use_bias):
    rng = np.random.RandomState(len(kind) * 10 + k)
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = _offsets(kind, k, rng)
    weight = (rng.randn(k, k, C, O) / np.sqrt(k * k * C)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, k * k)).astype(np.float32) \
        if use_mask else None
    bias = rng.randn(O).astype(np.float32) if use_bias else None
    cot = rng.randn(B, H, W, O).astype(np.float32)

    def jloss(x, off, w, m, b):
        y = jax_deform_conv2d(x, off, w, b, m, kernel_size=k)
        return jnp.sum(y * cot), y

    args = (x, off, weight, mask, bias)
    jargs = tuple(None if a is None else jnp.asarray(a) for a in args)
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    (_, want), grads = jax.value_and_grad(jloss, argnums, has_aux=True)(*jargs)
    want = np.asarray(want)

    targs = [None if a is None else torch.tensor(a, requires_grad=True)
             for a in args]
    got = deform_conv2d(targs[0], targs[1], targs[2], targs[4], targs[3],
                        kernel_size=k)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == want.shape == (B, H, W, O)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if kind == "zero":  # the plain conv
        plain = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(weight).permute(3, 2, 0, 1), padding=k // 2)
        plain = plain.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got.detach().numpy(), plain, rtol=0,
                                   atol=1e-5 * np.abs(plain).max())
    if kind == "outside":
        assert np.abs(np.asarray(grads[1])[..., :4]).max() == 0
    for i, g in zip(argnums, grads):
        g = np.asarray(g)
        np.testing.assert_allclose(targs[i].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-30),
                                   err_msg=f"grad {i}")
