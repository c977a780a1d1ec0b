"""The port's int8 ops (``scan_tpu_torch/ops/quant.py``) against
``scan_tpu/ops/quant.py`` on the CPU.

Same numpy inputs through both. ``scan_tpu``'s functions run op by op, not
under ``jax.jit``: inside a jitted fusion XLA:CPU contracts the epilogue's
``acc * scale + bias`` into one FMA, which rounds once where the port (and
XLA op by op, and the port's CUDA kernels, built with ``--fmad=false``)
round twice. Op by op the two packages do the same float32 steps, so every
output must be equal: s8 outputs byte for byte and fp outputs bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.ops import quant as jq
from scan_tpu_torch.ops import quant as tq


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_quantize_weight_matches():
    w = (np.random.RandomState(0).randn(3, 3, 16, 32) * 0.05).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    got_q, got_s = tq.quantize_weight(_t(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("static", [False, True])
def test_quantize_activation_matches(static):
    x = (np.random.RandomState(1).randn(2, 8, 8, 16) * 3).astype(np.float32)
    s = np.float32(0.021) if static else None
    want_q, want_s = jq.quantize_activation(
        jnp.asarray(x), None if s is None else jnp.asarray(s))
    got_q, got_s = tq.quantize_activation(_t(x), None if s is None else _t(s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


CONVS = {
    "3x3_s1": (3, 1, ((1, 1), (1, 1)), 16),
    "3x3_s2": (3, 2, ((1, 1), (1, 1)), 16),
    "3x3_s21_pair": (3, (2, 1), ((1, 0), (1, 1)), 16),
    "1x1": (1, 1, ((0, 0), (0, 0)), 24),
    "3x3_same": (3, 1, "SAME", 16),
    "3x3_s2_same": (3, 2, "SAME", 16),
    "stem_cin3": (3, 1, ((1, 1), (1, 1)), 3),
    "head_out_cin265": (3, 1, ((1, 1), (1, 1)), 265),
}
EPILOGUES = {"fp": (None, False), "fp_relu": (None, True),
             "s8": (0.05, False), "s8_relu": (0.05, True)}


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_int8_conv_matches(conv, epilogue):
    k, stride, padding, cin = CONVS[conv]
    oq, relu = EPILOGUES[epilogue]
    rng = np.random.RandomState(len(conv) + cin)
    x = (rng.randn(2, 9, 12, cin) * 3).astype(np.float32)
    w = (rng.randn(k, k, cin, 24) * 0.1).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jq.int8_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
        padding=padding, act_scale=jnp.float32(0.02),
        out_quant_scale=None if oq is None else jnp.float32(oq),
        fold_relu=relu))
    got = tq.int8_conv(
        _t(x), _t(w), _t(b), stride=stride, padding=padding,
        act_scale=torch.tensor(0.02),
        out_quant_scale=None if oq is None else torch.tensor(oq),
        fold_relu=relu).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_conv_s8_input_dynamic_and_out_dtype(out_dtype):
    """An s8 input at a given scale (no re-quantization), no bias, and a
    dynamic-scale call, with both output dtypes."""
    rng = np.random.RandomState(3)
    x_q = rng.randint(-127, 128, (2, 8, 10, 8)).astype(np.int8)
    x = (rng.randn(2, 8, 10, 8) * 5).astype(np.float32)
    w = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    want = jq.int8_conv(jnp.asarray(x_q), jnp.asarray(w), stride=(2, 1),
                        padding=((1, 0), (1, 1)), act_scale=jnp.float32(0.1),
                        out_dtype=jdt)
    got = tq.int8_conv(_t(x_q), _t(w), stride=(2, 1), padding=((1, 0), (1, 1)),
                       act_scale=torch.tensor(0.1), out_dtype=tdt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    want = jq.int8_conv(jnp.asarray(x), jnp.asarray(w), out_dtype=jdt)
    got = tq.int8_conv(_t(x), _t(w), out_dtype=tdt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_int8_conv_im2col_matches(epilogue):
    oq, relu = EPILOGUES[epilogue]
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 10, 14, 3) * 40).astype(np.float32)
    w = (rng.randn(3, 3, 3, 16) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    kw = dict(act_scale=0.3, out_quant_scale=oq, fold_relu=relu)
    want = np.asarray(jq.int8_conv_im2col(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        **{k: None if v is None else (jnp.float32(v) if k != "fold_relu"
                                      else v) for k, v in kw.items()}))
    got = tq.int8_conv_im2col(
        _t(x), _t(w), _t(b),
        **{k: None if v is None else (torch.tensor(v) if k != "fold_relu"
                                      else v) for k, v in kw.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tq.int8_conv_im2col(_t(x), _t(np.zeros((1, 1, 3, 16), np.float32)))


def test_quantized_activation_dequantize():
    qa = tq.QuantizedActivation(torch.full((2, 4, 4, 8), 3, dtype=torch.int8),
                                torch.tensor(0.5))
    assert qa.shape == (2, 4, 4, 8)
    assert torch.equal(qa.dequantize(torch.bfloat16),
                       torch.full((2, 4, 4, 8), 1.5, dtype=torch.bfloat16))


def test_conv_s32_pads_rows_and_depth_exactly():
    """Fewer than 32 output rows and a depth that is no multiple of 8: the
    zero padding for the card's shape rules leaves the int32 sums exact."""
    rng = np.random.RandomState(5)
    x_q = torch.from_numpy(rng.randint(-127, 128, (1, 2, 3, 5)).astype(np.int8))
    w_q = torch.from_numpy(rng.randint(-127, 128, (3, 3, 5, 6)).astype(np.int8))
    wq = tq.prepare_weight(w_q, torch.ones(6))
    assert wq.mat.shape == (48, 8)
    got = tq.conv_s32(x_q, wq, (1, 1), ((1, 1), (1, 1)))
    want = torch.nn.functional.conv2d(
        x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
        padding=1).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got, want.to(torch.int32))
