"""The plain versions of the port's int8 stem kernels K3-K6 against
``scan_tpu``'s Pallas kernels, on the CPU.

The Pallas kernels run as ``scan_tpu``'s own tests run them: ``conv0_s8``
under ``pltpu.force_tpu_interpret_mode()``, the others with
``interpret=True``. The same numpy inputs, made from a seed, go through
both, at the full stage-1 width (64 channels) and a small H x W.

Layouts: the port's kernels read and write plain NHWC. ``scan_tpu``'s K3
writes (B, H, W/2, 128), a reshape of the same bytes; its K4 reads the
phase-major (B, H/2, W/2, 4C) tensor (``vgg._s2d`` of the full-resolution
conv output) and its K6 the two row-phase pairs (B, H/2, W/2, 2C), pair qy
holding rows qy::2 with the two columns of each window side by side. The
tests build those from the full-resolution tensor the port's kernels take.

Tolerances: K3, K4 and K6 must be equal byte for byte, as ``scan_tpu``'s
specs demand of its kernels. K5 is held to its spec
(``tests/test_stem_int8_kernel.py``): no element off by more than 1 LSB,
fewer than 0.1% off by 1. Against the ``int8_conv`` chain that spec names
as its oracle, the port's plain K5 must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.modeling.backbone.vgg import _phase_packed_weight, _s2d
from scan_tpu.ops.quant import int8_conv
from scan_tpu_torch.ops.cuda import conv0_kernel, phase_max_kernel
from scan_tpu_torch.ops.cuda import stem_int8_kernel


def _stem_data(b, h, w, seed, zero=False):
    rng = np.random.RandomState(seed)
    x_q = rng.randint(-127, 128, (b, h, w, 3)).astype(np.int8)
    if zero:
        x_q[:] = 0
    w0 = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)
    b0 = (rng.randn(64) * 0.5).astype(np.float32)
    w1 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b1 = (rng.randn(64) * 0.5).astype(np.float32)
    return x_q, w0, b0, w1, b1


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---- K3 conv0_s8 ---------------------------------------------------------

@pytest.mark.parametrize("b,h,w,tr", [(1, 16, 32, 2), (2, 24, 48, 4)])
def test_conv0_plain_equals_pallas(b, h, w, tr):
    from jax.experimental.pallas import tpu as pltpu

    from scan_tpu.ops.pallas.conv0_kernel import conv0_s8, reference_conv0_s8

    x_q, w0, b0, _, _ = _stem_data(b, h, w, seed=h + w)
    s0, s1 = np.float32(0.7), np.float32(0.11)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(conv0_s8(*map(jnp.asarray, (x_q, w0, b0, s0, s1)),
                                   tr=tr))
    oracle = np.asarray(reference_conv0_s8(*map(jnp.asarray,
                                                (x_q, w0, b0, s0, s1))))
    got = conv0_kernel.conv0_s8_plain(*_t(x_q, w0, b0, s0, s1)).numpy()
    assert got.shape == (b, h, w, 64) and got.dtype == np.int8
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(got.reshape(oracle.shape), oracle)
    assert 0 < (got != 0).mean() < 1  # the clip and the ReLU both bite


def test_conv0_wrapper_runs_plain_on_cpu():
    x_q, w0, b0, _, _ = _stem_data(1, 8, 16, seed=3)
    args = _t(x_q, w0, b0, np.float32(0.5), np.float32(0.2))
    before = conv0_kernel.conv0_s8.launches
    assert torch.equal(conv0_kernel.conv0_s8(*args),
                       conv0_kernel.conv0_s8_plain(*args))
    assert conv0_kernel.conv0_s8.launches == before


# ---- K4 phase_max_requant ----------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,w", [(1, 16, 32), (2, 20, 24), (1, 10, 10)])
def test_phase_max_requant_plain_equals_pallas(dtype, b, h, w):
    from scan_tpu.ops.pallas.phase_max_kernel import phase_max_requant

    rng = np.random.RandomState(h * w)
    z = jnp.asarray((rng.randn(b, h, w, 64) * 40).astype(np.float32)).astype(
        getattr(jnp, dtype))
    scale = np.float32(0.37)
    want = np.asarray(phase_max_requant(_s2d(z), jnp.float32(scale),
                                        block_h=4, interpret=True))
    zt = torch.from_numpy(np.array(z.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = phase_max_kernel.phase_max_requant(zt, torch.tensor(scale))
    assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_phase_max_requant_relu_floor():
    z = -torch.ones(1, 8, 16, 64, dtype=torch.bfloat16)
    got = phase_max_kernel.phase_max_requant(z, torch.tensor(0.5))
    assert int(got.abs().max()) == 0


# ---- K6 pair_phase_max_s8 ----------------------------------------------

@pytest.mark.parametrize("b,h,w", [(1, 16, 32), (2, 20, 24), (1, 14, 18)])
def test_pair_phase_max_plain_equals_pallas(b, h, w):
    from scan_tpu.ops.pallas.phase_max_kernel import pair_phase_max_s8

    rng = np.random.RandomState(h + w)
    z = rng.randint(-127, 128, (b, h, w, 64)).astype(np.int8)
    pairs = [jnp.asarray(z[:, qy::2].reshape(b, h // 2, w // 2, 128))
             for qy in range(2)]
    want = np.asarray(pair_phase_max_s8(*pairs, block_rows=64,
                                        interpret=True))
    got = phase_max_kernel.pair_phase_max_s8(torch.from_numpy(z)).numpy()
    assert got.shape == (b, h // 2, w // 2, 64) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


# ---- K5 fused_stem_int8 --------------------------------------------------

def _int8_conv_chain(x_q, w0, b0, w1, b1, s0, s1, s_out):
    """``tests/test_stem_int8_kernel.py``'s oracle: the STEM_S8_EPILOGUE
    ``int8_conv`` chain with the packed stride-2 conv1_2."""
    y_q = int8_conv(x_q, w0, b0, stride=1, padding=((1, 1), (1, 1)),
                    act_scale=s0, out_quant_scale=s1, fold_relu=True)
    z_q = int8_conv(y_q, _phase_packed_weight(w1), jnp.tile(b1, 4), stride=2,
                    padding=((1, 1), (1, 1)), act_scale=s1,
                    out_quant_scale=s_out, fold_relu=True)
    return jnp.maximum(jnp.maximum(z_q[..., :64], z_q[..., 64:128]),
                       jnp.maximum(z_q[..., 128:192], z_q[..., 192:]))


@pytest.mark.parametrize("hw,th,zero", [((16, 32), 2, False),
                                        ((24, 64), 3, False),
                                        ((8, 16), 2, True)])
def test_fused_stem_int8_plain_vs_pallas(hw, th, zero):
    """zero=True is the all-zero-input edge: the output is the quantized
    bias chain, and conv1_2 must see zeros outside the image."""
    from scan_tpu.ops.pallas.stem_int8_kernel import fused_stem_int8

    h, w = hw
    data = _stem_data(2, h, w, seed=h + w, zero=zero)
    scales = [np.float32(v) for v in ((1.0, 0.5, 0.5) if zero
                                      else (0.31, 0.9, 0.8))]
    jargs = [jnp.asarray(a) for a in (*data, *scales)]
    want = np.asarray(fused_stem_int8(*jargs, th=th, interpret=True))
    oracle = np.asarray(_int8_conv_chain(*jargs))
    got = stem_int8_kernel.fused_stem_int8(*_t(*data, *scales)).numpy()
    assert got.shape == want.shape == (2, h // 2, w // 2, 64)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    np.testing.assert_array_equal(got, oracle)
    if zero:
        assert (got != got[:, 1:2, 1:2]).any(), "the border must differ"
