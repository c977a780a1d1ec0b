"""The weight packs of kernels K2 and K5, whose conv1_2 runs as a
tensor-core implicit GEMM (``scan_tpu_torch/csrc/stem_mma.cuh``).

conv1_2's GEMM K index is tap-major, then input channel: k = (3 ky + kx) *
64 + ci, and w1 is packed as [co][tap][ci], K contiguous (K2's bf16 conv1_1
likewise, w0 as [co][tap][4 channel slots]). These CPU tests hold the packs
to that order:
- each pack reads back to the weights it was made from;
- an im2col of a seeded conv1_1 output, in the kernel's K order, contracted
  with the packed w1 gives conv1_2: exactly ``conv_s32`` for s8, and
  ``F.conv2d`` within float32 rounding (rtol 1e-5, atol 1e-5 of the largest
  value; the same bf16 products summed in another order) for bf16;
- ``VGG16._stage1_fp`` packs once per weight version.
The kernels themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scan_tpu_torch.modeling.backbone import vgg as vgg_mod
from scan_tpu_torch.ops.cuda import stem_int8_kernel, stem_kernel
from scan_tpu_torch.ops.quant import conv_s32, prepare_weight, quantize_weight

CH = 64


def _im2col(y):
    """(B, H, W, C) -> (B*H*W, 9*C), zero padding 1, K order (ky, kx, ci)."""
    b, h, w, c = y.shape
    yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [yp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, -1).reshape(b * h * w, 9 * c)


def _fp_weights(seed, ch=CH):
    rng = np.random.RandomState(seed)
    t = lambda *s, k: torch.from_numpy((rng.randn(*s) * k).astype(np.float32))  # noqa: E731
    return t(ch, 3, 3, 3, k=0.2), t(ch, k=0.1), t(ch, ch, 3, 3, k=0.05), \
        t(ch, k=0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_pack_reads_back(dtype):
    w0, b0, w1, b1 = _fp_weights(1)
    p = stem_kernel.pack_weights(w0, b0, w1, b1, dtype)
    assert p.dtype == dtype
    assert p.b0.dtype == p.b1.dtype == torch.float32
    assert p.w0.dtype == p.w1.dtype == dtype and p.w1.shape == (CH, 9, CH)
    r = lambda t: t.to(dtype).float()  # noqa: E731
    if dtype == torch.bfloat16:  # w0 [co][14 taps][4], w1 [co][tap][ci]
        assert p.w0.shape == (CH, 14, 4)
        back0 = p.w0[:, :9, :3].reshape(CH, 3, 3, 3).permute(0, 3, 1, 2)
        assert not p.w0[:, 9:].any() and not p.w0[:, :, 3].any()
        back1 = p.w1.reshape(CH, 3, 3, CH).permute(0, 3, 1, 2)
    else:  # w0 [tap][ci][co], w1 [ci][tap][co]
        back0 = p.w0.reshape(3, 3, 3, CH).permute(3, 2, 0, 1)
        back1 = p.w1.reshape(CH, 3, 3, CH).permute(3, 0, 1, 2)
    assert torch.equal(back0.float(), r(w0))
    assert torch.equal(back1.float(), r(w1))
    assert torch.equal(p.b0, r(b0)) and torch.equal(p.b1, r(b1))
    for t in p[1:]:
        assert t.is_contiguous()


def test_k2_pack_defaults_to_the_weights_dtype():
    w = [t.to(torch.bfloat16) for t in _fp_weights(2)]
    assert stem_kernel.pack_weights(*w).dtype == torch.bfloat16


def test_k5_pack_reads_back():
    rng = np.random.RandomState(3)
    w0 = torch.from_numpy((rng.randn(3, 3, 3, CH) * 0.2).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(3, 3, CH, CH) * 0.05).astype(np.float32))
    w0k, w0_s, w1k, w1_s = stem_int8_kernel.pack_weights(w0, w1)
    w0_q, w0_s_want = quantize_weight(w0)
    w1_q, w1_s_want = quantize_weight(w1)
    assert torch.equal(w0_s, w0_s_want) and torch.equal(w1_s, w1_s_want)
    assert w1k.dtype == torch.int8 and w1k.shape == (CH, 9, CH)
    assert w1k.is_contiguous()
    assert torch.equal(w1k.reshape(CH, 3, 3, CH).permute(1, 2, 3, 0), w1_q)
    words = w0k.contiguous().view(torch.int8).reshape(9, CH, 4)
    assert torch.equal(words[..., :3].permute(0, 2, 1).reshape(3, 3, 3, CH),
                       w0_q)
    assert not words[..., 3].any()


@pytest.mark.parametrize("b,h,w", [(1, 4, 6), (2, 5, 9)])
def test_k5_pack_contracts_to_conv_s32(b, h, w):
    rng = np.random.RandomState(h * w)
    y_q = rng.randint(0, 128, (b, h, w, CH)).astype(np.int8)
    w0 = torch.from_numpy((rng.randn(3, 3, 3, CH) * 0.2).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(3, 3, CH, CH) * 0.05).astype(np.float32))
    _, _, w1k, _ = stem_int8_kernel.pack_weights(w0, w1)
    got = _im2col(y_q.astype(np.int64)) @ \
        w1k.reshape(CH, 9 * CH).numpy().astype(np.int64).T
    want = conv_s32(torch.from_numpy(y_q), prepare_weight(*quantize_weight(w1)),
                    (1, 1), ((1, 1), (1, 1)))
    assert np.array_equal(got.reshape(b, h, w, CH), want.numpy())


@pytest.mark.parametrize("b,h,w", [(1, 4, 6), (2, 5, 9)])
def test_k2_bf16_pack_contracts_to_conv2d(b, h, w):
    rng = np.random.RandomState(h + w)
    y = torch.from_numpy(np.maximum(rng.randn(b, h, w, CH), 0).astype(
        np.float32)).to(torch.bfloat16).float()  # conv1_1 out, bf16 values
    w0, b0, w1, b1 = _fp_weights(h * w)
    p = stem_kernel.pack_weights(w0, b0, w1, b1, torch.bfloat16)
    got = torch.from_numpy(_im2col(y.numpy())) @ \
        p.w1.reshape(CH, 9 * CH).float().T
    want = F.conv2d(y.permute(0, 3, 1, 2), w1.to(torch.bfloat16).float(),
                    padding=1).permute(0, 2, 3, 1).reshape(-1, CH)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("b,h,w", [(1, 4, 6), (2, 5, 9)])
def test_k2_bf16_w0_pack_contracts_to_conv2d(b, h, w):
    """conv1_1's K: 14 tap slots (9 used) x 4 channel slots (3 used)."""
    rng = np.random.RandomState(7 * h + w)
    x = torch.from_numpy((rng.randn(b, h, w, 3) * 2).astype(np.float32)).to(
        torch.bfloat16).float()
    w0, b0, w1, b1 = _fp_weights(h)
    p = stem_kernel.pack_weights(w0, b0, w1, b1, torch.bfloat16)
    slots = np.zeros((b, h, w, 4), np.float32)
    slots[..., :3] = x.numpy()
    cols = _im2col(slots)  # (N, 9 * 4)
    cols = np.concatenate([cols, np.zeros((len(cols), 5 * 4), np.float32)], 1)
    got = torch.from_numpy(cols) @ p.w0.reshape(CH, 14 * 4).float().T
    want = F.conv2d(x.permute(0, 3, 1, 2), w0.to(torch.bfloat16).float(),
                    padding=1).permute(0, 2, 3, 1).reshape(-1, CH)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_stage1_fp_packs_once_per_weight_version(monkeypatch):
    calls = []

    def counting(*weights):
        calls.append(1)
        return stem_kernel.pack_weights(*weights)

    monkeypatch.setattr(vgg_mod, "pack_stem", counting)
    torch.manual_seed(0)
    net = vgg_mod.VGG16(width_div=8, stage_blocks=(2, 1, 1, 1, 1))
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        first = net(x)[0]
        net(x)
        assert len(calls) == 1
        net.conv1.weight.mul_(2.0)  # an in-place update: a new version
        second = net(x)[0]
        assert len(calls) == 2
        net(x)
        assert len(calls) == 2
        net.conv0.bias.add_(0.5)
        net(x)
        assert len(calls) == 3
    assert first.shape == second.shape == (1, 16, 16, 8)
    assert not torch.equal(first, second)
