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
- ``VGG16._stage1_fp`` packs once per weight version, and for its compute
  dtype (bf16 over float32 masters packs the masters for bf16).
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
    assert p.w0.dtype == p.w1.dtype == dtype
    r = lambda t: t.to(dtype).float()  # noqa: E731
    if dtype == torch.bfloat16:  # w0 [co][14 taps][4], w1 [co][tap][ci]
        assert p.w0.shape == (CH, 14, 4) and p.w1.shape == (CH, 9, CH)
        back0 = p.w0[:, :9, :3].reshape(CH, 3, 3, 3).permute(0, 3, 1, 2)
        assert not p.w0[:, 9:].any() and not p.w0[:, :, 3].any()
        back1 = p.w1.reshape(CH, 3, 3, CH).permute(0, 3, 1, 2)
        assert torch.equal(back0.float(), r(w0))
        assert torch.equal(back1.float(), r(w1))
    else:  # the 3xTF32 split: [hi/lo] x w0 [co][27 (tap, ci) + 5 zeros],
        # w1 [co][tap][ci]
        assert p.w0.shape == (2, CH, 32) and p.w1.shape == (2, CH, 9, CH)
        assert not p.w0[:, :, 27:].any()
        for part in (p.w0, p.w1):  # both halves are TF32: low 13 bits 0
            assert not (part.view(torch.int32) & 0x1FFF).any()
        hi0 = p.w0[0, :, :27].reshape(CH, 3, 3, 3).permute(0, 3, 1, 2)
        hi1 = p.w1[0].reshape(CH, 3, 3, CH).permute(0, 3, 1, 2)
        assert torch.equal(hi0, stem_kernel.tf32_round(w0))
        assert torch.equal(hi1, stem_kernel.tf32_round(w1))
        back0 = (p.w0[0] + p.w0[1])[:, :27].reshape(
            CH, 3, 3, 3).permute(0, 3, 1, 2)
        back1 = (p.w1[0] + p.w1[1]).reshape(CH, 3, 3, CH).permute(0, 3, 1, 2)
        # hi + lo holds 22 of float32's 24 significant bits
        for back, w in ((back0, w0), (back1, w1)):
            assert bool(((back - w).abs() <= w.abs() * 2.0 ** -22).all())
            assert not torch.equal(back, w)  # the dropped bits are real
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
    # w0: K3's pack, words [co][4 ky + kx] of bytes (c0, c1, c2, 0)
    assert w0k.dtype == torch.int32 and w0k.shape == (CH, 16)
    by = w0k.contiguous().view(torch.int8).reshape(CH, 4, 4, 4)
    assert torch.equal(by[:, :3, :3, :3].permute(1, 2, 3, 0), w0_q)
    assert not by[:, 3].any() and not by[:, :, 3].any()
    assert not by[..., 3].any()


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

    def counting(*weights, **kw):
        calls.append(kw.get("out_dtype"))
        return stem_kernel.pack_weights(*weights, **kw)

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
        # a bf16 compute dtype packs the float32 masters for bf16, once
        net.compute_dtype = torch.bfloat16
        assert net(x)[0].dtype == torch.bfloat16
        net(x)
        assert calls == [torch.float32] * 3 + [torch.bfloat16]
    assert first.shape == second.shape == (1, 16, 16, 8)
    assert not torch.equal(first, second)


# ---- K2 float32's arithmetic: 3xTF32 on the tensor cores ----------------
#
# The emulation runs each conv as the kernel's GEMM: K in its order (conv1_1
# the 27 (tap, channel) pairs padded to 32, conv1_2 tap-major then input
# channel), and
# per k8 step the kernel's sums: the step's three mma, a_lo b_hi, a_hi b_lo,
# a_hi b_hi, chained from zero into a sum of their own, which one float32
# add then puts into the running sum. hi = tf32(x), lo = tf32(x - hi) are
# rounded as cvt.rna does, on the bits. The products of TF32 operands are
# exact (11 x 11 bits); each mma's sum is rounded here to nearest once. The
# card's tensor cores round that sum otherwise (toward zero), which is why
# the kernel sums each step apart rather than chaining 216 mma into one
# accumulator: that chain's error misses the tolerance on the card.

PIXEL_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


def _normalised_image(seed, h=64, w=96):
    """A seeded 3 x h x w frame as the detector normalises it (BGR 255 less
    the C2F config's pixel mean), NHWC."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (1, h, w, 3)).astype(np.float32)
    return torch.from_numpy(img - PIXEL_MEAN)


def _he_weights(seed):
    """He-scaled conv1_1 / conv1_2 weights and small biases."""
    rng = np.random.RandomState(seed)
    t = lambda *s, k: torch.from_numpy((rng.randn(*s) * k).astype(np.float32))  # noqa: E731
    return (t(CH, 3, 3, 3, k=(2 / 27) ** 0.5), t(CH, k=0.05),
            t(CH, CH, 3, 3, k=(2 / 576) ** 0.5), t(CH, k=0.05))


def _tf32_gemm(a, w_hi, w_lo, three):
    """a (P, K) float32, w (N, K) hi and lo -> (P, N) float32 sums."""
    a_hi = stem_kernel.tf32_round(a)
    a_lo = stem_kernel.tf32_round(a - a_hi)
    terms = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)) if three else \
        ((a_hi, w_hi),)
    acc = torch.zeros((a.shape[0], w_hi.shape[0]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        step = torch.zeros_like(acc)
        for x, w in terms:  # one mma each, from the step's own zero sum
            prod = x[:, k0:k0 + 8].double() @ w[:, k0:k0 + 8].double().T
            step = (step.double() + prod).float()
        acc = acc + step
    return acc


def _emulated_k2_f32(x, w0, b0, w1, b1, three=True):
    b, h, w, _ = x.shape
    p = stem_kernel.pack_weights(w0, b0, w1, b1, torch.float32)
    if not three:  # one TF32 product: the weights rounded once
        p = p._replace(w0=torch.stack([p.w0[0], torch.zeros_like(p.w0[0])]),
                       w1=torch.stack([p.w1[0], torch.zeros_like(p.w1[0])]))
    cols = np.concatenate([_im2col(x.numpy()), np.zeros((b * h * w, 5),
                                                        np.float32)], 1)
    y = _tf32_gemm(torch.from_numpy(cols), p.w0[0], p.w0[1], three)
    y = torch.clamp_min(y + p.b0, 0.0).reshape(b, h, w, CH)
    z = _tf32_gemm(torch.from_numpy(_im2col(y.numpy())),
                   p.w1[0].reshape(CH, 9 * CH), p.w1[1].reshape(CH, 9 * CH),
                   three).reshape(b, h, w, CH)
    pooled = z.reshape(b, h // 2, 2, w // 2, 2, CH).amax(dim=(2, 4))
    return torch.clamp_min(pooled + p.b1, 0.0)


def test_k2_f32_3xtf32_meets_the_float32_tolerance():
    """The kernel's 3xTF32 arithmetic meets the 1e-4 tolerance K2 float32
    is held to on the card (``chip_smoke.py``'s k2_stem_vs_plain) against
    ``reference_stem`` in float32; one TF32 product a term misses it by far,
    which is why the kernel takes three."""
    x = _normalised_image(5)
    weights = _he_weights(6)
    want = stem_kernel.reference_stem(x, *weights, out_dtype=torch.float32)
    got = _emulated_k2_f32(x, *weights)
    assert got.shape == want.shape == (1, 32, 48, CH)
    assert float(want.abs().max()) > 50  # realistic magnitudes
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    single = _emulated_k2_f32(x, *weights, three=False)
    err = (single - want).abs() - 1e-4 * want.abs()
    assert float(err.max()) > 10 * 1e-4
    assert float((err > 1e-4).float().mean()) > 0.5


def test_k2_f32_3xtf32_conv1_1_gemm_order():
    """conv1_1's K: the 27 (tap, channel) pairs, tap-major, padded to 32,
    four k8 steps, against F.conv2d in float64 within 3xTF32's rounding."""
    x = _normalised_image(7, 12, 20)
    w0, b0, w1, b1 = _he_weights(8)
    p = stem_kernel.pack_weights(w0, b0, w1, b1, torch.float32)
    cols = np.concatenate([_im2col(x.numpy()), np.zeros((240, 5),
                                                        np.float32)], 1)
    got = _tf32_gemm(torch.from_numpy(cols), p.w0[0], p.w0[1], True)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w0.double(),
                    padding=1).permute(0, 2, 3, 1).reshape(-1, CH)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-4)
