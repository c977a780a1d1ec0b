"""Kernels K1 (NMS) and K2 (fused VGG stem) against their plain versions on
the card. A CUDA kernel has no CPU mode, so every test here is marked
``gpu`` and skips without a card. This file imports no JAX, so it runs on
the machine with the card: ``python -m pytest tests/test_torch_kernels.py -m gpu``.

Tolerances: K1's keep masks must be equal, and K3-K6's bytes. K2 in float32 within atol/rtol
1e-4 of the plain version with TF32 off (float32 sums in another order); in
bfloat16 within rtol 2**-7 (two bf16 ulps) and atol 2**-8 of the largest
output: a conv1_1 value may round to bf16 on the other side of a tie in the
two sum orders, which moves an output by well under one ulp of the largest.

K2's bf16 variant and K5 work on tiles of 8 x 16 pooled outputs; the edge
cases below cover one image, pooled sizes that are not multiples of the
tile, odd H and W, and a width below one tile.
"""

import ctypes

import numpy as np
import pytest
import torch

from scan_tpu_torch.ops.cuda import nms_kernel, stem_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_case(seed, b, k, n_labels, invalid_frac, device):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (b, k)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (b, k)) >= invalid_frac)
    labels = torch.from_numpy(rng.randint(1, n_labels + 1, (b, k)).astype(np.int32))
    order = torch.sort(-torch.where(valid, scores, torch.tensor(-1e10)),
                       stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return (boxes.to(device), torch.gather(valid, 1, order).to(device),
            torch.gather(labels, 1, order).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 512, 1000, 2048])
@pytest.mark.parametrize("label_dtype", [None, torch.int32, torch.int64])
def test_nms_kernel_matches_plain(cuda_device, k, label_dtype):
    """K1's chunked scan resolves 64 rows at a time: K below, at and past
    one chunk, and K = 2048 (32 words, the small scan's largest). Labels of
    int32 and int64 go to the kernel uncast."""
    boxes, valid, labels = _sorted_case(k, 4, k, 8, 0.25, cuda_device)
    labels = None if label_dtype is None else labels.to(label_dtype)
    before = nms_kernel.nms_sorted.launches
    got = nms_kernel.nms_sorted(boxes, valid, labels, 0.6)
    torch.cuda.synchronize()
    assert nms_kernel.nms_sorted.launches == before + 1
    want = nms_kernel.nms_sorted_plain(boxes, valid, labels, 0.6)
    assert torch.equal(got, want)
    if k >= 512:
        assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 1000])
@pytest.mark.parametrize("case", ["all_invalid", "all_overlapping"])
def test_nms_kernel_degenerate_sets(cuda_device, k, case):
    """No valid row (nothing kept), and one box repeated (only the first
    valid row of each label kept)."""
    boxes, valid, labels = _sorted_case(k + 1, 2, k, 3, 0.25, cuda_device)
    if case == "all_invalid":
        valid = torch.zeros_like(valid)
    else:
        boxes = torch.tensor([10.0, 20.0, 60.0, 90.0],
                             device=cuda_device).expand(2, k, 4).contiguous()
    for lab in (None, labels):
        before = nms_kernel.nms_sorted.launches
        got = nms_kernel.nms_sorted(boxes, valid, lab, 0.6)
        torch.cuda.synchronize()
        assert nms_kernel.nms_sorted.launches == before + 1
        want = nms_kernel.nms_sorted_plain(boxes, valid, lab, 0.6)
        assert torch.equal(got, want)
        if case == "all_invalid":
            assert not want.any()
        else:
            assert int(want.sum()) == 2 * (1 if lab is None else 3)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2049, 4096, 6000, 12000])
@pytest.mark.parametrize("label_dtype", [None, torch.int32, torch.int64])
def test_nms_kernel_matches_plain_past_2048(cuda_device, k, label_dtype):
    """K past the earlier design's 2048 (32 words): the scan stages chunk
    rows in pieces of 64 words, two or more pieces a chunk from K = 4097 on
    (K = 6000 and 12,000 are the RPN's PRE_NMS_TOP_N_TEST / _TRAIN
    defaults). Boxes spread so that a fair share is kept."""
    boxes, valid, labels = _sorted_case(k, 2, k, 8, 0.25, cuda_device)
    boxes = boxes * (k / 512) ** 0.5  # the same density as at K = 512
    labels = None if label_dtype is None else labels.to(label_dtype)
    before = nms_kernel.nms_sorted.launches
    got = nms_kernel.nms_sorted(boxes, valid, labels, 0.6)
    torch.cuda.synchronize()
    assert nms_kernel.nms_sorted.launches == before + 1
    want = nms_kernel.nms_sorted_plain(boxes, valid, labels, 0.6)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.gpu
def test_nms_kernel_refuses_k_past_its_shared_memory(cuda_device):
    """The one limit left is the scan's shared memory (the bitset beside the
    staging buffers); the wrapper's MAX_K is the library's."""
    assert nms_kernel._lib() is not None
    lib = nms_kernel.build.load("nms")
    lib.scan_nms_max_k.restype = ctypes.c_int
    assert lib.scan_nms_max_k() == nms_kernel.MAX_K
    k = nms_kernel.MAX_K + 1
    with pytest.raises(ValueError):
        nms_kernel.nms_sorted(
            torch.zeros(1, k, 4, device=cuda_device),
            torch.ones(1, k, dtype=torch.bool, device=cuda_device), None, 0.6)


def _stem_data(h, w, seed, device, b=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, 3, generator=g) * 50
    w0 = torch.randn(64, 3, 3, 3, generator=g) * 0.1
    b0 = torch.randn(64, generator=g) * 0.1
    w1 = torch.randn(64, 64, 3, 3, generator=g) * 0.05
    b1 = torch.randn(64, generator=g) * 0.1
    return [t.to(device) for t in (x, w0, b0, w1, b1)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(64, 96), (37, 50), (200, 333)])
def test_stem_kernel_matches_plain(cuda_device, h, w):
    data = _stem_data(h, w, h * w, cuda_device)
    got = stem_kernel.fused_stem(*data, out_dtype=torch.float32)
    want = stem_kernel.reference_stem(*data, out_dtype=torch.float32)
    assert got.shape == want.shape == (2, h // 2, w // 2, 64)
    torch.testing.assert_close(got, want.contiguous(), atol=1e-4, rtol=1e-4)

    got = stem_kernel.fused_stem(*data, out_dtype=torch.bfloat16)
    want = stem_kernel.reference_stem(*data, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -8 * scale)


# (B, H, W): one exact tile; pooled H and W off the tile; odd H and W;
# a pooled width below one tile; a pooled height below one tile, odd
STEM_EDGES = [(1, 16, 32), (1, 34, 70), (2, 37, 51), (1, 20, 12), (3, 9, 45)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", STEM_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_kernel_tile_edges(cuda_device, b, h, w, dtype):
    data = _stem_data(h, w, b * h * w, cuda_device, b=b)
    packed = stem_kernel.pack_weights(*data[1:], out_dtype=dtype)
    before = stem_kernel.fused_stem.launches
    got = stem_kernel.fused_stem(*data, out_dtype=dtype, packed=packed)
    torch.cuda.synchronize()
    assert stem_kernel.fused_stem.launches == before + 1
    want = stem_kernel.reference_stem(*data, out_dtype=dtype)
    assert got.shape == want.shape == (b, h // 2, w // 2, 64)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want.contiguous(), atol=1e-4,
                                   rtol=1e-4)
    else:
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -8 * scale)


@pytest.mark.gpu
def test_stem_kernel_refuses_a_pack_of_another_dtype(cuda_device):
    data = _stem_data(8, 8, 0, cuda_device)
    packed = stem_kernel.pack_weights(*data[1:], out_dtype=torch.float32)
    with pytest.raises(ValueError):
        stem_kernel.fused_stem(*data, out_dtype=torch.bfloat16, packed=packed)


@pytest.mark.gpu
def test_stem_kernel_refuses_other_widths(cuda_device):
    x = torch.zeros(1, 8, 8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        stem_kernel.fused_stem(
            x, torch.zeros(16, 3, 3, 3, device=cuda_device),
            torch.zeros(16, device=cuda_device),
            torch.zeros(16, 16, 3, 3, device=cuda_device),
            torch.zeros(16, device=cuda_device))


# ---- the int8 path: the s8 conv (im2col + torch._int_mm) and K3-K6 ----
#
# Tolerances: everything on the int8 path must be equal. The s32 sums are
# exact; every epilogue runs the same float32 steps in the same order, with
# IEEE division and no FMA contraction, so the plain version on the card
# gives the same bytes as the kernel. K5 too: its s32 sums are exact in the
# tensor cores' order, so it must equal its plain version byte for byte.

from scan_tpu_torch.ops import quant  # noqa: E402
from scan_tpu_torch.ops.cuda import (  # noqa: E402
    conv0_kernel, phase_max_kernel, stem_int8_kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("k,stride,padding,cin", [
    (3, 1, ((1, 1), (1, 1)), 3), (3, 2, ((1, 1), (1, 1)), 64),
    (3, (2, 1), ((1, 0), (1, 1)), 16), (1, 1, ((0, 0), (0, 0)), 256),
    (3, 1, ((1, 1), (1, 1)), 265)])
def test_int8_conv_on_card_equals_cpu(cuda_device, k, stride, padding, cin):
    rng = np.random.RandomState(cin)
    x = torch.from_numpy(rng.randn(2, 5, 7, cin).astype(np.float32) * 3)
    w = torch.from_numpy((rng.randn(k, k, cin, 64) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    for oq, relu in ((None, False), (None, True), (0.05, True), (0.05, False)):
        outs = []
        for dev in ("cpu", cuda_device):
            s = None if oq is None else torch.tensor(oq, device=dev)
            outs.append(quant.int8_conv(
                x.to(dev), w.to(dev), b.to(dev), stride=stride,
                padding=padding, out_quant_scale=s, fold_relu=relu).cpu())
        assert torch.equal(outs[0], outs[1]), (oq, relu)


def _int8_stem_data(b, h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (b, h, w, 3), generator=g).to(torch.int8)
    w0 = torch.randn(3, 3, 3, 64, generator=g) * 0.2
    b0 = torch.randn(64, generator=g) * 0.5
    w1 = torch.randn(3, 3, 64, 64, generator=g) * 0.05
    b1 = torch.randn(64, generator=g) * 0.5
    scales = [torch.tensor(v) for v in (0.31, 0.9, 0.8)]
    return [t.to(device) for t in (x_q, w0, b0, w1, b1, *scales)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(64, 96), (37, 50), (200, 336)])
def test_conv0_kernel_matches_plain(cuda_device, h, w):
    x_q, w0, b0, _, _, s0, s1, _ = _int8_stem_data(2, h, w, h * w, cuda_device)
    before = conv0_kernel.conv0_s8.launches
    got = conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1 * 0.1)
    torch.cuda.synchronize()
    assert conv0_kernel.conv0_s8.launches == before + 1
    want = conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1 * 0.1)
    assert got.shape == (2, h, w, 64) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < want.numel()


# K3 works on tiles of 4 rows x 128 columns, eight m16 tiles of 16 pixels a
# row: (B, H, W, s1) with H and W off the tile, W below one m16 tile, one
# and eight images, a tiny s1 (most outputs saturate at 127), s1 = 2**-5,
# which puts many quotients y / s1 on exact half-integers, and an s1 at
# which the division-free path needs its guard band (the kernel then
# divides where a product lies within 2**-14 of a half-integer).
CONV0_EDGES = [(1, 4, 128, 0.09), (2, 13, 200, 0.09), (1, 5, 9, 0.09),
               (3, 17, 15, 0.09), (8, 24, 130, 0.09), (2, 40, 70, 1e-4),
               (2, 40, 70, 2.0 ** -5), (2, 40, 70, 0.0099051333963871)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,s1", CONV0_EDGES)
def test_conv0_kernel_tile_edges(cuda_device, b, h, w, s1):
    x_q, w0, b0, _, _, s0, _, _ = _int8_stem_data(b, h, w, b + h * w,
                                                  cuda_device)
    s1 = torch.tensor(s1, device=cuda_device)
    packed = conv0_kernel.pack_weight(w0)
    before = conv0_kernel.conv0_s8.launches
    got = conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1, packed=packed)
    torch.cuda.synchronize()
    assert conv0_kernel.conv0_s8.launches == before + 1
    want = conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1)
    assert got.shape == want.shape == (b, h, w, 64)
    assert torch.equal(got, want)
    if float(s1) < 1e-3:
        assert int((want == 127).sum()) > want.numel() // 4
    else:
        assert 0 < int((want != 0).sum()) < want.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("bias_mul,s1", [(1.0, 1e32), (1e35, 1e32),
                                         (1e35, 0.09), (1.0, 1e-9)])
def test_conv0_kernel_extreme_scales(cuda_device, bias_mul, s1):
    """Scales outside the common path's range (r = 1 / s1 below 2**-100, a
    bias above 2**100) go the exact way, and s1 below its floor of 1e-8 is
    clamped: all equal the plain version."""
    x_q, w0, b0, _, _, s0, _, _ = _int8_stem_data(2, 9, 40, 7, cuda_device)
    s1 = torch.tensor(s1, device=cuda_device)
    b0 = b0 * bias_mul
    got = conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1)
    torch.cuda.synchronize()
    assert torch.equal(got, conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w", [(16, 32), (37, 50), (400, 672)])
def test_phase_max_requant_kernel_matches_plain(cuda_device, dtype, h, w):
    g = torch.Generator().manual_seed(h + w)
    z = (torch.randn(2, h, w, 64, generator=g) * 40).to(dtype).to(cuda_device)
    s = torch.tensor(0.37, device=cuda_device)
    before = phase_max_kernel.phase_max_requant.launches
    got = phase_max_kernel.phase_max_requant(z, s)
    torch.cuda.synchronize()
    assert phase_max_kernel.phase_max_requant.launches == before + 1
    assert got.shape == (2, h // 2, w // 2, 64)
    assert torch.equal(got, phase_max_kernel.phase_max_requant_plain(z, s))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(16, 32), (37, 50), (400, 672)])
def test_pair_phase_max_kernel_matches_plain(cuda_device, h, w):
    g = torch.Generator().manual_seed(h * w)
    z = torch.randint(-127, 128, (2, h, w, 64), generator=g).to(
        torch.int8).to(cuda_device)
    before = phase_max_kernel.pair_phase_max_s8.launches
    got = phase_max_kernel.pair_phase_max_s8(z)
    torch.cuda.synchronize()
    assert phase_max_kernel.pair_phase_max_s8.launches == before + 1
    assert torch.equal(got, phase_max_kernel.pair_phase_max_s8_plain(z))


@pytest.mark.gpu
def test_phase_max_kernels_refuse_narrow_channels(cuda_device):
    with pytest.raises(ValueError):
        phase_max_kernel.phase_max_requant(
            torch.zeros(1, 4, 4, 4, device=cuda_device),
            torch.tensor(0.5, device=cuda_device))
    with pytest.raises(ValueError):
        phase_max_kernel.pair_phase_max_s8(
            torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(16, 32), (24, 64), (37, 50), (200, 336)])
def test_stem_int8_kernel_matches_plain(cuda_device, h, w):
    data = _int8_stem_data(2, h, w, h + w, cuda_device)
    before = stem_int8_kernel.fused_stem_int8.launches
    got = stem_int8_kernel.fused_stem_int8(*data)
    torch.cuda.synchronize()
    assert stem_int8_kernel.fused_stem_int8.launches == before + 1
    want = stem_int8_kernel.fused_stem_int8_plain(*data)
    assert got.shape == want.shape == (2, h // 2, w // 2, 64)
    assert torch.equal(got, want), "expected equal: same steps, same order"


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", STEM_EDGES)
def test_stem_int8_kernel_tile_edges(cuda_device, b, h, w):
    data = _int8_stem_data(b, h, w, b + h + w, cuda_device)
    packed = stem_int8_kernel.pack_weights(data[1], data[3])
    before = stem_int8_kernel.fused_stem_int8.launches
    got = stem_int8_kernel.fused_stem_int8(*data, packed=packed)
    torch.cuda.synchronize()
    assert stem_int8_kernel.fused_stem_int8.launches == before + 1
    want = stem_int8_kernel.fused_stem_int8_plain(*data)
    assert got.shape == want.shape == (b, h // 2, w // 2, 64)
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < want.numel()


@pytest.mark.gpu
def test_stem_int8_kernel_saturates(cuda_device):
    """All-127 input and large weights: conv1_1 and conv1_2 sums reach the
    top of s32's useful range and both requants clip at 127 (and at 0 for
    the channels whose weights are negative)."""
    b, h, w = 2, 40, 70
    x_q = torch.full((b, h, w, 3), 127, dtype=torch.int8, device=cuda_device)
    g = torch.Generator().manual_seed(5)
    sign = torch.where(torch.rand(64, generator=g) < 0.75, 1.0, -1.0)
    w0 = (torch.rand(3, 3, 3, 64, generator=g) + 1.0) * 4.0 * sign
    w1 = (torch.rand(3, 3, 64, 64, generator=g) + 1.0) * 4.0 * sign
    b0, b1 = torch.full((64,), 3.0), torch.full((64,), -2.0)
    s = [torch.tensor(v) for v in (0.02, 0.05, 0.01)]
    data = [t.to(cuda_device) for t in (x_q, w0, b0, w1, b1, *s)]
    got = stem_int8_kernel.fused_stem_int8(*data)
    torch.cuda.synchronize()
    want = stem_int8_kernel.fused_stem_int8_plain(*data)
    assert torch.equal(got, want)
    assert int((want == 127).sum()) > want.numel() // 2
    assert int((want == 0).sum()) > 0


@pytest.mark.gpu
def test_stem_int8_kernel_zero_input_edge(cuda_device):
    """All-zero input: the output is the quantized bias chain, with conv1_2
    seeing zero padding at the image border (the masking case)."""
    x_q, w0, b0, w1, b1, _, _, _ = _int8_stem_data(1, 8, 16, 1, cuda_device)
    x_q = torch.zeros_like(x_q)
    s = [torch.tensor(v, device=cuda_device) for v in (1.0, 0.5, 0.5)]
    got = stem_int8_kernel.fused_stem_int8(x_q, w0, b0 * 2, w1, b1, *s)
    want = stem_int8_kernel.fused_stem_int8_plain(x_q, w0, b0 * 2, w1, b1, *s)
    assert torch.equal(got, want)
    assert int(want.ne(want[:, 1:2, 1:2]).sum()) > 0, "border must differ"


@pytest.mark.gpu
def test_stem_kernel_refuses_autograd(cuda_device):
    """K2 has no backward: with grad mode on, an input that requires grad
    makes the wrapper raise instead of returning a constant to autograd."""
    x, w0, b0, w1, b1 = _stem_data(32, 48, 7, cuda_device)
    w1 = w1.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        stem_kernel.fused_stem(x, w0, b0, w1, b1)
    with torch.no_grad():
        stem_kernel.fused_stem(x, w0, b0, w1, b1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_step_runs_k2_on_the_frozen_stem(cuda_device, dtype,
                                                  monkeypatch):
    """One DA step of the full-width C2F model on a small input, in float32
    and in bf16 over float32 masters: the frozen stem runs K2 (in the
    compute dtype) in the source and the target forward and never its
    plain version, its weights do not move, and a trained weight does."""
    import os

    from scan_tpu_torch.config import get_default_cfg
    from scan_tpu_torch.engine.train_step import make_da_train_step
    from scan_tpu_torch.modeling.detector import build_detector
    from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "scan", "scan_vgg16_cityscapace_to_foggy.yaml"))
    cfg.TPU.MAX_BOXES = 4
    cfg.TPU.COMPUTE_DTYPE = dtype
    det = build_detector(cfg, device=cuda_device, train=True)

    def refuse(*a, **k):
        raise AssertionError("the plain stem ran on the card")

    monkeypatch.setattr(stem_kernel, "reference_stem", refuse)
    opt = make_optimizer(cfg, det)
    step = make_da_train_step(det, opt, make_lr_scheduler(cfg, opt))
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 2, 128, 192, 3), generator=g,
                           dtype=torch.uint8)
    batch_s = dict(images=images[0], sizes=torch.tensor([[128, 192]] * 2),
                   boxes=torch.tensor([[[8., 8., 60., 70.], [40., 30., 150., 120.],
                                        [0, 0, 0, 0], [0, 0, 0, 0]]] * 2),
                   labels=torch.tensor([[3, 6, 0, 0]] * 2, dtype=torch.int32),
                   mask=torch.tensor([[True, True, False, False]] * 2))
    body = det.backbone.body
    stem_w = body.conv1.weight.detach().clone()
    trained = body.conv4.weight.detach().clone()
    before = stem_kernel.fused_stem.launches
    _, metrics = step(det.proto_state(), batch_s, {"images": images[1]},
                      forward_target=True)
    torch.cuda.synchronize()
    assert stem_kernel.fused_stem.launches == before + 2
    assert torch.isfinite(metrics["loss_total"]).item()
    assert torch.equal(body.conv1.weight, stem_w)
    assert not torch.equal(body.conv4.weight, trained)
    assert all(p.dtype == torch.float32 for p in det.parameters())
