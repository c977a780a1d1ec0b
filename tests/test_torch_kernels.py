"""Kernels K1 (NMS) and K2 (fused VGG stem) against their plain versions on
the card. A CUDA kernel has no CPU mode, so every test here is marked
``gpu`` and skips without a card. This file imports no JAX, so it runs on
the machine with the card: ``python -m pytest tests/test_torch_kernels.py -m gpu``.

Tolerances: K1's keep masks must be equal. K2 in float32 within atol/rtol
1e-4 of the plain version with TF32 off (float32 sums in another order); in
bfloat16 within rtol 2**-7 (two bf16 ulps) and atol 2**-8 of the largest
output: a conv1_1 value may round to bf16 on the other side of a tie in the
two sum orders, which moves an output by well under one ulp of the largest.
"""

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
@pytest.mark.parametrize("k", [512, 1000, 2048])
@pytest.mark.parametrize("use_labels", [False, True])
def test_nms_kernel_matches_plain(cuda_device, k, use_labels):
    boxes, valid, labels = _sorted_case(k, 4, k, 8, 0.25, cuda_device)
    labels = labels if use_labels else None
    before = nms_kernel.nms_sorted.launches
    got = nms_kernel.nms_sorted(boxes, valid, labels, 0.6)
    torch.cuda.synchronize()
    assert nms_kernel.nms_sorted.launches == before + 1
    want = nms_kernel.nms_sorted_plain(boxes, valid, labels, 0.6)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.gpu
def test_nms_kernel_refuses_k_above_2048(cuda_device):
    with pytest.raises(ValueError):
        nms_kernel.nms_sorted(
            torch.zeros(1, 2049, 4, device=cuda_device),
            torch.ones(1, 2049, dtype=torch.bool, device=cuda_device), None, 0.6)


def _stem_data(h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, h, w, 3, generator=g) * 50
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


@pytest.mark.gpu
def test_stem_kernel_refuses_other_widths(cuda_device):
    x = torch.zeros(1, 8, 8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        stem_kernel.fused_stem(
            x, torch.zeros(16, 3, 3, 3, device=cuda_device),
            torch.zeros(16, device=cuda_device),
            torch.zeros(16, 16, 3, 3, device=cuda_device),
            torch.zeros(16, device=cuda_device))
