"""The towers' fused conv-bias + GroupNorm + ReLU (``ops/cuda/group_norm_kernel.py``,
``csrc/group_norm.cu``) and the gate that picks it in ``ConvTower``.

On the CPU: the plain version against ``relu(group_norm(y + b))``; the
wrapper's refusals that need no card; the gate's decision on each condition
(an input that reports itself on the card stands in for a CUDA tensor);
the tower's output bitwise today's wherever the gate says no; and the fused
block's wiring (the conv without its bias, the bias, the affine) through
the plain version.

On the card (marked ``gpu``, skipped without one; this file imports no JAX):
the kernel against its plain version, computed in float32 from the same
input, at C2F's five level shapes at batch 1 and 8, C = 256, G = 32, with
and without the conv bias, in bf16 and float32. Limits: float32 within
1e-5 of the largest output; bf16 within one bf16 ulp of the plain result,
an ulp taken no finer than that of 2^-8 of the largest output (below it the
two float32 evaluations' own rounding, ~1e-6 of the largest, is more than
an ulp). Then the refusals and one full-width bf16 eval forward whose
detections with the kernel and with the plain function match as sets.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from scan_tpu_torch.modeling import layers
from scan_tpu_torch.modeling.layers import Conv, ConvTower, GroupNorm32
from scan_tpu_torch.ops.cuda import group_norm_kernel as gnk
from scan_tpu_torch.ops.quant import QuantizedActivation

# C2F's FPN levels at 672x1344 (strides 8 to 128)
LEVELS = [(84, 168), (42, 84), (21, 42), (11, 21), (6, 11)]
C, G = 256, 32


def _inputs(b, h, w, dtype, device, seed, param_dtype=None):
    """A conv-like output with per-channel offsets (so a group's mean is
    not 0), the conv bias in its dtype, and the norm's affine."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(b, h, w, C, generator=g) * (0.5 + torch.rand(C, generator=g))
    y = y + torch.randn(C, generator=g)
    bias = torch.randn(C, generator=g) * 0.5
    weight = 1.0 + 0.2 * torch.randn(C, generator=g)
    gn_bias = 0.2 * torch.randn(C, generator=g)
    pd = param_dtype or dtype
    return (y.to(device, dtype), bias.to(device, dtype),
            weight.to(device, pd), gn_bias.to(device, pd))


def _reference(y, bias, weight, gn_bias):
    """``relu(group_norm(y + b))`` in NCHW, float32, as the modules write it."""
    x = y.float() if bias is None else y.float() + bias.float()
    out = F.relu(F.group_norm(layers.to_nchw(x), G, weight.float(),
                              gn_bias.float(), 1e-5))
    return layers.to_nhwc(out)


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_relu_group_norm_of_the_sum(dtype, with_bias):
    """float32 within 1e-6 (relative and absolute) of the sum's norm taken
    in float64; bf16 exactly the float32 formula rounded once."""
    y, bias, weight, gn_bias = _inputs(2, 11, 21, dtype, "cpu", 0)
    bias = bias if with_bias else None
    got = gnk.group_norm_relu_plain(y, bias, weight, gn_bias, G)
    assert got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        x = y.double() if bias is None else y.double() + bias.double()
        xg = x.reshape(2, -1, G, C // G)
        mean = xg.mean((1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean((1, 3), keepdim=True)
        want = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
        want = torch.relu(want * weight.double() + gn_bias.double())
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, _reference(y, bias, weight, gn_bias).to(dtype))


def test_wrapper_refuses_the_cpu_and_autograd():
    y, bias, weight, gn_bias = _inputs(1, 6, 11, torch.float32, "cpu", 1)
    with pytest.raises(ValueError, match="unsupported device"):
        gnk.group_norm_relu(y, bias, weight, gn_bias, G)
    weight.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        gnk.group_norm_relu(y, bias, weight, gn_bias, G)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: the gate's device
    condition without a card."""

    @property
    def is_cuda(self):
        return True


def _block(dtype=torch.float32, quant=False, masters=False, width=C):
    conv = Conv(16, width, 3, quant=quant)
    gn = GroupNorm32(width)
    gen = torch.Generator().manual_seed(3)
    layers.init_parameters(torch.nn.Sequential(conv, gn), gen)
    for m in (conv, gn):
        if not quant:
            m.compute_dtype = dtype
            if not masters:
                m.to(dtype)
    return conv, gn


@pytest.mark.parametrize("case", [
    "card", "card_float32_masters", "card_bf16", "card_frozen_under_grad",
    "cpu", "card_under_grad", "card_input_requires_grad", "card_quant",
    "card_float16", "card_bf16_width_128", "card_quantized_input"])
def test_gate_decides_from_what_it_sees(case):
    dtype = {"card_bf16": torch.bfloat16, "card_bf16_width_128": torch.bfloat16,
             "card_float16": torch.float16}.get(case, torch.float32)
    # an FPN of 128 channels: 4 a group, past a bf16 16-byte load's 8
    width = 128 if case == "card_bf16_width_128" else C
    conv, gn = _block(dtype, quant=case == "card_quant",
                      masters=case == "card_float32_masters", width=width)
    if case == "card_float32_masters":
        conv.compute_dtype = gn.compute_dtype = torch.bfloat16
    x = torch.randn(1, 6, 6, 16, dtype=dtype)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "card_quantized_input":
        x = QuantizedActivation(torch.zeros(1, 6, 6, 16, dtype=torch.int8),
                                torch.tensor(0.1))
    if case == "card_frozen_under_grad":
        for p in (*conv.parameters(), *gn.parameters()):
            p.requires_grad_(False)
    if case == "card_input_requires_grad":
        for p in (*conv.parameters(), *gn.parameters()):
            p.requires_grad_(False)
        x.requires_grad_(True)
    grad = case in ("card_under_grad", "card_frozen_under_grad",
                    "card_input_requires_grad")
    with torch.set_grad_enabled(grad):
        got = layers.fuses_group_norm(x, conv, gn)
    want = case in ("card", "card_float32_masters", "card_bf16",
                    "card_frozen_under_grad")
    assert got is want


@pytest.mark.parametrize("shape, dtype, groups, want", [
    ((8, 84, 168, C), torch.bfloat16, G, True),
    ((8, 84, 168, 128), torch.float32, G, True),  # 4 a group: one load
    ((8, 84, 168, 128), torch.bfloat16, G, False),  # 4 a group, 8 a load
    ((1, 6, 11, C), torch.float16, G, False),
    ((1, 6, 11, 2048), torch.float32, G, False),  # 512 loads a pixel
    ((1, 512, 4096, C), torch.bfloat16, G, False),  # 2^24 values a group
])
def test_supports_states_the_wrappers_shape_rules(shape, dtype, groups, want):
    assert gnk.supports(shape, dtype, groups) is want


def _todays_tower(tower, x):
    """``ConvTower.forward`` as it was: each module in turn."""
    for i in range(tower.num_convs):
        x = getattr(tower, f"conv{i}")(x)
        if tower.norm == "GN":
            x = getattr(tower, f"gn{i}")(x)
        x = F.relu(x)
    return x


@pytest.mark.parametrize("case", ["cpu", "under_grad", "quant", "norm_none"])
def test_plain_path_is_todays_bitwise(case, monkeypatch):
    """Where the gate says no, the kernel's wrapper is never called and the
    tower computes exactly what it computed before the fused path."""
    def refuse(*a, **k):
        raise AssertionError("the fused kernel ran")

    monkeypatch.setattr(gnk, "group_norm_relu", refuse)
    tower = ConvTower(2, 16, C, norm="NONE" if case == "norm_none" else "GN",
                      quant=case == "quant")
    layers.init_parameters(tower, torch.Generator().manual_seed(4))
    x = torch.randn(2, 9, 13, 16)
    with torch.set_grad_enabled(case == "under_grad"):
        got = tower(x)
        want = _todays_tower(tower, x)
    assert torch.equal(got, want)
    if case == "under_grad":
        got.sum().backward()
        assert tower.conv0.weight.grad is not None


def test_fused_block_wiring_through_the_plain_version(monkeypatch):
    """With the gate forced and the plain version standing in for the
    kernel, the tower computes what its modules compute (float32: the bias
    added before the norm either way), so the conv runs without its bias and
    the bias, affine and groups reach the kernel's arguments."""
    calls = []

    def plain(y, bias, weight, gn_bias, groups, eps):
        calls.append((y.shape, bias is not None, groups, eps))
        assert y.is_contiguous()
        return gnk.group_norm_relu_plain(y, bias, weight, gn_bias, groups, eps)

    tower = ConvTower(3, 16, C)
    layers.init_parameters(tower, torch.Generator().manual_seed(5))
    for m in tower.modules():
        if isinstance(m, GroupNorm32):  # an affine that is not the identity
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.3, 0.3)
        elif isinstance(m, Conv):
            m.bias.data.uniform_(-0.5, 0.5)
    x = torch.randn(2, 9, 13, 16)
    with torch.no_grad():
        want = _todays_tower(tower, x)
        monkeypatch.setattr(layers, "fuses_group_norm", lambda *a: True)
        monkeypatch.setattr(gnk, "group_norm_relu", plain)
        got = tower(x)
    assert calls == [((2, 9, 13, C), True, G, 1e-5)] * 3
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (float32 tensor)."""
    e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


def _assert_within(got, want_f32, dtype):
    big = float(want_f32.abs().max())
    if dtype == torch.float32:
        assert float((got - want_f32).abs().max()) <= 1e-5 * big
        return
    want = want_f32.to(torch.bfloat16).float()
    floor = _bf16_ulp(torch.tensor(big * 2 ** -8, device=got.device))
    tol = torch.maximum(_bf16_ulp(want), floor)
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hw", LEVELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_matches_plain(cuda_device, dtype, hw, b, with_bias):
    y, bias, weight, gn_bias = _inputs(b, *hw, dtype, cuda_device,
                                       seed=hw[0] * 10 + b)
    bias = bias if with_bias else None
    before = gnk.group_norm_relu.launches
    got = gnk.group_norm_relu(y, bias, weight, gn_bias, G)
    torch.cuda.synchronize()
    assert gnk.group_norm_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == y.shape and got.is_contiguous()
    x = y.float() if bias is None else y.float() + bias.float()
    want = F.relu(F.group_norm(layers.to_nchw(x), G, weight.float(),
                               gn_bias.float(), 1e-5))
    _assert_within(got, layers.to_nhwc(want), dtype)
    plain = gnk.group_norm_relu_plain(y, bias, weight, gn_bias, G)
    assert torch.equal(plain, layers.to_nhwc(want).to(dtype))
    assert 0 < int((got == 0).sum()) < got.numel()  # the ReLU clips some


@pytest.mark.gpu
def test_group_norm_kernel_float32_affine_on_bf16(cuda_device):
    """A master-weight detector evaluated under no_grad: bf16 activations
    and bias, float32 GroupNorm parameters read as they are."""
    y, bias, weight, gn_bias = _inputs(8, *LEVELS[1], torch.bfloat16,
                                       cuda_device, 9, torch.float32)
    got = gnk.group_norm_relu(y, bias, weight, gn_bias, G)
    want = _reference(y, bias, weight, gn_bias)
    _assert_within(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_group_norm_kernel_refusals(cuda_device):
    y, bias, weight, gn_bias = _inputs(2, 6, 11, torch.bfloat16, cuda_device, 2)
    with pytest.raises(ValueError, match="contiguous"):
        gnk.group_norm_relu(y.transpose(1, 2), bias, weight, gn_bias, G)
    with pytest.raises(ValueError, match="group width"):
        gnk.group_norm_relu(y, bias, weight, gn_bias, 64)  # 4 channels a group
    with pytest.raises(ValueError, match="bias"):
        gnk.group_norm_relu(y, bias.float(), weight, gn_bias, G)
    with pytest.raises(ValueError, match="unsupported device"):
        gnk.group_norm_relu(y.cpu(), bias.cpu(), weight.cpu(), gn_bias.cpu(), G)
    y.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        gnk.group_norm_relu(y, bias, weight, gn_bias, G)
    with torch.no_grad():
        gnk.group_norm_relu(y, bias, weight, gn_bias, G)


def _iou(a, b):
    """Pairwise IoU of boxes a (N, 4) and b (M, 4), x0 y0 x1 y1."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[:, 2:] - t[:, :2]).clamp_min(0).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def _unmatched_scores(got, want, b):
    """Scores of the detections of image ``b`` on either side left without
    a partner of the same label at IoU >= 0.5, matched one to one in
    descending score order."""
    vg, vw = got["valid"][b], want["valid"][b]
    bg, bw = got["boxes"][b][vg].float(), want["boxes"][b][vw].float()
    lg, lw = got["labels"][b][vg], want["labels"][b][vw]
    sg, sw = got["scores"][b][vg].float(), want["scores"][b][vw].float()
    iou = _iou(bw, bg)
    iou[lw[:, None] != lg[None]] = 0
    taken = torch.zeros(len(bg), dtype=torch.bool, device=bg.device)
    left = []
    for i in torch.argsort(-sw).tolist():
        cand = torch.where(taken, torch.zeros_like(iou[i]), iou[i])
        j = int(cand.argmax()) if len(bg) else -1
        if j >= 0 and float(cand[j]) >= 0.5:
            taken[j] = True
        else:
            left.append(float(sw[i]))
    return left + sg[~taken].tolist()


def _assert_same_sets(got, want, margin):
    """The valid detections of each image as sets: equal counts, and one to
    one by label at IoU >= 0.5 (NMS keeps one of two overlapping boxes
    whose scores tie, and a one-ulp change of a bf16 logit decides which),
    but for detections that score within ``margin`` of the image's cut (the
    least score either side kept), which such a change moves across it."""
    assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
    for b in range(want["valid"].shape[0]):
        cut = min(float(got["scores"][b][got["valid"][b]].min()),
                  float(want["scores"][b][want["valid"][b]].min()))
        left = _unmatched_scores(got, want, b)
        assert all(s <= cut + margin for s in left), (b, cut, sorted(left))


@pytest.mark.gpu
def test_full_width_bf16_eval_detections_match_the_plain_function(
        cuda_device, monkeypatch):
    """The C2F detector at full width in bf16, evaluation in precision mode
    (both towers and the condgraph's head_in take the kernel, 50 blocks a
    batch), its cls bias raised so NMS has candidates: the detections with
    the kernel and with the plain function match as sets. The logits are
    bf16 (~200 distinct values a level), so a one-ulp difference upstream
    can decide a tie: in NMS between two boxes that overlap, and at the
    image's cut. A one-ulp change of a logit near 0.3 moves a score by
    ~0.004; the margin at the cut is 0.01."""
    from scan_tpu_torch.config import get_default_cfg
    from scan_tpu_torch.modeling.detector import build_detector
    from scan_tpu_torch.utils import profiler

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "scan", "scan_vgg16_cityscapace_to_foggy.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    det = build_detector(cfg, device=cuda_device, train=False)
    with torch.no_grad():
        det.fcos.cls_logits.bias.add_(2.6)
        det.fcos.bbox_pred.bias.fill_(3.4657)  # box sides 32 px
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 256, 512, 3), generator=g,
                           dtype=torch.uint8).to(cuda_device)
    sizes = torch.tensor([[256, 512]] * 2, device=cuda_device)
    before = gnk.group_norm_relu.launches
    profiler.reset()
    with profiler.recording():
        got = det.forward_inference(images, sizes)
    counters = profiler.snapshot()["counters"]
    profiler.reset()
    assert gnk.group_norm_relu.launches == before + 50
    assert counters["gn.calls"] == counters["gn.fused"] == 50
    monkeypatch.setattr(gnk, "group_norm_relu", gnk.group_norm_relu_plain)
    want = det.forward_inference(images, sizes)
    assert int(want["valid"].sum()) > 0
    _assert_same_sets(got, want, margin=0.01)
