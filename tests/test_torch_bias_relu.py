"""The VGG body's bias + ReLU (+ 2x2 max-pool) kernel
(``ops/cuda/bias_relu_kernel.py``, ``csrc/bias_relu.cu``) and the gate that
picks it in ``VGG16.forward``.

On the CPU: the plain version against the module ops (``relu(y + b)``, then
``F.max_pool2d``) and against ``scan_tpu``'s own conv bias, ReLU and pool on
the same bf16 conv outputs; the wrapper's refusals that need no card; the
gate's decision on each condition (an input that reports itself on the card
stands in for a CUDA tensor); ``VGG16.forward`` bitwise today's wherever the
gate says no; the fused wiring (the conv without its bias, the bias, the
pool at each stage's last conv) through the plain version; and the
counters ``vgg.convs`` / ``vgg.fused``.

On the card (marked ``gpu``, skipped without one; only the ``scan_tpu``
test imports JAX, inside itself): the kernel equal
(``torch.equal``) to the module path (cuDNN's conv, PyTorch's bias add,
``F.relu``, ``F.max_pool2d``) at each stage's shape of the C2F eval at
672x1344, batch 1 and 8, bf16 and float32; odd sizes in the pool mode and
NaNs, which propagate as the modules propagate them; the refusals; a
training forward, which takes the kernel at the frozen stage 2 only; and
one full-width bf16 eval forward whose detections equal the module path's.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scan_tpu_torch.modeling import layers
from scan_tpu_torch.modeling.backbone import vgg as vgg_mod
from scan_tpu_torch.modeling.backbone.vgg import VGG16, fuses_bias_relu
from scan_tpu_torch.modeling.layers import ChannelGroupNorm, Conv
from scan_tpu_torch.ops.cuda import bias_relu_kernel as brk
from scan_tpu_torch.ops.quant import QuantizedActivation
from scan_tpu_torch.utils import profiler

# stages 2-5 of the C2F eval at 672x1344: (H, W, C) of each conv's output,
# and the channels entering the stage
STAGES = [(336, 672, 128, 64), (168, 336, 256, 128), (84, 168, 512, 256),
          (42, 84, 512, 512)]
SHAPES = [(2, 6, 8, 16), (1, 7, 9, 24)]  # even, and odd H and W


def _conv_like(shape, dtype, seed):
    """A conv-like NHWC output with per-channel offsets (so the bias and
    the ReLU both matter) and the bias, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    y = torch.randn(*shape, generator=g) * (0.5 + torch.rand(c, generator=g))
    y = y + 0.5 * torch.randn(c, generator=g)
    bias = torch.randn(c, generator=g) * 0.5
    return y.to(dtype), bias.to(dtype)


def _modules(y, bias, pool):
    """The module path after the conv: the bias add, ``F.relu``, and
    ``F.max_pool2d`` on the NCHW view."""
    x = F.relu(y + bias)
    if pool:
        x = layers.to_nhwc(F.max_pool2d(layers.to_nchw(x), 2, 2))
    return x


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_module_ops(dtype, pool, shape):
    """The plain version is the module ops, bitwise, NaNs included; the
    pool floors odd sizes."""
    y, bias = _conv_like(shape, dtype, 0)
    y[0, 1, 2, 3] = float("nan")
    got = brk.bias_relu_plain(y, bias, pool)
    b, h, w, c = shape
    assert got.is_contiguous() and got.dtype == dtype
    assert got.shape == ((b, h // 2, w // 2, c) if pool else shape)
    torch.testing.assert_close(got, _modules(y, bias, pool), rtol=0, atol=0,
                               equal_nan=True)
    assert bool(got.isnan().any()) and bool((got == 0).any())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_scan_tpus_vgg_stage(dtype, pool, shape):
    """On the same conv outputs, the plain version equals ``scan_tpu``'s
    VGG stage tail: its ``Conv`` adding the bias (here a 1x1 identity
    kernel, which returns the conv output as it is), ``nn.relu`` and, at a
    stage's end, ``nn.max_pool`` 2x2/2 (VALID: odd sizes floored)."""
    # JAX here only: the card's tests of this file run without it
    import jax.numpy as jnp
    from flax import linen as nn

    from scan_tpu.modeling.layers import Conv as JaxConv

    y, bias = _conv_like(shape, dtype, 1)
    c = shape[-1]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def as_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jdt)

    params = {"params": {"Conv_0": {
        "kernel": jnp.eye(c, dtype=jdt)[None, None], "bias": as_jax(bias)}}}
    x = nn.relu(JaxConv(c, kernel_size=1, dtype=jdt).apply(params, as_jax(y)))
    if pool:
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
    want = torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
    got = brk.bias_relu_plain(y, bias, pool)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["cpu", "autograd"])
def test_wrapper_refuses_without_a_card(case):
    y, bias = _conv_like((1, 4, 6, 16), torch.float32, 2)
    if case == "cpu":
        with pytest.raises(ValueError, match="unsupported device"):
            brk.bias_relu(y, bias)
    else:
        bias.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            brk.bias_relu(y, bias, pool=True)


@pytest.mark.parametrize("shape, dtype, pool, want", [
    ((8, 336, 672, 128), torch.bfloat16, False, True),
    ((8, 42, 84, 512), torch.float32, True, True),
    ((1, 7, 9, 8), torch.bfloat16, True, True),  # odd sizes pool floored
    ((1, 6, 8, 12), torch.bfloat16, False, False),  # 12 bf16: 1.5 loads
    ((1, 6, 8, 4096), torch.bfloat16, False, False),  # 512 loads a pixel
    ((1, 6, 8, 16), torch.float16, False, False),
    ((1, 1, 8, 16), torch.float32, True, False),  # nothing to pool
    ((1, 1, 8, 16), torch.float32, False, True),
    ((1 << 14, 512, 256, 8), torch.bfloat16, False, False),  # 2^31 pixels
])
def test_supports_states_the_wrappers_shape_rules(shape, dtype, pool, want):
    assert brk.supports(shape, dtype, pool) is want


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: the gate's device
    condition without a card."""

    @property
    def is_cuda(self):
        return True


GATE_YES = ("card", "card_bf16", "card_float32_masters", "card_pool",
            "card_frozen_under_grad")


@pytest.mark.parametrize("case", [
    *GATE_YES, "cpu", "card_under_grad", "card_input_requires_grad",
    "card_bias_requires_grad", "card_quant", "card_with_bn", "card_no_bias",
    "card_float16", "card_width_12", "card_pool_one_row",
    "card_quantized_input"])
def test_gate_decides_from_what_it_sees(case):
    dtype = {"card_bf16": torch.bfloat16, "card_width_12": torch.bfloat16,
             "card_float16": torch.float16}.get(case, torch.float32)
    conv = Conv(16, 12 if case == "card_width_12" else 32, 3,
                kernel_init="vgg", quant=case == "card_quant",
                bias=case != "card_no_bias")
    layers.init_parameters(conv, torch.Generator().manual_seed(3))
    if case != "card_quant":
        conv.compute_dtype = dtype
        if case != "card_float32_masters":
            conv.to(dtype)
        else:
            conv.compute_dtype = torch.bfloat16
    h = 1 if case == "card_pool_one_row" else 6
    x = torch.randn(1, h, 8, 16, dtype=dtype)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "card_quantized_input":
        x = QuantizedActivation(torch.zeros(1, 6, 8, 16, dtype=torch.int8),
                                torch.tensor(0.1))
    frozen = ("card_frozen_under_grad", "card_input_requires_grad",
              "card_bias_requires_grad")
    if case in frozen:
        conv.requires_grad_(False)
    if case == "card_input_requires_grad":
        x.requires_grad_(True)
    if case == "card_bias_requires_grad":
        conv.bias.requires_grad_(True)
    grad = case in ("card_under_grad", *frozen)
    with torch.set_grad_enabled(grad):
        got = fuses_bias_relu(x, conv, case == "card_with_bn",
                              case in ("card_pool", "card_pool_one_row"))
    assert got is (case in GATE_YES)


def _vgg(width_div=8, quant=False, with_bn=False, seed=4):
    body = VGG16(width_div=width_div, quant=quant, with_bn=with_bn)
    layers.init_parameters(body, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in body.modules():
            if isinstance(m, Conv):  # biases that move the ReLU's cut
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, ChannelGroupNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
    return body


def _todays_forward(body, x):
    """``VGG16.forward`` as it was: each module in turn after stage 1."""
    outs, idx = [], 0
    for stage, blocks in enumerate(body.stage_blocks):
        if stage == 0 and body.stem:
            x = body._stage1_int8(x) if body.quant else body._stage1_fp(x)
            idx += 2
        else:
            for _ in range(blocks):
                x = getattr(body, f"conv{idx}")(x)
                if body.with_bn:
                    x = getattr(body, f"bn{idx}")(x)
                x = F.relu(x)
                idx += 1
            x = layers.to_nhwc(F.max_pool2d(layers.to_nchw(x), 2, 2))
        if isinstance(x, QuantizedActivation):
            outs.append(x.dequantize(body.dtype or torch.float32))
        else:
            outs.append(x)
    return tuple(outs)


@pytest.mark.parametrize("case", ["cpu", "cpu_bf16", "under_grad", "quant",
                                  "with_bn"])
def test_forward_is_todays_bitwise_where_the_gate_says_no(case, monkeypatch):
    """Where the gate says no, the kernel's wrapper is never called and the
    body computes exactly what it computed before the fused path."""
    def refuse(*a, **k):
        raise AssertionError("the fused kernel ran")

    monkeypatch.setattr(brk, "bias_relu", refuse)
    body = _vgg(quant=case == "quant", with_bn=case == "with_bn")
    if case == "cpu_bf16":
        for m in body.modules():
            if isinstance(m, Conv):
                m.compute_dtype = torch.bfloat16
        body.compute_dtype = torch.bfloat16
        body.to(torch.bfloat16)
    x = torch.randn(2, 34, 50, 3, generator=torch.Generator().manual_seed(6))
    with torch.set_grad_enabled(case == "under_grad"):
        got = body(x)
        want = _todays_forward(body, x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "under_grad":
        got[-1].float().sum().backward()
        assert body.conv12.weight.grad is not None
        assert body.conv2.weight.grad is None  # frozen stage 2


@pytest.mark.parametrize("hw", [(32, 48), (38, 54)])  # stage 5 odd at 38x54
def test_fused_wiring_through_the_plain_version(hw, monkeypatch):
    """With the gate forced and the plain version standing in for the
    kernel, the body computes what its modules compute (float32), so the
    conv runs without its bias, the bias reaches the kernel, and each
    stage's last conv takes the pool and the body pools nothing more."""
    calls = []

    def plain(y, bias, pool):
        calls.append((y.shape[1:], pool))
        assert y.is_contiguous() and bias.shape == (y.shape[3],)
        return brk.bias_relu_plain(y, bias, pool)

    body = _vgg()
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = _todays_forward(body, x)
        monkeypatch.setattr(vgg_mod, "fuses_bias_relu", lambda *a: True)
        monkeypatch.setattr(brk, "bias_relu", plain)
        got = body(x)
    assert [p for _, p in calls] == [False, True, False, False, True] + [
        False, False, True] * 2
    assert len(calls) == 11
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["cpu", "fused", "quant", "with_bn"])
def test_vgg_counters(case, monkeypatch):
    """``vgg.convs`` counts the fp convs outside K2 (11 in the VGG16 body,
    all 13 in VGG16-BN, which has no K2) and ``vgg.fused`` those that took
    the kernel: none on the CPU, all with the gate and the kernel stood in
    for; the int8 body counts nothing."""
    body = _vgg(quant=case == "quant", with_bn=case == "with_bn")
    if case == "fused":
        monkeypatch.setattr(vgg_mod, "fuses_bias_relu", lambda *a: True)
        monkeypatch.setattr(brk, "bias_relu", brk.bias_relu_plain)
    x = torch.randn(1, 32, 48, 3)
    profiler.reset()
    with torch.no_grad():
        body(x)
        assert profiler.snapshot()["counters"] == {}  # nothing records now
        with profiler.recording():
            body(x)
    counters = profiler.snapshot()["counters"]
    profiler.reset()
    want = {"cpu": {"vgg.convs": 11}, "fused": {"vgg.convs": 11,
                                                 "vgg.fused": 11},
            "quant": {}, "with_bn": {"vgg.convs": 13}}[case]
    assert counters == want


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_operands(b, h, w, c, cin, dtype, device, seed):
    """A channels_last NCHW input and a He-scaled 3x3 conv with a bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=g).to(device, dtype)
    wt = (torch.randn(c, cin, 3, 3, generator=g)
          * (2.0 / (9 * cin)) ** 0.5).to(device, dtype)
    bias = (0.3 * torch.randn(c, generator=g)).to(device, dtype)
    return layers.to_nchw(x), wt, bias


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("stage", STAGES, ids=["stage2", "stage3", "stage4",
                                               "stage5"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_the_module_path(cuda_device, dtype, stage, b, pool):
    """The unbiased cuDNN conv then the kernel equals the conv with its
    bias, ``F.relu`` and ``F.max_pool2d``, bitwise (``torch.equal``: the
    sign of a zero aside)."""
    h, w, c, cin = stage
    x, wt, bias = _conv_operands(b, h, w, c, cin, dtype, cuda_device,
                                 seed=h + b + c)
    want = F.relu(F.conv2d(x, wt, bias, padding=1))
    if pool:
        want = F.max_pool2d(want, 2, 2)
    want = layers.to_nhwc(want)
    y = layers.to_nhwc(F.conv2d(x, wt, None, padding=1))
    assert y.is_contiguous()
    before = brk.bias_relu.launches
    got = brk.bias_relu(y, bias, pool)
    torch.cuda.synchronize()
    assert brk.bias_relu.launches == before + 1
    assert (got is y) is not pool
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    assert 0 < int((got == 0).sum()) < got.numel()  # the ReLU clips some


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 7, 9, 64), (2, 13, 6, 128),
                                   (3, 5, 11, 8)])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_odd_sizes_and_nans(cuda_device, dtype, pool, shape):
    """Odd H and W (the pool floors them, as ``F.max_pool2d``), NaNs in
    the input propagating as through the modules, and a bias of -inf on a
    channel: equal to the module ops, NaNs where they have NaNs."""
    y, bias = _conv_like(shape, dtype, sum(shape))
    y = y.to(cuda_device)
    bias = bias.to(cuda_device)
    flat = y.view(-1)
    flat[:: 97] = float("nan")
    bias[1] = float("-inf")
    want = _modules(y, bias, pool)
    src = y.clone()
    got = brk.bias_relu(y, bias, pool)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(got.isnan().any())
    if pool:  # the pool mode leaves its input as it was
        torch.testing.assert_close(y, src, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_kernel_refusals(cuda_device):
    y, bias = _conv_like((2, 6, 8, 32), torch.bfloat16, 3)
    y, bias = y.to(cuda_device), bias.to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        brk.bias_relu(y.transpose(1, 2), bias)
    with pytest.raises(ValueError, match="multiple of 8"):
        brk.bias_relu(y[..., :12].contiguous(), bias[:12])
    with pytest.raises(ValueError, match="bias"):
        brk.bias_relu(y, bias.float())
    with pytest.raises(ValueError, match="bias"):
        brk.bias_relu(y, bias[:16])
    with pytest.raises(ValueError, match="2x2 pool"):
        brk.bias_relu(y[:, :1].contiguous(), bias, pool=True)
    with pytest.raises(ValueError, match="unsupported dtype"):
        brk.bias_relu(y.half(), bias.half())
    with pytest.raises(ValueError, match="unsupported device"):
        brk.bias_relu(y.cpu(), bias.cpu())
    y.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        brk.bias_relu(y, bias)
    with torch.no_grad():
        brk.bias_relu(y.detach().clone(), bias, pool=True)


@pytest.mark.gpu
def test_training_forward_fuses_the_frozen_stage_only(cuda_device,
                                                      monkeypatch):
    """A float32 full-width VGG16 forward with grad on, as a DA step runs
    it: K2 and the frozen stage 2 (conv2, conv3) take no gradient, so the
    kernel runs twice, and the outputs equal the module path's; the
    trainable stages' weights get their gradients."""
    body = _vgg(width_div=1).to(cuda_device)
    x = torch.randn(2, 128, 192, 3, device=cuda_device)
    before = brk.bias_relu.launches
    got = body(x)
    assert brk.bias_relu.launches == before + 2
    got[-1].sum().backward()
    assert body.conv4.weight.grad is not None
    monkeypatch.setattr(vgg_mod, "fuses_bias_relu", lambda *a: False)
    with torch.no_grad():
        want = body(x)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)


@pytest.mark.gpu
def test_full_width_bf16_eval_detections_equal_the_module_path(
        cuda_device, monkeypatch):
    """The C2F detector at full width in bf16, evaluation in precision mode,
    its cls bias raised so NMS has candidates: the kernel runs at all 11
    convs of stages 2-5 (counters and launches), and the detections equal
    those of the module path exactly."""
    from scan_tpu_torch.config import get_default_cfg
    from scan_tpu_torch.modeling.detector import build_detector

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
    before = brk.bias_relu.launches
    profiler.reset()
    with profiler.recording():
        got = det.forward_inference(images, sizes)
    counters = profiler.snapshot()["counters"]
    profiler.reset()
    assert brk.bias_relu.launches == before + 11
    assert counters["vgg.convs"] == counters["vgg.fused"] == 11
    monkeypatch.setattr(vgg_mod, "fuses_bias_relu", lambda *a: False)
    want = det.forward_inference(images, sizes)
    assert brk.bias_relu.launches == before + 11
    assert int(want["valid"].sum()) > 0
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
