"""The port's VGG16 with BN (``MODEL.BACKBONE.VGG_W_BN``;
``scan_tpu_torch/modeling/backbone/vgg.py`` with ``with_bn``,
``layers.ChannelGroupNorm``) against ``scan_tpu``'s, on the CPU.

VGG width / 8, 64x96 inputs, the parameters drawn with numpy in
``scan_tpu``'s tree (``test_torch_mobile_backbones.seeded_tree``: kernels
N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1)).

* float32, through each package's ``build_backbone`` at
  ``VGG_STAGE_BLOCKS`` (2, 2, 3, 3, 3) and (1, 1, 1, 1, 1): C1 within rtol
  1e-4 and atol 1e-5 of its largest value, every C level and P level
  within 1e-4 of its largest value (per-channel norms over the few pixels
  of the deep levels; see ``test_torch_mobile_backbones.py``).
* bf16 against ``scan_tpu``'s jitted forward, over float32 masters and with
  bf16 parameters: every level within twice ``scan_tpu``'s own
  bf16-to-float32 distance (the norms return bf16 here: flax's
  ``dtype=self.dtype``).
* The freeze: stages 1-2 of VGG16, norms included (``conv0..conv3``,
  ``bn0..bn3``; the same four at one conv a stage, as ``scan_tpu``'s
  solver counts them), have ``requires_grad`` False and get no gradient;
  every later parameter gets one.
* K2 is not on this body's path: a counter on ``vgg.fused_stem`` reads 0
  after a VGG-BN forward and 1 after the plain VGG's.
* int8 (``quant``), at ``scan_tpu``'s calibrated scales, jitted: each
  conv and each norm fed ``scan_tpu``'s own input for it (its
  intermediates, ``capture_intermediates``): every int8 conv output and
  every norm output within 1e-5 of its largest value (the epilogue's
  float32 steps round in another order; measured up to 1.5e-6). The whole
  int8 forward is held to ``scan_tpu``'s at C1 only (within 1e-5 of its
  largest value): the norms' float32 reductions run in another order, a
  last-bit difference moves a value across the next conv's int8 rounding
  step, and the next norm spreads it over its channel (measured on the
  C2F detector at 64x96: C1 within 3e-6 of ``scan_tpu``'s, C5 0.32 of 3.3
  apart); C2..C5 are checked finite and of ``scan_tpu``'s shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.backbone.build import build_backbone as jax_build_backbone
from scan_tpu.modeling.backbone.vgg import VGG16 as JaxVGG16
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.backbone import vgg as tvgg
from scan_tpu_torch.modeling.backbone.build import build_backbone
from scan_tpu_torch.modeling.layers import ChannelGroupNorm, Conv, read_scales
from scan_tpu_torch.utils.jax_weights import convert_params

from test_torch_mobile_backbones import seeded_tree
from test_torch_train_step import C2F

H, W = 64, 96
BLOCKS = [(2, 2, 3, 3, 3), (1, 1, 1, 1, 1)]


def bn_cfg(cfg, blocks=(2, 2, 3, 3, 3), with_bn=True):
    cfg.merge_from_file(C2F)
    cfg.MODEL.BACKBONE.VGG_W_BN = with_bn
    cfg.TPU.VGG_WIDTH_DIV = 8
    cfg.TPU.VGG_STAGE_BLOCKS = list(blocks)
    return cfg


def _input(b=2):
    rng = np.random.RandomState(1)
    return (rng.randn(b, H, W, 3) * 40).astype(np.float32)


def _params(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return seeded_tree(shapes, np.random.RandomState(seed))


def port_backbone(params, blocks=(2, 2, 3, 3, 3)):
    bb = build_backbone(bn_cfg(get_default_cfg(), blocks))
    sd = {k[len("backbone."):]: v
          for k, v in convert_params({"backbone": params}).items()}
    bb.load_state_dict(sd, strict=True)
    return bb.eval()


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max() / scale)


@pytest.mark.parametrize("blocks", BLOCKS, ids=["vgg16", "one_per_stage"])
def test_vgg_bn_matches_float32(blocks):
    x = _input()
    jbb = jax_build_backbone(bn_cfg(jax_default_cfg(), blocks))
    assert jbb.body_kwargs["with_bn"]
    params = _params(jbb, jnp.asarray(x), seed=3)
    want = jax.device_get(jax.jit(jbb.apply)(params, jnp.asarray(x)))
    jbody = JaxVGG16(with_bn=True, width_div=8, stage_blocks=blocks)
    want_body = jax.device_get(jax.jit(jbody.apply)(
        {"params": params["params"]["body"]}, jnp.asarray(x)))
    bb = port_backbone(params, blocks)
    assert not bb.body.stem and bb.body.with_bn
    assert isinstance(bb.body.bn0, ChannelGroupNorm)
    with torch.no_grad():
        body = bb.body(torch.from_numpy(x))
        got = bb.fpn(body)
    for name, gs, ws in (("C", body, want_body), ("P", got, want)):
        assert len(gs) == len(ws)
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == w.shape and g.dtype == torch.float32
            scale = np.abs(w).max()
            assert _rel(g, w, scale) <= 1e-4, (name, i, _rel(g, w, scale))
    np.testing.assert_allclose(body[0].numpy(), want_body[0], rtol=1e-4,
                               atol=1e-5 * np.abs(want_body[0]).max())


def test_vgg_bn_bf16_against_jitted_scan_tpu():
    x = _input()
    jbody = JaxVGG16(with_bn=True, width_div=8)
    params = _params(jbody, jnp.asarray(x), seed=5)
    f32 = jax.device_get(jax.jit(jbody.apply)(params, jnp.asarray(x)))
    jit = jax.device_get(jax.jit(jbody.clone(dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(x)))
    for kind in ("masters", "eval"):
        body = tvgg.VGG16(width_div=8, with_bn=True)
        body.load_state_dict({k[len("b."):]: v for k, v in convert_params(
            {"b": params}).items()}, strict=True)
        for m in body.modules():
            if isinstance(m, (Conv, ChannelGroupNorm)):
                m.compute_dtype = torch.bfloat16
                if kind == "eval":
                    m.to(torch.bfloat16)
        with torch.no_grad():
            got = body(torch.from_numpy(x))
        for i, (g, w) in enumerate(zip(got, jit)):
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            scale = np.abs(f32[i]).max()
            own = _rel(w, f32[i], scale)
            assert own > 1e-3, "the bf16-float32 distance is what the test reads"
            assert _rel(g.float(), w, scale) <= 2 * own, (kind, i)


@pytest.mark.parametrize("blocks", BLOCKS, ids=["vgg16", "one_per_stage"])
def test_vgg_bn_freezes_stages_1_2_with_their_norms(blocks):
    """``scan_tpu``'s solver freezes the first ``sum(VGG16_STAGE_BLOCKS[:2])``
    = 4 convs and norms by name, whatever ``VGG_STAGE_BLOCKS`` is
    (``solver/build.py:68-71``), as the port's plain VGG freezes its convs."""
    bb = build_backbone(bn_cfg(get_default_cfg(), blocks))
    n = tvgg.N_FROZEN_CONVS
    frozen = {k for k, p in bb.body.named_parameters() if not p.requires_grad}
    assert frozen == {f"{m}{i}.{t}" for i in range(n) for m in ("conv", "bn")
                      for t in ("weight", "bias")}
    out = bb(torch.from_numpy(_input(1)))
    sum(o.square().mean() for o in out).backward()
    for k, p in bb.body.named_parameters():
        assert (p.grad is None) == (k in frozen), k


def test_k2_is_not_on_the_vgg_bn_path(monkeypatch):
    calls = []
    real = tvgg.fused_stem

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tvgg, "fused_stem", counted)
    x = torch.from_numpy(_input(1))
    with torch.no_grad():
        build_backbone(bn_cfg(get_default_cfg()))(x)
        assert len(calls) == 0
        build_backbone(bn_cfg(get_default_cfg(), with_bn=False))(x)
        assert len(calls) == 1


@pytest.fixture(scope="module")
def int8_reference():
    """``scan_tpu``'s int8 VGG-BN body calibrated on a seeded batch, and its
    op-by-op forward with every conv's and norm's output captured."""
    x = _input()
    jbody = JaxVGG16(with_bn=True, width_div=8, quant=True)
    params = _params(JaxVGG16(with_bn=True, width_div=8), jnp.asarray(x), 7)
    _, ups = jax.jit(lambda v, x: jbody.apply(v, x, mutable=["act_scales"]))(
        params, jnp.asarray(x))
    tree = {"params": params["params"], "act_scales": ups["act_scales"]}
    out, state = jax.jit(lambda v, x: jbody.apply(
        v, x, capture_intermediates=True, mutable=["intermediates"]))(
        tree, jnp.asarray(x))
    inter = jax.device_get(state["intermediates"])
    return x, jax.device_get(tree), jax.device_get(out), inter


def test_int8_vgg_bn_layers_match_scan_tpu(int8_reference):
    x, tree, want, inter = int8_reference
    assert sorted(tree["act_scales"]) == sorted(
        f"conv{i}" for i in range(13)), "every conv keeps its own scale"
    body = tvgg.VGG16(width_div=8, quant=True, with_bn=True)
    sd = {k[len("b."):]: v for k, v in
          convert_params({"b": tree}).items()}
    body.load_state_dict(sd, strict=True)
    read_scales(body)
    assert not body.stem
    for m in body.modules():
        if getattr(m, "quant", False):
            m.dtype = torch.float32

    def cap(name):
        return np.asarray(inter[name]["__call__"][0], np.float32)

    idx, h = 0, torch.from_numpy(x)
    with torch.no_grad():
        for blocks in tvgg.VGG16_STAGE_BLOCKS:
            for _ in range(blocks):
                y = getattr(body, f"conv{idx}")(h)
                w = cap(f"conv{idx}")
                assert _rel(y, w, np.abs(w).max()) <= 1e-5, idx
                z = getattr(body, f"bn{idx}")(torch.from_numpy(w))
                wz = cap(f"bn{idx}")
                assert _rel(z, wz, np.abs(wz).max()) <= 1e-5, idx
                h = torch.relu(torch.from_numpy(wz))
                idx += 1
            h = tvgg.to_nhwc(torch.nn.functional.max_pool2d(
                tvgg.to_nchw(h), 2, 2))
        got = body(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=1e-5 * np.abs(want[0]).max())
