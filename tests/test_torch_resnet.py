"""The port's ResNet body (``scan_tpu_torch/modeling/backbone/resnet.py``,
``layers.FrozenBatchNorm``) and its FPN against ``scan_tpu``'s, on the CPU.

The EPM R-101 config at narrow widths (RES2_OUT_CHANNELS 32,
STEM_OUT_CHANNELS 16, BACKBONE_OUT_CHANNELS 32), a 64x96 input;
``scan_tpu``'s parameters carried across by ``utils/jax_weights.py``, with
the conv kernels redrawn at He scale and every FrozenBatchNorm given seeded
statistics, so the features are far from 0 and each BN's arithmetic shows.
Only the first test runs a depth-101 body; the rest run depth 50.

* float32, R-50 and R-101: C2..C5 and P3..P7 within rtol 1e-4 and atol
  1e-5 of each level's largest value (the residual sums grow the features
  to ~1e3 here, so an absolute 1e-5 would ask for more than float32 gives).
* bf16, against ``scan_tpu``'s jitted forward (what its users run) and its
  op-by-op one. Jitted, XLA keeps every ResNet conv's float32 sum (each
  feeds a FrozenBatchNorm, which promotes to float32); op by op it rounds
  it to bf16, and the two lie ~2% of the largest feature apart. A detector
  that trains (float32 masters) computes those convs with float32 results
  (``float_output``): its C2..C5 lie within 1e-6 of the jitted ones and its
  P3..P7 within half of ``scan_tpu``'s own jit-to-op distance (measured
  1.7e-7, and 0.17-0.29 of it). A detector for evaluation only (bf16
  parameters) rounds, as the op-by-op run does: its C2 equals that run's
  within 1e-6, and every level lies within 1.5x ``scan_tpu``'s own
  distance from the jitted run (measured up to 1.07x, at P3).
* Gradients of a weighted sum of P3..P7 with respect to every trainable
  parameter against ``jax.grad``, at FREEZE_CONV_BODY_AT 2 and 0, within
  rtol 1e-4 and 1e-4 of each tensor's largest gradient; the frozen convs
  have ``requires_grad`` False (``jax.grad`` gives them 0), and
  FrozenBatchNorm holds buffers.
* ``set_compute_dtype``: an eval detector's convs are bf16, its
  FrozenBatchNorms stay float32; a training detector keeps float32.
* The int8 detector with an R-50 body at ``scan_tpu``'s calibrated scales:
  the ResNet body stays fp, the FPN and head run int8. On ``scan_tpu``'s own
  body features (jitted), the port's int8 FPN, head and postprocess give
  ``tests/test_torch_detector_int8.py``'s agreement: ``valid`` and labels
  equal, boxes within 1e-3 px, scores within rtol 1e-4 (measured 1.2e-4 px
  and 3e-7). With the port's own float32 body only ``valid`` is held equal:
  the body's float32 sums in another order put a few FPN inputs on the
  other side of an int8 step, which the int8 towers carry on (measured: one
  image within 5e-5 px, the other with 23 of its 100 detections moved by
  more than 1e-2 px, the same against ``scan_tpu``'s op-by-op forward).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.backbone.build import build_backbone as jax_build_backbone
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.backbone.build import build_backbone
from scan_tpu_torch.modeling.backbone.resnet import ResNet
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.modeling.layers import Conv, FrozenBatchNorm
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

R101 = os.path.join(os.path.dirname(__file__), "..", "configs", "epm",
                    "da_ga_ca_cityscapes_R_101_FPN_4x.yaml")
H, W = 64, 96


def narrow_cfg(cfg, depth=50, dtype="float32", freeze_at=2):
    cfg.merge_from_file(R101)
    cfg.MODEL.BACKBONE.CONV_BODY = f"R-{depth}-FPN-RETINANET"
    cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = freeze_at
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 32
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def he_scaled(tree, rng):
    """Conv kernels redrawn at He scale, FrozenBN statistics seeded."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = he_scaled(v, rng)
            continue
        v = np.asarray(v)
        if k == "kernel":
            fan_in = np.prod(v.shape[:-1])
            v = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
        elif k == "weight":
            v = 1 + 0.2 * rng.randn(*v.shape)
        elif k in ("bias", "running_mean"):
            v = 0.1 * rng.randn(*v.shape)
        elif k == "running_var":
            v = 0.5 + rng.rand(*v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _input():
    return np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)


def jax_backbone(depth=50, dtype="float32", freeze_at=2):
    jbb = jax_build_backbone(narrow_cfg(jax_default_cfg(), depth, "float32",
                                        freeze_at))
    return jbb.clone(dtype=jnp.bfloat16) if dtype == "bfloat16" else jbb


@pytest.fixture(scope="module")
def r50_params():
    params = jax.jit(jax_backbone().init)(jax.random.PRNGKey(2),
                                          jnp.asarray(_input()))
    return he_scaled(jax.device_get(params), np.random.RandomState(3))


def port_backbone(params, depth=50, freeze_at=2):
    bb = build_backbone(narrow_cfg(get_default_cfg(), depth,
                                   freeze_at=freeze_at))
    sd = {k[len("backbone."):]: v
          for k, v in convert_params({"backbone": params}).items()}
    bb.load_state_dict(sd, strict=True)
    return bb.eval()


def _body(jbb, params, x, jit=True):
    body = jbb.body_cls(**jbb.body_kwargs, dtype=jbb.dtype)
    fn = body.apply if not jit else jax.jit(body.apply)
    return jax.device_get(fn({"params": params["params"]["body"]},
                             jnp.asarray(x)))


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max() / scale)


@pytest.mark.parametrize("depth", [50, 101])
def test_body_and_fpn_match_float32(depth, r50_params):
    x = _input()
    jbb = jax_backbone(depth)
    params = r50_params if depth == 50 else he_scaled(jax.device_get(
        jbb.init(jax.random.PRNGKey(2), jnp.asarray(x))),
        np.random.RandomState(3))
    want = jax.device_get(jbb.apply(params, jnp.asarray(x)))
    want_body = _body(jbb, params, x, jit=False)
    bb = port_backbone(params, depth)
    assert isinstance(bb.body, ResNet)
    assert len(bb.body.stage_blocks) == 4 and sum(bb.body.stage_blocks) == (
        33 if depth == 101 else 16)
    with torch.no_grad():
        got_body = bb.body(torch.from_numpy(x))
        got = bb.fpn(got_body)
    for name, gs, ws in (("C", got_body, want_body), ("P", got, want)):
        assert len(gs) == len(ws)
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name}{i + 2 + (name == 'P')}")
    assert np.abs(want_body[-1]).max() > 1.0  # far from 0


def test_bf16_forward_against_jitted_scan_tpu(r50_params):
    x = _input()
    jbb = jax_backbone(dtype="bfloat16")
    jit = jax.device_get(jax.jit(jbb.apply)(r50_params, jnp.asarray(x)))
    with jax.disable_jit():
        op = jax.device_get(jbb.apply(r50_params, jnp.asarray(x)))
    jit_body = _body(jbb, r50_params, x)
    op_body = _body(jbb, r50_params, x, jit=False)
    assert jit_body[0].dtype == np.float32  # FrozenBN promotes

    results = {}
    for kind in ("masters", "eval"):
        bb = port_backbone(r50_params)
        for m in bb.modules():
            if isinstance(m, Conv):
                m.compute_dtype = torch.bfloat16
                if kind == "eval":
                    m.to(torch.bfloat16)
        with torch.no_grad():
            body = bb.body(torch.from_numpy(x))
            results[kind] = (body, bb.fpn(body))
    for i in range(4):  # C2..C5
        scale = np.abs(op_body[i]).max()
        own = _rel(op_body[i], jit_body[i], scale)
        masters = _rel(results["masters"][0][i].float(), jit_body[i], scale)
        ev = _rel(results["eval"][0][i].float(), jit_body[i], scale)
        assert own > 5e-3, "the jit-to-op distance is what the test reads"
        assert masters <= 1e-6, (i, masters, own)
        assert ev <= 1.5 * own, (i, ev, own)
    np.testing.assert_allclose(results["eval"][0][0].float().numpy(),
                               op_body[0], rtol=0,
                               atol=1e-6 * np.abs(op_body[0]).max())
    for i in range(5):  # P3..P7
        scale = np.abs(np.asarray(op[i], np.float32)).max()
        own = _rel(op[i], jit[i], scale)
        masters = _rel(results["masters"][1][i].float(), jit[i], scale)
        ev = _rel(results["eval"][1][i].float(), jit[i], scale)
        assert masters <= 0.5 * own, (i, masters, own)
        assert ev <= 1.5 * own, (i, ev, own)


@pytest.mark.parametrize("freeze_at", [2, 0])
def test_gradients_match_jax_grad(freeze_at, r50_params):
    x = _input()
    jbb = jax_backbone(freeze_at=freeze_at)
    shapes = [w.shape for w in jax.device_get(
        jbb.apply(r50_params, jnp.asarray(x)))]
    rng = np.random.RandomState(4)
    weights = [rng.randn(*s).astype(np.float32) for s in shapes]

    def loss(p):
        return sum(jnp.sum(o * w) for o, w in
                   zip(jbb.apply(p, jnp.asarray(x)), weights))

    grads = convert_params({"backbone": jax.device_get(
        jax.grad(loss)(r50_params))})
    bb = port_backbone(r50_params, freeze_at=freeze_at)
    out = bb(torch.from_numpy(x))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, weights)).backward()
    params = dict(bb.named_parameters())
    buffers = {k for k, _ in bb.named_buffers()}
    n_trained = 0
    for key, want in grads.items():
        name = key[len("backbone."):]
        want = want.numpy()
        if name in buffers:  # FrozenBatchNorm
            assert "bn" in name.rsplit(".", 2)[-2], name
            assert not np.abs(want).any(), name
            continue
        p = params[name]
        frozen = name.startswith("body.stem_") and freeze_at >= 1 or (
            name.startswith("body.layer") and freeze_at >= int(name[10]) + 1)
        assert p.requires_grad != frozen, name
        if frozen:
            assert p.grad is None and not np.abs(want).any(), name
            continue
        n_trained += 1
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    assert n_trained == len([p for p in params.values() if p.requires_grad])
    assert any(k.startswith("body.stem_conv1") for k, p in params.items()
               if p.requires_grad) == (freeze_at == 0)


def test_set_compute_dtype_keeps_frozen_bn_float32():
    cfg = narrow_cfg(get_default_cfg(), dtype="bfloat16")
    for train in (False, True):
        det = build_detector(cfg, device="cpu", train=train)
        bns = [m for m in det.modules() if isinstance(m, FrozenBatchNorm)]
        assert len(bns) == 1 + 16 * 3 + 4  # stem, 3 a block, 4 downsamples
        assert all(b.dtype == torch.float32 for m in bns for b in m.buffers())
        convs = {p.dtype for m in det.backbone.body.modules()
                 if isinstance(m, Conv) for p in m.parameters()}
        assert convs == {torch.float32 if train else torch.bfloat16}
        images = torch.randint(0, 256, (1, H, W, 3), dtype=torch.uint8)
        with torch.no_grad():
            feats = det.backbone.body(det._prep_images(images))
        assert all(f.dtype == torch.float32 for f in feats)
        assert not any(k.startswith("backbone.body") for k, p in
                       det.named_parameters() if "bn" in k.rsplit(".", 2)[-2])


def int8_cfg(cfg):
    narrow_cfg(cfg)
    cfg.MODEL.DA_ON = False
    cfg.MODEL.FCOS.NUM_CONVS = 1
    cfg.MODEL.FCOS.NUM_CONVS_REG = 1
    cfg.MODEL.FCOS.NUM_CONVS_CLS = 1
    cfg.TPU.INT8_INFERENCE = True
    return cfg


def test_int8_r50_detector_matches_scan_tpu(r50_params):
    jdet = jax_build_detector(int8_cfg(jax_default_cfg()))
    params, _ = jdet.init_params(jax.random.PRNGKey(0),
                                 jnp.zeros((1, H, W, 3), jnp.float32))
    params = jax.device_get(params)
    params["backbone"] = r50_params
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 5.0, 0.0), ("bbox_pred", 5.0, 3.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    images = np.random.RandomState(0).randint(0, 256, (2, H, W, 3)).astype(
        np.uint8)
    sizes = np.asarray([[H, W], [56, 80]], np.int32)
    calibrated = jax.device_get(jdet.calibrate_int8(params, None,
                                                    [jnp.asarray(images)]))
    want = jax.device_get(jax.jit(jdet.forward_inference)(
        calibrated, None, jnp.asarray(images), jnp.asarray(sizes)))
    tdet = build_detector(int8_cfg(get_default_cfg()), device="cpu")
    load_jax_params(tdet, calibrated)
    body_convs = [m for m in tdet.backbone.body.modules() if isinstance(m, Conv)]
    assert body_convs and not any(m.quant for m in body_convs)
    assert all(m.quant for m in tdet.backbone.fpn.modules()
               if isinstance(m, Conv))
    assert all(m.calibrated for m in tdet.backbone.fpn.modules()
               if isinstance(m, Conv))
    # the int8 FPN, head and postprocess on scan_tpu's own body features
    jbody = jdet.backbone.body_cls(**jdet.backbone.body_kwargs)
    feats = jax.device_get(jax.jit(jbody.apply)(
        {"params": calibrated["backbone"]["params"]["body"]},
        jdet._prep_images(jnp.asarray(images))))
    own_body = tdet.backbone.body.forward
    tdet.backbone.body.forward = lambda x: tuple(
        torch.from_numpy(np.array(f)) for f in feats)
    got = {k: v.numpy() for k, v in tdet.forward_inference(
        torch.from_numpy(images), torch.from_numpy(sizes)).items()}
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.sum() > 20, "the test needs detections to compare"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-4,
                               atol=1e-6)
    # the whole port: its float32 body sums in another order, and a value
    # within rounding of an int8 step of the FPN's input flips a step
    tdet.backbone.body.forward = own_body
    whole = tdet.forward_inference(torch.from_numpy(images),
                                   torch.from_numpy(sizes))
    np.testing.assert_array_equal(whole["valid"].numpy(), v)
