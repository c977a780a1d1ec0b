"""The port's MobileNetV2 and FBNet bodies (``scan_tpu_torch/modeling/backbone/
mobilenet.py``, ``fbnet.py``, ``layers.ChannelNorm``, the grouped ``Conv``)
and their builders against ``scan_tpu``'s, on the CPU.

The parameters are drawn with numpy in ``scan_tpu``'s tree (from
``jax.eval_shape`` of its ``init``, so no init is compiled): kernels
N(0, 1/fan_in) as flax's lecun-normal (fan-in per group, k * k for a
depthwise conv), norm scales 1 + N(0, 0.1), biases N(0, 0.1), so the bridge
carries non-trivial scales and biases. The port takes them through
``utils/jax_weights.py``; flax's depthwise kernel (k, k, 1, C) becomes
torch's (C, 1, k, k) by the generic HWIO rule.

* float32, 1 x 128 x 192, MobileNetV2 and each FBNet arch (and ``cham_v2``
  at SCALE_FACTOR 0.5 / WIDTH_DIVISOR 8): C2 within rtol 1e-4 and atol
  1e-5 of its largest value, every endpoint within 2e-4 of its level's
  largest value.
  The deeper endpoints cannot be held closer: every conv feeds a norm over
  one channel's few pixels (C5 is 4 x 6 here), whose E[x^2] - E[x]^2 (flax's
  fast variance) cancels, so float32 rounding grows with depth. Measured
  against the port run in float64 on a 64x96 input, C5's error is 1.6e-3 of
  its largest value for ``scan_tpu``'s jitted run and 7.9e-4 for the port's
  float32 run; at 128x192 the port lies up to 1.4e-4 (``cham_v1a``'s C5)
  from the jitted run.
* bf16, MobileNetV2 and ``cham_v2`` (k3, k5 and k7 depthwise convs), against
  ``scan_tpu``'s jitted forward (what its users run): with the convs over
  float32 masters (``float_output``, a detector that trains) and with bf16
  parameters (a detector for evaluation, rounding each conv), every
  endpoint within twice ``scan_tpu``'s own bf16-to-float32 distance (the
  rule of the earlier bf16 tests). The norms return float32 in both
  packages. Measured at 128x192: over masters the port lies 0.54-0.77 of
  that distance from the jitted run at every level, rounding each conv
  1.0-1.34 of it (C2-C5 of MobileNetV2 and ``cham_v2``). So jitted
  ``scan_tpu`` keeps these convs' float32 sums, as it keeps the ResNet
  body's: the test holds the masters within 1x that distance, the rounding
  within 2x, and the masters nearer at every level (ROADMAP queue C).
* The registry: every body name of ``scan_tpu``'s ``BACKBONES`` builds, an
  unknown one raises ``KeyError``, ``MNV2-FPN-RETINANET`` is 256 wide
  whatever ``RESNETS.BACKBONE_OUT_CHANNELS`` says (as ``scan_tpu``'s), and
  the stem's norm is frozen as ``scan_tpu``'s solver freezes it.
* The C2F config on an MNV2 body (128x192, the FCOS towers cut to 1 conv,
  every parameter drawn as above): the eval forward's detections as sets
  (``test_mnv2_detector_forward_matches``) and one DA step
  (``forward_target`` False): its metrics within rtol 1e-4 of those of
  ``scan_tpu``'s step, whose ``loss_fn`` computes them before any update
  and is jitted alone (its backward, which the metrics do not read, would
  triple the compile), and the stem's norm unchanged.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.backbone import build as jax_build
from scan_tpu.modeling.backbone.fbnet import FBNetTrunk as JaxFBNet
from scan_tpu.modeling.backbone.mobilenet import MobileNetV2 as JaxMNV2
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.backbone.build import BACKBONES, build_backbone
from scan_tpu_torch.modeling.backbone.fbnet import FBNET_ARCHS, FBNetTrunk
from scan_tpu_torch.modeling.backbone.mobilenet import MobileNetV2, mobile_conv
from scan_tpu_torch.modeling.layers import ChannelNorm, Conv, clip
from scan_tpu_torch.utils.jax_weights import convert_params

H, W = 128, 192
BODIES = [("mnv2_body", None, 1.0, 1)] + [
    (arch, arch, 1.0, 1) for arch in sorted(FBNET_ARCHS)] + [
    ("cham_v2_half_div8", "cham_v2", 0.5, 8)]


def seeded_tree(shapes, rng):
    """A parameter tree of ``shapes`` filled as ``seeded_params`` fills it."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.randn(*leaf.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*leaf.shape)
        else:
            v = 0.1 * rng.randn(*leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def seeded_params(module, x, seed):
    """``module``'s parameter tree filled from numpy (see the docstring)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return seeded_tree(shapes, np.random.RandomState(seed))


def bodies(arch, scale, div):
    if arch is None:
        return JaxMNV2(), MobileNetV2()
    return (JaxFBNet(arch=arch, scale_factor=scale, width_divisor=div),
            FBNetTrunk(arch=arch, scale_factor=scale, width_divisor=div))


def port_body(body, params):
    body.load_state_dict({k[len("b."):]: v for k, v in
                          convert_params({"b": params}).items()}, strict=True)
    return body.eval()


def _input(b=1):
    return np.random.RandomState(1).randn(b, H, W, 3).astype(np.float32)


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max() / scale)


@pytest.mark.parametrize("key,arch,scale,div", BODIES,
                         ids=[b[0] for b in BODIES])
def test_body_matches_float32(key, arch, scale, div):
    x = _input()
    jbody, body = bodies(arch, scale, div)
    params = seeded_params(jbody, x, seed=len(key))
    want = jax.device_get(jax.jit(jbody.apply)(params, jnp.asarray(x)))
    body = port_body(body, params)
    if key == "mnv2_body":
        dw = body.stage1_block0.depthwise.weight
        assert tuple(dw.shape) == (96, 1, 3, 3)  # flax (3, 3, 1, 96)
        np.testing.assert_array_equal(
            dw.detach().numpy(),
            np.asarray(params["params"]["stage1_block0"]["depthwise"]
                       ["kernel"]).transpose(3, 2, 0, 1))
    with torch.no_grad():
        got = body(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    assert tuple(g.shape[-1] for g in got) == body.channels
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert g.shape[1:3] == (H >> (i + 2), W >> (i + 2))
        scale_w = np.abs(w).max()
        assert _rel(g, w, scale_w) <= 2e-4, (i, _rel(g, w, scale_w))
        if i == 0:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * scale_w, err_msg="C2")


def _bf16(body, eval_params):
    for m in body.modules():
        if isinstance(m, Conv):
            m.compute_dtype = torch.bfloat16
            if eval_params:
                m.to(torch.bfloat16)
    return body


@pytest.mark.parametrize("arch", [None, "cham_v2"], ids=["mnv2", "cham_v2"])
def test_bf16_body_against_jitted_scan_tpu(arch):
    x = _input()
    jbody, _ = bodies(arch, 1.0, 1)
    params = seeded_params(jbody, x, seed=7)
    f32 = jax.device_get(jax.jit(jbody.apply)(params, jnp.asarray(x)))
    j16 = jbody.clone(dtype=jnp.bfloat16)
    jit = jax.device_get(jax.jit(j16.apply)(params, jnp.asarray(x)))
    dists = {}
    for kind in ("masters", "eval"):
        body = _bf16(port_body(bodies(arch, 1.0, 1)[1], params),
                     kind == "eval")
        with torch.no_grad():
            got = body(torch.from_numpy(x))
        dists[kind] = []
        for i, (g, w) in enumerate(zip(got, jit)):
            assert g.dtype == torch.float32 and w.dtype == np.float32
            scale = np.abs(f32[i]).max()
            own = _rel(w, f32[i], scale)
            port = _rel(g, w, scale)
            dists[kind].append((port, own))
            assert own > 1e-3, "the bf16-float32 distance is what the test reads"
            assert port <= (1 if kind == "masters" else 2) * own, (
                kind, i, port, own)
    # jitted, XLA keeps each conv's float32 sum: the float32 results over
    # masters lie nearer its run than the rounded ones at every level
    assert all(m[0] < e[0] for m, e in zip(dists["masters"], dists["eval"]))


def _cfg(cfg, body, opts=()):
    from test_torch_train_step import C2F

    cfg.merge_from_file(C2F)
    cfg.MODEL.BACKBONE.CONV_BODY = body
    cfg.merge_from_list(list(opts))
    return cfg


def test_registry_builds_every_body():
    assert set(BACKBONES) == set(jax_build.BACKBONES)
    for body in BACKBONES:
        bb = build_backbone(_cfg(get_default_cfg(), body))
        assert bb.fpn.out_channels == (
            1024 if body.startswith("R-") else 256), body
    cfg = _cfg(get_default_cfg(), "MNV2-FPN-RETINANET",
               ("MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 128))
    bb = build_backbone(cfg)
    assert isinstance(bb.body, MobileNetV2) and bb.fpn.out_channels == 256
    assert bb.body.channels == (24, 32, 96, 320)
    frozen = {n for n, p in bb.named_parameters() if not p.requires_grad}
    assert frozen == {"body.stem_bn.weight", "body.stem_bn.bias"}
    assert isinstance(bb.body.stem_bn, ChannelNorm)
    cfg = _cfg(get_default_cfg(), "FBNet",
               ("MODEL.FBNET.ARCH", "cham_v1a", "MODEL.FBNET.SCALE_FACTOR",
                0.5, "MODEL.FBNET.WIDTH_DIVISOR", 8))
    body = build_backbone(cfg).body
    assert isinstance(body, FBNetTrunk)
    assert body.channels == (24, 32, 48, 56)
    assert body.stage1_g0_b0.dw.kernel_size == (7, 7)
    cfg.MODEL.BACKBONE.CONV_BODY = "MNV3-FPN"
    with pytest.raises(KeyError):
        build_backbone(cfg)


# ---------------------------------------------------------------------- #
# the C2F detector on MobileNetV2
# ---------------------------------------------------------------------- #
MNV2_OPTS = ("MODEL.BACKBONE.CONV_BODY", "MNV2-FPN-RETINANET",
             "MODEL.FCOS.NUM_CONVS_CLS", 1, "MODEL.FCOS.NUM_CONVS_REG", 1)


def double(batch):
    """``make_batches``' 64x96 batch at 128x192 (each pixel 2 x 2, boxes
    scaled): C5 of the MNV2 body is then 4 x 6, where float32 rounding of
    its per-channel norms no longer moves detections (see above)."""
    out = dict(batch, images=batch["images"].repeat(2, 1).repeat(2, 2))
    if "boxes" in batch:
        out["boxes"] = batch["boxes"] * 2
        out["sizes"] = batch["sizes"] * 2
    return out


@pytest.fixture(scope="module")
def mnv2_reference():
    """scan_tpu's C2F detector on MobileNetV2: numpy-drawn parameters and
    prototypes in its tree (shapes from ``jax.eval_shape``), the head's
    predictors rescaled so the eval forward has detections; its jitted eval
    forward and one DA step."""
    from test_torch_train_step import make_batches, tiny_cfg

    from scan_tpu.engine.train_step import make_da_train_step as jax_step
    from scan_tpu.modeling.condgraph.prototype import ProtoState
    from scan_tpu.solver.build import make_optimizer as jax_make_optimizer

    cfg = tiny_cfg(jax_default_cfg(), opts=MNV2_OPTS)
    jdet = jax_build_detector(cfg)
    bs, bt = (double(b) for b in make_batches(6))
    params_s, proto_s = jax.eval_shape(jdet._init_params,
                                       jax.random.PRNGKey(4),
                                       jnp.asarray(bs["images"]))
    rng = np.random.RandomState(4)
    params = {k: seeded_tree(v, rng) for k, v in params_s.items()}
    proto = ProtoState(rng.randn(*proto_s.prototype.shape).astype(np.float32),
                       np.asarray(-1, np.int32))
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 0.5, -1.0), ("bbox_pred", 0.5, 0.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    sizes = np.asarray([[128, 192], [112, 160]], np.int32)
    preds = jax.device_get(jax.jit(jdet.forward_inference)(
        params, proto, jnp.asarray(bs["images"]), jnp.asarray(sizes)))
    # the step's metrics come from its loss_fn's forward: that alone is
    # jitted (8 s to compile here, the whole step with its backward 38 s)
    step = jax_step(jdet, jax_make_optimizer(cfg, params))
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]
    _, (metrics, _) = jax.jit(loss_fn, static_argnums=4)(
        params, proto, {k: jnp.asarray(v) for k, v in bs.items()},
        {"images": jnp.asarray(bt["images"])}, False)
    return params, proto, (bs, bt), sizes, preds, jax.device_get(metrics)


def test_mnv2_detector_forward_matches(mnv2_reference):
    """Detections as sets per image: the same count, and each of
    ``scan_tpu``'s has one in the port of the same label, its box within
    1e-3 px and its score within rtol 1e-4 (two of one image whose scores
    lie within float32 rounding may trade slots)."""
    from test_torch_train_step import _port

    params, proto, (bs, _), sizes, want, _ = mnv2_reference
    det, _ = _port(params, proto, opts=MNV2_OPTS)
    assert isinstance(det.backbone.body, MobileNetV2)
    got = {k: v.numpy() for k, v in det.forward_inference(
        torch.from_numpy(bs["images"]), torch.from_numpy(sizes)).items()}
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 10, "the test needs detections to compare"
    for b in range(len(sizes)):
        vg, vw = got["valid"][b], want["valid"][b]
        box_g, box_w = got["boxes"][b][vg], want["boxes"][b][vw]
        ok = np.abs(box_w[:, None] - box_g[None]).max(-1) <= 1e-3
        ok &= want["labels"][b][vw][:, None] == got["labels"][b][vg][None]
        sw, sg = want["scores"][b][vw][:, None], got["scores"][b][vg][None]
        ok &= np.abs(sw - sg) <= 1e-4 * np.abs(sw) + 1e-6
        assert ok.any(1).all(), (b, int((~ok.any(1)).sum()))


def test_mnv2_da_step_losses_match(mnv2_reference):
    from test_torch_train_step import _check_metrics, _port

    params, proto, (bs, bt), _, _, want_metrics = mnv2_reference
    families = {k.split("_")[3] for k in want_metrics if k.startswith("loss_adv")}
    assert families == {"CON"}, families
    det, step = _port(params, proto, opts=MNV2_OPTS)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    _, metrics = step(det.proto_state(), bs, bt, forward_target=False)
    _check_metrics(metrics, want_metrics, 1e-4)
    after = det.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "backbone.body.stem.weight" in moved
    assert not moved & {"backbone.body.stem_bn.weight",
                        "backbone.body.stem_bn.bias"}


def test_mnv2_gradients_match_jax_grad():
    """The backward through the grouped convs, ``ChannelNorm`` and relu6,
    float32, at 2 x 64 x 96: the gradients of a weighted sum of C2..C5
    with respect to every trainable parameter against ``jax.grad`` of
    ``scan_tpu``'s body run in float64 (``jax.enable_x64``), within 2e-3 of
    each tensor's largest gradient plus 1e-5 of the largest over all (a
    bias whose gradient is 0 in exact arithmetic, before a norm, holds only
    rounding). Measured: the port's float32 gradients lie 2.9e-4 (median
    over tensors, 8.1e-4 at most) from float64, ``scan_tpu``'s own jitted
    float32 ones 2.0e-2 (1.2e-1 at most; ROADMAP queue C), so float64 is
    the reference here. relu6's gradient at its ties (0 and 6) equals
    ``jnp.clip``'s (split). A grouped (depthwise) conv over float32 masters
    in bf16 (``float_output``) gives, forward and backward, what a float32
    conv of its bf16-rounded operands gives (results, then gradients
    rounded to bf16), and so does its body's backward run through: finite
    float32 gradients on every trainable parameter. (bf16 gradients of
    this random-init body are not held to float32 ones: its bf16 features
    lie 0.3-0.8 of their largest value from float32's at C5.)"""
    x = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    jbody = JaxMNV2()
    params = seeded_params(jbody, x, seed=9)
    cots = [np.random.RandomState(i).randn(*o.shape).astype(np.float32)
            for i, o in enumerate(jax.eval_shape(jbody.apply, params, x))]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                     params)

        def loss(p):
            outs = jbody.apply(p, jnp.asarray(x, jnp.float64))
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

        want = convert_params({"b": jax.device_get(
            jax.jit(jax.grad(loss))(p64))})
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        body = port_body(MobileNetV2(), params).train()
        for m in body.modules():
            if isinstance(m, Conv):
                m.compute_dtype = dt
        outs = body(torch.from_numpy(x))
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
            ).backward()
        grads[dt] = {f"b.{k}": p.grad for k, p in body.named_parameters()
                     if p.requires_grad}
    assert set(grads[torch.float32]) == set(want) - {
        "b.stem_bn.weight", "b.stem_bn.bias"}  # frozen, as scan_tpu's solver
    scale = max(float(want[k].abs().max()) for k in grads[torch.float32])
    for k, g in grads[torch.float32].items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=2e-3 * np.abs(w).max() + 1e-5 * scale, err_msg=k)
    for k, g in grads[torch.bfloat16].items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
    dw = mobile_conv(8, 8, 3, stride=2, groups=8)
    dw.compute_dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    xin = torch.randn(2, 9, 11, 8, generator=gen, requires_grad=True)
    cot = torch.randn(2, 5, 6, 8, generator=gen)
    y = dw(xin)
    assert y.dtype == torch.float32
    (y * cot).sum().backward()
    xr = xin.detach().bfloat16().float().requires_grad_()
    wr = dw.weight.detach().bfloat16().float().requires_grad_()
    yr = F.conv2d(xr.permute(0, 3, 1, 2), wr, None, 2, 1, 1, 8)
    assert torch.equal(y.detach(), yr.permute(0, 2, 3, 1))
    yr.backward(cot.bfloat16().float().permute(0, 3, 1, 2))
    assert torch.equal(xin.grad, xr.grad.bfloat16().float())
    assert torch.equal(dw.weight.grad, wr.grad.bfloat16().float())
    ties = np.asarray([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    t = torch.tensor(ties, requires_grad=True)
    clip(t, 6).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.clip(v, 0, 6)))(jnp.asarray(ties))))
