"""The port's two-stage detector
(``scan_tpu_torch/modeling/generalized_rcnn.py``) against ``scan_tpu``'s ``FasterRCNN``, on the CPU.

R-50-FPN at narrow widths (RES2_OUT_CHANNELS 32, STEM_OUT_CHANNELS 16,
BACKBONE_OUT_CHANNELS 32), the RPN on P2..P6 (ANCHOR_STRIDE 4..64, 300
pre-NMS and 64 post-NMS proposals an image), the box head on P2..P5 (7x7,
sampling 2, MLP_HEAD_DIM 64, 5 classes), the mask head (CONV_LAYERS (32, 32),
14x14) and the keypoint head (CONV_LAYERS (32, 32), 14x14, 17 keypoints);
batch 2 at 64x96 (the second image's size 56x80). ``scan_tpu`` builds its
R-50-FPN body at its ResNet's default widths whatever RESNETS says
(``scan_tpu/modeling/backbone/build.py:115-135``), so the test gives its
``FasterRCNN`` the same narrow ``_BackboneWithFPN`` in place of
``backbone`` (an attribute; nothing in ``scan_tpu`` changes). Its seeded
parameters go through ``utils/jax_weights.py``, the body's kernels redrawn
at He scale with seeded FrozenBN statistics (``test_torch_resnet.py``).
``scan_tpu`` runs jitted, as its own tests run it.

* ``forward_inference`` with MASK_ON and, separately, KEYPOINT_ON: ``valid``
  and the labels equal, boxes within 1e-2 px (measured 1.2e-3) and scores
  within 1e-5 (7e-6). The branches run on each package's own final boxes,
  which differ by that 1e-3 px, and the features here reach ~1e3, so on the
  valid slots masks are held within 1e-2 (measured 2.4e-3), keypoints
  within 0.5 px (0.15) and keypoint scores within 1e-4 of the largest
  (4e-5); on the same boxes the branches agree to 1e-6 of the largest
  (``tests/test_torch_roi_heads.py``).
* ``forward_train`` with both branches on seeded targets (boxes, bitmap
  masks, keypoints; one box per image covers most of it, so the RPN's
  proposals match it): every loss within rtol 1e-4, with positives for the
  box, mask and keypoint losses; every trainable parameter's gradient of
  the summed loss within 1e-4 of the tensor's largest + 1e-4 of the
  largest of all (the bound of ``test_torch_train_step.py``); the frozen
  stem and stage 1 get none.
* The weight bridge: ``FasterRCNN``'s whole tree strictly (no missing and
  no unexpected key), both ConvTranspose kernels checked by their outputs
  in ``test_torch_roi_heads.py``; R-101-FPN builds with every branch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.backbone.build import _BackboneWithFPN
from scan_tpu.modeling.backbone.resnet import ResNet as JaxResNet
from scan_tpu.modeling.generalized_rcnn import FasterRCNN as JaxFasterRCNN
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.generalized_rcnn import FasterRCNN
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

from test_torch_resnet import he_scaled

H, W = 64, 96
SIZES = np.asarray([[H, W], [56, 80]], np.int32)
SCALES = (0.25, 0.125, 0.0625, 0.03125)
TRANSPOSED = ("roi_mask.conv5_mask", "roi_keypoint.kps_score_lowres")


def two_stage_cfg(cfg, mask=True, keypoint=True, dtype="float32", depth=50):
    cfg.MODEL.BACKBONE.CONV_BODY = f"R-{depth}-FPN"
    res = cfg.MODEL.RESNETS
    res.RES2_OUT_CHANNELS, res.STEM_OUT_CHANNELS = 32, 16
    res.BACKBONE_OUT_CHANNELS = 32
    r = cfg.MODEL.RPN
    r.USE_FPN = True
    r.ANCHOR_STRIDE = (4, 8, 16, 32, 64)
    r.PRE_NMS_TOP_N_TRAIN = r.PRE_NMS_TOP_N_TEST = 300
    r.POST_NMS_TOP_N_TRAIN = r.POST_NMS_TOP_N_TEST = 64
    b = cfg.MODEL.ROI_BOX_HEAD
    b.NUM_CLASSES, b.MLP_HEAD_DIM = 5, 64
    b.POOLER_RESOLUTION, b.POOLER_SCALES = 7, SCALES
    b.POOLER_SAMPLING_RATIO = 2
    cfg.MODEL.MASK_ON, cfg.MODEL.KEYPOINT_ON = mask, keypoint
    for head in (cfg.MODEL.ROI_MASK_HEAD, cfg.MODEL.ROI_KEYPOINT_HEAD):
        head.CONV_LAYERS = (32, 32)
        head.POOLER_SCALES, head.POOLER_SAMPLING_RATIO = SCALES, 2
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def jax_detector(mask=True, keypoint=True, dtype="float32"):
    """``scan_tpu``'s FasterRCNN with the narrow body (see the docstring)."""
    det = JaxFasterRCNN(two_stage_cfg(jax_default_cfg(), mask, keypoint,
                                      dtype))
    det.backbone = _BackboneWithFPN(
        body_cls=JaxResNet,
        body_kwargs=dict(depth=50, freeze_at=2, stride_in_1x1=True,
                         res2_out_channels=32, stem_out_channels=16),
        fpn_kwargs=dict(in_features=(0, 1, 2, 3), out_channels=32,
                        top_block="maxpool", use_gn=False, use_relu=False),
        dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    return det


def images():
    return np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)


def jax_params():
    """Seeded parameters of both branches, the body at He scale."""
    det = jax_detector()
    params = jax.device_get(det.init_params(jax.random.PRNGKey(0),
                                            jnp.asarray(images())))
    params["backbone"] = he_scaled(params["backbone"],
                                   np.random.RandomState(3))
    return params


def targets(g=4, k=17):
    """Three seeded boxes an image and one over most of it, with bitmap
    masks inside the boxes and keypoints (visibility 0-2) in them."""
    rng = np.random.RandomState(5)
    boxes = np.zeros((2, g, 4), np.float32)
    labels = np.zeros((2, g), np.int32)
    gm = np.zeros((2, g, H, W), np.float32)
    kps = np.zeros((2, g, k, 3), np.float32)
    for b in range(2):
        for i in range(g):
            if i == g - 1:
                x0, y0, w, h = 2, 3, 86, 55
            else:
                x0, y0 = rng.randint(0, 50), rng.randint(0, 30)
                w, h = rng.randint(16, 44), rng.randint(16, 34)
            boxes[b, i] = [x0, y0, min(x0 + w, W - 1), min(y0 + h, H - 1)]
            labels[b, i] = rng.randint(1, 5)
            gm[b, i, y0 + 2:y0 + h - 2, x0 + 3:x0 + w - 3] = 1
            kps[b, i, :, 0] = rng.uniform(x0, x0 + w, k)
            kps[b, i, :, 1] = rng.uniform(y0, y0 + h, k)
            kps[b, i, :, 2] = rng.randint(0, 3, k)
    return dict(boxes=boxes, labels=labels, mask=np.ones((2, g), bool),
                gt_masks=gm, gt_keypoints=kps)


def branch_params(params, mask, keypoint):
    drop = {"roi_mask"} - ({"roi_mask"} if mask else set())
    drop |= {"roi_keypoint"} - ({"roi_keypoint"} if keypoint else set())
    return {k: v for k, v in params.items() if k not in drop}


def port_detector(params, mask=True, keypoint=True, dtype="float32",
                  train=False):
    det = FasterRCNN(two_stage_cfg(get_default_cfg(), mask, keypoint, dtype),
                     device="cpu", train=train)
    return load_jax_params(det, branch_params(params, mask, keypoint))


def summed_loss_and_grads(jdet, params):
    """``scan_tpu``'s jitted losses and the gradient of their sum."""
    tj = {k: jnp.asarray(v) for k, v in targets().items()}

    def total(p):
        losses = jdet.forward_train(p, jnp.asarray(images()), tj,
                                    jnp.asarray(SIZES))
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params)
    return jax.device_get(losses), jax.device_get(grads)


def port_loss_and_grads(det):
    tt = {k: torch.from_numpy(v) for k, v in targets().items()}
    det.zero_grad()
    losses = det.forward_train(torch.from_numpy(images()), tt,
                               torch.from_numpy(SIZES))
    sum(losses.values()).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad for n, p in det.named_parameters() if p.requires_grad})


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.mark.parametrize("branch", ["mask", "keypoint"])
def test_forward_inference_matches_scan_tpu(params, branch):
    mask, keypoint = branch == "mask", branch == "keypoint"
    jdet = jax_detector(mask, keypoint)
    p = branch_params(params, mask, keypoint)
    want = jax.device_get(jax.jit(jdet.forward_inference)(
        p, jnp.asarray(images()), jnp.asarray(SIZES)))
    det = port_detector(params, mask, keypoint)
    got = {k: v.numpy() for k, v in det.forward_inference(
        torch.from_numpy(images()), torch.from_numpy(SIZES)).items()}
    assert set(got) == set(want)
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.sum() > 40, "the test needs detections to compare"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0,
                               atol=1e-5)
    if mask:
        assert got["masks"].shape == (2, 100, 28, 28)
        np.testing.assert_allclose(got["masks"][v], want["masks"][v], rtol=0,
                                   atol=1e-2)
    else:
        assert got["keypoints"].shape == (2, 100, 17, 3)
        np.testing.assert_allclose(got["keypoints"][v], want["keypoints"][v],
                                   rtol=0, atol=0.5)
        ks = want["keypoint_scores"][v]
        np.testing.assert_allclose(got["keypoint_scores"][v], ks, rtol=0,
                                   atol=1e-4 * np.abs(ks).max())


def test_forward_train_losses_and_gradients_match_scan_tpu(params):
    want, grads = summed_loss_and_grads(jax_detector(), params)
    det = port_detector(params, train=True)
    got, port_grads = port_loss_and_grads(det)
    assert set(got) == set(want) == {
        "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
        "loss_box_reg", "loss_mask", "loss_kp"}
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4), k
        assert float(want[k]) > 0, f"{k}: the test needs positives"
    g = convert_params(grads, TRANSPOSED)
    scale = max(float(t.abs().max()) for t in g.values())
    frozen = {k for k in g if k.startswith(("backbone.body.stem_",
                                            "backbone.body.layer1_"))}
    assert frozen and not frozen & set(port_grads)
    assert set(port_grads) == set(g) - frozen - {
        k for k in g if "_bn" in k or ".bn" in k}
    for name, got_g in port_grads.items():
        want_g = g[name]
        assert got_g is not None, name
        bound = 1e-4 * float(want_g.abs().max()) + 1e-4 * scale
        err = float((got_g - want_g).abs().max())
        assert err <= bound, (name, err, bound)


def test_weight_bridge_is_strict_and_r101_builds(params):
    det = port_detector(params)
    sd = convert_params(params, TRANSPOSED)
    assert set(sd) == set(det.state_dict())
    extra = dict(params, roi_extra={"params": {"w": {"kernel": np.zeros(
        (2, 2), np.float32)}}})
    with pytest.raises(KeyError):
        load_jax_params(det, extra)
    with pytest.raises(KeyError):
        load_jax_params(det, branch_params(params, True, False))
    r101 = FasterRCNN(two_stage_cfg(get_default_cfg(), depth=101),
                      device="cpu")
    assert len(r101.backbone.body.stage_blocks) == 4
    assert r101.backbone.body.stage_blocks[2] == 23
    assert hasattr(r101, "roi_mask") and hasattr(r101, "roi_keypoint")
    out = r101.forward_inference(torch.from_numpy(images()),
                                 torch.from_numpy(SIZES))
    assert out["masks"].shape == (2, 100, 28, 28)
    assert torch.isfinite(out["keypoints"]).all()
