"""The port's whole eval forward against ``scan_tpu``'s, on the CPU.

The same seeded uint8 batch goes through ``scan_tpu``'s
``SCANDetector.forward_inference`` and the port's, with ``scan_tpu``'s
parameters carried across by ``scan_tpu_torch/utils/jax_weights.py``, in
all three TEST.MODEs, float32, at a small size (VGG width / 4, 1-conv FCOS
towers, 64x96 images).

The FCOS predictors are rescaled so the test has something to check: cls
logits spread over a few units (distinct scores, candidates in common
mode) and boxes of ~40 px around each location (NMS suppresses).

Tolerances: ``valid`` and ``labels`` must be equal; on valid slots, boxes
within atol 1e-3 px (rtol 1e-4) and scores within rtol 1e-4, atol 1e-6:
fp32 convolutions sum in another order in the two frameworks, which moves
the head outputs by ~1e-6 relative. Invalid slots are not compared:
``torch.topk`` orders NEG_INF ties differently from ``lax.top_k``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.inference import compute_predictions
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
H, W = 64, 96


def tiny_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 16
    cfg.TPU.MAX_TARGET_POINTS = 16
    cfg.TPU.VGG_WIDTH_DIV = 4
    cfg.MODEL.FCOS.NUM_CONVS = 1
    cfg.MODEL.FCOS.NUM_CONVS_REG = 1
    cfg.MODEL.FCOS.NUM_CONVS_CLS = 1
    return cfg


@pytest.fixture(scope="module")
def models():
    jdet = jax_build_detector(tiny_cfg(jax_default_cfg()))
    params, proto = jdet.init_params(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    params = jax.device_get(params)
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 5.0, 0.0), ("bbox_pred", 5.0, 3.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    proto = jax.device_get(proto)
    tdet = build_detector(tiny_cfg(get_default_cfg()), device="cpu")
    load_jax_params(tdet, params, proto)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    sizes = np.asarray([[H, W], [56, 80]], np.int32)
    return jdet, params, proto, tdet, images, sizes


@pytest.mark.parametrize("mode", ["common", "precision", "light"])
def test_forward_inference_matches_scan_tpu(models, mode):
    jdet, params, proto, tdet, images, sizes = models
    jdet.test_mode = mode
    tdet.test_mode = mode
    want = jax.device_get(jax.jit(jdet.forward_inference)(
        params, proto, jnp.asarray(images), jnp.asarray(sizes)))
    got = {k: v.numpy() for k, v in tdet.forward_inference(
        torch.from_numpy(images), torch.from_numpy(sizes)).items()}

    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() > 20, "the test needs detections to compare"
    v = want["valid"]
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v],
                               rtol=1e-4, atol=1e-6)


def test_weight_bridge_covers_every_parameter(models):
    _, params, _, tdet, _, _ = models
    sd = convert_params(params)
    assert set(sd) == set(tdet.state_dict()) - {"prototype", "proto_counter"}
    w = params["backbone"]["params"]["body"]["conv3"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        tdet.backbone.body.conv3.weight.detach().numpy(),
        np.asarray(w).transpose(3, 2, 0, 1))


def test_compute_predictions_rescales_to_original(models):
    _, _, _, tdet, images, sizes = models
    tdet.test_mode = "precision"
    batch = dict(images=images, sizes=sizes,
                 scales=np.asarray([[2.0, 2.0], [1.0, 0.5]], np.float32),
                 indices=np.asarray([7, -1]))
    preds = compute_predictions(tdet, [batch], progress_every=0)
    assert set(preds) == {7}
    out = tdet.forward_inference(torch.from_numpy(images),
                                 torch.from_numpy(sizes))
    v = out["valid"][0].numpy()
    np.testing.assert_allclose(preds[7]["boxes"],
                               out["boxes"][0].numpy()[v] * 2.0)
    np.testing.assert_array_equal(preds[7]["labels"],
                                  out["labels"][0].numpy()[v])
