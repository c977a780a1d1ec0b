"""The port's w8a8 int8 eval forward (``TPU.INT8_INFERENCE``) against
``scan_tpu``'s, on the CPU, and the weight bridge for activation scales.

The tiny config of ``tests/test_torch_detector.py`` (VGG width / 4, 1-conv
FCOS towers, 64x96 images, rescaled predictors), float32, int8 on. For
each TEST.MODE, ``scan_tpu``'s ``calibrate_int8`` stores static scales from
one seeded uint8 batch; its parameters and those scales go into the port
through ``scan_tpu_torch/utils/jax_weights.py``, and both run
``forward_inference`` on that batch.

``scan_tpu`` runs its naive stem on the CPU (its s2d stem is TPU-only),
whose convs keep their own scales ``conv0/amax``, ``conv1/amax``; the bridge
maps them onto the port's stem scales. In float32 the naive stem and the
port's default chain compute the same thing.

Tolerances. ``scan_tpu`` runs under ``jax.jit``, where XLA contracts each
int8 epilogue's ``acc * scale + bias`` into one FMA; the port rounds twice.
The fp results of an int8 conv then differ by an ulp, and when such a value
sits on a rounding boundary of the next quantize it moves a whole step.
Measured on this batch: ``valid`` and labels equal, boxes within 1e-4 px and
scores within 6e-7. The test asks for equal ``valid`` and labels, boxes
within atol 1e-3 px (rtol 1e-4) and scores within rtol 1e-4, atol 1e-6.
The same FMA moves the scales the port's own calibration measures by up to
1.1e-5 relative (the FCOS towers' small |x|max), so those are held to rtol
5e-5. A forward at the port's own scales is not compared: with scales that
differ in the last bits, roundings flip and the top-ranked boxes can change.
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
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.modeling.layers import NO_SCALE
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
H, W = 64, 96
MODES = ("common", "precision", "light")


def tiny_int8_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 16
    cfg.TPU.MAX_TARGET_POINTS = 16
    cfg.TPU.VGG_WIDTH_DIV = 4
    cfg.MODEL.FCOS.NUM_CONVS = 1
    cfg.MODEL.FCOS.NUM_CONVS_REG = 1
    cfg.MODEL.FCOS.NUM_CONVS_CLS = 1
    cfg.TPU.INT8_INFERENCE = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _scales(sd):
    return {k: float(v) for k, v in sd.items() if k.endswith(("amax", "_act"))}


@pytest.fixture(scope="module")
def models():
    jdet = jax_build_detector(tiny_int8_cfg(jax_default_cfg()))
    params, proto = jdet.init_params(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    params = jax.device_get(params)
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 5.0, 0.0), ("bbox_pred", 5.0, 3.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    proto = jax.device_get(proto)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    sizes = np.asarray([[H, W], [56, 80]], np.int32)
    calibrated = {}
    for mode in MODES:
        jdet.test_mode = mode
        calibrated[mode] = jax.device_get(
            jdet.calibrate_int8(params, proto, [jnp.asarray(images)]))
    return jdet, params, proto, calibrated, images, sizes


def _port(mode, params, proto):
    tdet = build_detector(tiny_int8_cfg(get_default_cfg()), device="cpu")
    tdet.test_mode = mode
    load_jax_params(tdet, params, proto)
    return tdet


@pytest.mark.parametrize("mode", MODES)
def test_int8_forward_matches_scan_tpu(models, mode):
    jdet, _, proto, calibrated, images, sizes = models
    jdet.test_mode = mode
    want = jax.device_get(jax.jit(jdet.forward_inference)(
        calibrated[mode], proto, jnp.asarray(images), jnp.asarray(sizes)))
    tdet = _port(mode, calibrated[mode], proto)
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


@pytest.mark.parametrize("mode", ["precision", "light"])
def test_port_calibration_gives_scan_tpu_scales(models, mode):
    _, params, proto, calibrated, images, _ = models
    tdet = _port(mode, params, proto)
    assert all(v == NO_SCALE for v in _scales(tdet.state_dict()).values())
    tdet.calibrate_int8([images])
    got = _scales(tdet.state_dict())
    want = _scales(convert_params(calibrated[mode]))
    naive = {"backbone.body.conv0.amax": "backbone.body.conv0_act",
             "backbone.body.conv1.amax": "backbone.body.conv1_act"}
    want = {naive.get(k, k): v for k, v in want.items()}
    # scan_tpu's naive stem has no stem_out_act; it measures the same
    # tensor as conv2's scale
    assert got.pop("backbone.body.stem_out_act") == \
        got["backbone.body.conv2.amax"]
    uncalibrated = {k for k, v in got.items() if v == NO_SCALE}
    assert set(got) - uncalibrated == set(want)
    assert all(".cls_tower." in k for k in uncalibrated)
    assert bool(uncalibrated) == (mode == "light")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-5, err_msg=k)


def test_weight_bridge_carries_every_scale(models):
    """A calibrated tree loads with nothing missing: every scale buffer of
    the port holds the tree's value (the stem's from the naive names); an
    uncalibrated tree leaves every buffer without a value; a key with no
    place in the port raises."""
    _, params, proto, calibrated, _, _ = models
    tree = calibrated["precision"]
    tdet = _port("precision", tree, proto)
    got = _scales(tdet.state_dict())
    want = _scales(convert_params(tree))
    assert NO_SCALE not in got.values()
    body = "backbone.body."
    assert got[body + "conv0_act"] == want[body + "conv0.amax"]
    assert got[body + "conv1_act"] == want[body + "conv1.amax"]
    assert got[body + "stem_out_act"] == want[body + "conv2.amax"]
    for k, v in want.items():
        if not k.startswith((body + "conv0.", body + "conv1.")):
            assert got[k] == v, k

    light = _port("light", calibrated["light"], proto)
    for k, v in _scales(light.state_dict()).items():
        assert (v == NO_SCALE) == (".cls_tower." in k), k
    fresh = _port("precision", params, proto)
    assert set(_scales(fresh.state_dict()).values()) == {NO_SCALE}

    bogus = dict(tree)
    bogus["fcos"] = dict(tree["fcos"])
    bogus["fcos"]["act_scales"] = dict(tree["fcos"]["act_scales"])
    bogus["fcos"]["act_scales"]["no_such_conv"] = {"amax": np.float32(1.0)}
    with pytest.raises(KeyError, match="no_such_conv"):
        load_jax_params(_port("precision", params, proto), bogus, proto)


def test_int8_with_fp_stem_kernel_raises():
    """``TPU.PALLAS_STEM`` inside the int8 forward is not ported: building
    such a detector raises rather than run another stem than asked for."""
    cfg = tiny_int8_cfg(get_default_cfg())
    cfg.TPU.PALLAS_STEM = True
    with pytest.raises(NotImplementedError, match="PALLAS_STEM"):
        build_detector(cfg, device="cpu")
