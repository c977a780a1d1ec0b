"""The port's single-image path (``scan_tpu_torch/demo.py``, ``cli.py``,
``tools/demo.py``) against ``scan_tpu``'s ``Predictor``, on the CPU.

The C2F config at VGG width / 8 with INPUT.MIN_SIZE_TEST 96 and
MAX_SIZE_TEST 128 (a 96x128 bucket). ``scan_tpu``'s ``Predictor`` is built
with its detector's init replaced by numpy-drawn parameters in its tree
(``test_torch_mobile_backbones.seeded_tree``, shapes from
``jax.eval_shape``; its jitted ``PRNGKey(0)`` init would cost a compile),
the head's predictors rescaled so frames have detections; the same
parameters go into the port's ``Predictor`` (built on the CPU) through the
weight bridge.

* ``Predictor.detect`` on a 120x160 frame (fits the bucket) and on a
  200x100 one (resized to 128x64: the bucket grows to 128x64, as
  ``scan_tpu``'s does) and the first frame again (it grows back to
  96x128): the same number of detections at confidence 0.3, labels and
  names equal, boxes within 1e-3 px in the frame's own coordinates,
  scores within rtol 1e-4.
* ``draw_detections``: byte-equal to ``scan_tpu``'s on the same
  detections.
* Weights through ``Checkpointer.load``: a port checkpoint of the bridged
  detector gives the same detections to a ``Predictor`` built from the
  seeded init.
* ``cli detect --output``: the JSON holds, under the image's path, one
  dict per detection with ``scan_tpu``'s keys (``box``, ``score``,
  ``label``, ``label_name``), equal to ``Predictor.detect``'s; and
  ``python -m scan_tpu_torch.tools.demo`` writes the drawn PNG.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from scan_tpu import demo as jax_demo
from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.detector import SCANDetector as JaxDetector
from scan_tpu.modeling.condgraph.prototype import ProtoState
from scan_tpu_torch import cli
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.demo import Predictor, draw_detections
from scan_tpu_torch.tools import demo as demo_tool
from scan_tpu_torch.utils.checkpoint import Checkpointer
from scan_tpu_torch.utils.jax_weights import load_jax_params

from test_torch_mobile_backbones import seeded_tree
from test_torch_train_step import C2F

OPTS = ("TPU.VGG_WIDTH_DIV", 8, "INPUT.MIN_SIZE_TEST", 96,
        "INPUT.MAX_SIZE_TEST", 128, "TPU.MAX_NODES", 64,
        "TPU.MAX_TARGET_POINTS", 64)
THRESHOLD = 0.3


def demo_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.merge_from_list(list(OPTS))
    return cfg


def frames():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    a[30:80, 40:110] = (200, 40, 40)  # a block: structure for the features
    b = rng.randint(0, 256, (200, 100, 3)).astype(np.uint8)
    b[50:150, 20:70] = (30, 160, 220)
    return a, b


@pytest.fixture(scope="module")
def jax_predictor():
    rng = np.random.RandomState(11)

    def init_params(self, key, sample):
        params_s, proto_s = jax.eval_shape(self._init_params, key, sample)
        params = {k: seeded_tree(v, rng) for k, v in params_s.items()}
        fc = params["fcos"]["params"]
        for name, gain, bias in (("cls_logits", 0.5, -0.5),
                                 ("bbox_pred", 0.5, 1.0)):
            c = fc[name]["Conv_0"]
            c["kernel"] = np.asarray(c["kernel"]) * gain
            c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
        proto = ProtoState(
            rng.randn(*proto_s.prototype.shape).astype(np.float32),
            np.asarray(-1, np.int32))
        return params, proto

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxDetector, "init_params", init_params)
    try:
        pred = jax_demo.Predictor(demo_cfg(jax_default_cfg()),
                                  confidence_threshold=THRESHOLD)
    finally:
        mp.undo()
    return pred


@pytest.fixture(scope="module")
def port_predictor(jax_predictor):
    pred = Predictor(demo_cfg(get_default_cfg()), device="cpu",
                     confidence_threshold=THRESHOLD)
    load_jax_params(pred.detector, jax.device_get(jax_predictor.params),
                    jax.device_get(jax_predictor.proto))
    return pred


def _same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"box", "score", "label", "label_name"}
        assert g["label"] == w["label"] and g["label_name"] == w["label_name"]
        np.testing.assert_allclose(g["box"], w["box"], rtol=0, atol=1e-3)
        assert g["score"] == pytest.approx(w["score"], rel=1e-4)


def test_detect_matches_scan_tpu_and_grows_the_bucket(jax_predictor,
                                                      port_predictor):
    a, b = frames()
    assert port_predictor._bucket == (96, 128)
    for frame, bucket in ((a, (96, 128)), (b, (128, 64)), (a, (96, 128))):
        want = jax_predictor.detect(frame)
        got = port_predictor.detect(frame)
        assert port_predictor._bucket == jax_predictor._bucket == bucket
        assert len(want) > 5, "the test needs detections to compare"
        _same_detections(got, want)
        h, w = frame.shape[:2]
        for d in got:
            x1, y1, x2, y2 = d["box"]
            assert 0 <= x1 <= x2 <= w - 1 and 0 <= y1 <= y2 <= h - 1
            assert d["score"] >= THRESHOLD


def test_draw_detections_byte_equal(jax_predictor):
    a, _ = frames()
    dets = jax_predictor.detect(a)
    dets.append(dict(box=[-5.0, 100.2, 400.0, 119.6], score=0.9, label=3,
                     label_name="car"))  # clipped at the frame
    got, want = draw_detections(a, dets), jax_demo.draw_detections(a, dets)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want) and not np.array_equal(got, a)


def test_weights_through_the_checkpointer(port_predictor, tmp_path):
    a, _ = frames()
    ck = Checkpointer(str(tmp_path / "out"), port_predictor.detector)
    path = ck.save("model_final")
    fresh = Predictor(demo_cfg(get_default_cfg()), device="cpu",
                      confidence_threshold=THRESHOLD)
    seeded = fresh.detect(a)
    loaded = Predictor(demo_cfg(get_default_cfg()), weights=path,
                       device="cpu", confidence_threshold=THRESHOLD)
    want = port_predictor.detect(a)
    _same_detections(loaded.detect(a), want)
    assert seeded != want


def test_cli_detect_and_the_demo_tool(port_predictor, tmp_path):
    a, _ = frames()
    png = str(tmp_path / "frame.png")
    Image.fromarray(a).save(png)
    out = str(tmp_path / "dets.json")
    weights = Checkpointer(str(tmp_path / "w"), port_predictor.detector).save(
        "model_final")
    sets = [x for k, v in zip(OPTS[::2], OPTS[1::2])
            for x in ("--set", k, str(v))]
    assert cli.main(["detect", "--config-file", C2F, "--weights", weights,
                     "--confidence-threshold", str(THRESHOLD), "--set",
                     "MODEL.DEVICE", "cpu", "--output", out, *sets, png]) == 0
    with open(out) as f:
        res = json.load(f)
    assert list(res) == [png]
    _same_detections(res[png], port_predictor.detect(a))
    written = demo_tool.main([
        "--config-file", C2F, "--weights", weights, "--images", png,
        "--out-dir", str(tmp_path / "drawn"),
        "--confidence-threshold", str(THRESHOLD), "MODEL.DEVICE", "cpu",
        *[str(x) for x in OPTS]])
    assert written == [os.path.join(str(tmp_path / "drawn"), "frame.png")]
    with Image.open(written[0]) as im:
        drawn = np.asarray(im.convert("RGB"))
    assert np.array_equal(drawn, draw_detections(a, res[png]))


def test_predictor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Predictor(demo_cfg(get_default_cfg())).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(demo_cfg(get_default_cfg()))
