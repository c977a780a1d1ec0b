"""The port's entry points ``tools/test_net.py`` and ``tools/train_net_da.py``
(``python -m scan_tpu_torch.tools.*``), run through ``main(argv)`` on the CPU.

* ``test_net`` with ``MODEL.DEVICE cpu`` at a small width (C2F at VGG
  width / 4, 1-conv FCOS towers, the predictors rescaled so there are
  detections to score, as in ``test_torch_detector.py``) on the synthetic
  COCO tree of ``test_torch_data.py``, from a port checkpoint made of
  ``scan_tpu``'s parameters through ``utils/jax_weights.py``: it prints one
  JSON line whose AP and AP50 equal those of ``scan_tpu``'s ``inference``
  over ``scan_tpu``'s loader with the same parameters within 1e-6, and its
  per-image detections match on valid slots (labels equal, boxes within
  1e-3 px, scores within rtol 1e-4: the frameworks sum convolutions in
  other orders; invalid slots are not compared, as ``torch.topk`` orders
  ties otherwise).
* int8 per-dataset calibration: two test datasets of different contrast;
  each dataset's stored scales equal, exactly, those of a fresh detector
  calibrated on that dataset's first batch alone, so the second dataset's
  scales keep nothing of the first one's maxima. Against ``scan_tpu``'s
  ``calibrate_int8`` from its base parameters, run op by op
  (``jax.disable_jit``): the input's scale equal, every other within rtol
  1e-5 (measured: at most 4.1e-6). Under ``jax.jit`` XLA fuses each int8
  epilogue with the next quantize, and the fused code rounds otherwise; a
  value moved across a rounding boundary of a quantize moves a whole int8
  step, and the flips compound through the stack. ``scan_tpu``'s jitted
  scales are held to its own op-by-op ones within rtol 5e-2 (measured: up
  to 2.1%, the dim set's ``head_in.conv1``; the port is 1.3e-7 from the
  op-by-op value there), so that gap lies inside ``scan_tpu``.
* ``train_net_da`` on the CPU, from the config's ImageNet VGG16 URL
  resolved through ``SCAN_TPU_CACHE_DIR`` (a seeded file at the test's
  width): 2 iterations with ``VAL_ITER`` 2 and ``CHECKPOINT_PERIOD`` 1 write
  ``model_final`` and the pointer; the same command with ``MAX_ITER`` 3
  restores iteration 2 and trains one more.
* ``train_net`` (source-only, ``MODEL.DA_ON`` False) from a checkpoint of
  ``scan_tpu``'s parameters, without dropout: 2 iterations whose metrics
  equal those of ``scan_tpu``'s ``make_source_only_train_step`` on the same
  batches within rtol 1e-4; the same command with ``MAX_ITER`` 3 resumes at
  2; ``remove_solver_states`` on the run's directory drops exactly
  ``optimizer`` and ``scheduler``; ``test_net`` loads the slim file and
  prints its JSON line.
* ``test_net`` on ``configs/epm/da_ga_sim10k_VGG_16_FPN_4x_atss.yaml``
  (ATSS, VGG width / 8) from a port checkpoint of a seeded detector, over
  the config's own test set (a car-only COCO set written here): its JSON
  line has AP and AP50, and the forward ran the ATSS head.
* ``train_net_da`` on ``configs/epm/da_ga_cityscapes_R_101_FPN_4x.yaml``
  (R-101 at narrow widths) from its own ``MODEL.WEIGHT``,
  ``catalog://ImageNetPretrained/MSRA/R-101``, a seeded Detectron pickle
  found through ``SCAN_TPU_CACHE_DIR``: 2 iterations; the log names the
  pickle at iteration 0, ``model_final`` holds iteration 2, and the frozen
  stem and stage 1 still hold the pickle's values.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from scan_tpu.data import build as jax_build
from scan_tpu.engine.inference import inference as jax_inference
from scan_tpu.engine.train_step import \
    make_source_only_train_step as jax_source_step
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.solver.build import make_optimizer as jax_make_optimizer
from scan_tpu_torch import native
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.engine import inference as inference_mod
from scan_tpu_torch.engine import train_step as train_step_mod
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.tools import (remove_solver_states, test_net, train_net,
                                  train_net_da)
from scan_tpu_torch.utils.checkpoint import Checkpointer
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params
from scan_tpu_torch.utils.logger import setup_logger
from tests.test_torch_c2_loading import detectron_blobs, write_pickle
from tests.test_torch_data import coco_tree, make_trees
from tests.test_torch_reference_weights import imagenet_vgg

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
FOGGY = "cityscapes_foggy_val_cocostyle"
DIM = "cityscapes_val_cocostyle"  # the low-contrast second test set
OPTS = ["TPU.MAX_NODES", 16, "TPU.MAX_TARGET_POINTS", 16,
        "TPU.VGG_WIDTH_DIV", 4, "MODEL.FCOS.NUM_CONVS", 1,
        "MODEL.FCOS.NUM_CONVS_REG", 1, "MODEL.FCOS.NUM_CONVS_CLS", 1,
        "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 128,
        "TEST.IMS_PER_BATCH", 2, "TPU.LOADER_THREADS", 2,
        "DATASETS.TEST", (FOGGY,)]


def argv(*opts):
    return [str(o) for o in OPTS + list(opts)]


def jax_cfg(*opts):
    cfg = jax_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.merge_from_list(list(OPTS) + list(opts))
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    make_trees(data)
    coco_tree(data, DIM, "Cityscapes/leftImg8bit/val", [(4, (96, 128))],
              seed=60)
    img_dir = os.path.join(data, "Cityscapes/leftImg8bit/val")
    for name in os.listdir(img_dir):  # a quarter of the contrast
        path = os.path.join(img_dir, name)
        arr = np.asarray(Image.open(path))
        Image.fromarray((100 + arr // 4).astype(np.uint8)).save(path)

    jdet = jax_build_detector(jax_cfg())
    params, proto = jdet.init_params(
        jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3), jnp.float32))
    params = jax.device_get(params)
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 5.0, 0.0), ("bbox_pred", 5.0, 3.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    proto = jax.device_get(proto)

    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.merge_from_list(argv())
    det = build_detector(cfg, device="cpu")
    load_jax_params(det, params, proto)
    weight = Checkpointer(str(root / "ckpt"), det).save("from_scan_tpu")
    return dict(root=root, data=data, jdet=jdet, params=params, proto=proto,
                weight=weight)


@pytest.fixture(autouse=True)
def catalogs(setup, monkeypatch):
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", setup["data"])
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", setup["data"])


def recording_inference(monkeypatch, record):
    """Wrap the port's ``inference`` to keep each call's predictions and
    the detector's scale buffers at that point."""
    real = inference_mod.inference

    def wrapped(detector, loader):
        scales = {k: float(v) for k, v in detector.state_dict().items()
                  if k.endswith(("amax", "_act"))}
        results, preds = real(detector, loader)
        record.append((scales, preds))
        return results, preds

    monkeypatch.setattr(inference_mod, "inference", wrapped)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_test_net_matches_scan_tpu(setup, monkeypatch, capsys):
    record = []
    recording_inference(monkeypatch, record)
    out = str(setup["root"] / "test_out")
    ret = test_net.main(["--config-file", C2F, *argv(
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", setup["weight"],
        "OUTPUT_DIR", out)])
    printed = last_json(capsys)
    assert printed == ret and set(printed) >= {"AP", "AP50"}

    jdet, params, proto = setup["jdet"], setup["params"], setup["proto"]
    loader = jax_build.make_data_loaders_test(jax_cfg())[0]
    want, want_preds = jax_inference(jdet, params, proto, loader)
    assert abs(printed["AP"] - float(want["AP"])) <= 1e-6
    assert abs(printed["AP50"] - float(want["AP50"])) <= 1e-6
    assert printed["AP50"] > 0, "the test needs matches to score"
    (_, preds), = record
    assert sorted(preds) == sorted(want_preds) == list(range(5))
    n = 0
    for i, w in want_preds.items():
        g = preds[i]
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4,
                                   atol=1e-6)
        n += len(w["labels"])
    assert n > 20


def test_test_net_raises_when_the_native_build_fails(setup, monkeypatch,
                                                     tmp_path, capsys):
    """The loader threads are the first to ask for the native library; a
    compile failure there reaches ``test_net``'s caller with g++'s message,
    and no result is printed."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        test_net.main(["--config-file", C2F, *argv(
            "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", setup["weight"],
            "OUTPUT_DIR", str(tmp_path / "out"))])
    assert "AP" not in capsys.readouterr().out


def test_each_run_logs_into_its_own_output_dir(tmp_path):
    first = setup_logger("scan_tpu_torch.log_test", str(tmp_path / "a"))
    first.info("first run")
    second = setup_logger("scan_tpu_torch.log_test", str(tmp_path / "b"))
    second.info("second run")
    assert second is first
    files = [h for h in second.handlers
             if isinstance(h, logging.FileHandler)]
    assert [h.baseFilename for h in files] == [str(tmp_path / "b" / "log.txt")]
    for h in files:
        second.removeHandler(h)
        h.close()
    a = (tmp_path / "a" / "log.txt").read_text()
    b = (tmp_path / "b" / "log.txt").read_text()
    assert "first run" in a and "second run" not in a
    assert "second run" in b and "first run" not in b


def test_int8_calibrates_each_dataset_from_scratch(setup, monkeypatch,
                                                  capsys):
    record = []
    recording_inference(monkeypatch, record)
    int8 = ("TPU.INT8_INFERENCE", True, "TPU.INT8_CALIB_BATCHES", 1)
    test_net.main(["--config-file", C2F, *argv(
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", setup["weight"],
        "OUTPUT_DIR", str(setup["root"] / "int8_out"),
        "DATASETS.TEST", (FOGGY, DIM), *int8)])
    printed = last_json(capsys)
    assert set(printed) == {FOGGY, DIM}
    assert len(record) == 2

    jcfg = jax_cfg(*int8, "DATASETS.TEST", (FOGGY, DIM))
    jdet = jax_build_detector(jcfg)
    naive = {"backbone.body.conv0.amax": "backbone.body.conv0_act",
             "backbone.body.conv1.amax": "backbone.body.conv1_act"}

    def jax_scales(batch):
        calibrated = jax.device_get(jdet.calibrate_int8(
            setup["params"], setup["proto"], [jnp.asarray(batch)]))
        return {naive.get(k, k): float(v) for k, v in
                convert_params(calibrated).items()
                if k.endswith(("amax", "_act"))}

    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.merge_from_list(argv(*int8))
    for (got, _), loader in zip(record,
                                jax_build.make_data_loaders_test(jcfg)):
        batch = next(iter(loader))["images"]
        # the port's calibration of a fresh detector on this batch alone
        fresh = build_detector(cfg, device="cpu")
        Checkpointer(str(setup["root"] / "fresh"), fresh).load(
            setup["weight"])
        fresh.calibrate_int8([batch])
        assert got == {k: float(v) for k, v in fresh.state_dict().items()
                       if k.endswith(("amax", "_act"))}
        with jax.disable_jit():
            want = jax_scales(batch)
        jitted = jax_scales(batch)
        assert got.pop("backbone.body.stem_out_act") == \
            got["backbone.body.conv2.amax"]
        assert set(got) == set(want) == set(jitted)
        assert got["backbone.body.conv0_act"] == \
            want["backbone.body.conv0_act"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(jitted[k], want[k], rtol=5e-2,
                                       err_msg=k)
    # the dim set's input |x|max is its own, not the first set's maximum
    first, second = record[0][0], record[1][0]
    assert second["backbone.body.conv0_act"] < \
        0.5 * first["backbone.body.conv0_act"]


def test_train_net_da_writes_and_resumes(setup, caplog, monkeypatch,
                                         tmp_path):
    cache = tmp_path / "cache"
    cache.mkdir()
    vgg = imagenet_vgg(seed=21, width_div=8)
    torch.save(vgg, cache / "vgg16_caffe-292e1171.pth")
    monkeypatch.setenv("SCAN_TPU_CACHE_DIR", str(cache))
    out = str(setup["root"] / "train_out")
    common = ["--config-file", C2F, *argv(
        "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out, "TPU.VGG_WIDTH_DIV", 8,
        "TPU.MAX_BOXES", 4, "INPUT.MIN_SIZE_RANGE_TRAIN", (-1, -1),
        "INPUT.MIN_SIZE_TRAIN", (96,), "INPUT.MAX_SIZE_TRAIN", 128,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.VAL_ITER", 2,
        "SOLVER.CHECKPOINT_PERIOD", 1)]
    caplog.set_level("INFO", logger="scan_tpu_torch")
    train_net_da.main(common + ["SOLVER.MAX_ITER", "2"])
    assert "vgg16_caffe-292e1171.pth (iteration 0)" in caplog.text
    files = sorted(os.listdir(out))
    assert {"model_0000001.pth", "model_0000002.pth", "model_final.pth",
            "last_checkpoint"} <= set(files)
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().endswith("model_final.pth")
    assert "validation @2" in caplog.text
    state = torch.load(os.path.join(out, "model_final.pth"),
                       weights_only=True)
    assert state["iteration"] == 2 and state["scheduler"]["last_epoch"] == 2

    caplog.clear()
    train_net_da.main(common + ["SOLVER.MAX_ITER", "3"])
    assert "model_final.pth at iteration 2" in caplog.text
    state = torch.load(os.path.join(out, "model_final.pth"),
                       weights_only=True)
    assert state["iteration"] == 3 and state["scheduler"]["last_epoch"] == 3
    # an explicit --distributed outside torch.distributed.run's environment
    # cannot start its process group, and raises
    for var in ("RANK", "WORLD_SIZE", "SCAN_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK expected"):
        train_net_da.main(["--distributed", *common])


def test_train_net_matches_scan_tpu_resumes_and_slims(setup, monkeypatch,
                                                      caplog, capsys):
    out = str(setup["root"] / "train_net_out")
    steps = []
    real = train_step_mod.make_source_only_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def wrapped(proto, batch, generator=None):
            assert generator is None  # no dropout: comparable to scan_tpu
            steps.append({k: np.array(v) for k, v in batch.items()})
            proto, metrics = step(proto, batch, generator)
            steps[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
            return proto, metrics
        return wrapped

    monkeypatch.setattr(train_step_mod, "make_source_only_train_step",
                        recording)
    train = ("TPU.MAX_BOXES", 4, "INPUT.MIN_SIZE_RANGE_TRAIN", (-1, -1),
             "INPUT.MIN_SIZE_TRAIN", (96,), "INPUT.MAX_SIZE_TRAIN", 128,
             "SOLVER.IMS_PER_BATCH", 2, "MODEL.MIDDLE_HEAD.ATT_DROPOUT", 0.0)
    common = ["--config-file", C2F, *argv(
        "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out, "MODEL.WEIGHT",
        setup["weight"], "SOLVER.CHECKPOINT_PERIOD", 1, *train)]
    caplog.set_level("INFO", logger="scan_tpu_torch")
    train_net.main(common + ["SOLVER.MAX_ITER", "2"])
    assert len(steps) == 2
    assert {"model_0000001.pth", "model_final.pth"} <= set(os.listdir(out))

    jcfg = jax_cfg("MODEL.DA_ON", False, *train)
    params = {k: v for k, v in setup["params"].items()
              if not k.startswith("dis_")}
    opt = jax_make_optimizer(jcfg, params)
    state, proto = opt.init(params), setup["proto"]
    jstep = jax_source_step(jax_build_detector(jcfg), opt)
    for i, rec in enumerate(steps):
        batch = {k: jnp.asarray(rec[k])
                 for k in ("images", "sizes", "boxes", "labels", "mask")}
        params, state, proto, want = jstep(params, state, proto, batch)
        assert set(rec["metrics"]) == set(want)
        for k, v in rec["metrics"].items():
            assert v == pytest.approx(float(want[k]), rel=1e-4), (i, k)

    caplog.clear()
    train_net.main(common + ["SOLVER.MAX_ITER", "3"])
    assert "model_final.pth at iteration 2" in caplog.text
    assert len(steps) == 3
    for var in ("RANK", "WORLD_SIZE", "SCAN_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK expected"):
        train_net.main(["--distributed", *common])

    slim = str(setup["root"] / "slim" / "model_slim.pth")
    assert remove_solver_states.main([out, slim]) == slim
    full = torch.load(os.path.join(out, "model_final.pth"), weights_only=True)
    got = torch.load(slim, weights_only=True)
    assert set(full) - set(got) == {"optimizer", "scheduler"}
    assert set(got) == {"model", "iteration"} and got["iteration"] == 3
    for k, v in full["model"].items():
        assert torch.equal(got["model"][k], v), k
    capsys.readouterr()
    ret = test_net.main(["--config-file", C2F, *argv(
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", slim,
        "OUTPUT_DIR", str(setup["root"] / "slim_test"))])
    assert last_json(capsys) == ret and {"AP", "AP50"} <= set(ret)


EPM = os.path.join(os.path.dirname(__file__), "..", "configs", "epm")
SMALL = ["MODEL.DEVICE", "cpu", "INPUT.MIN_SIZE_TEST", 96,
         "INPUT.MAX_SIZE_TEST", 128, "TEST.IMS_PER_BATCH", 2,
         "TPU.LOADER_THREADS", 2]


def test_test_net_on_the_atss_config(setup, tmp_path, capsys):
    cfg_file = os.path.join(EPM, "da_ga_sim10k_VGG_16_FPN_4x_atss.yaml")
    ann_dir = os.path.join(setup["data"], "Cityscapes", "cocoAnnotations")
    with open(os.path.join(ann_dir, f"{DIM}.json")) as f:
        ann = json.load(f)
    car = ann["categories"][0]["id"]
    ann["annotations"] = [dict(a, category_id=1) for a in ann["annotations"]
                          if a["category_id"] == car]
    ann["categories"] = [dict(ann["categories"][0], id=1, name="car")]
    with open(os.path.join(ann_dir, "cityscapes_val_caronly_cocostyle.json"),
              "w") as f:
        json.dump(ann, f)
    opts = SMALL + ["TPU.VGG_WIDTH_DIV", 8]
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(opts)
    det = build_detector(cfg, device="cpu", seed=3)
    assert type(det.fcos).__name__ == "ATSSHead"
    weight = Checkpointer(str(tmp_path / "ckpt"), det).save("atss")
    calls = []
    real = det.fcos.__class__.forward

    def counting(self, feats):
        calls.append(len(feats))
        return real(self, feats)

    capsys.readouterr()
    try:
        det.fcos.__class__.forward = counting
        ret = test_net.main(["--config-file", cfg_file, *map(str, opts),
                             "MODEL.WEIGHT", weight,
                             "OUTPUT_DIR", str(tmp_path / "out")])
    finally:
        det.fcos.__class__.forward = real
    assert last_json(capsys) == ret and {"AP", "AP50"} <= set(ret)
    assert calls and set(calls) == {5}


def test_train_net_da_r101_from_a_detectron_pickle(setup, tmp_path, caplog,
                                                   monkeypatch):
    cfg_file = os.path.join(EPM, "da_ga_cityscapes_R_101_FPN_4x.yaml")
    narrow = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
              "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
              "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32]
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(narrow)
    assert cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-101"
    body = build_detector(cfg, device="cpu").backbone.body
    blobs = detectron_blobs(body, seed=9)
    cache = tmp_path / "cache"
    cache.mkdir()
    write_pickle(cache / "R-101.pkl", blobs)
    monkeypatch.setenv("SCAN_TPU_CACHE_DIR", str(cache))
    out = str(tmp_path / "r101_out")
    caplog.set_level("INFO", logger="scan_tpu_torch")
    train_net_da.main(["--config-file", cfg_file, *map(str, SMALL + narrow + [
        "OUTPUT_DIR", out, "TPU.MAX_BOXES", 4,
        "INPUT.MIN_SIZE_RANGE_TRAIN", (-1, -1), "INPUT.MIN_SIZE_TRAIN", (96,),
        "INPUT.MAX_SIZE_TRAIN", 128, "SOLVER.IMS_PER_BATCH", 2,
        "SOLVER.MAX_ITER", 2, "SOLVER.VAL_ITER", 2,
        "SOLVER.CHECKPOINT_PERIOD", 2])])
    assert "from the Detectron pickle" in caplog.text
    assert "R-101.pkl (iteration 0)" in caplog.text
    assert "validation @2" in caplog.text
    state = torch.load(os.path.join(out, "model_final.pth"), weights_only=True)
    assert state["iteration"] == 2
    model = state["model"]
    assert torch.equal(model["backbone.body.stem_conv1.weight"],
                       torch.from_numpy(blobs["conv1_w"]))
    assert torch.equal(model["backbone.body.layer1_block2.conv3.weight"],
                       torch.from_numpy(blobs["res2_2_branch2c_w"]))
    assert torch.equal(model["backbone.body.layer1_block0.downsample_bn.bias"],
                       torch.from_numpy(blobs["res2_0_branch1_bn_b"]))
    assert not torch.equal(model["backbone.body.layer4_block2.conv3.weight"],
                           torch.from_numpy(blobs["res5_2_branch2c_w"]))
