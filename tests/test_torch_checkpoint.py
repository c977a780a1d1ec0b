"""The port's ``Checkpointer`` (``utils/checkpoint.py``), on the CPU.

* A save/load round trip restores the parameters, the prototype and its
  counter, the int8 |x|max buffers (and each conv's ``calibrated`` set),
  the SGD momentum, the scheduler's ``last_epoch`` and the iteration, from
  a file that ``torch.load(weights_only=True)`` reads.
* ``load`` prefers the ``last_checkpoint`` pointer over the file it is
  given; refuses a file that lacks a model key or a ``model`` entry, and a
  URL; ``load_dis=False`` keeps the detector's discriminators; a training
  checkpoint loads into an eval detector, fp or int8.
* Resume equivalence through the real loaders (the synthetic Cityscapes
  tree of ``test_torch_data.py``, 96x128, C2F at VGG width / 8): 4 straight
  DA iterations equal 2 iterations, a save, a restore into a fresh
  detector and optimizer, and 2 more; parameters, momentum and prototype
  exactly equal (``tests/test_e2e_train.py``'s pattern for ``scan_tpu``).
"""

import os

import numpy as np
import pytest
import torch

from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.data.build import (make_data_loader_source,
                                       make_data_loader_target)
from scan_tpu_torch.engine.train_step import make_da_train_step
from scan_tpu_torch.engine.trainer import do_train_da
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.modeling.layers import NO_SCALE
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_torch_data import make_trees

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")


def small_cfg(*opts):
    """C2F at VGG width / 8 with 1-conv towers on 96x128 frames, the CPU."""
    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "TPU.VGG_WIDTH_DIV", 8,
        "MODEL.FCOS.NUM_CONVS_REG", 1, "MODEL.FCOS.NUM_CONVS_CLS", 1,
        "TPU.MAX_NODES", 32, "TPU.MAX_TARGET_POINTS", 32, "TPU.MAX_BOXES", 4,
        "INPUT.MIN_SIZE_RANGE_TRAIN", (-1, -1), "INPUT.MIN_SIZE_TRAIN", (96,),
        "INPUT.MAX_SIZE_TRAIN", 128, "INPUT.MIN_SIZE_TEST", 96,
        "INPUT.MAX_SIZE_TEST", 128, "SOLVER.IMS_PER_BATCH", 2,
        "TEST.IMS_PER_BATCH", 2, "TPU.LOADER_THREADS", 2, *opts])
    return cfg


def seeded_batches(seed, b=2, h=96, w=128):
    rng = np.random.RandomState(seed)
    bs = dict(images=rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
              sizes=np.asarray([[h, w]] * b, np.int32),
              boxes=np.asarray([[[8, 8, 60, 50], [40, 30, 100, 90],
                                 [0, 0, 0, 0], [0, 0, 0, 0]]] * b, np.float32),
              labels=np.asarray([[2, 6, 0, 0]] * b, np.int32),
              mask=np.asarray([[True, True, False, False]] * b))
    return bs, dict(images=rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8))


def trained(cfg, steps=1, seed=0):
    det = build_detector(cfg, device="cpu", seed=seed)
    opt = make_optimizer(cfg, det)
    sched = make_lr_scheduler(cfg, opt)
    step = make_da_train_step(det, opt, sched)
    for i in range(steps):
        step(det.proto_state(), *seeded_batches(i))
    return det, opt, sched


def momenta(opt):
    return [opt.state[p]["momentum_buffer"] for g in opt.param_groups
            for p in g["params"]]


def assert_state_equal(a, b, skip=()):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if not k.startswith(skip):
            assert torch.equal(sa[k], sb[k]), k


def test_round_trip_restores_everything(tmp_path):
    cfg = small_cfg()
    det, opt, sched = trained(cfg, steps=1)
    ckpt = Checkpointer(str(tmp_path), det, opt, sched)
    path = ckpt.save("model_0000001", iteration=1)
    assert path.endswith("model_0000001.pth")
    state = torch.load(path, weights_only=True)
    assert sorted(state) == ["iteration", "model", "optimizer", "scheduler"]

    det2, opt2, sched2 = trained(cfg, steps=0, seed=5)
    it = Checkpointer(str(tmp_path), det2, opt2, sched2).load()
    assert it == 1
    assert_state_equal(det2, det)
    assert int(det2.proto_counter) == int(det.proto_counter) >= 0  # from -1
    for m2, m in zip(momenta(opt2), momenta(opt)):
        assert torch.equal(m2, m)
    assert sched2.last_epoch == sched.last_epoch == 1
    assert sched2.get_last_lr() == sched.get_last_lr()


def test_int8_scales_and_calibrated_sets_round_trip(tmp_path):
    cfg = small_cfg("TPU.INT8_INFERENCE", True)
    det = build_detector(cfg, device="cpu")
    det.calibrate_int8([seeded_batches(0)[0]["images"]])
    convs = {n: m for n, m in det.named_modules() if hasattr(m, "scale_names")}
    assert all(m.calibrated for m in convs.values())
    Checkpointer(str(tmp_path), det).save("calibrated")

    fresh = build_detector(cfg, device="cpu", seed=3)
    assert not any(m.calibrated for _, m in fresh.named_modules()
                   if hasattr(m, "scale_names"))
    Checkpointer(str(tmp_path), fresh).load()
    assert_state_equal(fresh, det)
    for n, m in fresh.named_modules():
        if n in convs:
            assert m.calibrated == convs[n].calibrated, n
    images = torch.from_numpy(seeded_batches(1)[0]["images"])
    sizes = torch.tensor([[96, 128]] * 2)
    for k, v in det.forward_inference(images, sizes).items():
        assert torch.equal(fresh.forward_inference(images, sizes)[k], v), k


def test_pointer_first_then_the_given_file(tmp_path):
    cfg = small_cfg()
    det, _, _ = trained(cfg, steps=0)
    a = Checkpointer(str(tmp_path / "a"), det)
    first = a.save("first", iteration=1)
    a.save("second", iteration=2)
    assert a.get_checkpoint_file().endswith("second.pth")
    assert a.load(first) == 2  # the pointer wins
    b = Checkpointer(str(tmp_path / "b"), det)
    assert not b.has_checkpoint()
    assert b.load(first) == 1
    assert b.load("") == 0


def test_refusals(tmp_path):
    cfg = small_cfg()
    det, _, _ = trained(cfg, steps=0)
    sd = det.state_dict()
    sd.pop("fcos.cls_logits.weight")
    torch.save({"model": sd, "iteration": 3}, tmp_path / "cut.pth")
    torch.save({"iteration": 3}, tmp_path / "nomodel.pth")
    ckpt = Checkpointer(str(tmp_path / "out"), det)
    with pytest.raises(ValueError, match="fcos.cls_logits.weight"):
        ckpt.load(str(tmp_path / "cut.pth"))
    with pytest.raises(ValueError, match="no 'model'"):
        ckpt.load(str(tmp_path / "nomodel.pth"))
    url = "https://example.org/vgg16_caffe.pth"
    with pytest.raises(ValueError, match="example.org"):
        ckpt.load(url)


def test_load_dis_false_keeps_the_discriminators(tmp_path):
    cfg = small_cfg()
    det, _, _ = trained(cfg, steps=1)
    path = Checkpointer(str(tmp_path), det).save("model_final", 1)
    other = build_detector(cfg, device="cpu", seed=9)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    assert Checkpointer(str(tmp_path / "eval"), other).load(
        path, load_dis=False) == 1
    dis = [k for k in before if k.startswith("dis_")]
    assert dis
    for k, v in other.state_dict().items():
        want = before[k] if k.startswith("dis_") else det.state_dict()[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("int8", [False, True])
def test_training_checkpoint_loads_for_eval(tmp_path, int8):
    cfg = small_cfg()
    det, opt, sched = trained(cfg, steps=1)
    path = Checkpointer(str(tmp_path), det, opt, sched).save("model_final", 1)
    ecfg = small_cfg("TPU.INT8_INFERENCE", int8, "TPU.COMPUTE_DTYPE",
                     "bfloat16")
    ev = build_detector(ecfg, device="cpu", seed=4)
    Checkpointer(str(tmp_path / "eval_tmp"), ev).load(path, load_dis=False)
    want = det.state_dict()
    for k, v in ev.state_dict().items():
        if k.endswith(".amax") or k.endswith("_act"):
            assert float(v) == NO_SCALE, k
        elif not k.startswith("dis_"):
            assert torch.equal(v, want[k].to(v.dtype)), k
    assert not any(getattr(m, "calibrated", None) for m in ev.modules())


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "data")
    make_trees(d)
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", d)
    return d


def test_resume_equals_a_straight_run(tmp_path, data_dir):
    cfg = small_cfg("SOLVER.VAL_ITER", 100, "SOLVER.CHECKPOINT_PERIOD", 2,
                    "MODEL.MIDDLE_HEAD.ATT_DROPOUT", 0.1)

    def run(max_iter, out, det, opt, sched, start_iter=0):
        cfg.SOLVER.MAX_ITER = max_iter
        src = make_data_loader_source(cfg)
        src.start_iter = start_iter
        tgt = make_data_loader_target(cfg, start_iter=start_iter)
        ckpt = Checkpointer(out, det, opt, sched)
        do_train_da(cfg, det, make_da_train_step(det, opt, sched),
                    det.proto_state(), src, tgt, None, ckpt,
                    start_iter=start_iter)
        return ckpt

    straight = trained(cfg, steps=0)
    run(4, str(tmp_path / "straight"), *straight)

    first = trained(cfg, steps=0)
    run(2, str(tmp_path / "resumed"), *first)
    resumed = trained(cfg, steps=0, seed=7)
    ckpt = Checkpointer(str(tmp_path / "resumed"), *resumed)
    it = ckpt.load()
    assert it == 2
    run(4, str(tmp_path / "resumed"), *resumed, start_iter=it)

    assert_state_equal(resumed[0], straight[0])
    assert int(resumed[0].proto_counter) > 0
    for a, b in zip(momenta(resumed[1]), momenta(straight[1])):
        assert torch.equal(a, b)
    assert resumed[2].last_epoch == straight[2].last_epoch == 4
