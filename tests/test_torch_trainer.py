"""The port's DA training loop (``engine/trainer.py``), on the CPU.

* ``do_train_da`` over four iterations of the real port step (C2F at VGG
  width / 8, seeded weights and batches) with a stub validation every two
  that returns AP50 0.5, then 0.45: ``forward_target`` turns on after the
  first validation (50 > INITIAL_AP50 30, ``trainer.py:150``), the best
  metric and the checkpoint names follow ``trainer.py:197-206``, and every
  step gets a dropout generator seeded from its iteration.
* ``FiniteGuard`` pipelined: with a non-finite ``loss_total`` at steps 3 and
  4, the loop raises for step 3, after step 4 was issued and before step
  4's validation.
* ``do_train_plain`` over two source-only steps.
* ``check_finite`` and ``to_percent_ap``.
"""

import math
import os

import numpy as np
import pytest
import torch

from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine import inference as inference_mod
from scan_tpu_torch.engine import trainer
from scan_tpu_torch.engine.train_step import (make_da_train_step,
                                               make_source_only_train_step)
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")


def tiny_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 32
    cfg.TPU.MAX_TARGET_POINTS = 32
    cfg.TPU.MAX_BOXES = 4
    cfg.TPU.VGG_WIDTH_DIV = 8
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.VAL_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 3
    return cfg


def loader(seed, with_targets=True):
    rng = np.random.RandomState(seed)
    while True:
        batch = dict(images=rng.randint(0, 256, (1, 64, 96, 3)).astype(np.uint8),
                     sizes=np.asarray([[64, 96]], np.int32))
        if with_targets:
            batch.update(boxes=np.asarray([[[8, 8, 40, 44], [30, 20, 70, 60],
                                            [0, 0, 0, 0], [0, 0, 0, 0]]],
                                          np.float32),
                         labels=np.asarray([[2, 6, 0, 0]], np.int32),
                         mask=np.asarray([[True, True, False, False]]))
        yield batch


class Recorder:
    def __init__(self):
        self.saved = []

    def save(self, name, iteration):
        self.saved.append((name, iteration))


def test_do_train_da_gates_and_bookkeeping(monkeypatch):
    cfg = tiny_cfg()
    det = build_detector(cfg, device="cpu")
    opt = make_optimizer(cfg, det)
    step = make_da_train_step(det, opt, make_lr_scheduler(cfg, opt))
    calls = []

    def recording_step(proto, bs, bt, forward_target=False, generator=None):
        calls.append((forward_target, generator.initial_seed()))
        return step(proto, bs, bt, forward_target=forward_target,
                    generator=generator)

    aps = iter([0.5, 0.45])
    validated = []

    def stub_inference(detector, data_loader):
        validated.append(int(detector.proto_counter))
        return {"AP50": next(aps)}, {}

    monkeypatch.setattr(inference_mod, "inference", stub_inference)
    ckpt = Recorder()
    proto, best = trainer.do_train_da(
        cfg, det, recording_step, det.proto_state(), loader(0),
        loader(1, with_targets=False), loader_val=[], checkpointer=ckpt)
    assert [ft for ft, _ in calls] == [False, False, True, True]
    seeds = [s for _, s in calls]
    assert len(set(seeds)) == 4
    assert seeds[0] == trainer._dropout_generator(cfg, "cpu", 0).initial_seed()
    assert best == pytest.approx(50.0)
    assert validated == [1, 3]  # the prototype state after steps 2 and 4
    assert ckpt.saved == [("model_50.0000_2", 2), ("model_0000003", 3),
                          ("model_final", 4)]
    assert int(proto.counter) == 3  # the RNN counter saturates at ITER


def test_finite_guard_raises_for_the_first_bad_step_in_order(monkeypatch):
    cfg = tiny_cfg()
    cfg.SOLVER.VAL_ITER = 4
    det = build_detector(cfg, device="cpu")
    issued = []

    def fake_step(proto, bs, bt, forward_target=False, generator=None):
        it = len(issued) + 1
        issued.append(it)
        bad = float("nan") if it == 3 else float("inf") if it == 4 else 1.0
        return proto, {"loss_total": torch.tensor(bad)}

    validated = []
    monkeypatch.setattr(inference_mod, "inference",
                        lambda d, l: validated.append(1) or ({"AP50": 0.1}, {}))
    with pytest.raises(FloatingPointError, match="at iter 3"):
        trainer.do_train_da(cfg, det, fake_step, det.proto_state(),
                            loader(0), loader(1, False), loader_val=[])
    assert issued == [1, 2, 3, 4] and validated == []


def test_do_train_plain_runs_the_source_only_step():
    cfg = tiny_cfg()
    cfg.SOLVER.MAX_ITER = 2
    det = build_detector(cfg, device="cpu")
    opt = make_optimizer(cfg, det)
    step = make_source_only_train_step(det, opt, make_lr_scheduler(cfg, opt))
    w = det.fcos.cls_logits.weight.detach().clone()
    ckpt = Recorder()
    proto = trainer.do_train_plain(cfg, det, step, det.proto_state(),
                                   loader(2), checkpointer=ckpt)
    assert int(proto.counter) == 1
    assert not torch.equal(det.fcos.cls_logits.weight, w)
    assert ckpt.saved == [("model_final", 2)]


def test_check_finite_and_percent_ap():
    trainer.check_finite({"a": 1.0, "b": 0.0}, 1)
    with pytest.raises(FloatingPointError, match="'b': nan"):
        trainer.check_finite({"a": 1.0, "b": math.nan}, 7)
    assert trainer.to_percent_ap(0.423) == pytest.approx(42.3)
    with pytest.raises(ValueError):
        trainer.to_percent_ap(42.3)
    guard = trainer.FiniteGuard()
    guard.check()  # nothing armed
    guard.arm(5, torch.tensor(2.0))
    guard.check()
    guard.arm(6, torch.tensor(float("-inf")))
    with pytest.raises(FloatingPointError, match="iter 6"):
        guard.check()
