"""Training loops (counterpart of ``scan_tpu/engine/trainer.py``).

Parity target: reference ``fcos_core/engine/trainer.py:124-495``:
  * the zipped source/target iteration with one optimizer step;
  * the AP50-gated target GST pass (``forward_target = AP50 >
    SOLVER.INITIAL_AP50``, trainer.py:350);
  * in-training COCO validation every SOLVER.VAL_ITER, with the best AP50
    checkpointed as ``model_{AP50:.4f}_{iter}`` (trainer.py:465-479);
  * smoothed metric logging with an ETA.

The parameters live in the detector and the optimizer, so the loops take
and return the prototype state only. ``checkpointer`` may be None; when
given it is called as ``checkpointer.save(name, iteration=it)`` and saves
what it was built with. The condgraph MHA's train-time dropout draws from a
``torch.Generator`` seeded per (base seed, iteration), so a run resumed at
iteration k replays the masks of k onwards.
"""

import datetime
import logging
import math
import time
from typing import Optional

import torch

from ..utils.metric_logger import MetricLogger

logger = logging.getLogger("scan_tpu_torch.trainer")

DROPOUT_SEED = 1234  # reference setup_seed(1234)


def check_finite(host_metrics: dict, it: int) -> None:
    """Raise on a non-finite loss: NaN gradients have already poisoned the
    parameters, and going on only trains garbage."""
    bad = {k: v for k, v in host_metrics.items() if not math.isfinite(v)}
    if bad:
        raise FloatingPointError(
            f"non-finite training metrics at iter {it}: {bad}; the "
            "parameters are NaN-poisoned, resume from the last healthy "
            "checkpoint")


class FiniteGuard:
    """Per-step first-failure latch on ``loss_total``
    (``scan_tpu/engine/trainer.py:44-84``), pipelined.

    ``arm`` queues a copy of step k's scalar into pinned host memory and
    records an event behind it; ``check``, called once step k + 1 is
    queued, waits for that event only, not for step k + 1, and raises if
    the value is not finite. So a NaN at step k raises in iteration
    k + 1's loop body, before any validation or checkpoint of it, and the
    read costs the card no idle time.
    """

    def __init__(self):
        self._pending = None  # (iter, host scalar, event or None)

    def arm(self, it: int, loss_total) -> None:
        event = None
        if loss_total.is_cuda:
            host = torch.empty((), dtype=loss_total.dtype, pin_memory=True)
            host.copy_(loss_total, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = loss_total
        self._pending = (it, host, event)

    def check(self) -> None:
        if self._pending is None:
            return
        it, host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        val = float(host)
        if not math.isfinite(val):
            raise FloatingPointError(
                f"non-finite loss_total={val} at iter {it}; the parameters "
                "are NaN-poisoned, resume from the last healthy checkpoint")


def to_percent_ap(cur: float) -> float:
    """The evaluator reports fractions in [0, 1]; SOLVER.INITIAL_AP50 is in
    percent (reference trainer.py:350)."""
    cur = float(cur)
    if not 0.0 <= cur <= 1.0:
        raise ValueError(f"validation metric {cur} is not a fraction; the "
                         "evaluator's contract (fractions in [0, 1]) broke")
    return cur * 100.0


def _dropout_generator(cfg, device, iteration: int):
    """A generator for the MHA's dropout at ``iteration``, or None when the
    config trains without dropout (``trainer.py:132-137``)."""
    mh = cfg.MODEL.MIDDLE_HEAD
    if not (mh.CONDGRAPH_ON and mh.GLOBAL_GCN and mh.ATT_DROPOUT > 0.0):
        return None
    gen = torch.Generator(device=device)
    return gen.manual_seed(DROPOUT_SEED * 1_000_003 + iteration)


def _step_keys(batch):
    return {k: batch[k] for k in ("images", "sizes", "boxes", "labels", "mask")}


def do_train_da(cfg, detector, train_step, proto_state, loader_source,
                loader_target, loader_val=None, checkpointer=None,
                start_iter: int = 0, initial_ap50: Optional[float] = None):
    """The DA loop (``trainer.py:100-211``). Returns (proto_state,
    best_metric)."""
    device = next(detector.parameters()).device
    meters = MetricLogger()
    max_iter = cfg.SOLVER.MAX_ITER
    val_iter = cfg.SOLVER.VAL_ITER
    val_type = cfg.SOLVER.VAL_TYPE
    ap50_emp = initial_ap50 if initial_ap50 is not None else 0.0
    best_metric = ap50_emp

    logger.info("Start DA training: %d iterations", max_iter)
    end = time.time()
    data_time_acc = 0.0
    window = 0
    src_iter, tgt_iter = iter(loader_source), iter(loader_target)
    finite_guard = FiniteGuard()
    for iteration in range(start_iter, max_iter):
        t0 = time.time()
        batch_s = _step_keys(next(src_iter))
        batch_t = {"images": next(tgt_iter)["images"]}
        data_time_acc += time.time() - t0
        window += 1

        forward_target = bool(ap50_emp > cfg.SOLVER.INITIAL_AP50)
        proto_state, metrics = train_step(
            proto_state, batch_s, batch_t, forward_target=forward_target,
            generator=_dropout_generator(cfg, device, iteration))
        it = iteration + 1
        # step k + 1 is queued: read step k's scalar
        finite_guard.check()
        finite_guard.arm(it, metrics["loss_total"])

        if it % 20 == 0 or it == max_iter:
            host_metrics = {k: float(v) for k, v in metrics.items()}
            check_finite(host_metrics, it)
            meters.update(time=(time.time() - end) / window,
                          data=data_time_acc / window, **host_metrics)
            data_time_acc = 0.0
            window = 0
            eta = datetime.timedelta(
                seconds=int(meters.time.global_avg * (max_iter - it)))
            logger.info("eta: %s  iter: %d  %s  fwd_tgt: %s", eta, it,
                        str(meters), forward_target)
            end = time.time()

        # ---- in-training validation + best checkpoint ----
        if (cfg.SOLVER.ADAPT_VAL_ON and loader_val is not None
                and it % val_iter == 0):
            from . import inference as inference_mod

            results, _ = inference_mod.inference(detector, loader_val)
            cur = float(results.get(val_type, results.get("AP50", 0.0)))
            ap50_emp = to_percent_ap(cur)
            logger.info("validation @%d: %s=%.4f", it, val_type, ap50_emp)
            if ap50_emp > best_metric:
                best_metric = ap50_emp
                if checkpointer is not None:
                    checkpointer.save(f"model_{ap50_emp:.4f}_{it}",
                                      iteration=it)

        if checkpointer is not None and it % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            checkpointer.save(f"model_{it:07d}", iteration=it)

    finite_guard.check()  # the last step's scalar
    if checkpointer is not None:
        checkpointer.save("model_final", iteration=max_iter)
    return proto_state, best_metric


def do_train_plain(cfg, detector, train_step, proto_state, loader,
                   checkpointer=None, start_iter: int = 0):
    """Source-only training (reference trainer.py:153-240). Returns the
    prototype state."""
    device = next(detector.parameters()).device
    meters = MetricLogger()
    max_iter = cfg.SOLVER.MAX_ITER
    end = time.time()
    it = start_iter
    finite_guard = FiniteGuard()
    for iteration, batch in enumerate(loader, start_iter):
        data_time = time.time() - end
        proto_state, metrics = train_step(
            proto_state, _step_keys(batch),
            generator=_dropout_generator(cfg, device, iteration))
        it = iteration + 1
        finite_guard.check()
        finite_guard.arm(it, metrics["loss_total"])
        if it % 20 == 0 or it == max_iter:
            host_metrics = {k: float(v) for k, v in metrics.items()}
            check_finite(host_metrics, it)
            meters.update(time=(time.time() - end) / 20, data=data_time,
                          **host_metrics)
            eta = datetime.timedelta(
                seconds=int(meters.time.global_avg * (max_iter - it)))
            logger.info("eta: %s  iter: %d  %s", eta, it, str(meters))
            end = time.time()
        if checkpointer is not None and it % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            checkpointer.save(f"model_{it:07d}", iteration=it)
        if it >= max_iter:
            break
    finite_guard.check()
    if checkpointer is not None:
        checkpointer.save("model_final", iteration=it)
    return proto_state
