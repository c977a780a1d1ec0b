"""Bisect a mid-training NaN (counterpart of ``tools/nan_bisect.py``):
resume from a checkpoint and step with a finiteness check on every loss
term after each iteration.

    python -m scan_tpu_torch.tools.nan_bisect --config-file CFG \\
        --ckpt OUT/model_0001750.pth --until 1860 [--fwd-tgt] \\
        [--save-prev DIR] [KEY VALUE ...]

The loaders are keyed by (seed, iteration, slot) and the condgraph's
dropout draws from a generator seeded per iteration
(``engine/trainer.py``), so any window of a run replays exactly from its
last healthy checkpoint and the first non-finite step can be pinned
without rerunning the schedule. The metrics are computed before the update
they feed, so two parameters are read after each update as well (the
largest FCOS ``scale0`` and ``|bbox_pred.weight|``). ``--save-prev DIR``
writes the state before the offending step (``prenan.pth``) and its
batches (``batches.npz``). Exit status 1 when a non-finite value is found.
"""

import argparse
import copy
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--until", type=int, required=True)
    ap.add_argument("--fwd-tgt", action="store_true")
    ap.add_argument("--save-prev", default="",
                    help="dir to save the state of the last finite "
                         "iteration and the offending batches")
    ap.add_argument("overrides", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from ..config import get_default_cfg
    from ..data.build import make_data_loader_source, make_data_loader_target
    from ..engine.train_step import make_da_train_step
    from ..engine.trainer import _dropout_generator
    from ..modeling.detector import build_detector
    from ..solver.build import make_lr_scheduler, make_optimizer
    from ..utils.checkpoint import Checkpointer

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.overrides:
        cfg.merge_from_list(args.overrides)
    cfg.freeze()

    detector = build_detector(cfg, device=cfg.MODEL.DEVICE, seed=1234,
                              train=True)
    device = next(detector.parameters()).device
    optimizer = make_optimizer(cfg, detector)
    scheduler = make_lr_scheduler(cfg, optimizer)
    # not dirname(ckpt): Checkpointer.load prefers a last_checkpoint pointer
    # in its own directory over the explicit path, which there would name
    # the run's last (corrupt) checkpoint
    ckpt = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "bisect_scratch"),
                        detector, optimizer, scheduler)
    start_iter = ckpt.load(args.ckpt)
    print(f"restored {args.ckpt} at iteration {start_iter}", flush=True)

    loader_src = make_data_loader_source(cfg, start_iter=start_iter)
    loader_tgt = make_data_loader_target(cfg, start_iter=start_iter)
    for loader in (loader_src, loader_tgt):
        loader.max_iters = args.until  # the streams stop where we stop
    train_step = make_da_train_step(detector, optimizer, scheduler)
    src_iter, tgt_iter = iter(loader_src), iter(loader_tgt)
    proto = detector.proto_state()
    prev = None
    for iteration in range(start_iter, args.until):
        batch_s = {k: v for k, v in next(src_iter).items()
                   if k in ("images", "sizes", "boxes", "labels", "mask")}
        batch_t = {"images": next(tgt_iter)["images"]}
        if args.save_prev:  # copies: the step updates the live tensors
            prev = (copy.deepcopy(detector.state_dict()),
                    copy.deepcopy(optimizer.state_dict()),
                    copy.deepcopy(scheduler.state_dict()), batch_s, batch_t)
        proto, metrics = train_step(
            proto, batch_s, batch_t, forward_target=args.fwd_tgt,
            generator=_dropout_generator(cfg, device, iteration))
        host = {k: float(v) for k, v in metrics.items()}
        host["sent_scale0"] = float(detector.fcos.scale0.scale.detach().max())
        host["sent_bbox_w"] = float(
            detector.fcos.bbox_pred.weight.detach().abs().max())
        bad = {k: v for k, v in host.items() if not np.isfinite(v)}
        it = iteration + 1
        if it % 10 == 0 or bad or it == args.until:
            print(f"iter {it}: loss_total={host['loss_total']:.4f} "
                  f"nonfinite={sorted(bad)}", flush=True)
        if bad:
            print(f"FIRST NONFINITE at iter {it}: {bad}", flush=True)
            if args.save_prev:
                save_prev(args.save_prev, detector, optimizer, scheduler,
                          prev, it - 1)
            return 1
    print("no nonfinite value reached", flush=True)
    return 0


def save_prev(out_dir, detector, optimizer, scheduler, prev, iteration):
    """The state before the offending step and its batches."""
    import torch

    from ..utils.checkpoint import Checkpointer

    model, opt, sched, batch_s, batch_t = prev
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "batches.npz"),
             **{f"s_{k}": np.asarray(v) for k, v in batch_s.items()},
             **{f"t_{k}": np.asarray(v) for k, v in batch_t.items()})
    with torch.no_grad():
        detector.load_state_dict(model)
    optimizer.load_state_dict(opt)
    scheduler.load_state_dict(sched)
    Checkpointer(out_dir, detector, optimizer, scheduler).save(
        "prenan", iteration=iteration)
    print(f"saved pre-nan state + batches to {out_dir}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
