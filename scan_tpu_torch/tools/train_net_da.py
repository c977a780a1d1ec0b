"""Adversarial domain-adaptation training, the main SCAN entry point
(counterpart of ``tools/train_net_da.py``; reference ``tools/train_net_da.py``).

    python -m scan_tpu_torch.tools.train_net_da \\
        --config-file configs/scan/scan_vgg16_cityscapace_to_foggy.yaml \\
        [--test-only] [--use-tensorboard] [KEY VALUE ...]

    # data-parallel, one process per card
    python -m torch.distributed.run --nproc-per-node N \\
        -m scan_tpu_torch.tools.train_net_da --distributed \\
        --config-file ... [KEY VALUE ...]

Builds the detector for training on ``MODEL.DEVICE`` (the card unless
``cpu`` is given; float32 masters under a bf16 ``TPU.COMPUTE_DTYPE``) with
its per-level discriminators, one SGD over the trainable parameters with
WarmupMultiStep, the source, target and validation loaders, and runs the
DA loop with in-training validation, periodic and best-AP50 checkpoints in
``OUTPUT_DIR``. Every config in ``configs/`` runs as written: the VGG16
ones, the R-101 ones (``R-101-FPN-RETINANET``) and the ATSS one.
``MODEL.WEIGHT`` is loaded first: an ImageNet VGG16 or a reference SCAN
``.pth``, a Detectron ``.pkl`` (the ImageNet R-101 of
``catalog://ImageNetPretrained/MSRA/R-101`` or a file path; into the ResNet
body, at iteration 0, no solver state), an ``http(s)`` URL or ``catalog://``
name resolved to the local weight cache (``utils/model_zoo.py``; nothing is
fetched, a file missing there raises with its path), or a port checkpoint
(``./model_GA.pth`` of a GA run). A run that finds its ``last_checkpoint`` in
``OUTPUT_DIR`` resumes from it instead: the parameters, prototype,
momentum and schedule are restored and both training streams skip to the
restored iteration.

``--distributed`` (or ``SCAN_TPU_DISTRIBUTED=1``) starts a process group
from ``torch.distributed.run``'s environment: NCCL on the card (each rank on
``cuda:LOCAL_RANK``), gloo under ``MODEL.DEVICE cpu``; a failed start raises.
Over N > 1 processes ``SOLVER.IMS_PER_BATCH`` and ``TEST.IMS_PER_BATCH`` must
split evenly (else it raises): every rank's loaders yield the same global
batches and each rank trains and validates on its slice, one all-reduce a
step (``engine/dp.py``); rank 0 alone logs, writes checkpoints and
TensorBoard, and scores the validation. ``--use-tensorboard`` writes the
loop's scalars to ``OUTPUT_DIR/tb`` (``utils/tensorboard.py``).
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="SCAN DA training (PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--use-tensorboard", action="store_true")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from ..config import get_default_cfg
    from ..parallel.mesh import process_group

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    if cfg.TPU.DEBUG_NANS:
        raise NotImplementedError("TPU.DEBUG_NANS is not ported; the loop "
                                  "checks every step's loss_total instead")

    with process_group(args.distributed, cfg.MODEL.DEVICE):
        return _run(args, cfg)


def _run(args, cfg):
    from ..data.build import (make_data_loader_source,
                              make_data_loader_target, make_data_loader_test)
    from ..engine.dp import build_da_train_step
    from ..engine.inference import inference
    from ..engine.trainer import do_train_da
    from ..modeling.detector import build_detector
    from ..parallel.mesh import (broadcast_module, check_split, get_rank,
                                 get_world_size, is_main_process)
    from ..solver.build import make_lr_scheduler, make_optimizer
    from ..utils.checkpoint import Checkpointer
    from ..utils.collect_env import collect_env_info
    from ..utils.logger import setup_logger

    world = get_world_size()
    logger = setup_logger("scan_tpu_torch", cfg.OUTPUT_DIR,
                          distributed_rank=get_rank())
    logger.info("environment:\n%s", collect_env_info())
    logger.info("config:\n%s", args.config_file)
    if world > 1:
        check_split(world, **{"SOLVER.IMS_PER_BATCH": cfg.SOLVER.IMS_PER_BATCH,
                              "TEST.IMS_PER_BATCH": cfg.TEST.IMS_PER_BATCH})
        logger.info("data-parallel over %d processes", world)

    detector = build_detector(cfg, device=cfg.MODEL.DEVICE, seed=1234,
                              train=True)
    loader_src = make_data_loader_source(cfg)
    optimizer = make_optimizer(cfg, detector)
    scheduler = make_lr_scheduler(cfg, optimizer)

    checkpointer = Checkpointer(cfg.OUTPUT_DIR, detector, optimizer,
                                scheduler)
    start_iter = checkpointer.load(cfg.MODEL.WEIGHT)
    broadcast_module(detector)

    # resume mid-schedule: the loaders skip to the restored iteration so
    # the stream matches what an uninterrupted run would have seen
    # (reference make_data_loader(start_iter), data/build.py:107-127)
    loader_src.start_iter = start_iter
    loader_val = make_data_loader_test(cfg)

    if args.test_only:
        results, _ = inference(detector, loader_val)
        logger.info("test results: %s", {k: v for k, v in results.items()
                                          if not isinstance(v, dict)})
        return results

    tb_logger = None
    if args.use_tensorboard and is_main_process():
        from ..utils.tensorboard import TensorboardLogger

        tb_logger = TensorboardLogger(os.path.join(cfg.OUTPUT_DIR, "tb"))

    loader_tgt = make_data_loader_target(cfg, start_iter=start_iter)
    train_step = build_da_train_step(detector, optimizer, scheduler)
    _, best = do_train_da(
        cfg, detector, train_step, detector.proto_state(), loader_src,
        loader_tgt, loader_val,
        checkpointer if is_main_process() else None, start_iter=start_iter,
        tb_logger=tb_logger)
    if tb_logger is not None:
        tb_logger.flush()
    return best


if __name__ == "__main__":
    main()
