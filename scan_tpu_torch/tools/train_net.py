"""Source-only (plain) training (counterpart of ``tools/train_net.py``;
reference ``tools/train_net.py``).

    python -m scan_tpu_torch.tools.train_net \\
        --config-file configs/scan/scan_vgg16_cityscapace_to_foggy.yaml \\
        [KEY VALUE ...]

    # data-parallel, one process per card
    python -m torch.distributed.run --nproc-per-node N \\
        -m scan_tpu_torch.tools.train_net --distributed --config-file ...

Sets ``MODEL.DA_ON`` False, builds the detector for training on
``MODEL.DEVICE`` (the card unless ``cpu`` is given; float32 masters under a
bf16 ``TPU.COMPUTE_DTYPE``), one SGD over the trainable parameters with
WarmupMultiStep, and the loader of ``DATASETS.TRAIN_SOURCE`` (else
``DATASETS.TRAIN``), and runs ``do_train_plain`` with periodic
checkpoints in ``OUTPUT_DIR``, for any config in ``configs/`` (VGG16,
R-101 or ATSS). ``MODEL.WEIGHT`` is loaded first: an ImageNet VGG16 or a
reference SCAN ``.pth``, a Detectron ``.pkl`` for a ResNet body (a file or a
``catalog://`` name), an ``http(s)`` URL from the local weight cache
(``utils/model_zoo.py``), or a port checkpoint. A run that
finds ``last_checkpoint`` in ``OUTPUT_DIR`` resumes from it instead, and the
loader skips to the restored iteration. ``--distributed`` trains
data-parallel as ``tools/train_net_da.py`` does (``SOLVER.IMS_PER_BATCH``
must split over the processes; rank 0 alone logs and writes checkpoints).
``TPU.DEBUG_NANS`` is not ported and raises.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="SCAN source-only training "
                                                 "(PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from ..config import get_default_cfg
    from ..parallel.mesh import process_group

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.MODEL.DA_ON = False
    cfg.freeze()
    if cfg.TPU.DEBUG_NANS:
        raise NotImplementedError("TPU.DEBUG_NANS is not ported; the loop "
                                  "checks every step's loss_total instead")

    with process_group(args.distributed, cfg.MODEL.DEVICE):
        return _run(args, cfg)


def _run(args, cfg):
    from ..data.build import make_data_loader_train
    from ..engine.dp import build_source_only_train_step
    from ..engine.trainer import do_train_plain
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
        check_split(world, **{"SOLVER.IMS_PER_BATCH": cfg.SOLVER.IMS_PER_BATCH})
        logger.info("data-parallel over %d processes", world)

    detector = build_detector(cfg, device=cfg.MODEL.DEVICE, seed=1234,
                              train=True)
    optimizer = make_optimizer(cfg, detector)
    scheduler = make_lr_scheduler(cfg, optimizer)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR, detector, optimizer,
                                scheduler)
    start_iter = checkpointer.load(cfg.MODEL.WEIGHT)
    broadcast_module(detector)
    loader = make_data_loader_train(cfg, start_iter=start_iter)
    train_step = build_source_only_train_step(detector, optimizer, scheduler)
    return do_train_plain(cfg, detector, train_step, detector.proto_state(),
                          loader, checkpointer if is_main_process() else None,
                          start_iter=start_iter)


if __name__ == "__main__":
    main()
