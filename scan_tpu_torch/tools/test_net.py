"""Evaluation entry point (counterpart of ``tools/test_net.py``; reference
``tools/test_net.py``).

    python -m scan_tpu_torch.tools.test_net --config-file configs/scan/....yaml \\
        MODEL.WEIGHT path/to/model_final.pth [KEY VALUE ...]

Builds the detector of any config in ``configs/`` (VGG16 or R-101 body,
FCOS or ATSS head) on ``MODEL.DEVICE`` (the card unless ``cpu`` is given),
one loader per ``DATASETS.TEST`` name, loads ``MODEL.WEIGHT`` (a port
checkpoint, a reference ``.pth``, a Detectron ``.pkl``, or a URL or
``catalog://`` name from the weight cache) without the discriminators, evaluates each dataset and prints the results as one JSON
line (a dict per dataset when there are several). Under
``TPU.INT8_INFERENCE`` each dataset gets its own static activation scales,
calibrated over its first ``TPU.INT8_CALIB_BATCHES`` batches from the
un-calibrated state, as ``scan_tpu`` calibrates each from its base
parameters.
"""

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="SCAN evaluation (PyTorch)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from ..config import get_default_cfg
    from ..data.build import make_data_loaders_test
    from ..engine.inference import inference
    from ..modeling.detector import build_detector
    from ..utils.checkpoint import Checkpointer
    from ..utils.collect_env import collect_env_info
    from ..utils.logger import setup_logger

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    logger = setup_logger("scan_tpu_torch", cfg.OUTPUT_DIR)
    logger.info("environment:\n%s", collect_env_info())
    detector = build_detector(cfg, device=cfg.MODEL.DEVICE)
    # one loader per DATASETS.TEST name (reference tools/test_net.py:71-97
    # evaluates each test dataset separately)
    loaders = make_data_loaders_test(cfg)

    ckpt = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "eval_tmp"), detector)
    if cfg.MODEL.WEIGHT:
        ckpt.load(cfg.MODEL.WEIGHT, load_dis=False)

    all_printable = {}
    for name, loader in zip(cfg.DATASETS.TEST, loaders):
        if cfg.TPU.INT8_INFERENCE:
            # static activation scales over the first INT8_CALIB_BATCHES
            # batches of THIS dataset, from the un-calibrated state: a
            # global calibration clips datasets with larger activations
            batches = []
            for _, b in zip(range(int(cfg.TPU.INT8_CALIB_BATCHES)),
                            iter(loader)):
                batches.append(b["images"])
            detector.reset_int8_calibration().calibrate_int8(batches)
            logger.info(
                "int8[%s]: calibrated static activation scales over %d "
                "batches", name, len(batches),
            )
        results, _ = inference(detector, loader)
        printable = {
            k: v for k, v in results.items() if not isinstance(v, dict)
        }
        logger.info("results[%s]: %s", name, printable)
        all_printable[name] = printable
    if len(all_printable) == 1:
        all_printable = next(iter(all_printable.values()))
    print(json.dumps(all_printable), flush=True)
    return all_printable


if __name__ == "__main__":
    main()
