"""The system under test: ``scan_tpu_torch``, built from a config file of
``benchmark/configs`` and the seeded weights of ``weights.py``. This is
the one module of the harness that imports the port."""

import warnings

import torch

from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.train_step import make_da_train_step
from scan_tpu_torch.modeling.detector import SCANDetector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer


def port_cfg(cfg_dict, work):
    """The port's config: its defaults, the config file's whole ``cfg``
    merged over them, the workload's ``precision`` as its compute dtype,
    then the workload's ``overrides`` (a flat key/value list)."""
    cfg = get_default_cfg()
    cfg._merge_dict(cfg_dict, [])
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", work["precision"],
                         *work.get("overrides", [])])
    return cfg


def build_detector(cfg, weights, device, train):
    """``SCANDetector`` built on the card with ``weights`` loaded, as
    ``build_detector`` returns it (float32 masters when ``train``, else
    parameters in the compute dtype; ``eval()`` either way)."""
    with torch.device(device):
        det = SCANDetector(cfg)
    missing, unexpected = det.load_state_dict(weights, strict=False)
    # an int8 detector's |x|max buffers start empty and are calibrated
    missing = [k for k in missing if not k.endswith(("_act", ".amax"))]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the detector: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    return det.set_compute_dtype(cast_params=not train).eval()


def build_da_step(cfg, det, start_iter):
    """``make_da_train_step`` with the config's SGD and WarmupMultiStep,
    the schedule advanced to ``start_iter``."""
    opt = make_optimizer(cfg, det)
    sched = make_lr_scheduler(cfg, opt)
    sched.last_epoch = start_iter - 1
    with warnings.catch_warnings():  # stepped before the optimizer: on purpose
        warnings.simplefilter("ignore")
        sched.step()
    return opt, sched, make_da_train_step(det, opt, sched)
