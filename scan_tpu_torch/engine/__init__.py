"""The evaluation and training loops. The training names are resolved at
first use, so ``import scan_tpu_torch.engine`` does not pull in the trainer
or the detector. ``inference`` is the module ``engine/inference.py``, which
runs the ``inference`` function when called."""

import importlib

from . import inference
from .inference import compute_predictions, evaluate_dataset

# reference-name aliases (fcos_core.engine.validation / trainer)
validation = inference
validataion = inference  # [sic] the reference's spelling, kept as an alias

_LAZY = {
    "make_da_train_step": "train_step",
    "make_source_only_train_step": "train_step",
    "do_train_da": "trainer",
    "do_train_plain": "trainer",
}

__all__ = [
    "compute_predictions",
    "evaluate_dataset",
    "inference",
    "make_da_train_step",
    "make_source_only_train_step",
    "do_train_da",
    "do_train_plain",
    "validation",
    "validataion",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
