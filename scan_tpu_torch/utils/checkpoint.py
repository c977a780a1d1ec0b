"""Checkpointing on torch files (counterpart of ``scan_tpu/utils/checkpoint.py``).

Parity target: reference ``fcos_core/utils/checkpoint.py:101-493``
(``DetectronCheckpointer``): one file per save holding the detector (every
module of the model dict), the optimizer's and the scheduler's state and
the iteration; a ``last_checkpoint`` pointer file for crash auto-resume;
``load(f, load_dis, load_opt_sch)`` semantics.

A file is ``<save_dir>/<name>.pth``, a dict of plain types only (tensors,
numbers, strings, lists, dicts), so ``torch.load(..., weights_only=True)``
reads it::

    {"model": detector.state_dict(),   # parameters, the prototype and its
                                       # counter, the int8 |x|max buffers
     "optimizer": ..., "scheduler": ..., "iteration": int}

It is written to a temporary file and renamed into place before the
pointer moves, so a crash leaves the last complete checkpoint. Loading
reads the scale buffers back into each int8 conv's ``calibrated`` set
(``load_state_dict``'s hook), so a calibrated detector stays static.
Reference ``.pth`` weights (``scan_tpu``'s ``torch_weights``) and weight
URLs are not loaded: the port fetches nothing.
"""

import logging
import os
from typing import Optional

import torch

from ..modeling.layers import NO_SCALE, is_scale_key

logger = logging.getLogger("scan_tpu_torch.checkpoint")

_URL_PREFIXES = ("catalog://", "http://", "https://")


class Checkpointer:
    def __init__(self, save_dir: str, detector, optimizer=None,
                 scheduler=None):
        self.save_dir = os.path.abspath(save_dir)
        self.detector = detector
        self.optimizer = optimizer
        self.scheduler = scheduler
        os.makedirs(self.save_dir, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, name: str, iteration: int = 0) -> str:
        path = os.path.join(self.save_dir, f"{name}.pth")
        state = {"model": self.detector.state_dict(),
                 "iteration": int(iteration)}
        if self.optimizer is not None:
            state["optimizer"] = self.optimizer.state_dict()
        if self.scheduler is not None:
            state["scheduler"] = self.scheduler.state_dict()
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(path)
        logger.info("saved checkpoint %s", path)
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return f.read().strip()
        except OSError:
            return ""

    # ------------------------------------------------------------------ #
    def load(self, f: Optional[str] = None, load_dis: bool = True,
             load_opt_sch: bool = True) -> int:
        """Reference-compatible resolution order: prefer the last_checkpoint
        pointer, else the given file (checkpoint.py:303-316). Returns the
        restored iteration, 0 when there is nothing to load."""
        if self.has_checkpoint():
            f = self.get_checkpoint_file()
        if not f:
            logger.info("no checkpoint found; keeping initialisation")
            return 0
        if f.startswith(_URL_PREFIXES):
            raise ValueError(f"{f} is a URL; scan_tpu_torch fetches no "
                             "weights, give a local checkpoint file")
        state = torch.load(f, map_location="cpu", weights_only=True)
        if "model" not in state:
            raise ValueError(f"checkpoint {f} has no 'model' entry")
        self._load_model(f, state["model"], load_dis)
        if load_opt_sch:
            if self.optimizer is not None and "optimizer" in state:
                self.optimizer.load_state_dict(state["optimizer"])
            if self.scheduler is not None and "scheduler" in state:
                self.scheduler.load_state_dict(state["scheduler"])
        iteration = int(state.get("iteration", 0))
        logger.info("restored %s at iteration %d", f, iteration)
        return iteration

    @torch.no_grad()
    def _load_model(self, path, saved: dict, load_dis: bool):
        """Copy ``saved`` into the detector. Refuses a file that lacks one of
        the detector's keys (incompatible architecture) but for the int8
        scale buffers, and ignores keys the detector lacks; with
        ``load_dis`` False the ``dis_*`` keys keep the detector's values."""
        own = self.detector.state_dict()
        keep = {k for k in own if not load_dis and k.startswith("dis_")}
        missing = sorted(k for k in own
                         if k not in saved and k not in keep
                         and not is_scale_key(k))
        if missing:
            raise ValueError(
                f"checkpoint {path} lacks {len(missing)} model keys "
                "(incompatible architecture?): " + ", ".join(missing[:8]))
        n_extra = sum(k not in own for k in saved)
        if n_extra:  # as scan_tpu's partial restore, extra state is ignored
            logger.info("partial restore of %s (%d extra keys ignored)",
                        path, n_extra)
        sd = {k: v for k, v in saved.items() if k in own and k not in keep}
        for k in own:
            if is_scale_key(k) and k not in sd:
                sd[k] = torch.tensor(NO_SCALE)
        self.detector.load_state_dict(sd, strict=False)
