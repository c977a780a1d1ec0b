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

``load`` goes by a file's content, not its extension (the port's own files
end in ``.pth`` as the reference's do): a dict with ``model`` is the port's
checkpoint; a file in the reference's layout (an ImageNet VGG16 or a full
SCAN checkpoint, see ``torch_weights.py``) loads as ``scan_tpu``'s
``_load_torch`` loads it (``checkpoint.py:155-177``): iteration 0, no
optimizer or scheduler state, ``load_dis`` honoured, the prototype loaded
and its counter kept, components the file lacks left as they are, and an
unknown key or a shape mismatch raising. A Detectron ``.pkl`` (the
ImageNet ResNet of the EPM R-101 configs, read by ``c2_loading.py``'s
restricted unpickler) loads into the ResNet body alone: iteration 0, no
optimizer or scheduler state, the rest of the detector as it was. An
``http(s)`` URL or a ``catalog://`` name resolves to its file in the local
weight cache (``model_zoo.py``); nothing is fetched.
"""

import logging
import os
from typing import Optional

import torch

from ..modeling.layers import NO_SCALE, is_scale_key
from . import c2_loading, torch_weights
from .model_zoo import is_uri, resolve_weight_uri

logger = logging.getLogger("scan_tpu_torch.checkpoint")


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
        if is_uri(f):
            resolved = resolve_weight_uri(f)
            logger.info("%s resolved to %s", f, resolved)
            f = resolved
        blobs = c2_loading.load_c2_pickle(f)
        if blobs is not None:  # an ImageNet body: iteration 0, no solver
            self._load_c2(f, blobs)
            return 0
        state = torch.load(f, map_location="cpu", weights_only=True)
        if not isinstance(state, dict):
            raise ValueError(f"{f} holds no state dict")
        if "model" not in state:
            if torch_weights.is_reference(state):
                self._load_reference(f, state, load_dis)
                return 0
            raise ValueError(f"checkpoint {f} has no 'model' entry and is "
                             "not in the reference's layout")
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
    def _load_reference(self, path, state: dict, load_dis: bool):
        """Copy a reference-layout file's converted entries into the
        detector, keeping each tensor's device and dtype."""
        det = self.detector
        converted, prototype = torch_weights.convert_reference(state, det)
        own = det.state_dict()
        loaded = set()
        for k, v in converted.items():
            if k.startswith("dis_") and not load_dis:
                continue
            if k not in own:
                raise KeyError(f"unexpected checkpoint key {k} in {path}")
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch loading {path}: {k} is "
                    f"{tuple(own[k].shape)} here, {tuple(v.shape)} in the file")
            own[k].copy_(v)
            loaded.add(k.split(".")[0])
        if prototype is not None:
            if tuple(det.prototype.shape) != tuple(prototype.shape):
                raise ValueError(
                    f"shape mismatch loading {path}: the prototype is "
                    f"{tuple(det.prototype.shape)} here, "
                    f"{tuple(prototype.shape)} in the file")
            det.prototype.copy_(prototype)  # the counter is kept
        logger.info("loaded %d reference entries of %s from %s (iteration "
                    "0)", len(converted), sorted(loaded), path)

    @torch.no_grad()
    def _load_c2(self, path, blobs: dict):
        """Copy a Detectron pickle's blobs into the ResNet body, keeping
        each tensor's device and dtype; a blob with no place there or of
        another shape raises."""
        body = self.detector.backbone.body
        if not hasattr(body, "stem_conv1"):
            raise ValueError(
                f"{path} is a Detectron ResNet pickle, and this detector's "
                f"body is {type(body).__name__}")
        own = body.state_dict()
        converted = c2_loading.convert_c2_resnet(blobs)
        for k, v in converted.items():
            if k not in own:
                raise KeyError(f"{path}: blob for {k}, which the "
                               f"{type(body).__name__} body does not have")
            if tuple(own[k].shape) != v.shape:
                raise ValueError(
                    f"shape mismatch loading {path}: backbone.body.{k} is "
                    f"{tuple(own[k].shape)} here, {v.shape} in the file")
            own[k].copy_(torch.from_numpy(v))
        logger.info("loaded %d ResNet body entries from the Detectron "
                    "pickle %s (iteration 0)", len(converted), path)

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
