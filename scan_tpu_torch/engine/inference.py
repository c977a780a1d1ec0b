"""Evaluation loop (counterpart of ``scan_tpu/engine/inference.py``).

``compute_predictions`` runs the detector over batches laid out as
``scan_tpu``'s loader yields them (``images`` uint8 NHWC, ``sizes`` (B, 2)
[h, w], ``scales`` (B, 2) [sw, sh], ``indices`` (B,), -1 for padding slots)
and returns predictions per index in ORIGINAL image coordinates;
``inference`` scores them with the COCO protocol of
``evaluation/coco_eval.py``, as the trainer's in-loop validation does. The
device mesh, the chained dispatch and the VOC evaluator of ``scan_tpu`` are
not ported, nor are its loaders.
"""

import logging
import time
from typing import Dict

import numpy as np
import torch

from ..evaluation.coco_eval import evaluate_coco_dataset

logger = logging.getLogger("scan_tpu_torch.inference")


def compute_predictions(detector, data_loader,
                        progress_every: int = 50) -> Dict[int, dict]:
    """index -> dict(boxes (n, 4) xyxy, scores (n,), labels (n,)) as numpy.

    Runs on the detector's device (the card unless it was built for
    another). The next batch is queued before the previous one is copied
    back, so the host-side collect overlaps device work."""
    device = next(detector.parameters()).device
    predictions: Dict[int, dict] = {}
    t0 = time.time()
    n_img = 0
    pending = None

    def collect(out, batch):
        nonlocal n_img
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for slot in range(len(batch["indices"])):
            index = int(batch["indices"][slot])
            if index < 0:
                continue
            valid = out["valid"][slot]
            sw, sh = batch["scales"][slot]
            boxes = out["boxes"][slot][valid] * np.asarray(
                [sw, sh, sw, sh], np.float32)
            predictions[index] = dict(
                boxes=boxes,
                scores=out["scores"][slot][valid],
                labels=out["labels"][slot][valid],
            )
            n_img += 1

    for bi, batch in enumerate(data_loader):
        images = torch.as_tensor(np.asarray(batch["images"])).to(
            device, non_blocking=True)
        sizes = torch.as_tensor(np.asarray(batch["sizes"])).to(device)
        out = detector.forward_inference(images, sizes)
        if pending is not None:
            collect(*pending)
        pending = (out, batch)
        if progress_every and (bi + 1) % progress_every == 0:
            logger.info("eval batch %d (%.1f img/s)", bi + 1,
                        max(n_img, 1) / (time.time() - t0))
    if pending is not None:
        collect(*pending)
    dt = time.time() - t0
    if n_img:
        logger.info("inference done: %d images in %.1fs (%.2f img/s)",
                    n_img, dt, n_img / dt)
    return predictions


def inference(detector, data_loader):
    """Predictions and COCO bbox metrics, fractions in [0, 1]
    (``scan_tpu/engine/inference.py:129-135``). ``data_loader`` iterates
    batches as ``compute_predictions`` takes them and has a ``dataset`` with
    ``scan_tpu``'s ``COCODataset`` API (see ``evaluate_coco_dataset``).
    Returns (results, predictions)."""
    predictions = compute_predictions(detector, data_loader, progress_every=0)
    return evaluate_coco_dataset(data_loader.dataset, predictions), predictions
