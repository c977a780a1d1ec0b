"""Evaluation loop (counterpart of ``scan_tpu/engine/inference.py``).

``compute_predictions`` runs the detector over batches laid out as
``scan_tpu``'s loader yields them (``images`` uint8 NHWC, ``sizes`` (B, 2)
[h, w], ``scales`` (B, 2) [sw, sh], ``indices`` (B,), -1 for padding slots)
and returns predictions per index in ORIGINAL image coordinates, from any
iterable of such batches, the port's ``data/build.py::DetectionLoader``
among them. ``inference`` scores them with ``evaluate_dataset``: the COCO
protocol of ``evaluation/coco_eval.py`` for a ``COCODataset``, the VOC one of
``evaluation/voc_eval.py`` for any other dataset, as ``scan_tpu`` dispatches
(``scan_tpu/engine/inference.py:121-126``); the trainer's in-loop
validation calls it. Under a process group of more than one rank (data
parallelism, ``parallel/mesh.py``) each rank runs its contiguous slice of
every batch: a global batch is sliced, a batch the loader made for the
rank alone (marked ``RANK_SLICE``) is taken as it is; ``inference``
gathers the predictions on rank 0, which evaluates them and hands the
results to every rank, as ``scan_tpu`` shards its eval over the mesh
(``inference.py:44-56, 129``).
The chained dispatch (``TPU.INFER_CHAIN``) of ``scan_tpu`` is not ported.

``scan_tpu_torch.engine.inference`` is both this module and, called, the
``inference`` function, as ``scan_tpu``'s package re-exports the function
under the module's name.
"""

import logging
import time
from typing import Dict

import numpy as np
import torch

from ..data.datasets.coco import COCODataset
from ..evaluation.coco_eval import evaluate_coco_dataset
from ..evaluation.voc_eval import evaluate_voc_dataset
from ..parallel.mesh import (all_gather, broadcast_object, get_rank,
                             get_world_size, is_main_process, rank_part)
from ..utils.callable_module import make_callable

logger = logging.getLogger("scan_tpu_torch.inference")


def compute_predictions(detector, data_loader,
                        progress_every: int = 50) -> Dict[int, dict]:
    """index -> dict(boxes (n, 4) xyxy, scores (n,), labels (n,)) as numpy.

    Runs on the detector's device (the card unless it was built for
    another). The next batch is queued before the previous one is copied
    back, so the host-side collect overlaps device work. Under a process
    group each rank predicts its slice of every batch only."""
    device = next(detector.parameters()).device
    rank, world = get_rank(), get_world_size()
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
        batch = rank_part(batch, rank, world)
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


def evaluate_dataset(dataset, predictions: Dict[int, dict]):
    """COCO metrics for a ``COCODataset``, VOC metrics for any other."""
    if isinstance(dataset, COCODataset):
        return evaluate_coco_dataset(dataset, predictions)
    return evaluate_voc_dataset(dataset, predictions)


def inference(detector, data_loader):
    """Predictions and metrics, fractions in [0, 1]
    (``scan_tpu/engine/inference.py:129-135``). ``data_loader`` iterates
    batches as ``compute_predictions`` takes them and has the ``dataset``
    they index. Returns (results, predictions): under a process group the
    results are rank 0's on every rank, the predictions this rank's."""
    predictions = compute_predictions(detector, data_loader, progress_every=0)
    if get_world_size() == 1:
        return evaluate_dataset(data_loader.dataset, predictions), predictions
    gathered = all_gather(predictions)
    results = None
    if is_main_process():
        merged = {}
        for part in gathered:
            merged.update(part)
        results = evaluate_dataset(data_loader.dataset, merged)
    return broadcast_object(results), predictions


make_callable(__name__, "inference")
