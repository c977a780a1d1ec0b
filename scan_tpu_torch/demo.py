"""Single-image predictor and the simple ``SCAN`` API (counterpart of
``scan_tpu/demo.py``).

Parity targets:
  * ``COCODemo`` (reference ``demo/predictor.py:100-436``): build the model
    from a config, min-side resize and BGR255 preprocessing, a confidence
    threshold, box/label overlay;
  * the installable ``fcos.FCOS`` API (reference ``fcos/fcos.py:79-318``):
    ``detect(image)`` returning plain dicts.

The detector is built for evaluation (``build_detector``: bf16 conv and
GroupNorm parameters under ``TPU.COMPUTE_DTYPE bfloat16``, as ``test_net``
builds it) on ``device``, which defaults to ``MODEL.DEVICE`` (the card;
the CPU only when asked for). Its weights come from ``weights`` through
``Checkpointer.load`` (a port checkpoint, a reference ``.pth``, a Detectron
``.pkl`` or a cached URL); without weights the port's seeded init (seed 0)
is used, which cannot equal ``scan_tpu``'s ``PRNGKey(0)`` init: compare the
two packages on carried-over parameters, not on their inits.

A frame is resized by the port's ``Preprocessor`` (min side
``INPUT.MIN_SIZE_TEST`` or ``min_image_size``, capped at
``INPUT.MAX_SIZE_TEST``) and normalised into a zero-padded buffer, the
bucket ``32 * ceil(MIN / 32) x 32 * ceil(MAX / 32)``, which grows to the
frame's own 32-multiples when a resized frame does not fit, as
``scan_tpu``'s does. Detections are scaled back to the frame's own
coordinates, thresholded, and named after the Cityscapes categories.
"""

import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import get_default_cfg
from .data.transforms import Preprocessor, get_resize_hw
from .modeling.detector import build_detector

CITYSCAPES_CATEGORIES = [
    "__background__", "person", "rider", "car", "truck",
    "bus", "train", "motorcycle", "bicycle",
]


def _bucket(h, w):
    return 32 * ((h + 31) // 32), 32 * ((w + 31) // 32)


class Predictor:
    """Runs the SCAN detector on numpy RGB images."""

    def __init__(self, cfg, weights: Optional[str] = None,
                 confidence_threshold: float = 0.5,
                 categories: Optional[List[str]] = None,
                 min_image_size: Optional[int] = None, device=None):
        self.cfg = cfg
        self.detector = build_detector(
            cfg, device=cfg.MODEL.DEVICE if device is None else device)
        self.device = next(self.detector.parameters()).device
        self.confidence_threshold = confidence_threshold
        self.categories = categories or CITYSCAPES_CATEGORIES
        self.min_size = min_image_size or cfg.INPUT.MIN_SIZE_TEST
        self.max_size = cfg.INPUT.MAX_SIZE_TEST
        self.pre = Preprocessor(
            [self.min_size], self.max_size, cfg.INPUT.PIXEL_MEAN,
            cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255,
        )
        if weights:
            from .utils.checkpoint import Checkpointer

            # a fresh directory: Checkpointer.load prefers a last_checkpoint
            # pointer it finds in its own directory over the file it is given
            with tempfile.TemporaryDirectory() as tmp:
                Checkpointer(os.path.join(tmp, "ckpt"), self.detector).load(
                    weights, load_dis=False)
        self._bucket = _bucket(self.min_size, self.max_size)

    def preprocess(self, image: np.ndarray):
        """(H, W, 3) uint8 RGB -> (the (1, bh, bw, 3) normalised float32
        batch, zero-padded to the bucket, and the resized (h, w))."""
        oh, ow = get_resize_hw(image.shape[1], image.shape[0], self.min_size,
                               self.max_size)
        bh, bw = self._bucket
        if oh > bh or ow > bw:
            self._bucket = _bucket(oh, ow)
        buf = np.zeros(self._bucket + (3,), np.float32)
        _, (oh, ow) = self.pre.into_buffer(image, None, buf)
        return buf[None], (oh, ow)

    def forward(self, batch, size):
        """The detector's eval forward on one preprocessed frame: a dict of
        (1, DETECTIONS_PER_IMG) tensors on the detector's device."""
        images = torch.from_numpy(batch).to(self.device, non_blocking=True)
        sizes = torch.tensor([size], dtype=torch.int32, device=self.device)
        return self.detector.forward_inference(images, sizes)

    def detect(self, image: np.ndarray) -> List[Dict]:
        """image: (H, W, 3) uint8 RGB. Returns a list of detection dicts in
        original-image coordinates."""
        oh0, ow0 = image.shape[:2]
        batch, (oh, ow) = self.preprocess(image)
        out = {k: v.cpu().numpy() for k, v in
               self.forward(batch, (oh, ow)).items()}
        valid = out["valid"][0]
        boxes = out["boxes"][0][valid] * np.asarray(
            [ow0 / ow, oh0 / oh, ow0 / ow, oh0 / oh], np.float32)
        scores = out["scores"][0][valid]
        labels = out["labels"][0][valid]
        keep = scores >= self.confidence_threshold
        results = []
        for b, s, lab in zip(boxes[keep], scores[keep], labels[keep]):
            name = (self.categories[int(lab)] if int(lab) < len(self.categories)
                    else str(int(lab)))
            results.append(dict(box=b.tolist(), score=float(s),
                                label=int(lab), label_name=name))
        return results

    def run_on_image(self, image: np.ndarray) -> np.ndarray:
        """The image with detections drawn (COCODemo.run_on_opencv_image)."""
        return draw_detections(image, self.detect(image))


def draw_detections(image: np.ndarray, detections: List[Dict]) -> np.ndarray:
    """Overlay boxes (2-px outlines; pure numpy, no cv2), one seeded colour
    per label, as ``scan_tpu``'s."""
    out = image.copy()
    rng = np.random.RandomState(3)
    colors = {d["label"]: rng.randint(64, 255, 3) for d in detections}
    for d in detections:
        x1, y1, x2, y2 = (int(round(v)) for v in d["box"])
        c = colors[d["label"]]
        x1 = max(0, min(x1, out.shape[1] - 1))
        x2 = max(0, min(x2, out.shape[1] - 1))
        y1 = max(0, min(y1, out.shape[0] - 1))
        y2 = max(0, min(y2, out.shape[0] - 1))
        out[y1:y1 + 2, x1:x2] = c
        out[max(y2 - 1, 0):y2 + 1, x1:x2] = c
        out[y1:y2, x1:x1 + 2] = c
        out[y1:y2, max(x2 - 1, 0):x2 + 1] = c
    return out


class SCAN:
    """Simple pip-style API (reference fcos/fcos.py FCOS class).
    ``overrides`` are config keys and values (``MODEL.DEVICE="cpu"``)."""

    def __init__(self, config_path: str, weights: Optional[str] = None,
                 confidence_threshold: float = 0.5, **overrides):
        cfg = get_default_cfg()
        cfg.merge_from_file(config_path)
        for k, v in overrides.items():
            cfg.merge_from_list([k, str(v)])
        self.predictor = Predictor(cfg, weights,
                                   confidence_threshold=confidence_threshold)

    def detect(self, image: np.ndarray) -> List[Dict]:
        return self.predictor.detect(image)

    def show_bboxes(self, image: np.ndarray) -> np.ndarray:
        return self.predictor.run_on_image(image)
