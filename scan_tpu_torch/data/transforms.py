"""Host-side preprocessing (numpy + the native library); a copy of
``scan_tpu/data/transforms.py``, which the port does not import.

Parity target: reference ``fcos_core/data/transforms/transforms.py:27-90``:
  * Resize: min side to `size` (random choice over the configured range for
    training), capped so the max side <= max_size;
  * RandomHorizontalFlip (p=0.5 train) with box transpose;
  * Normalize: RGB -> BGR * 255 - caffe mean (std 1).

Box resize uses the reference BoxList.resize ratios (w_ratio, h_ratio
applied per-coordinate); flip uses BoxList.transpose(0) semantics with the
'-1' convention (bounding_box.py:168-186).

The resize runs in the native library (``native/``), PIL's bilinear filter
bit for bit. Pillow runs only when ``SCAN_TPU_NO_NATIVE=1`` asks for it,
and is imported only then. ``scan_tpu``'s ``Preprocessor.__call__`` (the
unfused PIL path no loader calls) is not copied.
"""

import random
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native


def get_resize_hw(w: int, h: int, size: int, max_size: Optional[int]) -> Tuple[int, int]:
    if max_size is not None:
        min_orig = float(min(w, h))
        max_orig = float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def pil_resize(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """PIL's bilinear resize (the ``SCAN_TPU_NO_NATIVE=1`` path)."""
    from PIL import Image

    pil = Image.fromarray(np.ascontiguousarray(image))
    return np.asarray(pil.resize((ow, oh), Image.BILINEAR))


class Preprocessor:
    def __init__(self, min_sizes: Sequence[int], max_size: int,
                 pixel_mean, pixel_std, to_bgr255: bool = True,
                 flip_prob: float = 0.0, seed: int = 0):
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.mean = np.asarray(pixel_mean, np.float32)
        self.std = np.asarray(pixel_std, np.float32)
        self.to_bgr255 = to_bgr255
        self.flip_prob = flip_prob
        self.rng = random.Random(seed)

    def plan(self, h: int, w: int, rng=None):
        """Draw the (resize target, flip) decisions for one image.

        ``rng`` lets the caller key the draws deterministically (the
        loader derives one per (iteration, slot) so batches are
        reproducible under any prefetch-thread schedule and across
        checkpoint resume); default falls back to the shared stream.
        """
        rng = rng or self.rng
        size = rng.choice(self.min_sizes)
        oh, ow = get_resize_hw(w, h, size, self.max_size)
        flip = self.flip_prob > 0 and rng.random() < self.flip_prob
        return oh, ow, flip

    def transform_boxes(self, boxes, h, w, oh, ow, flip):
        if boxes is not None and boxes.size:
            rw, rh = ow / w, oh / h
            boxes = boxes * np.asarray([rw, rh, rw, rh], np.float32)
            if flip:
                x1 = ow - boxes[:, 2] - 1
                x2 = ow - boxes[:, 0] - 1
                boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
        return boxes

    def into_buffer(self, image: np.ndarray, boxes, out: np.ndarray,
                    rng=None):
        """Fused path: resize+flip+normalize straight into the padded
        (H, W, 3) float32 buffer (the flip commutes with the symmetric
        resize filter so it is applied to the source view). Returns
        (boxes, (oh, ow))."""
        h, w = image.shape[:2]
        oh, ow, flip = self.plan(h, w, rng)
        src = image[:, ::-1] if flip else image
        if native.enabled():
            native.preprocess_image(src, out, oh, ow, self.mean, self.std,
                                    self.to_bgr255)
        else:
            out[:oh, :ow] = self._normalize(src, oh, ow)
        boxes = self.transform_boxes(boxes, h, w, oh, ow, flip)
        return boxes, (oh, ow)

    def into_buffer_u8(self, image: np.ndarray, boxes, out: np.ndarray,
                       rng=None):
        """Resize+flip into a padded uint8 RGB buffer; normalization happens
        on the card (``detector._prep_images``). 4x less host->card
        traffic."""
        h, w = image.shape[:2]
        oh, ow, flip = self.plan(h, w, rng)
        src = image[:, ::-1] if flip else image
        if native.enabled():
            native.resize_image_u8(src, out, oh, ow)
        else:
            out[:oh, :ow] = pil_resize(src, oh, ow)
        boxes = self.transform_boxes(boxes, h, w, oh, ow, flip)
        return boxes, (oh, ow)

    def _normalize(self, image, oh, ow):
        h, w = image.shape[:2]
        if (oh, ow) != (h, w):
            image = pil_resize(image, oh, ow)
        img = image.astype(np.float32) / 255.0
        if self.to_bgr255:
            img = img[:, :, ::-1] * 255.0
        img = (img - self.mean) / self.std
        return np.ascontiguousarray(img)


def build_preprocessor(cfg, is_train: bool, seed: int = 0) -> Preprocessor:
    if is_train:
        if cfg.INPUT.MIN_SIZE_RANGE_TRAIN[0] == -1:
            min_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN) if isinstance(
                cfg.INPUT.MIN_SIZE_TRAIN, (tuple, list)
            ) else [cfg.INPUT.MIN_SIZE_TRAIN]
        else:
            lo, hi = cfg.INPUT.MIN_SIZE_RANGE_TRAIN
            min_sizes = list(range(lo, hi + 1))
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        flip = 0.5
    else:
        min_sizes = [cfg.INPUT.MIN_SIZE_TEST]
        max_size = cfg.INPUT.MAX_SIZE_TEST
        flip = 0.0
    return Preprocessor(
        min_sizes, max_size, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
        cfg.INPUT.TO_BGR255, flip_prob=flip, seed=seed,
    )
