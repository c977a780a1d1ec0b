"""Padded image batches with per-image true sizes (counterpart of
``scan_tpu/structures/image_batch.py``).

Replaces the reference's ``ImageList`` (reference
``fcos_core/structures/image_list.py:7-72``): images padded to one (H, W),
either a fixed bucket or the batch's largest size rounded up to
SIZE_DIVISIBILITY, in ``scan_tpu``'s NHWC layout and float32 values.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ImageBatch:
    """tensors: (B, H, W, 3) padded images; sizes: (B, 2) [h, w] true sizes."""

    tensors: torch.Tensor
    sizes: torch.Tensor

    @property
    def padded_hw(self) -> Tuple[int, int]:
        return self.tensors.shape[1], self.tensors.shape[2]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_images(images: Sequence[np.ndarray], size_divisibility: int = 32,
                 bucket_hw: Optional[Tuple[int, int]] = None,
                 device=None) -> ImageBatch:
    """Stack HWC numpy images into a padded NHWC float32 batch.

    If bucket_hw is given, pad to that exact shape (static bucket). Otherwise
    pad to the per-batch max rounded up to size_divisibility (the
    reference's to_image_list, reference image_list.py:29-70).
    """
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    if bucket_hw is None:
        H = round_up(max(hs), size_divisibility)
        W = round_up(max(ws), size_divisibility)
    else:
        H, W = bucket_hw
    out = np.zeros((len(images), H, W, 3), np.float32)
    for i, im in enumerate(images):
        out[i, : im.shape[0], : im.shape[1]] = im
    sizes = np.stack([np.array(hs), np.array(ws)], axis=1).astype(np.int32)
    return ImageBatch(torch.from_numpy(out).to(device),
                      torch.from_numpy(sizes).to(device))
