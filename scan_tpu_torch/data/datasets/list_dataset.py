"""Dataset over a plain list of image paths (demo-style inference input);
the counterpart of ``scan_tpu/data/datasets/list_dataset.py``.

Parity target: reference ``fcos_core/data/datasets/list_dataset.py:1-36`` —
wraps image paths and yields a dummy whole-image box target. The loader
buckets by aspect ratio, so ``get_img_info`` must return real dimensions:
``scan_tpu`` reads the header with PIL, here the image is decoded once
(``_load_rgb``, native or Pillow) and its size kept.
"""

import os
from typing import List, Optional, Sequence

import numpy as np

from .coco import _load_rgb


class ListDataset:
    def __init__(self, image_lists: Sequence[str], transforms=None,
                 class_names_: Optional[List[str]] = None):
        self.image_lists = list(image_lists)
        self.transforms = transforms
        self._infos: dict = {}
        self._class_names = class_names_ or ["object"]

    def __len__(self):
        return len(self.image_lists)

    def get_img_info(self, index) -> dict:
        if index not in self._infos:
            path = self.image_lists[index]
            h, w = self.load_image(index).shape[:2]
            self._infos[index] = dict(
                id=index, file_name=os.path.basename(path),
                width=w, height=h,
            )
        return self._infos[index]

    def class_names(self) -> List[str]:
        return self._class_names

    def load_image(self, index) -> np.ndarray:
        return _load_rgb(self.image_lists[index])

    def get_raw_target(self, index):
        """Dummy whole-image box, label 1 (reference list_dataset.py:20-21)."""
        info = self.get_img_info(index)
        boxes = np.asarray(
            [[0, 0, info["width"] - 1, info["height"] - 1]], np.float32
        )
        return boxes, np.asarray([1], np.int32)
