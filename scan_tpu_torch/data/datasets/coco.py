"""COCO-style dataset backed by a self-contained JSON parser; a copy of
``scan_tpu/data/datasets/coco.py``, which the port does not import.

Parity target: reference ``fcos_core/data/datasets/coco.py:39-101``
(a torchvision CocoDetection subclass + pycocotools). pycocotools is not
a dependency of the port, so ``CocoJson`` implements the small slice
of its API the detection pipeline needs (image index, per-image
annotations, category ids). Semantics matched:

  * ids sorted; images without valid annotations dropped when training
    (valid = at least one box with w>1 and h>1, coco.py:18-35);
  * crowd annotations filtered out of training targets;
  * category ids remapped to contiguous 1..C;
  * xywh -> xyxy with the '-1' convention (BoxList.convert);
  * boxes clipped to the image, empty boxes removed.
"""

import json
import os
from typing import Dict, List

import numpy as np


class CocoJson:
    """Minimal pycocotools.COCO replacement for bbox detection."""

    def __init__(self, ann_file: str):
        with open(ann_file, "r") as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {im_id: [] for im_id in self.imgs}
        for ann in d.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def get_cat_ids(self):
        return sorted(self.cats.keys())

    def get_img_ids(self):
        return sorted(self.imgs.keys())


def _has_valid_annotation(anno) -> bool:
    if len(anno) == 0:
        return False
    # all boxes with near-zero extent -> invalid (reference coco.py:18-21)
    return not all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno)


class COCODataset:
    def __init__(self, ann_file: str, root: str,
                 remove_images_without_annotations: bool = True,
                 transforms=None):
        self.root = root
        self.coco = CocoJson(ann_file)
        self.ids = self.coco.get_img_ids()
        if remove_images_without_annotations:
            self.ids = [
                i
                for i in self.ids
                if _has_valid_annotation(
                    [a for a in self.coco.img_to_anns.get(i, [])]
                )
            ]
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(self.coco.get_cat_ids())
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.id_to_img_map = {k: v for k, v in enumerate(self.ids)}
        self.transforms = transforms

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index) -> dict:
        return self.coco.imgs[self.id_to_img_map[index]]

    def class_names(self) -> List[str]:
        return [
            self.coco.cats[self.contiguous_category_id_to_json_id[i]]["name"]
            for i in range(1, len(self.coco.cats) + 1)
        ]

    def load_image(self, index) -> np.ndarray:
        info = self.get_img_info(index)
        return _load_rgb(os.path.join(self.root, info["file_name"]))

    def get_raw_target(self, index):
        """Returns (boxes_xyxy float32 (n,4), labels int32 (n,)) in original
        image coordinates, crowd filtered, clipped, empties removed."""
        img_id = self.id_to_img_map[index]
        info = self.coco.imgs[img_id]
        w, h = info["width"], info["height"]
        anno = [
            a for a in self.coco.img_to_anns.get(img_id, [])
            if a.get("iscrowd", 0) == 0
        ]
        if not anno:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        xywh = np.asarray([a["bbox"] for a in anno], np.float32).reshape(-1, 4)
        boxes = np.stack(
            [
                xywh[:, 0],
                xywh[:, 1],
                xywh[:, 0] + np.clip(xywh[:, 2] - 1, 0, None),
                xywh[:, 1] + np.clip(xywh[:, 3] - 1, 0, None),
            ],
            axis=1,
        )
        labels = np.asarray(
            [
                self.json_category_id_to_contiguous_id[a["category_id"]]
                for a in anno
            ],
            np.int32,
        )
        # clip + remove empty (reference clip_to_image(remove_empty=True))
        boxes[:, 0] = np.clip(boxes[:, 0], 0, w - 1)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, h - 1)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, w - 1)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, h - 1)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        return boxes[keep], labels[keep]


def pil_decode(data: bytes) -> np.ndarray:
    """PNG/JPEG/... bytes -> (h, w, 3) RGB uint8 with Pillow."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _load_rgb(path: str) -> np.ndarray:
    """The native decode (GIL released) where the library has the codecs
    and the format is PNG or JPEG, else Pillow. ``SCAN_TPU_NO_NATIVE=1``
    always decodes with Pillow."""
    from ... import native

    with open(path, "rb") as f:
        data = f.read()
    arr = native.decode_image(data) if native.enabled() else None
    return arr if arr is not None else pil_decode(data)
