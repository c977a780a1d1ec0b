"""VOC-XML datasets: PascalVOC, Sim10k (car-only), KITTI (car-only); a copy
of ``scan_tpu/data/datasets/voc_xml.py``, which the port does not import.

Parity targets: reference ``fcos_core/data/datasets/voc.py``, ``sim10k.py``,
``kitti.py`` — 0-based pixel boxes (int - 1), difficult filtering, car-only
class maps for the DA benchmarks.
"""

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from .coco import _load_rgb

VOC_CLASSES = (
    "__background__ ", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)

CAR_ONLY_CLASSES = ("__background__ ", "car")


class VOCXmlDataset:
    CLASSES = VOC_CLASSES
    IMG_EXT = ".jpg"
    CLASS_FILTER = None  # keep all

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False,
                 transforms=None):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult
        self.transforms = transforms
        self._annopath = os.path.join(self.root, "Annotations", "%s.xml")
        self._imgpath = os.path.join(self.root, "JPEGImages", "%s" + self.IMG_EXT)
        self._imgsetpath = os.path.join(self.root, "ImageSets", "Main", "%s.txt")
        with open(self._imgsetpath % self.image_set) as f:
            self.ids = [x.strip() for x in f.readlines()]
        self.id_to_img_map = dict(enumerate(self.ids))
        self.class_to_ind = dict(zip(self.CLASSES, range(len(self.CLASSES))))

    def __len__(self):
        return len(self.ids)

    def class_names(self) -> List[str]:
        return [c.strip() for c in self.CLASSES[1:]]

    def load_image(self, index) -> np.ndarray:
        return _load_rgb(self._imgpath % self.ids[index])

    def _parse(self, index):
        anno = ET.parse(self._annopath % self.ids[index]).getroot()
        boxes, labels, difficult = [], [], []
        for obj in anno.iter("object"):
            diff_node = obj.find("difficult")
            diff = int(diff_node.text) == 1 if diff_node is not None else False
            if not self.keep_difficult and diff:
                continue
            name = obj.find("name").text.lower().strip()
            if self.CLASS_FILTER is not None and name != self.CLASS_FILTER:
                continue
            if name not in self.class_to_ind:
                continue
            bb = obj.find("bndbox")
            box = [
                float(bb.find(k).text) - 1  # 0-based (reference TO_REMOVE=1)
                for k in ("xmin", "ymin", "xmax", "ymax")
            ]
            boxes.append(box)
            labels.append(self.class_to_ind[name])
            difficult.append(diff)
        size = anno.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
            np.asarray(difficult, bool),
            (h, w),
        )

    def get_img_info(self, index) -> dict:
        anno = ET.parse(self._annopath % self.ids[index]).getroot()
        size = anno.find("size")
        return {
            "height": int(size.find("height").text),
            "width": int(size.find("width").text),
        }

    def get_raw_target(self, index):
        boxes, labels, _, (h, w) = self._parse(index)
        if boxes.shape[0]:
            boxes[:, 0] = np.clip(boxes[:, 0], 0, w - 1)
            boxes[:, 1] = np.clip(boxes[:, 1], 0, h - 1)
            boxes[:, 2] = np.clip(boxes[:, 2], 0, w - 1)
            boxes[:, 3] = np.clip(boxes[:, 3], 0, h - 1)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, labels = boxes[keep], labels[keep]
        return boxes, labels

    def get_groundtruth(self, index):
        """Full annotation incl. difficult flags (for VOC-style eval)."""
        return self._parse(index)


class PascalVOCDataset(VOCXmlDataset):
    CLASSES = VOC_CLASSES


class Sim10kDataset(VOCXmlDataset):
    CLASSES = CAR_ONLY_CLASSES
    CLASS_FILTER = "car"


class KittiDataset(VOCXmlDataset):
    CLASSES = CAR_ONLY_CLASSES
    CLASS_FILTER = "car"
    IMG_EXT = ".png"

