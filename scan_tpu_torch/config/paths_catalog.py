"""Dataset name -> (factory, paths) catalog; a copy of
``scan_tpu/config/paths_catalog.py``, which the port does not import.

Mirrors the reference catalog (reference ``fcos_core/config/paths_catalog.py:7``)
for all dataset names used by the SCAN/EPM configs. ``DATA_DIR`` is
overridable via the ``SCAN_TPU_DATA_DIR`` environment variable, the one
``scan_tpu`` reads, so one data tree serves both packages. ``scan_tpu``'s
``ModelCatalog`` (``catalog://`` weight URLs) is not copied: the port
fetches no weights.
"""

import os


class DatasetCatalog:
    DATA_DIR = os.environ.get("SCAN_TPU_DATA_DIR", "datasets")

    DATASETS = {
        "coco_2017_train": {
            "img_dir": "coco/train2017",
            "ann_file": "coco/annotations/instances_train2017.json",
        },
        "coco_2017_val": {
            "img_dir": "coco/val2017",
            "ann_file": "coco/annotations/instances_val2017.json",
        },
        "coco_2014_train": {
            "img_dir": "coco/train2014",
            "ann_file": "coco/annotations/instances_train2014.json",
        },
        "coco_2014_val": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_val2014.json",
        },
        "coco_2014_minival": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_minival2014.json",
        },
        "voc_2007_train": {"data_dir": "voc/VOC2007", "split": "train"},
        "voc_2007_val": {"data_dir": "voc/VOC2007", "split": "val"},
        "voc_2007_test": {"data_dir": "voc/VOC2007", "split": "test"},
        "voc_2012_train": {"data_dir": "voc/VOC2012", "split": "train"},
        "voc_2012_val": {"data_dir": "voc/VOC2012", "split": "val"},
        "voc_2007_train_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_train2007.json",
        },
        "voc_2007_val_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_val2007.json",
        },
        "voc_2007_test_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_test2007.json",
        },
        "cityscapes_train_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit/train",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_train_cocostyle.json",
        },
        "cityscapes_train_caronly_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit/train",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_train_caronly_cocostyle.json",
        },
        "cityscapes_val_caronly_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit/val",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_val_caronly_cocostyle.json",
        },
        "cityscapes_val_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit/val",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_val_cocostyle.json",
        },
        "cityscapes_foggy_train_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit_foggy/train",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_foggy_train_cocostyle.json",
        },
        "cityscapes_foggy_val_cocostyle": {
            "img_dir": "Cityscapes/leftImg8bit_foggy/val",
            "ann_file": "Cityscapes/cocoAnnotations/cityscapes_foggy_val_cocostyle.json",
        },
        "sim10k_trainval_caronly": {
            "data_dir": "Sim10k",
            "split": "trainval10k_caronly",
        },
        "kitti_train_caronly": {"data_dir": "KITTI", "split": "train_caronly"},
    }

    @staticmethod
    def get(name):
        if name not in DatasetCatalog.DATASETS:
            raise RuntimeError(f"Dataset not available: {name}")
        attrs = DatasetCatalog.DATASETS[name]
        data_dir = DatasetCatalog.DATA_DIR
        if "kitti" in name:
            factory = "KittiDataset"
            args = dict(
                data_dir=os.path.join(data_dir, attrs["data_dir"]),
                split=attrs["split"],
            )
        elif "sim10k" in name:
            factory = "Sim10kDataset"
            args = dict(
                data_dir=os.path.join(data_dir, attrs["data_dir"]),
                split=attrs["split"],
            )
        elif "coco" in name or "cocostyle" in name or "cityscapes" in name:
            factory = "COCODataset"
            args = dict(
                root=os.path.join(data_dir, attrs["img_dir"]),
                ann_file=os.path.join(data_dir, attrs["ann_file"]),
            )
        elif "voc" in name:
            factory = "PascalVOCDataset"
            args = dict(
                data_dir=os.path.join(data_dir, attrs["data_dir"]),
                split=attrs["split"],
            )
        else:
            raise RuntimeError(f"Dataset not available: {name}")
        return dict(factory=factory, args=args)
