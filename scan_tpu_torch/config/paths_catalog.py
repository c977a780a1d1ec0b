"""Dataset name -> (factory, paths) catalog; a copy of
``scan_tpu/config/paths_catalog.py``, which the port does not import.

Mirrors the reference catalog (reference ``fcos_core/config/paths_catalog.py:7``)
for all dataset names used by the SCAN/EPM configs. ``DATA_DIR`` is
overridable via the ``SCAN_TPU_DATA_DIR`` environment variable, the one
``scan_tpu`` reads, so one data tree serves both packages. ``ModelCatalog``
resolves ``catalog://`` weight names to the Detectron URLs, as
``scan_tpu``'s does; the port fetches nothing, and ``utils/model_zoo.py``
looks the URL's file up in the local weight cache.
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


class ModelCatalog:
    """``catalog://`` name -> pretrained-weight URL resolution.

    Parity target: reference ``fcos_core/config/paths_catalog.py:184-235``.
    The catalog names map onto the public Detectron bucket; resolution is
    pure string logic. Nothing is downloaded: ``utils/model_zoo.py`` finds
    the URL's file in the local weight cache.
    """

    S3_C2_DETECTRON_URL = "https://dl.fbaipublicfiles.com/detectron"
    C2_IMAGENET_MODELS = {
        "MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
        "MSRA/R-50-GN": "ImageNetPretrained/47261647/R-50-GN.pkl",
        "MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
        "MSRA/R-101-GN": "ImageNetPretrained/47592356/R-101-GN.pkl",
        "FAIR/20171220/X-101-32x8d":
            "ImageNetPretrained/20171220/X-101-32x8d.pkl",
        "FAIR/20171220/X-101-64x4d":
            "ImageNetPretrained/20171220/X-101-64x4d.pkl",
    }
    C2_DETECTRON_SUFFIX = (
        "output/train/{}coco_2014_train%3A{}coco_2014_valminusminival/"
        "generalized_rcnn/model_final.pkl"
    )
    C2_DETECTRON_MODELS = {
        "35857197/e2e_faster_rcnn_R-50-C4_1x": "01_33_49.iAX0mXvW",
        "35857345/e2e_faster_rcnn_R-50-FPN_1x": "01_36_30.cUF7QR7I",
        "35857890/e2e_faster_rcnn_R-101-FPN_1x": "01_38_50.sNxI7sX7",
        "36761737/e2e_faster_rcnn_X-101-32x8d-FPN_1x": "06_31_39.5MIHi1fZ",
        "35858791/e2e_mask_rcnn_R-50-C4_1x": "01_45_57.ZgkA7hPB",
        "35858933/e2e_mask_rcnn_R-50-FPN_1x": "01_48_14.DzEQe4wC",
        "35861795/e2e_mask_rcnn_R-101-FPN_1x": "02_31_37.KqyEK4tT",
        "36761843/e2e_mask_rcnn_X-101-32x8d-FPN_1x": "06_35_59.RZotkLKI",
        "37129812/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x":
            "09_35_36.8pzTQKYK",
        "37697547/e2e_keypoint_rcnn_R-50-FPN_1x": "08_42_54.kdzV35ao",
    }

    @staticmethod
    def get(name: str) -> str:
        if name.startswith("Caffe2Detectron/COCO"):
            return ModelCatalog._detectron_baseline(name)
        if name.startswith("ImageNetPretrained"):
            key = name[len("ImageNetPretrained/"):]
            return "/".join([
                ModelCatalog.S3_C2_DETECTRON_URL,
                ModelCatalog.C2_IMAGENET_MODELS[key],
            ])
        raise RuntimeError(f"model not present in the catalog: {name}")

    @staticmethod
    def _detectron_baseline(name: str) -> str:
        dataset_tag = "keypoints_" if "keypoint" in name else ""
        suffix = ModelCatalog.C2_DETECTRON_SUFFIX.format(
            dataset_tag, dataset_tag
        )
        key = name[len("Caffe2Detectron/COCO/"):]
        model_id, model_name = key.split("/")
        signature = ModelCatalog.C2_DETECTRON_MODELS[key]
        name_with_sig = f"{model_name}.yaml.{signature}"
        return "/".join([
            ModelCatalog.S3_C2_DETECTRON_URL, model_id,
            "12_2017_baselines", name_with_sig, suffix,
        ])
