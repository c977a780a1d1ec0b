"""Datasets and fixed-shape batch loaders (counterpart of ``scan_tpu/data``)."""

from .build import (
    DetectionLoader,
    build_dataset,
    build_datasets,
    make_data_loader_source,
    make_data_loader_target,
    make_data_loader_test,
    make_data_loaders_test,
    make_data_loader_train,
)
from .datasets.concat import ConcatDataset
from .datasets.list_dataset import ListDataset

# reference-name alias (fcos_core.data.make_data_loader)
make_data_loader = make_data_loader_test

__all__ = [
    "ConcatDataset",
    "ListDataset",
    "DetectionLoader",
    "build_dataset",
    "build_datasets",
    "make_data_loader",
    "make_data_loader_source",
    "make_data_loader_target",
    "make_data_loader_test",
    "make_data_loaders_test",
    "make_data_loader_train",
]
