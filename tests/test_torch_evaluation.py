"""The port's evaluation (``evaluation/voc_eval.py``,
``engine/inference.py::evaluate_dataset``) against ``scan_tpu``'s, on the CPU.

Seeded predictions (each GT box jittered, with a score, a right or wrong
label, plus false positives) over the synthetic COCO and VOC/KITTI/Sim10k
trees of ``test_torch_data.py``, read through each package's own
datasets: the results dicts must be equal, per category too. Both sides
run the same numpy arithmetic, so there is no tolerance. ``evaluate_dataset``
must dispatch as ``scan_tpu``'s: COCO metrics for a ``COCODataset``, VOC
metrics for any other dataset.
"""

import numpy as np
import pytest

from scan_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from scan_tpu.data import build as jax_build
from scan_tpu.engine.inference import \
    evaluate_dataset as jax_evaluate_dataset
from scan_tpu.evaluation import voc_eval as jax_voc_eval
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.data import build
from scan_tpu_torch.engine.inference import evaluate_dataset
from scan_tpu_torch.evaluation import voc_eval
from tests.test_torch_data import make_trees

NAMES = ["cityscapes_foggy_val_cocostyle", "cityscapes_train_cocostyle",
         "voc_2007_test", "kitti_train_caronly", "sim10k_trainval_caronly"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_trees(d)
    return d


@pytest.fixture(autouse=True)
def catalogs(data_dir, monkeypatch):
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", data_dir)
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", data_dir)


def seeded_predictions(dataset, n_classes, seed):
    rng = np.random.RandomState(seed)
    preds = {}
    for i in range(len(dataset)):
        boxes, labels = dataset.get_raw_target(i)
        jitter = rng.randn(*boxes.shape).astype(np.float32) * 3
        wrong = rng.rand(len(labels)) < 0.2
        labels = np.where(wrong, rng.randint(1, n_classes, len(labels)),
                          labels)
        xy = rng.rand(3, 2) * 60
        fp = np.concatenate([xy, xy + rng.rand(3, 2) * 30 + 5], 1)
        preds[i] = dict(
            boxes=np.concatenate([boxes + jitter, fp]).astype(np.float32),
            scores=rng.rand(len(labels) + 3).astype(np.float32),
            labels=np.concatenate([labels, rng.randint(1, n_classes, 3)])
            .astype(np.int32))
    return preds


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_dataset_equals_scan_tpu(name):
    ds = build.build_dataset(name, is_train=False)
    jds = jax_build.build_dataset(name, is_train=False)
    n_classes = len(ds.class_names()) + 1
    preds = seeded_predictions(ds, n_classes, seed=len(name))
    got = evaluate_dataset(ds, preds)
    want = jax_evaluate_dataset(jds, preds)
    assert dict(got) == dict(want)
    key = "AP" if "coco" in name else "map"
    assert key in got and 0.0 < got["AP50"] < 1.0


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_eval_equals_scan_tpu(use_07):
    ds = build.build_dataset("voc_2007_test", is_train=False)
    jds = jax_build.build_dataset("voc_2007_test", is_train=False)
    preds = seeded_predictions(ds, 21, seed=7)
    got = voc_eval.evaluate_voc_dataset(ds, preds, use_07_metric=use_07)
    want = jax_voc_eval.evaluate_voc_dataset(jds, preds, use_07_metric=use_07)
    assert got == want
    rng = np.random.RandomState(0)
    rec = np.sort(rng.rand(30))
    prec = rng.rand(30)
    assert voc_eval.voc_ap(rec, prec, use_07) == \
        jax_voc_eval.voc_ap(rec, prec, use_07)
