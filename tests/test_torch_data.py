"""The port's datasets and loader (``scan_tpu_torch/data``) against
``scan_tpu``'s, on the CPU.

Synthetic trees at the catalog's paths (a Cityscapes-style COCO tree with
landscape and portrait frames, Pascal VOC, KITTI, Sim10k; noise images in
PNG and JPEG) are read through both packages' catalogs and
``make_data_loader_source`` / ``make_data_loaders_test``. Every key of
every batch (``images`` uint8 and float32, ``sizes``, ``boxes``, ``labels``,
``mask``, ``scales``, ``indices``) must be equal byte for byte, in train and
eval, with 1 and 3 loader threads, from iteration 0 and from ``start_iter``
3. Both packages decode with their own native library and resize as PIL
does, so there is no tolerance.
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from scan_tpu.data import build as jax_build
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.data import build
from scan_tpu_torch.data.datasets.concat import ConcatDataset
from tests.test_e2e_train import make_synth_coco
from tests.test_voc_datasets import make_voc_tree

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
KEYS = ("images", "sizes", "boxes", "labels", "mask", "scales", "indices")
# (train name, test name) per dataset family
NAMES = {
    "coco": ("cityscapes_train_cocostyle", "cityscapes_foggy_val_cocostyle"),
    "voc": ("voc_2007_train", "voc_2007_test"),
    "kitti": ("kitti_train_caronly", "kitti_train_caronly"),
    "sim10k": ("sim10k_trainval_caronly", "sim10k_trainval_caronly"),
}


def coco_tree(data_dir, name, img_dir, shapes, seed):
    """A COCO tree at the catalog's paths for ``name``: make_synth_coco
    sets of each (h, w) in ``shapes``, merged into one json."""
    merged = dict(images=[], annotations=[], categories=None)
    dst = os.path.join(data_dir, img_dir)
    os.makedirs(dst, exist_ok=True)
    for k, (n, hw) in enumerate(shapes):
        tmp = os.path.join(data_dir, f"_tmp_{name}_{k}")
        ann, imgs = make_synth_coco(tmp, n_images=n, hw=hw, seed=seed + k)
        with open(ann) as f:
            d = json.load(f)
        for im in d["images"]:
            src = os.path.join(imgs, im["file_name"])
            im["file_name"] = f"s{k}_{im['file_name']}"
            im["id"] += 100 * k
            shutil.move(src, os.path.join(dst, im["file_name"]))
        for a in d["annotations"]:
            a["id"] += 1000 * k
            a["image_id"] += 100 * k
        merged["images"] += d["images"]
        merged["annotations"] += d["annotations"]
        merged["categories"] = d["categories"]
        shutil.rmtree(tmp)
    # a crowd box, which training drops and evaluation ignores
    merged["annotations"].append(dict(
        id=99999, image_id=merged["images"][0]["id"], category_id=1,
        bbox=[2, 2, 30, 20], area=600, iscrowd=1))
    ann_dir = os.path.join(data_dir, "Cityscapes", "cocoAnnotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(ann_dir, f"{name}.json"), "w") as f:
        json.dump(merged, f)


def voc_tree(root, split, ids, ext, seed, classes):
    """make_voc_tree with noise images and ``split`` as the image set."""
    rng = np.random.RandomState(seed)
    objs = {}
    for i in ids:
        objs[i] = [dict(name=classes[(j + len(i)) % len(classes)],
                        diff=int(j == 2), x1=int(rng.randint(1, 40)),
                        y1=int(rng.randint(1, 30)), x2=int(rng.randint(50, 99)),
                        y2=int(rng.randint(40, 79))) for j in range(4)]
    make_voc_tree(root, ids, ext=ext, objects_per_id=objs)
    for i in ids:
        arr = rng.randint(0, 256, (80, 100, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "JPEGImages", i + ext))
    os.replace(os.path.join(root, "ImageSets", "Main", "split.txt"),
               os.path.join(root, "ImageSets", "Main", f"{split}.txt"))


def make_trees(data_dir):
    """Every tree the new tests read, under one SCAN_TPU_DATA_DIR."""
    coco_tree(data_dir, "cityscapes_train_cocostyle",
              "Cityscapes/leftImg8bit/train", [(4, (96, 128)), (3, (128, 96))],
              seed=0)
    coco_tree(data_dir, "cityscapes_foggy_train_cocostyle",
              "Cityscapes/leftImg8bit_foggy/train", [(5, (96, 128))], seed=10)
    coco_tree(data_dir, "cityscapes_foggy_val_cocostyle",
              "Cityscapes/leftImg8bit_foggy/val", [(5, (96, 128))], seed=20)
    for split, seed in (("train", 30), ("test", 31)):
        voc_tree(os.path.join(data_dir, "voc", "VOC2007"), split,
                 [f"{split}{i}" for i in range(5)], ".jpg", seed,
                 ("dog", "car", "person", "cat"))
    voc_tree(os.path.join(data_dir, "KITTI"), "train_caronly",
             [f"k{i}" for i in range(4)], ".png", 40, ("car", "person"))
    voc_tree(os.path.join(data_dir, "Sim10k"), "trainval10k_caronly",
             [f"s{i}" for i in range(4)], ".jpg", 50, ("car", "person"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_trees(d)
    return d


@pytest.fixture(autouse=True)
def catalogs(data_dir, monkeypatch):
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", data_dir)
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", data_dir)


def data_cfg(cfg, family="coco", threads=1, u8=True):
    cfg.merge_from_file(C2F)
    cfg.INPUT.MIN_SIZE_RANGE_TRAIN = (-1, -1)
    cfg.INPUT.MIN_SIZE_TRAIN = (64, 72, 80)
    cfg.INPUT.MAX_SIZE_TRAIN = 120
    cfg.INPUT.MIN_SIZE_TEST = 72
    cfg.INPUT.MAX_SIZE_TEST = 120
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.TEST.IMS_PER_BATCH = 3
    cfg.SOLVER.MAX_ITER = 7
    cfg.TPU.MAX_BOXES = 3
    cfg.TPU.LOADER_THREADS = threads
    cfg.TPU.DEVICE_NORMALIZE = u8
    cfg.DATASETS.TRAIN_SOURCE = (NAMES[family][0],)
    cfg.DATASETS.TEST = (NAMES[family][1],)
    return cfg


def both_cfgs(**kw):
    return data_cfg(get_default_cfg(), **kw), data_cfg(jax_default_cfg(), **kw)


def assert_batches_equal(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("family", ["coco", "voc", "kitti", "sim10k"])
def test_loader_batches_equal_scan_tpu(family, split, threads):
    cfg, jcfg = both_cfgs(family=family, threads=threads)
    if split == "train":
        got = list(build.make_data_loader_source(cfg))
        want = list(jax_build.make_data_loader_source(jcfg))
    else:
        got = list(build.make_data_loaders_test(cfg)[0])
        want = list(jax_build.make_data_loaders_test(jcfg)[0])
    assert_batches_equal(got, want)
    assert got[0]["images"].dtype == np.uint8


@pytest.mark.parametrize("split", ["train", "eval"])
def test_float32_batches_equal_scan_tpu(split):
    """TPU.DEVICE_NORMALIZE off: the host normalises into float32."""
    cfg, jcfg = both_cfgs(u8=False, threads=2)
    if split == "train":
        got = list(build.make_data_loader_source(cfg))
        want = list(jax_build.make_data_loader_source(jcfg))
    else:
        got = list(build.make_data_loaders_test(cfg)[0])
        want = list(jax_build.make_data_loaders_test(jcfg)[0])
    assert_batches_equal(got, want)
    assert got[0]["images"].dtype == np.float32


@pytest.mark.parametrize("threads", [1, 3])
def test_start_iter_skips_into_the_stream(threads):
    cfg, jcfg = both_cfgs(threads=threads)
    straight = list(build.make_data_loader_source(cfg))
    resumed = list(build.make_data_loader_source(cfg, start_iter=3))
    want = list(jax_build.make_data_loader_source(jcfg, start_iter=3))
    assert len(straight) == 7 and len(resumed) == 4
    assert_batches_equal(resumed, straight[3:])
    assert_batches_equal(resumed, want)
    # the target stream: seed + 1, also resumed
    tgt = list(build.make_data_loader_target(cfg, start_iter=3))
    assert_batches_equal(tgt, list(jax_build.make_data_loader_target(
        jcfg, start_iter=3)))


def test_aspect_ratio_groups_and_buckets():
    cfg, jcfg = both_cfgs()
    loader = build.make_data_loader_source(cfg)
    jloader = jax_build.make_data_loader_source(jcfg)
    assert loader.groups == jloader.groups and len(loader.groups) == 2
    assert loader.buckets == jloader.buckets
    assert all(h % 32 == 0 and w % 32 == 0 for h, w in loader.buckets)
    (lh, lw), (ph, pw) = loader.buckets
    assert lw > lh and ph > pw  # one landscape, one portrait bucket
    for batch in loader:
        shape = batch["images"].shape[1:3]
        group = loader.buckets.index(shape)
        assert set(batch["indices"].tolist()) <= set(loader.groups[group])
    ds = loader.dataset
    assert build.compute_bucket_hw(ds, cfg, False) == \
        jax_build.compute_bucket_hw(jloader.dataset, jcfg, False)


def test_eval_cache_second_pass_equals_first():
    cfg, _ = both_cfgs(threads=3)
    loader = build.make_data_loaders_test(cfg)[0]
    first = list(loader)
    assert len(loader._eval_cache) == len(loader.dataset)
    second = list(loader)
    assert_batches_equal(second, first)
    assert first[-1]["indices"][-1] == -1  # 5 images in batches of 3


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_a_loader_thread_error_reaches_the_caller(split, threads,
                                                  monkeypatch):
    """An image that fails to load raises in the consumer at the batch
    that holds it, after every batch before it; the loader does not end
    early and quietly."""
    cfg, _ = both_cfgs(threads=threads)
    loader = (build.make_data_loader_source(cfg) if split == "train"
              else build.make_data_loaders_test(cfg)[0])
    stream = [idx for _, _, idx in loader._index_stream()]
    bad = stream[1][0]
    turn = min(k for k, idx in enumerate(stream) if bad in idx)
    real = loader.dataset.load_image

    def load_image(i):
        if i == bad:
            raise OSError(f"image {i} is unreadable")
        return real(i)

    monkeypatch.setattr(loader.dataset, "load_image", load_image)
    got = []
    with pytest.raises(OSError, match=f"image {bad} is unreadable"):
        for batch in loader:
            got.append(batch)
    assert len(got) == turn


def test_build_datasets_concatenates_for_training():
    cfg, jcfg = both_cfgs()
    names = ("cityscapes_train_cocostyle", "kitti_train_caronly")
    ds = build.build_datasets(names, is_train=True)
    jds = jax_build.build_datasets(names, is_train=True)
    assert isinstance(ds, ConcatDataset) and len(ds) == len(jds) == 11
    assert [len(d) for d in build.build_datasets(names, is_train=False)] \
        == [7, 4]
    for cfg_ in (cfg, jcfg):
        cfg_.DATASETS.TRAIN_SOURCE = names
    assert_batches_equal(list(build.make_data_loader_source(cfg)),
                         list(jax_build.make_data_loader_source(jcfg)))
