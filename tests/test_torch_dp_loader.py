"""Each data-parallel rank's loader decodes only its slots
(``data/build.py::DetectionLoader`` with ``rank`` and ``world``), on the CPU.

* Without a process group (the loader takes ``rank`` and ``world``; the
  factories read them from ``parallel/mesh.py``): at world 2 and 4, each
  rank's train, target and eval batches are byte for byte ``shard_batch``
  of the world-1 batch, marked ``RANK_SLICE`` = (rank, world), from
  iteration 0 and resumed at ``start_iter`` 3; each rank decodes only its
  slots (the dataset's ``load_image`` counted), and its eval cache holds
  only its images.
* Under a two-rank gloo group (``torch.multiprocessing`` spawn, a ``file://``
  store): the factories' loaders are the rank's; a marked batch reaches the
  data-parallel step unsliced, an unmarked global batch is sliced as
  before, a batch marked for another rank raises; ``compute_predictions``
  predicts the rank's images of a marked batch.
"""

import os
import time

import numpy as np
import pytest
import torch

from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.data import build
from scan_tpu_torch.parallel.mesh import RANK_SLICE, rank_part, shard_batch
from tests.test_torch_data import KEYS, data_cfg, make_trees


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_trees(d)
    return d


@pytest.fixture(autouse=True)
def catalog(data_dir, monkeypatch):
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", data_dir)


def cfg_for(threads=2):
    cfg = data_cfg(get_default_cfg(), threads=threads)
    cfg.SOLVER.IMS_PER_BATCH = 4   # splits over 2 and 4 ranks
    cfg.TEST.IMS_PER_BATCH = 4     # 5 val frames: the second batch has 1
    return cfg


def loaders(cfg, split, rank, world, monkeypatch, start_iter=0):
    """The factories' loader for ``split`` as rank ``rank`` of ``world``."""
    monkeypatch.setattr(build, "get_rank", lambda: rank)
    monkeypatch.setattr(build, "get_world_size", lambda: world)
    if split == "source":
        return build.make_data_loader_source(cfg, start_iter=start_iter)
    if split == "target":
        cfg.defrost()
        cfg.DATASETS.TRAIN_TARGET = ("cityscapes_foggy_train_cocostyle",)
        return build.make_data_loader_target(cfg, start_iter=start_iter)
    return build.make_data_loaders_test(cfg)[0]


def assert_rank_batches(got, want, rank, world):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[RANK_SLICE] == (rank, world)
        part = rank_part(g, rank, world)
        assert sorted(part) == sorted(KEYS)
        shard = shard_batch(w, rank, world)
        for k in KEYS:
            assert part[k].dtype == shard[k].dtype, k
            np.testing.assert_array_equal(part[k], shard[k], err_msg=k)


@pytest.mark.parametrize("split,start_iter", [
    ("source", 0), ("source", 3), ("target", 0), ("target", 3), ("eval", 0)])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_batches_are_shards_of_the_global_batch(monkeypatch, world,
                                                     split, start_iter):
    cfg = cfg_for()
    want = list(loaders(cfg, split, 0, 1, monkeypatch, start_iter))
    assert all(RANK_SLICE not in w for w in want)  # world 1: unmarked
    for rank in range(world):
        got = list(loaders(cfg, split, rank, world, monkeypatch, start_iter))
        assert_rank_batches(got, want, rank, world)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("split", ["source", "eval"])
def test_each_rank_decodes_only_its_slots(monkeypatch, split, world):
    cfg = cfg_for(threads=1)
    decoded = {}
    for rank in range(world):
        loader = loaders(cfg, split, rank, world, monkeypatch)
        calls = []
        load = loader.dataset.load_image
        monkeypatch.setattr(loader.dataset, "load_image",
                            lambda i, load=load, calls=calls: (
                                calls.append(i), load(i))[1])
        batches = list(loader)
        mine = [int(i) for b in batches for i in b["indices"] if i >= 0]
        assert sorted(calls) == sorted(mine)  # its images, each once
        decoded[rank] = calls
        if split == "eval":
            assert sorted(loader._eval_cache) == sorted(set(mine))
            again = list(loader)  # the second pass decodes nothing
            assert len(calls) == len(mine)
            for a, b in zip(again, batches):
                np.testing.assert_array_equal(a["images"], b["images"])
    n_slots = cfg.SOLVER.IMS_PER_BATCH * cfg.SOLVER.MAX_ITER
    total = sum(len(v) for v in decoded.values())
    assert total == (n_slots if split == "source" else 5)


def test_loader_refuses_an_uneven_split():
    cfg = cfg_for()
    ds = build.build_datasets(cfg.DATASETS.TRAIN_SOURCE, is_train=True)
    with pytest.raises(ValueError):
        build.DetectionLoader(ds, cfg, True, 3, max_iters=2, rank=0, world=2)
    with pytest.raises(ValueError):
        build.DetectionLoader(ds, cfg, True, 4, max_iters=2, rank=2, world=2)


def test_rank_part_refuses_another_ranks_batch():
    batch = {"images": np.zeros((2, 4, 4, 3)), RANK_SLICE: (1, 2)}
    assert rank_part(batch, 1, 2).keys() == {"images"}
    with pytest.raises(ValueError):
        rank_part(batch, 0, 2)
    with pytest.raises(ValueError):
        rank_part(batch, 1, 4)
    # unmarked: sliced as before
    glob = {"images": np.arange(4)}
    assert np.array_equal(rank_part(glob, 1, 2)["images"], [2, 3])


# ---- under a two-rank gloo group -----------------------------------------

WORLD = 2


class _Probe(torch.nn.Module):
    """A detector stand-in for ``compute_predictions``: one box a slot."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward_inference(self, images, sizes):
        b = images.shape[0]
        boxes = torch.zeros(b, 1, 4)
        boxes[:, 0, 2:] = sizes.flip(-1).float()
        return dict(boxes=boxes, scores=torch.ones(b, 1),
                    labels=torch.ones(b, 1, dtype=torch.int64),
                    valid=torch.ones(b, 1, dtype=torch.bool))


def _rank_main(rank, world, store, work, data_dir):
    from scan_tpu_torch.engine import dp
    from scan_tpu_torch.engine import train_step as plain
    from scan_tpu_torch.engine.inference import compute_predictions
    from scan_tpu_torch.parallel.mesh import maybe_init_distributed

    torch.set_num_threads(1)
    DatasetCatalog.DATA_DIR = data_dir
    maybe_init_distributed(True, device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=world, timeout_s=120)
    cfg = cfg_for()
    out = {}
    src = build.make_data_loader_source(cfg)
    val = build.make_data_loaders_test(cfg)[0]
    out["loader_rank_world"] = (src.rank, src.world, val.rank, val.world)
    seen = []

    def fake_da_step(detector, optimizer, scheduler=None, reduce=None):
        def step(proto, batch_s, batch_t, forward_target=False,
                 generator=None):
            seen.append((batch_s, batch_t))
            return proto, {}
        return step

    def fake_source_step(detector, optimizer, scheduler=None, reduce=None):
        def step(proto, batch, generator=None):
            seen.append((batch, None))
            return proto, {}
        return step

    plain.make_da_train_step = fake_da_step
    plain.make_source_only_train_step = fake_source_step
    da = dp.make_dp_da_train_step(None, None)
    so = dp.make_dp_source_only_train_step(None, None)
    batch = next(iter(src))
    da(None, batch, {"images": batch["images"],
                     RANK_SLICE: batch[RANK_SLICE]})
    so(None, batch)
    glob = {k: np.arange(4 * 3).reshape(4, 3) + 100 * i
            for i, k in enumerate(("images", "sizes"))}
    da(None, glob, {"images": glob["images"]})
    other = dict(batch, **{RANK_SLICE: (1 - rank, world)})
    try:
        so(None, other)
        out["other_rank_raised"] = False
    except ValueError:
        out["other_rank_raised"] = True
    out["batch"] = batch
    out["seen"] = seen
    out["predictions"] = sorted(compute_predictions(_Probe(), val,
                                                    progress_every=0))
    out["val_indices"] = sorted(int(i) for b in val for i in b["indices"]
                                if i >= 0)
    torch.save(out, os.path.join(work, f"rank{rank}.pth"))
    torch.distributed.destroy_process_group()


def test_marked_batches_reach_the_dp_step_unsliced(tmp_path, data_dir):
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(WORLD, str(tmp_path / "store"), str(tmp_path),
                          data_dir), nprocs=WORLD, join=False)
    deadline = time.time() + 240
    while not ctx.join(timeout=5):
        assert time.time() < deadline, "the ranks did not finish"
    all_val = set()
    for rank in range(WORLD):
        r = torch.load(tmp_path / f"rank{rank}.pth", weights_only=False)
        assert r["loader_rank_world"] == (rank, WORLD, rank, WORLD)
        batch = r["batch"]
        assert batch[RANK_SLICE] == (rank, WORLD)
        assert len(batch["images"]) == 2  # 4 a global batch, 2 a rank
        (ds_s, ds_t), (so_b, _), (g_s, g_t) = r["seen"]
        for got in (ds_s, so_b):  # marked: unsliced, without the mark
            assert RANK_SLICE not in got and sorted(got) == sorted(KEYS)
            for k in KEYS:
                assert got[k] is batch[k], k
        assert ds_t["images"] is batch["images"] and RANK_SLICE not in ds_t
        # unmarked global: this rank's half, as before
        np.testing.assert_array_equal(g_s["images"],
                                      (np.arange(12).reshape(4, 3))[
                                          2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(g_t["images"], g_s["images"])
        assert r["other_rank_raised"]
        assert r["predictions"] == r["val_indices"]
        all_val |= set(r["val_indices"])
    assert all_val == set(range(5))  # the ranks' images cover the set once


def test_dp_scaling_reads_the_last_window():
    """``tools/dp_scaling.py`` takes the last 20 iterations' seconds and
    data wait from the global averages printed at iterations 20 and 40."""
    from scan_tpu_torch.tools.dp_scaling import last_window

    log = "\n".join(
        f"x INFO: eta: 0:00:01  iter: {it}  time: 9.9 ({g:.4f})  "
        f"data: 9.9 ({d:.4f})  loss_cls_gs: 1.0 (1.0)  fwd_tgt: False"
        for it, g, d in ((20, 0.31, 0.05), (40, 0.28, 0.035)))
    it_s, data_s = last_window(log, 40)
    assert it_s == pytest.approx(0.25) and data_s == pytest.approx(0.02)
