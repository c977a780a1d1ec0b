"""Dataset factories and fixed-shape batch loaders; a copy of
``scan_tpu/data/build.py``, which the port does not import.

Parity target: reference ``fcos_core/data/build.py:107-321``
(make_data_loader{,_source,_target}): catalog-resolved datasets, infinite
iteration-based sampling for the DA streams, aspect-ratio-aware batching.

Fixed-shape batching, as ``scan_tpu`` has it: every batch is padded to a
static bucket (H, W) chosen from the dataset's resize envelope, rounded to
32, and GT is padded to TPU.MAX_BOXES with a validity mask. Loading runs in
background threads with a bounded prefetch queue. Batches are numpy arrays,
exactly as ``scan_tpu`` yields them; the loader threads never touch CUDA
(the consumer copies a batch to the card).
"""

import math
import queue
import random
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..config.paths_catalog import DatasetCatalog
from ..parallel.mesh import RANK_SLICE, get_rank, get_world_size
from .datasets.coco import COCODataset
from .datasets.concat import ConcatDataset
from .datasets.voc_xml import KittiDataset, PascalVOCDataset, Sim10kDataset
from .transforms import build_preprocessor, get_resize_hw

FACTORIES = {
    "COCODataset": COCODataset,
    "PascalVOCDataset": PascalVOCDataset,
    "Sim10kDataset": Sim10kDataset,
    "KittiDataset": KittiDataset,
}


def build_dataset(name: str, is_train: bool):
    spec = DatasetCatalog.get(name)
    factory = FACTORIES[spec["factory"]]
    args = dict(spec["args"])
    if spec["factory"] == "COCODataset":
        args["remove_images_without_annotations"] = is_train
    elif is_train is False:
        args["use_difficult"] = True
    return factory(**args)


def build_datasets(names, is_train: bool):
    """Builds every name in a DATASETS list; concatenates when training
    (reference ``fcos_core/data/build.py:32-54``). Test-time callers get
    the per-name list back, one loader/evaluation per dataset."""
    if isinstance(names, str):
        names = (names,)
    datasets = [build_dataset(n, is_train) for n in names]
    if not is_train:
        return datasets
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _resize_envelope(cfg, is_train: bool):
    if is_train:
        if cfg.INPUT.MIN_SIZE_RANGE_TRAIN[0] == -1:
            sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        else:
            sizes = [cfg.INPUT.MIN_SIZE_RANGE_TRAIN[1]]
        return sizes, cfg.INPUT.MAX_SIZE_TRAIN
    return [cfg.INPUT.MIN_SIZE_TEST], cfg.INPUT.MAX_SIZE_TEST


def compute_bucket_hw(dataset, cfg, is_train: bool, indices=None):
    """Max (H, W) over the dataset's resize envelope, rounded to /32."""
    div = max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32)
    sizes, max_size = _resize_envelope(cfg, is_train)
    best_h = best_w = 0
    pool = indices if indices is not None else range(len(dataset))
    pool = list(pool)
    # sample aspect ratios (cheap: img info only)
    step = max(1, len(pool) // 256)
    for i in pool[::step]:
        info = dataset.get_img_info(i)
        for s in sizes:
            oh, ow = get_resize_hw(info["width"], info["height"], s, max_size)
            best_h = max(best_h, oh)
            best_w = max(best_w, ow)
    return _round_up(best_h, div), _round_up(best_w, div)


def aspect_ratio_groups(dataset):
    """Indices split by orientation (reference GroupedBatchSampler groups on
    aspect ratio >= 1, data/build.py:85-104): landscape vs portrait."""
    landscape, portrait = [], []
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        (landscape if info["width"] >= info["height"] else portrait).append(i)
    return [g for g in (landscape, portrait) if g]


class DetectionLoader:
    """Yields fixed-shape numpy batches.

    Train batches: images (B,H,W,3), sizes (B,2), boxes (B,G,4),
    labels (B,G), mask (B,G). Eval batches additionally carry 'indices'
    (dataset indices) and 'scales' (w_ratio, h_ratio back to original).

    Data parallelism: with ``world`` > 1 the loader decodes, transforms and
    yields only slots [rank B / world, (rank + 1) B / world) of each
    global batch of ``batch_size`` B, marked ``RANK_SLICE`` = (rank, world)
    so that the data-parallel step and ``engine/inference.py`` do not slice
    it again. Everything that decides a batch stays global (the index
    stream and its ``start_iter`` skip, the aspect-ratio groups, the
    buckets, each slot's transform key), so a rank's batch is byte for byte
    ``shard_batch(global_batch, rank, world)`` with the mark. ``world`` 1
    yields the global batch, unmarked.
    """

    def __init__(self, dataset, cfg, is_train: bool, batch_size: int,
                 max_iters: Optional[int] = None, seed: int = 1234,
                 bucket_hw=None, num_threads: Optional[int] = None,
                 start_iter: int = 0, rank: int = 0, world: int = 1):
        if world < 1 or not 0 <= rank < world or batch_size % world:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"rank {rank} of {world} processes")
        self.dataset = dataset
        self.cfg = cfg
        self.is_train = is_train
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.max_iters = max_iters
        self.seed = seed
        # resume support (reference IterationBasedBatchSampler,
        # data/build.py:86-104): skip into the shuffled stream so a
        # restored run sees the batches it would have seen. Exact because
        # per-image transform draws are keyed by (seed, iteration, slot),
        # not a sequential stream (see _make_batch).
        self.start_iter = start_iter
        self.max_boxes = cfg.TPU.MAX_BOXES
        self.pre = build_preprocessor(cfg, is_train, seed=seed)
        # aspect-ratio grouping (reference GroupedBatchSampler): one static
        # bucket per orientation so portrait images don't pad to landscape
        if bucket_hw is not None:
            self.groups = [list(range(len(dataset)))]
            self.buckets = [bucket_hw]
        elif cfg.DATALOADER.ASPECT_RATIO_GROUPING:
            self.groups = aspect_ratio_groups(dataset)
            self.buckets = [
                compute_bucket_hw(dataset, cfg, is_train, indices=g)
                for g in self.groups
            ]
        else:
            self.groups = [list(range(len(dataset)))]
            self.buckets = [compute_bucket_hw(dataset, cfg, is_train)]
        # the largest bucket, for callers sizing init samples
        self.bucket_hw = max(self.buckets)
        self.num_threads = num_threads or cfg.TPU.LOADER_THREADS
        self.device_normalize = bool(cfg.TPU.get("DEVICE_NORMALIZE", False))
        # Decode-once cache for fixed eval sets: eval transforms are
        # deterministic (single MIN_SIZE_TEST, no flip), so the
        # post-transform slot content is a pure function of the index.
        # Under data parallelism it holds only this rank's images.
        # The first pass pays decode+resize; re-iterations (repeated
        # in-training validations, eval re-runs) copy from the cache.
        # Bounded by TPU.EVAL_CACHE_MB (0 disables); entries stop being
        # added once the budget is spent.
        cache_mb = int(cfg.TPU.get("EVAL_CACHE_MB", 0))
        self._eval_cache = {} if (not is_train and cache_mb > 0) else None
        self._eval_cache_free = cache_mb << 20

    def __len__(self):
        if self.is_train:
            return max((self.max_iters or 0) - self.start_iter, 0)
        return math.ceil(len(self.dataset) / self.batch_size)

    def _index_stream(self) -> Iterator[tuple]:
        """Yields (iteration, group_id, indices) with batches drawn within
        one orientation group (reference grouped_batch_sampler semantics).
        Skips the first ``start_iter`` batches cheaply (index math only —
        no image IO), reproducing the stream a fresh run would have
        produced at that iteration."""
        if self.is_train:
            rng = np.random.RandomState(self.seed)
            it = 0
            while self.max_iters is None or it < self.max_iters:
                epoch_batches = []
                for gi, group in enumerate(self.groups):
                    order = rng.permutation(len(group))
                    for start in range(
                        0, len(group) - self.batch_size + 1, self.batch_size
                    ):
                        epoch_batches.append(
                            (gi, [group[j] for j in order[start : start + self.batch_size]])
                        )
                if not epoch_batches:
                    # dataset smaller than a batch: wrap around
                    gi = 0
                    group = self.groups[0]
                    idx = [group[j % len(group)] for j in range(self.batch_size)]
                    epoch_batches.append((gi, idx))
                rng.shuffle(epoch_batches)
                for gi, idx in epoch_batches:
                    if self.max_iters is not None and it >= self.max_iters:
                        return
                    if it >= self.start_iter:
                        yield it, gi, idx
                    it += 1
        else:
            for gi, group in enumerate(self.groups):
                for start in range(0, len(group), self.batch_size):
                    yield 0, gi, group[start : start + self.batch_size]

    def _make_batch(self, item) -> Dict[str, np.ndarray]:
        iteration, group_id, indices = item
        H, W = self.buckets[group_id]
        bs = self.batch_size // self.world
        first = self.rank * bs  # the rank's first slot of the global batch
        img_dtype = np.uint8 if self.device_normalize else np.float32
        images = np.zeros((bs, H, W, 3), img_dtype)
        sizes = np.zeros((bs, 2), np.int32)
        boxes = np.zeros((bs, self.max_boxes, 4), np.float32)
        labels = np.zeros((bs, self.max_boxes), np.int32)
        mask = np.zeros((bs, self.max_boxes), bool)
        scales = np.ones((bs, 2), np.float32)
        idx_arr = np.full((bs,), -1, np.int64)
        for gslot, i in enumerate(indices[first:first + bs], first):
            slot = gslot - first
            cached = self._eval_cache.get(i) if self._eval_cache is not None \
                else None
            if cached is not None:
                img_c, (oh, ow), gt_boxes, gt_labels, (oh0, ow0) = cached
                images[slot, :oh, :ow] = img_c
            else:
                img = self.dataset.load_image(i)
                gt_boxes, gt_labels = self.dataset.get_raw_target(i)
                oh0, ow0 = img.shape[:2]
                # transform draws keyed by (seed, iteration, slot): identical
                # batches under any prefetch-thread interleaving, and exact
                # across checkpoint resume (start_iter skip)
                rng = random.Random(
                    (self.seed * 2654435761 + iteration * 131 + gslot)
                    % (1 << 63)
                )
                # fused native resize(+normalize) straight into the slot
                if self.device_normalize:
                    gt_boxes, (oh, ow) = self.pre.into_buffer_u8(
                        img, gt_boxes, images[slot], rng=rng
                    )
                else:
                    gt_boxes, (oh, ow) = self.pre.into_buffer(
                        img, gt_boxes, images[slot], rng=rng
                    )
                if self._eval_cache is not None and i not in self._eval_cache:
                    entry = images[slot, :oh, :ow].copy()
                    if entry.nbytes <= self._eval_cache_free:
                        # dict set is GIL-atomic; racing prefetch threads at
                        # worst duplicate the copy
                        self._eval_cache_free -= entry.nbytes
                        self._eval_cache[i] = (
                            entry, (oh, ow), gt_boxes, gt_labels, (oh0, ow0)
                        )
            if oh > H or ow > W:
                raise ValueError(
                    f"image {i} resized to ({oh},{ow}) exceeds bucket {(H, W)}"
                )
            sizes[slot] = (oh, ow)
            n = min(len(gt_labels), self.max_boxes)
            if n:
                boxes[slot, :n] = gt_boxes[:n]
                labels[slot, :n] = gt_labels[:n]
                mask[slot, :n] = True
            scales[slot] = (ow0 / ow, oh0 / oh)
            idx_arr[slot] = i
        batch = dict(
            images=images, sizes=sizes, boxes=boxes, labels=labels,
            mask=mask, scales=scales, indices=idx_arr,
        )
        if self.world > 1:
            batch[RANK_SLICE] = (self.rank, self.world)
        return batch

    def __iter__(self):
        """Background-threaded prefetching iterator. An error raised while a
        loader thread builds a batch is raised here, in that batch's turn."""
        work_q: "queue.Queue" = queue.Queue(maxsize=self.num_threads * 2)
        out: Dict[int, dict] = {}
        out_lock = threading.Condition()
        stop = threading.Event()

        def producer():
            for seq, gi in enumerate(self._index_stream()):
                if stop.is_set():
                    return
                work_q.put((seq, gi))
            work_q.put(None)

        def worker():
            while not stop.is_set():
                item = work_q.get()
                if item is None:
                    work_q.put(None)  # propagate sentinel
                    return
                seq, gi = item
                try:
                    batch = self._make_batch(gi)
                except Exception as e:  # raised again by the consumer
                    batch = e
                with out_lock:
                    out[seq] = batch
                    out_lock.notify_all()

        threads = [threading.Thread(target=producer, daemon=True)]
        threads += [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_threads)
        ]
        for t in threads:
            t.start()

        total = len(self) if len(self) else None
        seq = 0
        try:
            while total is None or seq < total:
                with out_lock:
                    while seq not in out:
                        alive = any(t.is_alive() for t in threads[1:])
                        if not alive and seq not in out:
                            if total is None:
                                return
                            raise RuntimeError(
                                f"the loader stopped at batch {seq} of {total}")
                        out_lock.wait(timeout=0.5)
                    batch = out.pop(seq)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                seq += 1
        finally:
            stop.set()


def _rank_world():
    """This process's rank and the world size (1 without a process
    group): each rank's loader decodes only its slots."""
    return dict(rank=get_rank(), world=get_world_size())


def make_data_loader_source(cfg, seed: int = 1234, start_iter: int = 0):
    ds = build_datasets(cfg.DATASETS.TRAIN_SOURCE, is_train=True)
    # each DA stream uses the full IMS_PER_BATCH (reference data/build.py:183)
    return DetectionLoader(
        ds, cfg, True, cfg.SOLVER.IMS_PER_BATCH,
        max_iters=cfg.SOLVER.MAX_ITER, seed=seed, start_iter=start_iter,
        **_rank_world(),
    )


def make_data_loader_target(cfg, seed: int = 1234, start_iter: int = 0):
    ds = build_datasets(cfg.DATASETS.TRAIN_TARGET, is_train=True)
    return DetectionLoader(
        ds, cfg, True, cfg.SOLVER.IMS_PER_BATCH,
        max_iters=cfg.SOLVER.MAX_ITER, seed=seed + 1, start_iter=start_iter,
        **_rank_world(),
    )


def make_data_loader_train(cfg, seed: int = 1234, start_iter: int = 0):
    names = cfg.DATASETS.TRAIN_SOURCE or cfg.DATASETS.TRAIN
    ds = build_datasets(names, is_train=True)
    return DetectionLoader(
        ds, cfg, True, cfg.SOLVER.IMS_PER_BATCH,
        max_iters=cfg.SOLVER.MAX_ITER, seed=seed, start_iter=start_iter,
        **_rank_world(),
    )


def make_data_loaders_test(cfg):
    """One loader per DATASETS.TEST name (reference build.py:148-178:
    test datasets are never concatenated — each is evaluated separately)."""
    datasets = build_datasets(cfg.DATASETS.TEST, is_train=False)
    return [
        DetectionLoader(ds, cfg, False, cfg.TEST.IMS_PER_BATCH,
                        **_rank_world())
        for ds in datasets
    ]


def make_data_loader_test(cfg):
    return make_data_loaders_test(cfg)[0]
