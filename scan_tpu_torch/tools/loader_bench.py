"""Loader-only microbench (counterpart of ``tools/loader_bench.py``): per
image decode + resize (+ normalize) cost against the number of loader
threads, on ``scan_tpu_torch.data``.

    python -m scan_tpu_torch.tools.loader_bench [--n 64] [--hw 1024 2048]
        [--threads 1 2 4] [--batch 8] [--no-native]

Writes ``--n`` PNGs of ``--hw`` into a temporary directory, then, for
each thread count, iterates the eval ``DetectionLoader`` over them twice:
a cold pass (decode and resize) and a cached one (the eval
cache, ``TPU.EVAL_CACHE_MB``). The aggregate CPU seconds per image stay
flat as threads rise where the decode and resize release the GIL, so
throughput scales until images/s ~ cores / cpu_s_per_img. Prints one JSON
line per (thread count, pass); each says whether the native library did
the work (``native``) and whether it decoded the PNGs itself (``codecs``:
False where it was built without libpng / libjpeg, as on a host that lacks
their headers; Pillow decoded then).
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_images(root, n, h, w, seed=0):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    base = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    for i in range(1, n + 1):
        # shift the base image so PNGs differ without n full rand() calls
        arr = np.roll(base, i * 37, axis=1)
        Image.fromarray(arr).save(os.path.join(root, f"img{i}.png"))
        images.append(dict(id=i, file_name=f"img{i}.png", height=h, width=w))
        annotations.append(dict(id=i, image_id=i, category_id=1,
                                bbox=[4, 4, 60, 40], area=2400, iscrowd=0))
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=1, name="car")]), f)
    return ann, root


def bench(root, args):
    from .. import native
    from ..config import get_default_cfg
    from ..data.build import DetectionLoader
    from ..data.datasets.coco import COCODataset

    cfg = get_default_cfg()
    cfg.INPUT.MIN_SIZE_TEST = 800
    cfg.INPUT.MAX_SIZE_TEST = 1333
    cfg.TPU.MAX_BOXES = 10
    use_native = native.enabled()
    codecs = native.has_codecs() if use_native else False
    ann, img_dir = make_images(root, args.n, *args.hw)
    ds = COCODataset(ann, img_dir, remove_images_without_annotations=False)
    rows = []
    for t in args.threads:
        loader = DetectionLoader(ds, cfg, False, args.batch, num_threads=t)
        # warm the page cache and the native library's load
        it = iter(loader)
        next(it)
        del it
        if loader._eval_cache is not None:
            loader._eval_cache = {}  # the cold pass must decode every image
        for label in ("cold", "cached"):
            c0 = time.process_time()
            t0 = time.perf_counter()
            n_img = 0
            for b in loader:
                n_img += int((b["indices"] >= 0).sum())
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
            row = {"native": use_native, "codecs": codecs,
                   "decode": "native" if codecs else "pillow",
                   "threads": t, "pass": label,
                   "wall_s_per_img": wall / n_img,
                   "cpu_s_per_img": cpu / n_img,
                   "img_per_sec": n_img / wall}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if loader._eval_cache is None:
                break  # no cache configured: a second pass = the first
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    ap.add_argument("--threads", type=int, nargs="+", default=(1, 2, 4))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-native", action="store_true",
                    help="force the Pillow paths (A/B against native)")
    args = ap.parse_args(argv)
    if args.no_native:
        os.environ["SCAN_TPU_NO_NATIVE"] = "1"
    with tempfile.TemporaryDirectory() as root:
        return bench(root, args)


if __name__ == "__main__":
    main()
