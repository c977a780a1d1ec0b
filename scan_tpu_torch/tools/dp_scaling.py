"""Weak scaling of data-parallel DA training: ``train_net_da`` in one
process on one card, then under ``torch.distributed.run`` on ``--nproc``
cards, with the same batch a card, from a Cityscapes-shaped PNG tree.

    python -m scan_tpu_torch.tools.dp_scaling [--nproc 4] [--per-card 4]
        [--iters 40] [--hw 1024 2048] [--size 512 1024] [--root DIR ...]
        [KEY VALUE ...]

Writes 64 seeded frames of ``--hw`` (smooth gradients, blocks and noise,
one box a block) as PNGs for the C2F config's source and target sets, and
8 for its validation set, under a temporary directory (the standard
library's zlib, no Pillow), then runs the C2F config's ``train_net_da``
for ``--iters`` iterations at ``--size`` (MIN_SIZE_TRAIN, MAX_SIZE_TRAIN),
validation off, from a random init, in the config's compute dtype
(float32): once in one process (``--per-card`` images a stream a step)
and once with ``--distributed`` in ``--nproc`` processes (``--nproc`` times
as many). The loop logs MetricLogger lines every 20 iterations; for each
run one JSON line gives the seconds an iteration and the data wait of the
last 20 iterations (from the printed global averages at the last two
logging points), and the N-card line the weak-scaling efficiency, one
card's time over N cards'. ``--root`` (repeated) runs the pair from each
checkout given, in turn (another commit's tree beside this one; each line
names its root), on the same image tree; by default from this checkout.
Trailing KEY VALUE pairs go to both runs' configs (``MODEL.DEVICE cpu``
and a narrow model rehearse it on the CPU, gloo between the processes).
Needs ``--nproc`` cards otherwise.
"""

import argparse
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

C2F = Path(__file__).resolve().parents[2] / "configs" / "scan" / \
    "scan_vgg16_cityscapace_to_foggy.yaml"
SETS = {  # catalog name -> image directory under SCAN_TPU_DATA_DIR
    "cityscapes_train_cocostyle": "Cityscapes/leftImg8bit/train",
    "cityscapes_foggy_train_cocostyle": "Cityscapes/leftImg8bit_foggy/train",
    "cityscapes_foggy_val_cocostyle": "Cityscapes/leftImg8bit_foggy/val",
}


def write_png(path, rgb):
    """(h, w, 3) uint8 -> an 8-bit RGB PNG: each row filter 0, one IDAT."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
        + chunk(b"IEND", b""))


def write_tree(root, hw, n=64, seed=0):
    """The three sets at the catalog's paths, COCO jsons beside them."""
    h, w = hw
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ann_dir = Path(root) / "Cityscapes" / "cocoAnnotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for name, img_dir in SETS.items():
        count = 8 if name.endswith("val_cocostyle") else n
        out = Path(root) / img_dir
        out.mkdir(parents=True, exist_ok=True)
        images, annotations = [], []
        for i in range(count):
            base = (np.stack([xx * 200 // w, yy * 200 // h,
                              (xx + yy) * 100 // (h + w)], -1)
                    + rng.randint(0, 24, (h, w, 3))).astype(np.uint8)
            for _ in range(4):
                bh, bw = rng.randint(h // 16, h // 4), rng.randint(w // 16,
                                                                   w // 4)
                y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
                base[y0:y0 + bh, x0:x0 + bw] = rng.randint(0, 256, 3)
                annotations.append(dict(
                    id=len(annotations) + 1, image_id=i + 1,
                    category_id=int(rng.randint(1, 9)),
                    bbox=[int(x0), int(y0), int(bw), int(bh)],
                    area=int(bw * bh), iscrowd=0))
            fname = f"frame_{i:04d}.png"
            write_png(out / fname, base)
            images.append(dict(id=i + 1, file_name=fname, height=h, width=w))
        cats = [dict(id=k, name=f"c{k}") for k in range(1, 9)]
        (ann_dir / f"{name}.json").write_text(json.dumps(dict(
            images=images, annotations=annotations, categories=cats)))


def last_window(log_text, iters):
    """(s an iteration, data wait) over the last 20 iterations, from the
    global averages printed at ``iters`` - 20 and ``iters``."""
    got = {}
    for line in log_text.splitlines():
        m = re.search(r"iter: (\d+)\s.*time: [\d.]+ \(([\d.]+)\)\s+"
                      r"data: [\d.]+ \(([\d.]+)\)", line)
        if m:
            got[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    a, b = got[iters - 20], got[iters]
    return 2 * b[0] - a[0], 2 * b[1] - a[1]


def run(world, args, tree, out_dir, root):
    opts = ["INPUT.MIN_SIZE_RANGE_TRAIN", "(-1,-1)",
            "INPUT.MIN_SIZE_TRAIN", f"({args.size[0]},)",
            "INPUT.MAX_SIZE_TRAIN", str(args.size[1]),
            "SOLVER.IMS_PER_BATCH", str(args.per_card * world),
            "TEST.IMS_PER_BATCH", str(world),
            "SOLVER.MAX_ITER", str(args.iters), "SOLVER.ADAPT_VAL_ON", "False",
            "SOLVER.CHECKPOINT_PERIOD", str(10 * args.iters),
            "MODEL.WEIGHT", "",
            "OUTPUT_DIR", str(out_dir), *args.opts]
    tool = ["-m", "scan_tpu_torch.tools.train_net_da", "--config-file",
            str(Path(root) / C2F.relative_to(C2F.parents[2]))]
    if world == 1:
        cmd = [sys.executable, *tool, *opts]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world), *tool, "--distributed", *opts]
    env = dict(os.environ, SCAN_TPU_DATA_DIR=str(tree))
    env.pop("PYTHONPATH", None)  # the package is the root's own
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          cwd=str(root))
    if proc.returncode != 0:
        raise RuntimeError(f"train_net_da at world {world} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return last_window((Path(out_dir) / "log.txt").read_text(), args.iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--per-card", type=int, default=4)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    ap.add_argument("--size", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--root", action="append", dest="roots")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.iters < 40 or args.iters % 20:
        raise ValueError("--iters must be a multiple of 20, at least 40")
    with tempfile.TemporaryDirectory(prefix="dp_scaling_") as tmp:
        tree = Path(tmp) / "data"
        write_tree(tree, args.hw)
        roots = [Path(r).resolve() for r in args.roots or [C2F.parents[2]]]
        for k, root in enumerate(roots):
            results = {}
            for world in (1, args.nproc):
                it_s, data_s = run(world, args, tree,
                                   Path(tmp) / f"root{k}_world{world}", root)
                results[world] = it_s
                line = dict(root=str(root), world=world,
                            per_card=args.per_card,
                            global_batch=args.per_card * world,
                            size=list(args.size), frames=list(args.hw),
                            iter_s=it_s, data_s=data_s,
                            window=f"iterations {args.iters - 19}-"
                                   f"{args.iters}")
                if world > 1:
                    line["weak_scaling"] = results[1] / it_s
                print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
