"""End-to-end DA efficacy evidence (counterpart of ``tools/da_efficacy.py``):
does the port's adversarial and GST machinery adapt?

Parity of losses and updates with ``scan_tpu`` proves the port computes
what the reference computes, but not that the machinery works. This
harness builds a synthetic domain shift and trains the C2F config twice
through ``python -m scan_tpu_torch.tools.train_net_da``:

  * source-only arm: every discriminator off and the GST gate pinned shut
    (SOLVER.INITIAL_AP50=101): the detector and condgraph trained on source
    labels only;
  * DA arm: the shipping CKA (per-level CON discriminators) and GST
    (NODES/ADJ transfer) with the AP50 gate at 2.0.

Both arms are then evaluated on the fogged target val split; the harness
asserts the DA arm's AP50 beats the source-only arm's by ``--margin`` and
writes the comparison to ``--log``. Every loss reading of both arms must be
finite (the trainer also raises on a non-finite loss).

Domain construction (the Cityscapes->Foggy structure of reference
README.md:71): source images are coloured rectangles (one colour per
class, 8 classes) on textured noise; the target domain is the same
generator under a fog-like corruption (an alpha-blend toward a bright grey
veil plus Gaussian noise) applied to other draws (unpaired domains). From
one seed ``generate`` writes the same PNGs and annotations as
``tools/da_efficacy.py``.

    python -m scan_tpu_torch.tools.da_efficacy [--iters 1500] [--n-train 64]
        [--n-val 32] [--hw 320,416] [--margin 0.02] [KEY VALUE ...]

Trailing ``KEY VALUE`` pairs go to every ``train_net_da`` run, after the
harness's own (``MODEL.DEVICE cpu``, ``SOLVER.VAL_ITER`` for a cut run).
The last stdout line is one JSON object with both AP50s, the gain, the
margin and the verdict; the process exits 1 when the gain falls short.
"""

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C2F = os.path.join(REPO, "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")

CLASS_COLORS = np.array([
    (220, 40, 40), (40, 220, 40), (60, 60, 230), (230, 230, 40),
    (230, 40, 230), (40, 230, 230), (240, 140, 40), (140, 90, 40),
], np.float32)  # classes 1..8


def _render_clean(rng, h, w, n_boxes):
    img = rng.uniform(20, 60, (h, w, 3)).astype(np.float32)
    # low-frequency texture so the background is not pure iid noise
    gy = np.linspace(0, 2 * np.pi * rng.uniform(1, 3), h)[:, None]
    gx = np.linspace(0, 2 * np.pi * rng.uniform(1, 3), w)[None, :]
    img += 25 * (np.sin(gy + rng.uniform(0, 6)) * np.cos(gx))[..., None]
    boxes, labels = [], []
    for _ in range(n_boxes):
        bw = int(rng.randint(24, w // 3))
        bh = int(rng.randint(24, h // 3))
        x = int(rng.randint(0, w - bw))
        y = int(rng.randint(0, h - bh))
        c = int(rng.randint(1, 9))
        color = CLASS_COLORS[c - 1] * rng.uniform(0.85, 1.15)
        img[y:y + bh, x:x + bw] = (
            0.85 * color + 0.15 * img[y:y + bh, x:x + bw]
        )
        boxes.append([x, y, bw, bh])
        labels.append(c)
    return np.clip(img, 0, 255), boxes, labels


def _fog(img, rng, alpha=0.65, veil=205.0, noise=10.0):
    out = (1 - alpha) * img + alpha * veil
    out = out + rng.randn(*img.shape).astype(np.float32) * noise
    return np.clip(out, 0, 255)


def _write_split(img_dir, ann_path, n, hw, rng, foggy, prefix):
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.dirname(ann_path), exist_ok=True)
    h, w = hw
    images, annotations = [], []
    ann_id = 1
    for i in range(1, n + 1):
        img, boxes, labels = _render_clean(rng, h, w, int(rng.randint(3, 7)))
        if foggy:
            img = _fog(img, rng)
        fn = f"{prefix}{i}.png"
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(img_dir, fn))
        images.append(dict(id=i, file_name=fn, height=h, width=w))
        for (x, y, bw, bh), c in zip(boxes, labels):
            annotations.append(dict(
                id=ann_id, image_id=i, category_id=c,
                bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0,
            ))
            ann_id += 1
    cats = [dict(id=c, name=f"class{c}") for c in range(1, 9)]
    with open(ann_path, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=cats), f)


def generate(data_root, n_train, n_val, hw, seed):
    """The source, fogged target and fogged val splits at the C2F
    catalog's paths under ``data_root``."""
    d = os.path.join(data_root, "Cityscapes")
    ann = os.path.join(d, "cocoAnnotations")
    rng = np.random.RandomState(seed)
    _write_split(os.path.join(d, "leftImg8bit", "train"),
                 os.path.join(ann, "cityscapes_train_cocostyle.json"),
                 n_train, hw, rng, foggy=False, prefix="src")
    _write_split(os.path.join(d, "leftImg8bit_foggy", "train"),
                 os.path.join(ann, "cityscapes_foggy_train_cocostyle.json"),
                 n_train, hw, rng, foggy=True, prefix="tgt")
    _write_split(os.path.join(d, "leftImg8bit_foggy", "val"),
                 os.path.join(ann, "cityscapes_foggy_val_cocostyle.json"),
                 n_val, hw, rng, foggy=True, prefix="val")


COMMON_OPTS = [
    "INPUT.MIN_SIZE_RANGE_TRAIN", "(-1,-1)",
    "INPUT.MIN_SIZE_TRAIN", "(320,)",
    "INPUT.MAX_SIZE_TRAIN", "448",
    "INPUT.MIN_SIZE_TEST", "320",
    "INPUT.MAX_SIZE_TEST", "448",
    "SOLVER.IMS_PER_BATCH", "4",
    "TEST.IMS_PER_BATCH", "4",
    "SOLVER.VAL_ITER", "250",
    "TPU.MAX_NODES", "128",
    "TPU.MAX_TARGET_POINTS", "128",
    "TPU.MAX_BOXES", "16",
    "TPU.LOADER_THREADS", "2",
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.WEIGHT", "",
]

SOURCE_ONLY_OPTS = [
    # no adversarial alignment, GST gate pinned shut
    "MODEL.ADV.USE_DIS_CON", "False",
    "MODEL.ADV.USE_DIS_P3_CON", "False",
    "MODEL.ADV.USE_DIS_P4_CON", "False",
    "MODEL.ADV.USE_DIS_P5_CON", "False",
    "MODEL.ADV.USE_DIS_P6_CON", "False",
    "MODEL.ADV.USE_DIS_P7_CON", "False",
    "SOLVER.INITIAL_AP50", "101.0",
]


def lr_decay_opts(max_iter):
    """The C2F recipe's LR decay (60k and 73k of 80k iterations, its
    SOLVER.*.STEPS) at the same fractions (75%, 91%) of the run, so both
    arms settle before their last validations."""
    steps = f"({int(max_iter * 0.75)},{int(max_iter * 0.91)})"
    opts = []
    for module in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
        opts += [f"SOLVER.{module}.STEPS", steps]
    return opts


VAL_RE = re.compile(r"validation @(\d+): \S+?=([0-9.eE+-]+)")
LOSS_RE = re.compile(r"iter: (\d+).*?loss_total: ([0-9.eE+-]+|nan|inf)"
                     r" \(([0-9.eE+-]+|nan|inf)\)")


def parse_validations(text):
    """All in-training 'validation @it: AP50=x' readings (percent)."""
    return [(int(m.group(1)), float(m.group(2)))
            for m in VAL_RE.finditer(text)]


def _run(cmd, env):
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    return proc, proc.stdout + proc.stderr


def run_arm(name, data_root, out_dir, max_iter, extra_opts, user_opts,
            log_lines):
    # a fresh output dir: the checkpointer resumes from last_checkpoint, which
    # would turn a rerun into a resume of stale weights
    shutil.rmtree(out_dir, ignore_errors=True)
    base = [sys.executable, "-m", "scan_tpu_torch.tools.train_net_da",
            "--config-file", C2F]
    tail_opts = [*extra_opts, "SOLVER.MAX_ITER", str(max_iter),
                 "OUTPUT_DIR", out_dir, *user_opts]
    cmd = base + [*COMMON_OPTS, *lr_decay_opts(max_iter), *tail_opts]
    env = dict(os.environ, SCAN_TPU_DATA_DIR=data_root)
    log_lines.append(f"== arm {name}: {' '.join(cmd[4:])}")
    proc, out = _run(cmd, env)
    log_lines.append("\n".join(out.splitlines()[-20:]))
    if proc.returncode != 0:
        raise RuntimeError(f"arm {name} failed rc={proc.returncode}:\n"
                           + "\n".join(out.splitlines()[-40:]))
    losses = [float(m.group(2)) for m in LOSS_RE.finditer(out)] + [
        float(m.group(3)) for m in LOSS_RE.finditer(out)]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"arm {name}: loss readings {losses}")
    # the mean of the last 5 in-training validations beats a single
    # endpoint under schedule noise
    vals = parse_validations(out)
    last5 = [v for _, v in vals[-5:]]
    if last5:
        mean5 = float(np.mean(last5))
        spread5 = float(max(last5) - min(last5))
        log_lines.append(
            f"arm {name}: last-5 validations (percent) "
            f"{[round(v, 2) for v in last5]} -> mean {mean5:.2f} "
            f"+/- spread {spread5:.2f}")
    else:
        mean5 = spread5 = float("nan")
        log_lines.append(f"arm {name}: no in-training validations parsed")
    # final eval on the target val split
    proc, out = _run(base + ["--test-only", *COMMON_OPTS, *tail_opts], env)
    ap50 = None
    for line in out.splitlines():
        if "test results" in line:
            log_lines.append(line.strip())
            m = re.search(r"'AP50':\s*([0-9.eE+-]+)", line)
            if m:
                ap50 = float(m.group(1))
    if ap50 is None:
        raise RuntimeError(f"arm {name}: AP50 not found in eval output:\n"
                           + "\n".join(out.splitlines()[-30:]))
    log_lines.append(f"arm {name}: target-val AP50 = {ap50:.4f}")
    return dict(ap50=ap50, last5_mean=mean5, last5_spread=spread5,
                validations=vals, loss_readings=len(losses) // 2)


def main(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", default=os.path.join(tmp, "da_efficacy_ds"))
    ap.add_argument("--out-root", default=os.path.join(tmp, "da_efficacy_out"))
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=32)
    ap.add_argument("--hw", default="320,416")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--margin", type=float, default=0.02,
                    help="required AP50 gain (fraction) of DA over "
                         "source-only")
    ap.add_argument("--log", default=None,
                    help="comparison log (default: OUT_ROOT/da_efficacy.log)")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    log_path = args.log or os.path.join(args.out_root, "da_efficacy.log")

    hw = tuple(int(x) for x in args.hw.split(","))
    if not args.skip_gen:
        generate(args.data_root, args.n_train, args.n_val, hw, args.seed)
        print("dataset generated at", args.data_root, flush=True)

    log_lines = [
        "DA efficacy run (synthetic clean->fog shift; see "
        "scan_tpu_torch/tools/da_efficacy.py)",
        f"iters={args.iters} n_train={args.n_train} n_val={args.n_val} "
        f"hw={hw} seed={args.seed} opts={args.opts}",
    ]
    src = run_arm("source-only", args.data_root,
                  os.path.join(args.out_root, "source_only"), args.iters,
                  SOURCE_ONLY_OPTS, args.opts, log_lines)
    da = run_arm("da-full", args.data_root,
                 os.path.join(args.out_root, "da_full"), args.iters,
                 ["SOLVER.INITIAL_AP50", "2.0"], args.opts, log_lines)
    gain = da["ap50"] - src["ap50"]
    verdict = "PASS" if gain >= args.margin else "FAIL"
    log_lines.append(
        f"RESULT: source-only AP50={src['ap50']:.4f}  DA AP50="
        f"{da['ap50']:.4f}  gain={gain:+.4f}  margin={args.margin}  {verdict}")
    log_lines.append(
        f"RESULT last-5 validations (percent): source-only "
        f"{src['last5_mean']:.2f} +/- {src['last5_spread']:.2f}  DA "
        f"{da['last5_mean']:.2f} +/- {da['last5_spread']:.2f}  gap "
        f"{da['last5_mean'] - src['last5_mean']:+.2f}")
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    with open(log_path, "w") as f:
        f.write("\n".join(log_lines) + "\n")
    print("\n".join(log_lines[-4:]))
    result = dict(source_only=src, da=da, gain=gain, margin=args.margin,
                  verdict=verdict, iters=args.iters, hw=list(hw))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["verdict"] == "PASS" else 1)
