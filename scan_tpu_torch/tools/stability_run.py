"""Sustained DA-training stability run with a mid-run kill and resume
(counterpart of ``tools/stability_run.py``).

Drives ``python -m scan_tpu_torch.tools.train_net_da`` on the C2F
schedule over a synthetic Cityscapes-shaped dataset, SIGKILLs the process
once its log shows iteration ``--kill-frac`` of the schedule (a
``iter: N`` line or a periodic checkpoint at N; progress, not wall time),
relaunches it (auto-resume from the checkpointer's ``last_checkpoint``,
reference ``fcos_core/engine/trainer.py:146``), and then asserts over the
combined log:

  * every loss term stays finite (no NaN/Inf) for the whole schedule;
  * the total loss decreases (the first readings' median above the last
    readings');
  * in-loop validation fired and a best-AP50 checkpoint was written;
  * the resumed process restored the killed run's iteration.

    python -m scan_tpu_torch.tools.stability_run --iters 2000 \\
        --kill-frac 0.5 --out OUT --data DS [KEY VALUE ...]

Trailing ``KEY VALUE`` pairs go to ``train_net_da`` (``MODEL.DEVICE cpu``,
input sizes, widths). The trimmed log goes to ``--log-out``; its first
line carries the PASS/FAIL verdict and any failure reasons.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_synth_cityscapes(root, n_train=32, n_val=8, hw=(512, 1024),
                          n_cats=8, seed=0):
    """COCO-style tree matching the catalog paths for the C2F config."""
    from PIL import Image

    h, w = hw

    def split(img_dir, ann_file, n, cam_seed):
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(os.path.dirname(ann_file), exist_ok=True)
        r = np.random.RandomState(cam_seed)
        images, annotations = [], []
        ann_id = 1
        for i in range(1, n + 1):
            # structured image: blocks + noise so the loss has signal
            arr = (r.randint(0, 80, (h, w, 3)) +
                   r.randint(0, 40)).astype(np.uint8)
            for _ in range(3):
                x, y = int(r.randint(0, w - 64)), int(r.randint(0, h - 48))
                bw, bh = int(r.randint(48, 160)), int(r.randint(32, 120))
                bw, bh = min(bw, w - x), min(bh, h - y)
                cat = int(r.randint(1, n_cats + 1))
                arr[y:y + bh, x:x + bw] = (
                    np.array([30 * cat, 255 - 25 * cat, 60 + 20 * cat])
                    + r.randint(-10, 10, (bh, bw, 3))
                ).clip(0, 255).astype(np.uint8)
                annotations.append(dict(
                    id=ann_id, image_id=i, category_id=cat,
                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
                ann_id += 1
            name = f"img{i:04d}.png"
            Image.fromarray(arr).save(os.path.join(img_dir, name))
            images.append(dict(id=i, file_name=name, height=h, width=w))
        cats = [dict(id=c, name=f"cat{c}") for c in range(1, n_cats + 1)]
        with open(ann_file, "w") as f:
            json.dump(dict(images=images, annotations=annotations,
                           categories=cats), f)

    cs = os.path.join(root, "Cityscapes")
    ann = os.path.join(cs, "cocoAnnotations")
    split(os.path.join(cs, "leftImg8bit", "train"),
          os.path.join(ann, "cityscapes_train_cocostyle.json"),
          n_train, seed + 1)
    split(os.path.join(cs, "leftImg8bit_foggy", "train"),
          os.path.join(ann, "cityscapes_foggy_train_cocostyle.json"),
          n_train, seed + 2)
    split(os.path.join(cs, "leftImg8bit_foggy", "val"),
          os.path.join(ann, "cityscapes_foggy_val_cocostyle.json"),
          n_val, seed + 3)
    return root


def launch(args, log_path):
    env = dict(os.environ, SCAN_TPU_DATA_DIR=args.data)
    cmd = [
        sys.executable, "-m", "scan_tpu_torch.tools.train_net_da",
        "--config-file",
        os.path.join(REPO, "configs/scan/scan_vgg16_cityscapace_to_foggy.yaml"),
        "MODEL.WEIGHT", "",
        "SOLVER.MAX_ITER", str(args.iters),
        "SOLVER.VAL_ITER", str(args.val_iter),
        "SOLVER.CHECKPOINT_PERIOD", str(args.ckpt_period),
        "SOLVER.INITIAL_AP50", "0",
        "TEST.IMS_PER_BATCH", "4",
        "TPU.LOADER_THREADS", "2",
        "OUTPUT_DIR", args.out,
    ] + (args.overrides or [])
    with open(log_path, "ab") as logf:
        return subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                env=env, cwd=REPO)


ITER_RE = re.compile(r"iter: (\d+)\s")
CKPT_RE = re.compile(r"saved checkpoint \S*model_(\d{7})\.pth")


def progress(log_path):
    """The furthest iteration the log shows: a metrics line or a periodic
    checkpoint."""
    try:
        with open(log_path, "rb") as f:
            text = f.read().decode("utf-8", "replace")
    except OSError:
        return 0
    hits = [int(x) for x in ITER_RE.findall(text) + CKPT_RE.findall(text)]
    return max(hits, default=0)


def check_log(text, iters, killed_at, min_readings):
    """The four assertions over the combined log. Returns (failures,
    summary)."""
    failures = []
    restored = re.findall(r"restored .* at iteration (\d+)", text)
    if not restored:
        failures.append("no 'restored ... at iteration' line after relaunch")
    else:
        r = int(restored[-1])
        if not 0 < r <= killed_at:
            failures.append(f"resume restored iteration {r}, "
                            f"killed at ~{killed_at}")

    # 'loss_total: <median> (<global_avg>)' per window; both columns are
    # checked, since a median can skip a NaN the average shows
    losses = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
              for m in re.finditer(
        r"iter: (\d+).*?loss_total: ([0-9.eE+-]+|nan|inf)"
        r" \(([0-9.eE+-]+|nan|inf)\)", text)]
    head = tail = float("nan")
    if len(losses) < min_readings:
        failures.append(f"only {len(losses)} loss readings found")
    else:
        vals = np.array([v for _, v, _ in losses], np.float64)
        gavg = np.array([g for _, _, g in losses], np.float64)
        if not (np.all(np.isfinite(vals)) and np.all(np.isfinite(gavg))):
            bad_i = np.where(~(np.isfinite(vals) & np.isfinite(gavg)))[0]
            bad = [losses[i] for i in bad_i]
            failures.append(f"non-finite loss at iters {bad[:5]}")
        k = max(1, min(3, len(vals) // 2), len(vals) // 5)
        head = float(np.median(vals[:k]))
        tail = float(np.median(vals[-k:]))
        if not tail < head:
            failures.append(f"loss did not decrease: head={head:.3f} "
                            f"tail={tail:.3f}")
    final = [it for it, _, _ in losses]
    if not final or final[-1] < iters:
        failures.append(f"final logged iter {final[-1] if final else 0} "
                        f"< {iters}")

    vals = re.findall(r"validation @(\d+): (\S+)=([0-9.eE+-]+)", text)
    if len(vals) < 2:
        failures.append(f"in-loop validation fired {len(vals)} times")
    else:
        # a NaN-poisoned model scores 0.0: the final validation must hold a
        # reasonable share of the best
        series = [float(v) for _, _, v in vals]
        if series[-1] <= 0.0 or series[-1] < 0.25 * max(series):
            failures.append(
                f"final validation {series[-1]:.3f} collapsed vs best "
                f"{max(series):.3f}")
    best = re.findall(r"model_([0-9.]+)_(\d+)", text)
    if not best:
        failures.append("no best-AP50 checkpoint (model_{ap:.4f}_{it}) saved")
    summary = dict(readings=len(losses), validations=len(vals),
                   best_ckpts=len(best), head=head, tail=tail)
    return failures, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--kill-frac", type=float, default=0.5)
    ap.add_argument("--val-iter", type=int, default=250)
    ap.add_argument("--ckpt-period", type=int, default=250)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--log-out", default=None,
                    help="trimmed log (default: OUT/stability_run.log)")
    ap.add_argument("--timeout", type=float, default=7200)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--min-readings", type=int, default=10,
                    help="loss readings (one each 20 iterations) required")
    ap.add_argument("overrides", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    log_out = args.log_out or os.path.join(args.out, "stability_run.log")

    marker = os.path.join(args.data, "Cityscapes", "cocoAnnotations",
                          "cityscapes_foggy_val_cocostyle.json")
    if not os.path.exists(marker):
        print("generating synthetic dataset ...", flush=True)
        make_synth_cityscapes(args.data, args.n_train, args.n_val,
                              tuple(args.hw))

    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "run.log")
    open(log_path, "wb").close()
    kill_at = max(1, int(args.iters * args.kill_frac))

    # ---- phase A: run until the log shows kill_at, then SIGKILL ----
    print(f"phase A: training to iter {kill_at}, then SIGKILL", flush=True)
    t0 = time.time()
    proc = launch(args, log_path)
    killed = False
    try:
        while proc.poll() is None:
            if time.time() - t0 > args.timeout:
                raise SystemExit("phase A timed out")
            if progress(log_path) >= kill_at:
                os.kill(proc.pid, signal.SIGKILL)
                killed = True
                break
            time.sleep(0.2)
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait()
    if not killed:
        raise SystemExit(
            f"phase A exited rc={proc.returncode} before iter {kill_at}")
    killed_at = progress(log_path)  # read again: the process is gone
    print(f"killed at iter ~{killed_at} ({time.time() - t0:.0f}s)",
          flush=True)

    # ---- phase B: relaunch; must auto-resume and finish ----
    with open(log_path, "ab") as f:
        f.write(b"\n===== SIGKILL + RELAUNCH =====\n")
    proc = launch(args, log_path)
    try:
        rc = proc.wait(timeout=args.timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit(f"phase B failed rc={rc}; see {log_path}")

    text = open(log_path, "rb").read().decode("utf-8", "replace")
    failures, summary = check_log(text, args.iters, killed_at,
                                  args.min_readings)

    # the trimmed log is written after the assertions, so its first line
    # carries the verdict
    keep = [ln for ln in text.splitlines() if re.search(
        r"iter: \d+|validation @|restored|saved checkpoint|RELAUNCH|"
        r"Start DA training|environment", ln)]
    verdict = "FAIL" if failures else "PASS"
    hdr = (f"# STABILITY RUN {verdict}\n"
           f"# {args.iters} iters C2F DA schedule, "
           f"SIGKILL @~{killed_at}, resumed, wall {wall:.0f}s\n"
           f"# validations: {summary['validations']}  best-ckpts: "
           f"{summary['best_ckpts']}  loss head->tail: "
           f"{summary['head']:.3f}->{summary['tail']:.3f}\n")
    hdr += "".join(f"# FAILURE: {f}\n" for f in failures)
    with open(log_out, "w") as f:
        f.write(hdr + "\n".join(keep) + "\n")

    print(hdr, flush=True)
    print(json.dumps(dict(verdict=verdict, killed_at=killed_at, wall_s=wall,
                          **summary)), flush=True)
    if failures:
        print("FAILURES:\n  " + "\n  ".join(failures))
        raise SystemExit(1)
    print(f"STABILITY RUN OK ({wall:.0f}s); trimmed log -> {log_out}")
    return summary


if __name__ == "__main__":
    main()
