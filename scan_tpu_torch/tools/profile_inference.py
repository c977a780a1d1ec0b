"""Stage-level inference profile of the C2F config (counterpart of
``tools/profile_inference.py``).

    python -m scan_tpu_torch.tools.profile_inference [--batch 24] [--iters 10]
        [--int8] [--mode precision] [--trace DIR] [--device cuda]
        [--hw 800 1344] [KEY VALUE ...]

Times cumulative prefixes of the inference pipeline (backbone -> condgraph
-> FCOS head -> postprocess) in bf16, so each stage's cost is the
difference of adjacent rows. The detector has seeded weights and takes a
seeded uint8 batch; under ``--int8`` its static activation scales are
calibrated on the first 16 images first, as ``bench.py`` and ``test_net``
deploy it. On the card each prefix is timed with CUDA events over
``--iters`` calls after two warm-up calls (a ``[warmup]`` line each); on the
CPU by the host clock. One JSON line per prefix. ``--trace DIR`` also
traces one whole forward, after one under the tracer's warm-up
(``utils/profiler.trace_calls``), into ``DIR/trace.json``
(``tools/trace_summary.py`` reads it). Trailing ``KEY VALUE`` pairs
override the config (narrow widths for a CPU run).
"""

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C2F = os.path.join(REPO, "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")


def timed(fn, iters, cuda, label):
    """Mean seconds per call of ``fn`` after two warm-up calls."""
    import torch

    from ..utils.profiler import synced_time

    t0 = time.perf_counter()
    for _ in range(2):
        synced_time(fn)
    print(f"[warmup] {label}: {time.perf_counter() - t0:.2f}s", flush=True)
    if not cuda:
        return sum(synced_time(fn)[0] for _ in range(iters)) / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--mode", default=None, help="TEST.MODE override")
    ap.add_argument("--trace", default=None, help="trace output dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", type=int, nargs=2, default=(800, 1344))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = ap.parse_args(argv)

    import torch

    from ..config import get_default_cfg
    from ..modeling.detector import build_detector
    from ..utils.profiler import TRACE_FILE, trace_calls

    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if args.int8:
        cfg.TPU.INT8_INFERENCE = True
    if args.mode:
        cfg.TEST.MODE = args.mode
    if args.opts:
        cfg.merge_from_list(args.opts)

    det = build_detector(cfg, device=args.device, seed=args.seed)
    dev = next(det.parameters()).device
    cuda = dev.type == "cuda"
    h, w = args.hw
    g = torch.Generator().manual_seed(args.seed)
    images = torch.randint(0, 256, (args.batch, h, w, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    sizes = torch.tensor([[h, min(w, 1333)]] * args.batch, dtype=torch.int32,
                         device=dev)
    if cfg.TPU.INT8_INFERENCE:
        det.calibrate_int8([images[:16]])

    def backbone_only():
        return det.backbone(det._prep_images(images))

    def through_condgraph():
        feats = list(backbone_only())
        if det.condgraph_on:
            feats = det.middle_head(feats, det.proto_state(), "inference")[0]
        return feats

    def through_head():
        return det._head(through_condgraph(), det.test_mode != "light")

    def full():
        return det.forward_inference(images, sizes)

    rows = {}
    with torch.no_grad():
        for name, fn in (("backbone", backbone_only),
                         ("+condgraph", through_condgraph),
                         ("+fcos_head", through_head),
                         ("full(+postprocess)", full)):
            rows[name] = timed(fn, args.iters, cuda, name)
            row = {"prefix": name, "ms_per_batch": rows[name] * 1e3,
                   "batch": args.batch, "hw": [h, w], "int8": args.int8,
                   "mode": cfg.TEST.MODE, "device": str(dev),
                   "clock": "cuda events" if cuda else "host"}
            if name == "full(+postprocess)":
                row["img_per_sec"] = args.batch / rows[name]
            print(json.dumps(row), flush=True)
        if args.trace:
            trace_calls(args.trace, full, cuda=cuda)
            print(json.dumps({"trace": os.path.join(args.trace, TRACE_FILE)}),
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
