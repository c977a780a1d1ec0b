#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure makes the script exit non-zero without the
final ``{"ok": true, ...}`` line:

  1. the card's name and power limit (nvidia-smi); build both kernels from
     ``scan_tpu_torch/csrc/*.cu`` (one nvcc each, in parallel);
  2. TF32 off for cuDNN and matmul;
  3. K1 (NMS) against its plain version: sorted synthetic sets, K = 512 and
     1000, B = 4, with and without labels, invalid rows mixed in; keep
     masks must be equal;
  4. K2 (fused VGG stem) against its plain version on a normalised 800x1344
     batch with the model's own conv1_1/conv1_2 weights: float32 within
     atol/rtol 1e-4; bfloat16 within rtol 2**-7 and atol 2**-8 of the
     largest output (see tests/test_torch_kernels.py for why);
  5. small-input agreement: the port on the card against the port's plain
     path on the CPU (which tests/test_torch_*.py hold against scan_tpu),
     128x192, float32, all three TEST.MODEs;
  6. the main path: ``build_detector`` on the C2F config (full VGG16,
     256-channel FPN and heads) at 800x1344, batch 4, seeded weights and a
     seeded uint8 batch, TEST.MODE common/precision/light in float32 and
     bfloat16. Both launch counters are zeroed before and read after; the
     candidate sets entering NMS in precision mode are held against the
     plain NMS;
  7. timing with CUDA events: each kernel and its plain version at the main
     path's shapes, cuDNN's conv/relu/conv/relu/maxpool as the stem's
     library call, forward img/s at bfloat16, precision, batch 8, and the
     same forward cut at its layers.

Every number is printed with the card's name and power limit; everything is
also written to ``chiprun_out/chip_smoke.json``. The line before the last is
the per-kernel JSON; the last line is the device JSON.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
C2F = HERE / "configs" / "scan" / "scan_vgg16_cityscapace_to_foggy.yaml"
H, W = 800, 1344
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_S = 67e12  # CUDA cores
PEAK_BF16_S = 989e12  # tensor cores, dense


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, seed):
        self.seed = seed
        self.card = card_line()
        self.failed = []
        self.record = {"card": self.card, "seed": seed}

    def say(self, key, value):
        self.record[key] = value
        print(f"{key} = {value} | {self.card}", flush=True)

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.time()
        try:
            fn()
        except Exception:  # a failed phase is reported and the run fails
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
        else:
            print(f"== {name}: ok ({time.time() - t0:.1f} s)", flush=True)


def cuda_time(fn, iters, warmup=2):
    """Mean ms per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import scan_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if Path(scan_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: scan_tpu_torch is not the checkout's", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from scan_tpu_torch.config import get_default_cfg
    from scan_tpu_torch.engine.inference import compute_predictions
    from scan_tpu_torch.modeling.detector import build_detector
    from scan_tpu_torch.modeling.fcos import postprocess as pp_mod
    from scan_tpu_torch.modeling.fcos.module import mix_cls_maps
    from scan_tpu_torch.modeling.fcos.postprocess import fcos_postprocess
    from scan_tpu_torch.ops.locations import compute_locations
    from scan_tpu_torch.ops import nms as nms_mod
    from scan_tpu_torch.ops.cuda import build, nms_kernel, stem_kernel

    s = Smoke(args.seed)
    dev = torch.device("cuda")
    print(s.card, flush=True)
    st = {}  # state handed from phase to phase

    def c2f(dtype="float32", mode="precision"):
        cfg = get_default_cfg()
        cfg.merge_from_file(str(C2F))
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.TEST.MODE = mode
        return cfg

    def images(b, h, w, seed):
        g = torch.Generator().manual_seed(seed)
        im = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
        return im.to(dev), torch.tensor([[h, w]] * b, dtype=torch.int32,
                                        device=dev)

    # ---- 1, 2 ----------------------------------------------------------
    def p_build():
        t0 = time.time()
        logs = build.build_all()
        s.say("build_s", round(time.time() - t0, 3))
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 3 ------------------------------------------------------------
    def sorted_set(b, k, n_labels, seed):
        g = torch.Generator().manual_seed(seed)
        xy = torch.rand(b, k, 2, generator=g) * 600
        wh = torch.rand(b, k, 2, generator=g) * 120 + 8
        boxes = torch.cat([xy, xy + wh], -1)
        scores = torch.rand(b, k, generator=g)
        valid = torch.rand(b, k, generator=g) > 0.2
        labels = torch.randint(1, n_labels + 1, (b, k), generator=g)
        order = torch.sort(-torch.where(valid, scores, torch.tensor(-1e10)),
                           stable=True).indices
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        return (boxes.to(dev), torch.gather(valid, 1, order).to(dev),
                torch.gather(labels, 1, order).to(dev))

    def p_nms():
        for k in (512, 1000):
            boxes, valid, labels = sorted_set(4, k, 8, s.seed + k)
            for lab in (None, labels):
                got = nms_kernel.nms_sorted(boxes, valid, lab, 0.6)
                want = nms_kernel.nms_sorted_plain(boxes, valid, lab, 0.6)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                s.say(f"k1_check_K{k}_{'labels' if lab is not None else 'nolabels'}",
                      f"mismatches={n_diff} kept={int(want.sum())} "
                      f"valid={int(valid.sum())}")
                if n_diff:
                    raise AssertionError(f"K1 keep masks differ at K={k}")

    # ---- 4 ------------------------------------------------------------
    def p_stem():
        det = build_detector(c2f(), device=dev, seed=s.seed)
        im, _ = images(4, H, W, s.seed)
        x = det._prep_images(im)
        st["stem_x"] = x
        c0, c1 = det.backbone.body.conv0, det.backbone.body.conv1
        st["stem_w"] = (c0.weight, c0.bias, c1.weight, c1.bias)
        errs = {}
        for b in (2, 4):
            a = (x[:b],) + st["stem_w"]
            got = stem_kernel.fused_stem(*a, out_dtype=torch.float32)
            want = stem_kernel.reference_stem(*a, out_dtype=torch.float32)
            err = (got - want).abs().max().item()
            errs["float32"] = max(errs.get("float32", 0.0), err)
            torch.testing.assert_close(got, want.contiguous(), atol=1e-4,
                                       rtol=1e-4)
            got = stem_kernel.fused_stem(*a, out_dtype=torch.bfloat16).float()
            want = stem_kernel.reference_stem(
                *a, out_dtype=torch.bfloat16).float()
            scale = want.abs().max().item()
            diff = (got - want).abs()
            err = diff.max().item()
            errs["bfloat16"] = max(errs.get("bfloat16", 0.0), err)
            s.say(f"k2_check_B{b}",
                  f"bf16 max_abs_err={err} max|plain|={scale} "
                  f"share_over_1ulp="
                  f"{float((diff > want.abs() * 2 ** -8).float().mean())}")
            torch.testing.assert_close(got, want, rtol=2 ** -7,
                                       atol=2 ** -8 * scale)
        st["stem_err"] = errs
        s.say("k2_max_abs_err_float32", errs["float32"])
        s.say("k2_max_abs_err_bfloat16", errs["bfloat16"])
        del det

    # ---- 5 ------------------------------------------------------------
    def p_small():
        h, w = 128, 192
        im, sizes = images(2, h, w, s.seed + 1)
        for mode in ("common", "precision", "light"):
            cfg = c2f("float32", mode)
            gpu = build_detector(cfg, device=dev, seed=s.seed)
            cpu = build_detector(cfg, device="cpu", seed=s.seed)
            for d in (gpu, cpu):  # spread scores, ~40 px boxes: NMS has work
                with torch.no_grad():
                    d.fcos.cls_logits.bias.zero_()
                    d.fcos.bbox_pred.bias.fill_(3.0)
            got = gpu.forward_inference(im, sizes)
            want = cpu.forward_inference(im.cpu(), sizes.cpu())
            v = want["valid"]
            assert torch.equal(got["valid"].cpu(), v), mode
            assert torch.equal(got["labels"].cpu()[v], want["labels"][v]), mode
            torch.testing.assert_close(got["boxes"].cpu()[v], want["boxes"][v],
                                       rtol=1e-4, atol=1e-2)
            torch.testing.assert_close(got["scores"].cpu()[v], want["scores"][v],
                                       rtol=1e-4, atol=1e-5)
            s.say(f"small_input_{mode}", f"valid={int(v.sum())} agree")

    # ---- 6 ------------------------------------------------------------
    def p_main():
        captured = []
        real = pp_mod.nms_keep_mask

        def recording(boxes, scores, valid, thr, labels=None, **kw):
            keep = real(boxes, scores, valid, thr, labels=labels, **kw)
            if st.get("capture"):
                captured.append((boxes, scores, valid, labels, thr, keep))
            return keep

        im, sizes = images(4, H, W, s.seed)
        batch = dict(images=im.cpu().numpy(), sizes=sizes.cpu().numpy(),
                     scales=np.ones((4, 2), np.float32),
                     indices=np.arange(4))
        pp_mod.nms_keep_mask = recording
        try:
            dets = {dt: build_detector(c2f(dt), device=dev, seed=s.seed)
                    for dt in ("float32", "bfloat16")}
            torch.cuda.synchronize()
            nms_kernel.nms_sorted.launches = 0
            stem_kernel.fused_stem.launches = 0
            for dt, det in dets.items():
                for mode in ("common", "precision", "light"):
                    det.test_mode = mode
                    st["capture"] = mode == "precision"
                    preds = compute_predictions(det, [batch], progress_every=0)
                    st["capture"] = False
                    assert sorted(preds) == [0, 1, 2, 3], sorted(preds)
                    for p in preds.values():
                        n = len(p["labels"])
                        assert n <= 100 and p["boxes"].shape == (n, 4)
                        assert np.isfinite(p["boxes"]).all()
                        assert np.isfinite(p["scores"]).all()
                        assert ((p["labels"] >= 1) & (p["labels"] <= 8)).all()
                    s.say(f"main_{dt}_{mode}", "detections="
                          f"{[len(preds[i]['labels']) for i in range(4)]}")
            st["launches"] = {"nms": nms_kernel.nms_sorted.launches,
                              "stem": stem_kernel.fused_stem.launches}
        finally:
            pp_mod.nms_keep_mask = real
        s.say("main_path_launches", st["launches"])
        assert st["launches"]["nms"] > 0 and st["launches"]["stem"] > 0
        for boxes, scores, valid, labels, thr, keep in captured:
            order = torch.sort(-torch.where(valid, scores, torch.tensor(
                nms_mod.NEG_INF, device=dev)), dim=-1, stable=True).indices
            b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            v = torch.gather(valid, 1, order)
            lab = torch.gather(labels, 1, order)
            want = torch.zeros_like(valid).scatter(
                1, order, nms_kernel.nms_sorted_plain(b, v, lab, thr))
            s.say("main_precision_nms_candidates",
                  f"valid_in={v.sum(1).tolist()} kept={want.sum(1).tolist()} "
                  f"K={valid.shape[1]}")
            assert torch.equal(keep, want), "captured NMS sets disagree"
            st["nms_set"] = (b, v, lab, thr)
        assert captured, "no NMS input captured in precision mode"
        st["dets"] = dets

    # ---- 7 ------------------------------------------------------------
    def p_time():
        kernels = []
        b, v, lab, thr = st["nms_set"]
        bsz, k = v.shape
        ms = cuda_time(lambda: nms_kernel.nms_sorted(b, v, lab, thr), 200)
        plain = cuda_time(lambda: nms_kernel.nms_sorted_plain(b, v, lab, thr), 3, 1)
        nbytes = b.numel() * 4 + v.numel() + lab.numel() * 4 + v.numel()
        ops = bsz * k * (k - 1) / 2 * 14  # IoU, compare, label test per pair
        bound = max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S) * 1e3
        kernels.append(dict(
            name="nms_sorted", route="cuda", source="scan_tpu_torch/csrc/nms.cu",
            replaces="scan_tpu/ops/pallas/nms_kernel.py:71",
            launches=st["launches"]["nms"], max_abs_err=0.0, ms=ms,
            plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_FP32_S
            else "operations", library_ms=None, shape=f"B={bsz} K={k}"))
        s.say("time_nms_sorted", f"ms={ms} plain_ms={plain} bound_ms={bound} "
              f"(B={bsz}, K={k})")

        x = st["stem_x"]
        w = st["stem_w"]
        bs, hh, ww, _ = x.shape
        flops = 2 * bs * hh * ww * 64 * (27 + 576)

        def library(dt):
            xc = x.permute(0, 3, 1, 2).to(dt)
            w0 = w[0].to(dt).contiguous(memory_format=torch.channels_last)
            w1 = w[2].to(dt).contiguous(memory_format=torch.channels_last)
            b0, b1 = w[1].to(dt), w[3].to(dt)
            return lambda: F.max_pool2d(F.relu(F.conv2d(
                F.relu(F.conv2d(xc, w0, b0, padding=1)), w1, b1, padding=1)), 2, 2)

        times = {}
        for dt, peak in ((torch.float32, PEAK_FP32_S), (torch.bfloat16, PEAK_BF16_S)):
            name = str(dt).split(".")[-1]
            kms = cuda_time(lambda: stem_kernel.fused_stem(*((x,) + w), out_dtype=dt), 10)
            pms = cuda_time(lambda: stem_kernel.reference_stem(*((x,) + w), out_dtype=dt), 10)
            lms = cuda_time(library(dt), 10)
            osize = 4 if dt == torch.float32 else 2
            nbytes = x.numel() * 4 + (64 * 3 * 9 + 64 * 64 * 9 + 128) * 4 \
                + bs * (hh // 2) * (ww // 2) * 64 * osize
            bound = max(nbytes / PEAK_BYTES_S, flops / peak) * 1e3
            times[name] = dict(ms=kms, plain_ms=pms, library_ms=lms,
                               bound_ms=bound, bound_by="bytes"
                               if nbytes / PEAK_BYTES_S > flops / peak
                               else "operations",
                               tflops=flops / kms / 1e9)
            s.say(f"time_stem_{name}",
                  f"ms={kms} plain_ms={pms} library_ms={lms} bound_ms={bound} "
                  f"kernel_TFLOP/s={flops / kms / 1e9} (B={bs}, {hh}x{ww})")
        bf, f32 = times["bfloat16"], times["float32"]
        kernels.append(dict(
            name="vgg_stem_fused", route="cuda", source="scan_tpu_torch/csrc/stem.cu",
            replaces="scan_tpu/ops/pallas/stem_kernel.py:215",
            launches=st["launches"]["stem"],
            max_abs_err=st["stem_err"]["bfloat16"],
            ms=bf["ms"], plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
            bound_by=bf["bound_by"], library_ms=bf["library_ms"],
            dtype="bfloat16", shape=f"B={bs} {hh}x{ww}",
            float32=dict(f32, max_abs_err=st["stem_err"]["float32"])))
        st["kernels"] = kernels

        det = st["dets"]["bfloat16"]
        det.test_mode = "precision"
        im, sizes = images(8, H, W, s.seed + 2)
        fwd_ms = cuda_time(lambda: det.forward_inference(im, sizes), 5, 2)
        s.say("forward_bf16_precision_b8_ms", fwd_ms)
        s.say("forward_bf16_precision_b8_img_s", 8 * 1e3 / fwd_ms)

        # the same forward cut at its layers, each timed on its own inputs
        with torch.no_grad():
            x = det._prep_images(im)
            feats = list(det.backbone(x))
            mh = det.middle_head(feats, det.proto_state(), "inference")
            head = det.fcos(mh[0], True)
            cls_maps, _ = mix_cls_maps("precision", head[0], mh[2])
            shapes = [(f.shape[1], f.shape[2]) for f in mh[0]]
            locs = compute_locations(shapes, det.strides, device=dev)
            pp = dataclasses.replace(det.pp_cfg, apply_sigmoid=False)
            parts = {
                "prep": lambda: det._prep_images(im),
                "backbone": lambda: det.backbone(x),
                "condgraph": lambda: det.middle_head(
                    feats, det.proto_state(), "inference"),
                "fcos_head": lambda: det.fcos(mh[0], True),
                "postprocess": lambda: fcos_postprocess(
                    pp, locs, cls_maps, head[1], head[2], sizes),
                "stem_kernel": lambda: stem_kernel.fused_stem(
                    x, *st["stem_w"], out_dtype=torch.bfloat16),
            }
            for name, fn in parts.items():
                s.say(f"forward_part_{name}_ms", cuda_time(fn, 5, 1))
        s.say("peak_mem_gib", torch.cuda.max_memory_allocated() / 2 ** 30)

    s.phase("build", p_build)
    s.phase("k1_nms_vs_plain", p_nms)
    s.phase("k2_stem_vs_plain", p_stem)
    s.phase("small_input_card_vs_cpu", p_small)
    s.phase("main_path_full_width", p_main)
    if "main_path_full_width" in s.failed or "k2_stem_vs_plain" in s.failed:
        s.failed.append("timing (skipped)")
    else:
        s.phase("timing", p_time)

    s.record["kernels"] = st.get("kernels")
    s.record["failed"] = s.failed
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(s.record, indent=1))
    if s.failed:
        print(f"chip_smoke: failed phases: {s.failed}", file=sys.stderr)
        return 1
    print(s.card)
    print(json.dumps({"kernels": st["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
