#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure makes the script exit non-zero without the
final ``{"ok": true, ...}`` line:

  1. the card's name and power limit (nvidia-smi); build every kernel from
     ``scan_tpu_torch/csrc/*.cu`` (one nvcc each, all started together);
     print each library's registers and spills (ptxas) and its SASS counts
     of HMMA and IMMA (cuobjdump), and for ``conv0`` also of I2F, F2I, FRND,
     F2F and MUFU (K3's epilogue converts and divides only in its guard
     band); fail unless ``stem`` has HMMA (K2's bf16 conv1_2) and
     ``stem_int8`` and ``conv0`` have IMMA (K5's conv1_2, K3's conv);
  2. TF32 off for cuDNN and matmul;
  3. K1 (NMS) against its plain version: sorted synthetic sets, K = 512 and
     1000, B = 4, without labels and with int64 and int32 labels, invalid
     rows mixed in; keep masks must be equal;
  4. K2 (fused VGG stem) against its plain version on a normalised 800x1344
     batch with the model's own conv1_1/conv1_2 weights: float32 within
     atol/rtol 1e-4; bfloat16 within rtol 2**-7 and atol 2**-8 of the
     largest output (see tests/test_torch_kernels.py for why);
  5. small-input agreement: the port on the card against the port's plain
     path on the CPU (which tests/test_torch_*.py hold against scan_tpu),
     128x192, float32, all three TEST.MODEs;
  6. the fp main path: ``build_detector`` on the C2F config (full VGG16,
     256-channel FPN and heads) at 800x1344, batch 4, seeded weights and a
     seeded uint8 batch, TEST.MODE common/precision/light in float32 and
     bfloat16. The launch counters are zeroed before and read after; the
     candidate sets entering NMS in precision mode are held against the
     plain NMS;
  7. int8 calibration: the C2F config with ``TPU.INT8_INFERENCE`` in
     bfloat16, static activation scales from one seeded batch of 4;
  8. K3-K6 against their plain versions at (4, 800, 1344), on the model's
     stem weights and calibrated scales: all four equal, byte for byte;
  9. int8 small-input agreement, per stem variant: 128x192, float32, card
     against the CPU at the same scales; backbone features equal, and
     detections matched as stated in ``p_int8_small``;
 10. the int8 main path, per stem variant (the default chain, PALLAS_CONV0,
     PALLAS_PHASE_MAX, PALLAS_STEM_INT8, and STEM_S8_EPILOGUE +
     STEM_PAIR_CONV + PALLAS_PHASE_MAX): ``compute_predictions`` in all three
     modes at 800x1344, batch 4, bfloat16; the counters are zeroed before
     each variant, and its kernel must have launched and the other int8
     kernels (and K2) not;
 11. timing with CUDA events: each kernel and its plain version at the
     checks' shapes; K1 and K3 also as their raw launches captured in a
     CUDA graph (device time without the wrapper's host work), K1 beside
     its launch floor (empty kernels on the same two grids, timed the same
     way), both beside PERF.md's times of their earlier designs; cuDNN's
     conv/relu/conv/relu/maxpool as the fp stem's library call (K2
     float32's ratio to it printed), the default int8 chain
     (im2col + ``torch._int_mm``) as the yardstick of K3 and K5, K2's
     TFLOP/s and K5's TOP/s, K2 bf16 and K5 without their tensor-core
     conv1_2 (the ``*_probe`` entry points) to split their time, fp and
     int8 forward img/s at bfloat16,
     precision, batch 8 (int8 for each stem variant), and both forwards cut
     at their layers;
 12. ``train_small_card_vs_cpu``: one DA step (``make_da_train_step``) of
     the full-width C2F model at 128x192, batch 2 + 2, float32, TF32 off,
     in each ``forward_target`` variant, on the card (K2 on the frozen stem)
     and on the CPU from the same seeded weights and batches: source and
     target node masks and labels equal, DBSCAN keep masks equal, the
     metrics within rtol 1e-4 and every parameter update within the bound
     stated in ``p_train_small``;
 13. ``train_main_path_full_width``: the DA step at C2F's full width, batch
     4 + 4 at 800x1344, float32, seeded weights, dropout on, seeded scenes
     with 16 GT boxes an image (source) and fogged scenes (target): three
     steps with ``forward_target`` True, the first (from the seeded state)
     with target nodes and a transfer loss above 0, then three with False
     (the counters zeroed before and read after: K2 twice a step, no other
     kernel), then one step of each variant under
     ``torch.cuda.set_sync_debug_mode("error")``; every loss finite, the
     trained parameters moved and the frozen ones not, the prototype
     counter and values advanced; peak device memory;
 14. ``train_loop_with_validation``: ``do_train_da`` for 4 iterations with
     SOLVER.VAL_ITER 2 and a seeded validation set of 4 images at 800x1344
     (COCO AP through ``engine/inference.py::inference``): K1 and K2 launch
     in each validation, K2 twice a training step; AP50 printed;
 15. ``train_timing``: ms per DA step and img/s (source + target) in each
     variant, CUDA events after warm-up, each step from phase 13's seeded
     state (so the True variant's GST has nodes, checked); the step split
     into G source, D source, G target, D target, backward and optimizer;
     ``sample_target_nodes`` alone at full width.

Every number is printed with the card's name and power limit; everything is
also written to ``chiprun_out/chip_smoke.json``. The line before the last is
the per-kernel JSON; the last line is the device JSON.
"""

import argparse
import ctypes
import dataclasses
import itertools
import json
import math
import re
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
PEAK_INT8_S = 1979e12  # tensor cores, dense
PAD1 = ((1, 1), (1, 1))
# PERF.md's times of the designs that K1 and K3 replaced (NVIDIA H100 80GB
# HBM3, 700.00 W): K1's wrapper at (4, 512), K3 at (4, 800, 1344)
EARLIER_MS = {"nms_sorted": 0.0794, "conv0_s8": 0.740}
SASS_OPS = ("HMMA", "IMMA", "I2F", "F2I", "FRND", "F2F", "MUFU")
# int8 stem variants: the TPU.* switches each sets, and the kernel it runs
INT8_VARIANTS = {
    "default": ({}, None),
    "conv0": ({"PALLAS_CONV0": True}, "conv0_s8"),
    "phase_max": ({"PALLAS_PHASE_MAX": True}, "phase_max_requant"),
    "stem_int8": ({"PALLAS_STEM_INT8": True}, "fused_stem_int8"),
    "pair_phase_max": ({"STEM_S8_EPILOGUE": True, "STEM_PAIR_CONV": True,
                        "PALLAS_PHASE_MAX": True}, "pair_phase_max_s8"),
}


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


def graph_ms(fn, n=20, reps=10):
    """Mean ms per call of ``fn``, a raw kernel launch on the current
    stream, captured ``n`` times in a CUDA graph and replayed ``reps``
    times: the device's time without the host's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_time(graph.replay, reps, 1) / n


def probe_ms(lib, symbol, n_ptrs, ptrs, b, h, w):
    """Time a kernel's ``*_probe`` entry point (the kernel without its
    conv1_2 main loop): ``n_ptrs`` pointers, then B, H, W and the stream."""
    import torch

    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(*ptrs, b, h, w, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"{symbol}: CUDA error {err}"
    return cuda_time(call, 10)


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
    from scan_tpu_torch.modeling.layers import stored_scale
    from scan_tpu_torch.ops import nms as nms_mod
    from scan_tpu_torch.ops import quant
    from scan_tpu_torch.ops.cuda import (build, conv0_kernel, nms_kernel,
                                         phase_max_kernel, stem_int8_kernel,
                                         stem_kernel)

    s = Smoke(args.seed)
    dev = torch.device("cuda")
    print(s.card, flush=True)
    st = {}  # state handed from phase to phase

    int8_kernels = {
        "conv0_s8": conv0_kernel.conv0_s8,
        "phase_max_requant": phase_max_kernel.phase_max_requant,
        "fused_stem_int8": stem_int8_kernel.fused_stem_int8,
        "pair_phase_max_s8": phase_max_kernel.pair_phase_max_s8,
    }
    counters = {"nms_sorted": nms_kernel.nms_sorted,
                "vgg_stem_fused": stem_kernel.fused_stem, **int8_kernels}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    def c2f(dtype="float32", mode="precision", int8=False, switches=None):
        cfg = get_default_cfg()
        cfg.merge_from_file(str(C2F))
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.TEST.MODE = mode
        cfg.TPU.INT8_INFERENCE = int8
        for key, value in (switches or {}).items():
            cfg.TPU[key] = value
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
        sass = {}
        for name in build.SOURCES:
            text = build.dump_sass(name)
            ops = SASS_OPS if name == "conv0" else SASS_OPS[:2]
            sass[name] = {op: len(re.findall(rf"\b{op}\b", text))
                          for op in ops}
        s.say("sass_counts", sass)
        assert sass["stem"]["HMMA"] > 0, "K2 bf16: no HMMA in stem's SASS"
        assert sass["stem_int8"]["IMMA"] > 0, "K5: no IMMA in stem_int8's SASS"
        assert sass["conv0"]["IMMA"] > 0, "K3: no IMMA in conv0's SASS"
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
            for tag, lab in (("nolabels", None), ("int64_labels", labels),
                             ("int32_labels", labels.int())):
                got = nms_kernel.nms_sorted(boxes, valid, lab, 0.6)
                want = nms_kernel.nms_sorted_plain(boxes, valid, lab, 0.6)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                s.say(f"k1_check_K{k}_{tag}",
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
            got = {k: v.cpu() for k, v in
                   gpu.forward_inference(im, sizes).items()}
            want = cpu.forward_inference(im.cpu(), sizes.cpu())
            v = want["valid"]
            # as sets: two detections of one label whose scores differ by
            # float32 rounding may trade places (K2 sums in another order
            # than the CPU's convolution)
            share = matched_share(got, want, box_atol=0.03, score_atol=1.1e-4)
            s.say(f"small_input_{mode}",
                  f"valid={int(v.sum())} matched={share}")
            assert torch.equal(got["valid"].sum(1), v.sum(1)), mode
            assert share == 1.0, f"{mode}: {share} of the detections match"

    def matched_share(got, want, box_atol, score_atol=None):
        """Share of ``want``'s valid detections that ``got`` has too: one
        of the same image and label, with every box coordinate within
        ``box_atol`` (and the score within ``score_atol``)."""
        vg, vc = got["valid"], want["valid"]
        matched = []
        for b in range(vg.shape[0]):
            box_g, box_c = got["boxes"][b][vg[b]], want["boxes"][b][vc[b]]
            ok = (box_c[:, None] - box_g[None]).abs().amax(-1) <= box_atol
            ok &= want["labels"][b][vc[b]][:, None] == \
                got["labels"][b][vg[b]][None]
            if score_atol is not None:
                ok &= (want["scores"][b][vc[b]][:, None]
                       - got["scores"][b][vg[b]][None]).abs() <= score_atol
            matched.append(ok.any(1))
        matched = torch.cat(matched)
        return float(matched.float().mean()) if matched.numel() else 1.0

    def check_preds(preds, n):
        assert sorted(preds) == list(range(n)), sorted(preds)
        for p in preds.values():
            k = len(p["labels"])
            assert k <= 100 and p["boxes"].shape == (k, 4)
            assert np.isfinite(p["boxes"]).all()
            assert np.isfinite(p["scores"]).all()
            assert ((p["labels"] >= 1) & (p["labels"] <= 8)).all()
        return [len(preds[i]["labels"]) for i in range(n)]

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
            zero_counts()
            for dt, det in dets.items():
                for mode in ("common", "precision", "light"):
                    det.test_mode = mode
                    st["capture"] = mode == "precision"
                    preds = compute_predictions(det, [batch], progress_every=0)
                    st["capture"] = False
                    s.say(f"main_{dt}_{mode}",
                          f"detections={check_preds(preds, 4)}")
            st["launches"] = counts()
        finally:
            pp_mod.nms_keep_mask = real
        s.say("main_path_launches", st["launches"])
        assert st["launches"]["nms_sorted"] > 0
        assert st["launches"]["vgg_stem_fused"] > 0
        assert not any(st["launches"][k] for k in int8_kernels), \
            "an int8 kernel launched on the fp path"
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
    def set_switches(det, switches):
        """The int8 stem switches of a built detector, as TPU.* would set
        them (the small-input phase flips them on one pair of models)."""
        body = det.backbone.body
        for key in ("STEM_S8_EPILOGUE", "STEM_PAIR_CONV", "PALLAS_CONV0",
                    "PALLAS_PHASE_MAX", "PALLAS_STEM_INT8"):
            setattr(body, key.lower(), bool(switches.get(key, False)))

    def p_int8_calibrate():
        det = build_detector(c2f("bfloat16", "precision", int8=True),
                             device=dev, seed=s.seed)
        im, _ = images(4, H, W, s.seed + 3)
        t0 = time.time()
        det.calibrate_int8([im])
        torch.cuda.synchronize()
        s.say("int8_calibrate_s", time.time() - t0)
        scales = {k: float(v) for k, v in det.state_dict().items()
                  if k.endswith(("amax", "_act"))}
        s.say("int8_scales", f"n={len(scales)} min={min(scales.values())} "
              f"max={max(scales.values())} stem="
              f"{[scales['backbone.body.' + n] for n in ('conv0_act', 'conv1_act', 'stem_out_act')]}")
        assert scales and min(scales.values()) > 0, scales
        st["int8_det"] = det

    # ---- 8 ------------------------------------------------------------
    def p_int8_kernels():
        det = st["int8_det"]
        body = det.backbone.body
        bf = torch.bfloat16
        im, _ = images(4, H, W, s.seed)
        with torch.no_grad():
            x = det._prep_images(im).to(bf)
            s0, s1, s_out = (stored_scale(body, n) for n in
                             ("conv0_act", "conv1_act", "stem_out_act"))
            k0, k1 = body.conv0.hwio(), body.conv1.hwio()
            b0, b1 = body.conv0.bias, body.conv1.bias
            w0, w1, bb0, bb1 = (t.to(bf) for t in (k0, k1, b0, b1))
            x_q, _ = quant.quantize_activation(x, s0)
            # K4's input: the default chain's conv1_2 output; K6's: the
            # s8-epilogue chain's
            y = F.relu(quant.int8_conv(x, w0, bb0, 1, PAD1, out_dtype=bf,
                                       act_scale=s0))
            z = quant.int8_conv(y, w1, bb1, 1, PAD1, out_dtype=bf,
                                act_scale=s1)
            del y
            y_q = quant.int8_conv(x, w0, bb0, 1, PAD1, act_scale=s0,
                                  out_quant_scale=s1, fold_relu=True)
            z_q = quant.int8_conv(y_q, w1, bb1, 1, PAD1, act_scale=s1,
                                  out_quant_scale=s_out, fold_relu=True)
            del y_q
        args = {
            "conv0_s8": (x_q, k0, b0, s0, s1),
            "phase_max_requant": (z, torch.clamp_min(s_out, 1e-8)),
            "fused_stem_int8": (x_q, k0, b0, k1, b1, s0, s1, s_out),
            "pair_phase_max_s8": (z_q,),
        }
        # K3 and K5 take their weights packed once, as the main path does
        kw = {"conv0_s8": dict(packed=conv0_kernel.pack_weight(k0)),
              "fused_stem_int8": dict(
                  packed=stem_int8_kernel.pack_weights(k0, k1))}
        plain = {
            "conv0_s8": conv0_kernel.conv0_s8_plain,
            "phase_max_requant": phase_max_kernel.phase_max_requant_plain,
            "fused_stem_int8": stem_int8_kernel.fused_stem_int8_plain,
            "pair_phase_max_s8": phase_max_kernel.pair_phase_max_s8_plain,
        }
        errs = {}
        for name, a in args.items():
            with torch.no_grad():
                got = int8_kernels[name](*a, **kw.get(name, {}))
                want = plain[name](*a)
            torch.cuda.synchronize()
            diff = (got.int() - want.int()).abs()
            n_diff = int((diff > 0).sum())
            errs[name] = int(diff.max())
            s.say(f"{name}_check",
                  f"shape={tuple(got.shape)} mismatches={n_diff} "
                  f"at_1_lsb={int((diff == 1).sum())} "
                  f"max_abs_err={errs[name]} of {want.numel()}; "
                  f"nonzero share={float((want != 0).float().mean())}")
            assert got.shape == want.shape and got.dtype == torch.int8
            assert n_diff == 0, f"{name} differs from its plain version"
        st["int8_args"], st["int8_plain"], st["int8_err"] = args, plain, errs
        st["int8_kw"] = kw

    # ---- 9 ------------------------------------------------------------
    def p_int8_small():
        """Card against CPU at the same scales, 128x192, float32. Every int8
        conv sums exactly and runs the same float32 steps on both, and the
        kernels equal their plain versions, so the backbone's features
        (VGG16 and FPN: int8 convs, ReLU, pools, the top-down adds) must be
        equal. The heads also run GroupNorm and fp convs, whose sums the
        card orders differently; where such a value sits on a rounding
        boundary of the next quantize it moves a whole step (on this input:
        2% of the first level's condgraph features, by one step). Scores
        then move by ~1e-3 and near-equal candidates trade places at the
        top-100 cut, so detections are matched as sets: a CPU detection is
        matched by a card detection of the same image and label whose box
        is within 1 px. At least 85% must be matched (94-100% measured on
        an H100, per image and mode), with as many detections on each."""
        h, w = 128, 192
        im, sizes = images(2, h, w, s.seed + 1)
        cfg = c2f("float32", "precision", int8=True)
        gpu = build_detector(cfg, device=dev, seed=s.seed)
        gpu.calibrate_int8([im])
        cpu = build_detector(cfg, device="cpu", seed=s.seed)
        cpu.load_state_dict(gpu.state_dict())
        for d in (gpu, cpu):  # spread scores, ~40 px boxes: NMS has work
            with torch.no_grad():
                d.fcos.cls_logits.bias.zero_()
                d.fcos.bbox_pred.bias.fill_(3.0)
        for name, (switches, kernel) in INT8_VARIANTS.items():
            for d in (gpu, cpu):
                set_switches(d, switches)
            zero_counts()
            with torch.no_grad():
                fg = gpu.backbone(gpu._prep_images(im))
                fc = cpu.backbone(cpu._prep_images(im.cpu()))
            feat_err = max((a.cpu() - b).abs().max().item()
                           for a, b in zip(fg, fc))
            got = {k: v.cpu() for k, v in
                   gpu.forward_inference(im, sizes).items()}
            want = cpu.forward_inference(im.cpu(), sizes.cpu())
            launched = counts()
            vg, vc = got["valid"], want["valid"]
            share = matched_share(got, want, box_atol=1.0)
            s.say(f"int8_small_{name}",
                  f"feature max_abs_err={feat_err} valid card/cpu="
                  f"{int(vg.sum())}/{int(vc.sum())} matched={share} "
                  f"launches={launched}")
            assert feat_err == 0.0, f"{name}: backbone features differ"
            assert int(vc.sum()) > 20, "the check needs detections"
            assert int(vg.sum()) == int(vc.sum()), name
            assert share >= 0.85, f"{name}: {share} of the detections match"
            if kernel is not None:
                assert launched[kernel] > 0, f"{name}: {kernel} did not run"

    # ---- 10 -----------------------------------------------------------
    def p_int8_main():
        im, sizes = images(4, H, W, s.seed)
        batch = dict(images=im.cpu().numpy(), sizes=sizes.cpu().numpy(),
                     scales=np.ones((4, 2), np.float32),
                     indices=np.arange(4))
        state = st["int8_det"].state_dict()
        st["int8_launches"], st["int8_dets"] = {}, {}
        for name, (switches, kernel) in INT8_VARIANTS.items():
            det = build_detector(
                c2f("bfloat16", "precision", int8=True, switches=switches),
                device=dev, seed=s.seed)
            det.load_state_dict(state)  # the calibrated scales
            torch.cuda.synchronize()
            zero_counts()
            for mode in ("common", "precision", "light"):
                det.test_mode = mode
                preds = compute_predictions(det, [batch], progress_every=0)
                s.say(f"int8_main_{name}_{mode}",
                      f"detections={check_preds(preds, 4)}")
            torch.cuda.synchronize()
            launched = counts()
            s.say(f"int8_main_{name}_launches", launched)
            assert launched["nms_sorted"] > 0, name
            assert launched["vgg_stem_fused"] == 0, name
            for k in int8_kernels:
                assert (launched[k] > 0) == (k == kernel), (name, k, launched)
            st["int8_launches"][name] = launched
            st["int8_dets"][name] = det

    # ---- 11 ------------------------------------------------------------
    def p_time():
        kernels = []
        b, v, lab, thr = st["nms_set"]
        bsz, k = v.shape
        wrapper = cuda_time(lambda: nms_kernel.nms_sorted(b, v, lab, thr), 200)
        plain = cuda_time(lambda: nms_kernel.nms_sorted_plain(b, v, lab, thr), 3, 1)
        # the raw launch on prepared buffers, and the launch floor
        lib = build.load("nms")
        words = (k + 63) // 64
        mask = torch.empty((bsz, k, words), dtype=torch.int64, device=dev)
        keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
        lab_c = lab.contiguous()
        launch = nms_kernel._lib()
        empty = lib.scan_nms_empty
        empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        empty.restype = ctypes.c_int

        def raw():
            err = launch(b.data_ptr(), v.data_ptr(), lab_c.data_ptr(),
                         lab_c.element_size(), bsz, k, float(thr), 1,
                         mask.data_ptr(), keep.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"nms: CUDA error {err}"

        def floor():
            err = empty(bsz, k, torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"nms empty: CUDA error {err}"
        ms = graph_ms(raw)
        floor_ms = graph_ms(floor)
        want = nms_kernel.nms_sorted_plain(b, v, lab, thr)
        assert torch.equal(keep, want), "K1's graph-timed launch disagrees"
        nbytes = b.numel() * 4 + v.numel() + lab.numel() * lab.element_size() \
            + v.numel()
        ops = bsz * k * (k - 1) / 2 * 14  # IoU, compare, label test per pair
        bound = max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S) * 1e3
        kernels.append(dict(
            name="nms_sorted", route="cuda", source="scan_tpu_torch/csrc/nms.cu",
            replaces="scan_tpu/ops/pallas/nms_kernel.py:71",
            launches=st["launches"]["nms_sorted"], max_abs_err=0.0, ms=ms,
            plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_FP32_S
            else "operations", library_ms=None, shape=f"B={bsz} K={k}",
            timing="raw launch in a CUDA graph", wrapper_ms=wrapper,
            launch_floor_ms=floor_ms))
        s.say("time_nms_sorted",
              f"graph_ms={ms} wrapper_ms={wrapper} launch_floor_ms={floor_ms} "
              f"plain_ms={plain} bound_ms={bound} (B={bsz}, K={k}, labels "
              f"{lab.dtype}); earlier design's wrapper_ms="
              f"{EARLIER_MS['nms_sorted']} (PERF.md)")

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
        packs = {dt: stem_kernel.pack_weights(*w, out_dtype=dt)  # as vgg.py
                 for dt in (torch.float32, torch.bfloat16)}
        for dt, peak in ((torch.float32, PEAK_FP32_S), (torch.bfloat16, PEAK_BF16_S)):
            name = str(dt).split(".")[-1]
            kms = cuda_time(lambda: stem_kernel.fused_stem(
                *((x,) + w), out_dtype=dt, packed=packs[dt]), 10)
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
                  f"kernel_TFLOP/s={flops / kms / 1e9} "
                  f"kernel/library={kms / lms} (B={bs}, {hh}x{ww})")
        bf, f32 = times["bfloat16"], times["float32"]
        pk = packs[torch.bfloat16]
        out = torch.empty((bs, hh // 2, ww // 2, 64), dtype=torch.bfloat16,
                          device=dev)
        xf = x.float().contiguous()
        bf["without_conv1_2_ms"] = probe_ms(
            build.load("stem"), "scan_stem_probe", 6,
            [t.data_ptr() for t in (xf, pk.w0, pk.b0, pk.w1, pk.b1, out)],
            bs, hh, ww)
        s.say("time_stem_bfloat16_without_conv1_2",
              f"ms={bf['without_conv1_2_ms']} "
              f"share={bf['without_conv1_2_ms'] / bf['ms']}")
        kernels.append(dict(
            name="vgg_stem_fused", route="cuda", source="scan_tpu_torch/csrc/stem.cu",
            replaces="scan_tpu/ops/pallas/stem_kernel.py:215",
            launches=st["launches"]["vgg_stem_fused"],
            max_abs_err=st["stem_err"]["bfloat16"],
            ms=bf["ms"], plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
            bound_by=bf["bound_by"], library_ms=bf["library_ms"],
            dtype="bfloat16", shape=f"B={bs} {hh}x{ww}",
            without_conv1_2_ms=bf["without_conv1_2_ms"],
            float32=dict(f32, max_abs_err=st["stem_err"]["float32"])))
        st["kernels"] = kernels

        det = st["dets"]["bfloat16"]
        det.test_mode = "precision"
        im, sizes = images(8, H, W, s.seed + 2)
        fwd_ms = cuda_time(lambda: det.forward_inference(im, sizes), 5, 2)
        s.say("forward_bf16_precision_b8_ms", fwd_ms)
        s.say("forward_bf16_precision_b8_img_s", 8 * 1e3 / fwd_ms)

        time_parts("forward", det, im, sizes,
                   lambda x: det.backbone.body._stage1_fp(x))

    def time_parts(prefix, det, im, sizes, stem):
        """The precision forward cut at its layers, each timed alone on its
        own inputs; ``stem`` times stage 1 on the normalised batch."""
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
                "stem": lambda: stem(x),
            }
            for name, fn in parts.items():
                s.say(f"{prefix}_part_{name}_ms", cuda_time(fn, 5, 1))
        s.say("peak_mem_gib", torch.cuda.max_memory_allocated() / 2 ** 30)

    def p_time_int8():
        args, plain, kw = st["int8_args"], st["int8_plain"], st["int8_kw"]
        x_q = args["conv0_s8"][0]
        bs, hh, ww, _ = x_q.shape
        pix = bs * hh * ww
        _, k0, b0, k1, b1, s0, s1, s_out = args["fused_stem_int8"]
        wq0 = quant.prepare_weight(*quant.quantize_weight(k0))
        wq1 = quant.prepare_weight(*quant.quantize_weight(k1))

        def chain_conv0():  # the default chain's im2col + _int_mm, same work
            return quant.int8_conv_q(x_q, wq0, b0, 1, PAD1, act_scale=s0,
                                     out_quant_scale=s1, fold_relu=True)

        def chain_stem():
            y_q = quant.int8_conv_q(x_q, wq0, b0, 1, PAD1, act_scale=s0,
                                    out_quant_scale=s1, fold_relu=True)
            return quant.max_pool_2x2(quant.int8_conv_q(
                y_q, wq1, b1, 1, PAD1, act_scale=s1, out_quant_scale=s_out,
                fold_relu=True))

        z_q = args["pair_phase_max_s8"][0]
        zb, zh, zw, zc = z_q.shape

        def library_pool():  # the s8 2x2 max-pool as one reduction over a view
            return z_q.view(zb, zh // 2, 2, zw // 2, 2, zc).amax(dim=(2, 4))
        w_bytes0 = 27 * 64 + 2 * 64 * 4
        w_bytes1 = 576 * 64 + 2 * 64 * 4
        pooled = pix // 4 * 64
        work = {  # name: (bytes moved, operations, peak for them, yardsticks)
            "conv0_s8": (pix * 3 + w_bytes0 + pix * 64, 2 * pix * 64 * 27,
                         PEAK_INT8_S, dict(int_mm_chain=chain_conv0)),
            "phase_max_requant": (args["phase_max_requant"][0].numel() * 2
                                  + pooled, pooled * 7, PEAK_FP32_S, {}),
            "fused_stem_int8": (pix * 3 + w_bytes0 + w_bytes1 + pooled,
                                2 * pix * 64 * (27 + 576), PEAK_INT8_S,
                                dict(int_mm_chain=chain_stem)),
            "pair_phase_max_s8": (z_q.numel() + pooled, pooled * 3,
                                  PEAK_FP32_S, dict(library=library_pool)),
        }
        replaces = {
            "conv0_s8": ("conv0.cu", "conv0_kernel.py:128"),
            "phase_max_requant": ("phase_max.cu", "phase_max_kernel.py:107"),
            "fused_stem_int8": ("stem_int8.cu", "stem_int8_kernel.py:163"),
            "pair_phase_max_s8": ("pair_phase_max.cu",
                                  "phase_max_kernel.py:61"),
        }
        variant_of = {k: v for v, (_, k) in INT8_VARIANTS.items() if k}
        with torch.no_grad():
            for name, (nbytes, ops, peak, extra) in work.items():
                a = args[name]
                ms = cuda_time(
                    lambda: int8_kernels[name](*a, **kw.get(name, {})), 20)
                pms = cuda_time(lambda: plain[name](*a), 5, 1)
                yard = {k: cuda_time(fn, 10) for k, fn in extra.items()}
                bound = max(nbytes / PEAK_BYTES_S, ops / peak) * 1e3
                src, tpu = replaces[name]
                st["kernels"].append(dict(
                    name=name, route="cuda",
                    source=f"scan_tpu_torch/csrc/{src}",
                    replaces=f"scan_tpu/ops/pallas/{tpu}",
                    launches=st["int8_launches"][variant_of[name]][name],
                    max_abs_err=float(st["int8_err"][name]), ms=ms,
                    plain_ms=pms, bound_ms=bound,
                    bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / peak
                    else "operations",
                    library_ms=yard.get("library"),
                    int_mm_chain_ms=yard.get("int_mm_chain"),
                    shape=f"B={bs} {hh}x{ww}"))
                earlier = (f" earlier design's ms={EARLIER_MS[name]} (PERF.md)"
                           if name in EARLIER_MS else "")
                s.say(f"time_{name}", f"ms={ms} plain_ms={pms} "
                      f"bound_ms={bound} {yard} bytes={nbytes} ops={ops} "
                      f"kernel_TOP/s={ops / ms / 1e9} (B={bs}, {hh}x{ww})"
                      + earlier)

        # K3's raw launch on prepared buffers, captured in a CUDA graph
        wk, w_s = kw["conv0_s8"]["packed"]
        k3_args = (w_s, quant.f32(s0, x_q).reshape(()),
                   b0.float().contiguous(), quant.f32(s1, x_q).reshape(()))
        k3_out = torch.empty((bs, hh, ww, 64), dtype=torch.int8, device=dev)
        launch = conv0_kernel._lib()

        def k3_raw():
            err = launch(x_q.data_ptr(), wk.data_ptr(),
                         *(t.data_ptr() for t in k3_args), k3_out.data_ptr(),
                         bs, hh, ww, torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"conv0: CUDA error {err}"
        k3 = next(k for k in st["kernels"] if k["name"] == "conv0_s8")
        k3["graph_ms"] = graph_ms(k3_raw, n=10)
        assert torch.equal(k3_out, plain["conv0_s8"](*args["conv0_s8"]))
        s.say("time_conv0_s8_raw_launch_in_graph", f"ms={k3['graph_ms']}")

        w0k, w0_s, w1k, w1_s = kw["fused_stem_int8"]["packed"]
        s0c, s1c, soc = (quant.clamp_scale(v, x_q) for v in (s0, s1, s_out))
        a0, a1 = s0c * w0_s, s1c * w1_s
        b0f, b1f = b0.float().contiguous(), b1.float().contiguous()
        out = torch.empty((bs, hh // 2, ww // 2, 64), dtype=torch.int8,
                          device=dev)
        k5 = next(k for k in st["kernels"] if k["name"] == "fused_stem_int8")
        k5["without_conv1_2_ms"] = probe_ms(
            build.load("stem_int8"), "scan_stem_int8_probe", 10,
            [t.data_ptr() for t in (x_q, w0k, w1k, a0, b0f, a1, b1f, s1c,
                                    soc, out)], bs, hh, ww)
        s.say("time_fused_stem_int8_without_conv1_2",
              f"ms={k5['without_conv1_2_ms']} "
              f"share={k5['without_conv1_2_ms'] / k5['ms']}")

        im, sizes = images(8, H, W, s.seed + 2)
        for name, det in st["int8_dets"].items():
            det.test_mode = "precision"
            fwd_ms = cuda_time(lambda: det.forward_inference(im, sizes), 5, 2)
            s.say(f"int8_{name}_forward_bf16_precision_b8_ms", fwd_ms)
            s.say(f"int8_{name}_forward_bf16_precision_b8_img_s",
                  8 * 1e3 / fwd_ms)
        det = st["int8_dets"]["default"]
        time_parts("int8_default", det, im, sizes,
                   lambda x: det.backbone.body._stage1_int8(x))

    # ---- 12-15: the DA training step ------------------------------------
    from scan_tpu_torch.engine import inference as inference_mod
    from scan_tpu_torch.engine import trainer
    from scan_tpu_torch.engine.train_step import make_da_train_step
    from scan_tpu_torch.modeling.condgraph import module as cg_mod
    from scan_tpu_torch.modeling.condgraph import sampling
    from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer

    def train_setup(cfg, device):
        det = build_detector(cfg, device=device, seed=s.seed)
        opt = make_optimizer(cfg, det)
        sched = make_lr_scheduler(cfg, opt)
        return det, opt, sched, make_da_train_step(det, opt, sched)

    def gt_boxes(g, b, h, w, n_boxes, k):
        """k GT boxes an image (16 px to 30% of the image a side) with
        labels 1..8, in ``n_boxes`` slots."""
        xy = torch.rand(b, k, 2, generator=g) * torch.tensor([w * 0.7, h * 0.7])
        wh = torch.rand(b, k, 2, generator=g) * torch.tensor([w * 0.3, h * 0.3])
        boxes = torch.zeros(b, n_boxes, 4)
        boxes[:, :k] = torch.cat([xy, xy + wh + 16], -1)
        labels = torch.zeros(b, n_boxes, dtype=torch.int32)
        labels[:, :k] = torch.randint(1, 9, (b, k), generator=g,
                                      dtype=torch.int32)
        mask = torch.zeros(b, n_boxes, dtype=torch.bool)
        mask[:, :k] = True
        return boxes, labels, mask

    def scene(g, boxes, labels, mask, h, w):
        """uint8 scenes: a smooth background with a vertical gradient, each
        GT box filled with its class's colour, pixel noise of sd 8."""
        b = boxes.shape[0]
        low = torch.rand(b, 3, max(h // 64, 2), max(w // 64, 2), generator=g)
        bg = F.interpolate(low, size=(h, w), mode="bilinear",
                           align_corners=False)
        bg = 60 + 140 * bg + torch.linspace(-30, 30, h)[None, None, :, None]
        img = bg.permute(0, 2, 3, 1).contiguous()
        colours = torch.rand(9, 3, generator=g) * 255
        for i in range(b):
            for j in range(int(mask[i].sum())):
                x0, y0, x1, y1 = (int(v) for v in boxes[i, j])
                img[i, y0:min(y1, h), x0:min(x1, w)] = colours[int(labels[i, j])]
        img = img + 8.0 * torch.randn(img.shape, generator=g)
        return img.clamp(0, 255).to(torch.uint8)

    def train_batches(b, h, w, seed, device, n_boxes=8, k=5, scenes=False):
        """Seeded uint8 source and target batches, the source with k GT
        boxes an image. Uniform noise, or with ``scenes`` the source a
        scene drawn at its boxes and the target a fogged scene (blended 45%
        towards grey 200, as Foggy Cityscapes thickens Cityscapes)."""
        g = torch.Generator().manual_seed(seed)
        if scenes:
            boxes, labels, mask = gt_boxes(g, b, h, w, n_boxes, k)
            im_s = scene(g, boxes, labels, mask, h, w)
            im_t = scene(g, *gt_boxes(g, b, h, w, n_boxes, k), h, w)
            im_t = (im_t.float() * 0.55 + 200 * 0.45).to(torch.uint8)
        else:
            im_s, im_t = torch.randint(0, 256, (2, b, h, w, 3), generator=g,
                                       dtype=torch.uint8)
            boxes, labels, mask = gt_boxes(g, b, h, w, n_boxes, k)
        bs = dict(images=im_s, sizes=torch.tensor([[h, w]] * b,
                                                  dtype=torch.int32),
                  boxes=boxes, labels=labels, mask=mask)
        on = lambda d: {k_: v.to(device) for k_, v in d.items()}  # noqa: E731
        return on(bs), on(dict(images=im_t))

    def delta_bound(got, want, rel_tensor, rel_all):
        """max over tensors of |got - want| / (rel_tensor * max|want| of
        the tensor + rel_all * max|want| of all): <= 1 passes."""
        scale = max(float(d.abs().max()) for d in want.values())
        return max((float((got[k] - want[k]).abs().max())
                    / (rel_tensor * float(want[k].abs().max())
                       + rel_all * scale), k) for k in want)

    def p_train_small():
        """Card against CPU, one DA step per variant, 128x192, batch 2 + 2,
        float32, TF32 off, every BASE_LR 0.1. Discrete choices must be
        equal: the source and target node masks and labels, and DBSCAN's
        keep masks. The metrics within rtol 1e-4. A parameter update
        within 2e-3 of its tensor's largest plus 2e-3 of the whole update's
        largest: the card's convolutions sum in other orders than the
        CPU's, and at this size a ReLU input within rounding of 0 falls on
        either side somewhere in VGG's stage 3 (~8e5 elements), which moves
        the update of the conv above it by up to ~6e-4 of its scale on an
        H100 (the CPU tests hold the port against scan_tpu at 1e-4 + 1e-4
        on a smaller input)."""
        cfg = c2f("float32")
        cfg.TPU.MAX_NODES, cfg.TPU.MAX_TARGET_POINTS = 64, 64
        cfg.TPU.MAX_BOXES = 8
        for key in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
            cfg.SOLVER[key].BASE_LR = 0.1
        record = []
        real = (cg_mod.sample_source_nodes, cg_mod.sample_target_nodes,
                sampling.density_cluster_drop_first)

        def rec(tag, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                outs = out if isinstance(out, tuple) else (out,)
                record.append((tag, [o.detach().cpu() for o in outs[1:3]]
                               if tag != "keep" else [outs[0].cpu()]))
                return out
            return wrapped

        cg_mod.sample_source_nodes = rec("source", real[0])
        cg_mod.sample_target_nodes = rec("target", real[1])
        sampling.density_cluster_drop_first = rec("keep", real[2])
        try:
            for ft in (False, True):
                runs = {}
                for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
                    det, _, _, step = train_setup(cfg, device)
                    bs, bt = train_batches(2, 128, 192, s.seed + 5, device)
                    before = {k: p.detach().clone()
                              for k, p in det.named_parameters()}
                    record.clear()
                    _, metrics = step(det.proto_state(), bs, bt,
                                      forward_target=ft)
                    runs[name] = (
                        {k: float(v) for k, v in metrics.items()},
                        {k: (p.detach() - before[k]).cpu()
                         for k, p in det.named_parameters()},
                        list(record))
                    del det, step
                (mc, dc, rc), (mw, dw, rw) = runs["card"], runs["cpu"]
                assert [t for t, _ in rc] == [t for t, _ in rw]
                for (tag, a), (_, b) in zip(rc, rw):
                    for x, y in zip(a, b):
                        assert torch.equal(x, y), f"{tag} differs (ft={ft})"
                n_keep = sum(int(a[0].sum()) for t, a in rw if t == "keep")
                worst_m = max(abs(mc[k] - mw[k]) / max(abs(mw[k]), 1e-12)
                              for k in mw)
                ratio, where = delta_bound(dc, dw, 2e-3, 2e-3)
                s.say(f"train_small_ft{int(ft)}",
                      f"metrics={len(mw)} worst_rel={worst_m} "
                      f"loss_total card/cpu={mc['loss_total']}/"
                      f"{mw['loss_total']} transfer card/cpu="
                      f"{mc.get('transfer_loss_gt')}/{mw.get('transfer_loss_gt')}"
                      f" nodes equal in "
                      f"{sum(t != 'keep' for t, _ in rw)} samplings, "
                      f"dbscan keep equal in {sum(t == 'keep' for t, _ in rw)}"
                      f" calls ({n_keep} kept); update bound ratio={ratio} "
                      f"at {where}")
                assert set(mc) == set(mw) and worst_m <= 1e-4, worst_m
                assert ratio <= 1.0, (ratio, where)
                assert ("transfer_loss_gt" in mw) == ft
        finally:
            (cg_mod.sample_source_nodes, cg_mod.sample_target_nodes,
             sampling.density_cluster_drop_first) = real

    def p_train_main():
        for key in ("dets", "int8_dets", "int8_det"):  # free the card
            st.pop(key, None)
        torch.cuda.empty_cache()
        cfg = c2f("float32")
        det, opt, sched, step = train_setup(cfg, dev)
        batches = [train_batches(4, H, W, s.seed + 10 + i, dev, n_boxes=100,
                                 k=16, scenes=True) for i in range(2)]
        frozen = {k for k, p in det.named_parameters() if not p.requires_grad}
        # the seeded state, which p_train_time returns to before each step
        init = {k: v.detach().clone() for k, v in det.state_dict().items()
                if k not in frozen}
        start = {k: init[k] if k in init else p.detach().clone()
                 for k, p in det.named_parameters()}
        proto0 = det.prototype.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        proto = det.proto_state()
        # True first: the seeded act maps are confident, so in the first
        # step target DBSCAN keeps candidates and GST has nodes. A step from
        # a random init teaches the act head background nearly everywhere
        # (after it target DBSCAN keeps few or no candidates), which a
        # real run leaves behind long before the AP50 gate opens the target
        # branch; p_train_time times every True step from the seeded state
        variants = (True,) * 3 + (False,) * 3
        real_target = cg_mod.sample_target_nodes
        real_dbscan = sampling.density_cluster_drop_first
        target_nodes, dbscan = [], []

        def counting(*a, **k):
            out = real_target(*a, **k)
            target_nodes.append(out[2].sum())
            return out

        def counting_dbscan(points, valid, *a, **k):
            keep = real_dbscan(points, valid, *a, **k)
            dbscan.append(torch.stack([valid.sum(), keep.sum()]))
            return keep

        cg_mod.sample_target_nodes = counting
        sampling.density_cluster_drop_first = counting_dbscan
        try:
            for i, ft in enumerate(variants):
                gen = torch.Generator(device=dev).manual_seed(1000 + i)
                proto, metrics = step(proto, *batches[i % 2],
                                      forward_target=ft, generator=gen)
                host = {k: float(v) for k, v in metrics.items()}
                s.say(f"train_step{i}_ft{int(ft)}",
                      " ".join(f"{k}={v:.6g}" for k, v in host.items()))
                bad = {k: v for k, v in host.items() if not math.isfinite(v)}
                assert not bad, bad
                assert ("transfer_loss_gt" in host) == ft
                if i == 0:  # GST ran on a non-empty node set
                    assert host["transfer_loss_gt"] > 0, host
        finally:
            cg_mod.sample_target_nodes = real_target
            sampling.density_cluster_drop_first = real_dbscan
        nodes = [int(n) for n in target_nodes]
        s.say("train_target_nodes_valid", nodes)
        s.say("train_dbscan_candidates_kept",
              [tuple(int(v) for v in c) for c in dbscan])
        assert len(nodes) == variants.count(True) and nodes[0] > 0, nodes
        torch.cuda.synchronize()
        launched = counts()
        s.say("train_main_launches", launched)
        assert launched["vgg_stem_fused"] == 2 * len(variants), launched
        assert not any(v for k, v in launched.items() if k != "vgg_stem_fused")
        per_step = launched["vgg_stem_fused"] // len(variants)
        for ft in (False, True):  # no host round trip inside a step
            gen = torch.Generator(device=dev).manual_seed(2000 + ft)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                proto, metrics = step(proto, *batches[0], forward_target=ft,
                                      generator=gen)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            s.say(f"train_sync_free_ft{int(ft)}",
                  f"loss_total={float(metrics['loss_total'])}")
        moved = {k for k, p in det.named_parameters()
                 if not torch.equal(p.detach(), start[k])}
        trainable = set(start) - frozen
        s.say("train_params", f"trainable={len(trainable)} moved="
              f"{len(moved & trainable)} frozen={len(frozen)} "
              f"frozen_moved={len(moved & frozen)} counter={int(proto.counter)} "
              f"proto_max_change={float((proto.prototype - proto0).abs().max())}")
        assert moved == trainable, sorted(trainable - moved)[:5]
        assert frozen == {f"backbone.body.conv{i}.{t}" for i in range(4)
                          for t in ("weight", "bias")}
        assert int(proto.counter) == cfg.MODEL.MIDDLE_HEAD.PROTO_ITER
        assert float((proto.prototype - proto0).abs().max()) > 0
        s.say("train_peak_mem_gib", torch.cuda.max_memory_allocated() / 2 ** 30)
        st["train"] = (cfg, det, opt, sched, step, batches)
        st["train_init"] = init
        st["train_k2_per_step"] = per_step

    class ValSet:
        """A COCO-style validation set of seeded GT boxes, with the
        ``COCODataset`` API the evaluator reads."""

        def __init__(self, n, seed):
            g = torch.Generator().manual_seed(seed)
            self.images = torch.randint(0, 256, (n, H, W, 3), generator=g,
                                        dtype=torch.uint8).numpy()
            self.id_to_img_map = {i: 100 + i for i in range(n)}
            self.contiguous_category_id_to_json_id = {c: c for c in range(1, 9)}
            anns = {}
            for i in range(n):
                xy = torch.rand(6, 2, generator=g) * torch.tensor([W * 0.7, H * 0.7])
                wh = torch.rand(6, 2, generator=g) * 200 + 20
                cat = torch.randint(1, 9, (6,), generator=g)
                anns[100 + i] = [dict(bbox=[*map(float, p), *map(float, q)],
                                      category_id=int(c), iscrowd=0,
                                      area=float(q[0] * q[1]))
                                 for p, q, c in zip(xy, wh, cat)]
            self.coco = type("Coco", (), dict(
                img_to_anns=anns, get_cat_ids=lambda _self: list(range(1, 9))))()

        def __len__(self):
            return len(self.images)

    class ValLoader:
        def __init__(self, dataset, batch):
            self.dataset, self.batch = dataset, batch

        def __iter__(self):
            for i in range(0, len(self.dataset), self.batch):
                n = min(self.batch, len(self.dataset) - i)
                yield dict(images=self.dataset.images[i:i + n],
                           sizes=np.asarray([[H, W]] * n, np.int32),
                           scales=np.ones((n, 2), np.float32),
                           indices=np.arange(i, i + n))

    def p_train_loop():
        cfg, det, _, _, step, batches = st["train"]
        cfg = cfg.clone()
        cfg.SOLVER.MAX_ITER, cfg.SOLVER.VAL_ITER = 4, 2
        loader_val = ValLoader(ValSet(4, s.seed + 20), 2)
        real = inference_mod.inference
        vals = []

        def counted(detector, data_loader):
            torch.cuda.synchronize()
            c0 = counts()
            out = real(detector, data_loader)
            torch.cuda.synchronize()
            c1 = counts()
            vals.append(({k: c1[k] - c0[k] for k in c1}, out[0]))
            return out

        inference_mod.inference = counted
        zero_counts()
        try:
            proto, best = trainer.do_train_da(
                cfg, det, step, det.proto_state(),
                itertools.cycle([batches[0][0], batches[1][0]]),
                itertools.cycle([batches[0][1], batches[1][1]]),
                loader_val=loader_val)
        finally:
            inference_mod.inference = real
        torch.cuda.synchronize()
        total = counts()
        for i, (c, res) in enumerate(vals):
            s.say(f"train_loop_validation{i}",
                  f"AP50={res['AP50']} AP={res['AP']} launches={c}")
            assert c["nms_sorted"] > 0 and c["vgg_stem_fused"] > 0, c
        in_val = {k: sum(c[k] for c, _ in vals) for k in total}
        train_k2 = total["vgg_stem_fused"] - in_val["vgg_stem_fused"]
        s.say("train_loop_launches", f"total={total} in_validation={in_val} "
              f"K2_in_training={train_k2} best_metric={best}")
        assert len(vals) == 2 and train_k2 == 2 * cfg.SOLVER.MAX_ITER
        st["val_launches"] = vals[0][0]
        for k in st.get("kernels") or []:
            if k["name"] in ("nms_sorted", "vgg_stem_fused"):
                k["validation_launches_per_pass"] = vals[0][0][k["name"]]
            if k["name"] == "vgg_stem_fused":
                k["train_launches_per_step"] = st["train_k2_per_step"]

    def p_train_time():
        """Every timed step starts from the seeded state of
        ``p_train_main`` (restored outside the timed span, the momentum
        kept), where GST has target nodes: the True variant times the
        branch it is named for."""
        cfg, det, opt, sched, step, batches = st["train"]
        init = st["train_init"]
        bs, bt = batches[0]
        targets = {k: bs[k] for k in ("boxes", "labels", "mask")}
        n_img = bs["images"].shape[0] + bt["images"].shape[0]

        def restore():
            with torch.no_grad():
                sd = det.state_dict()
                for k, v in init.items():
                    sd[k].copy_(v)
            torch.cuda.synchronize()

        def timed(fn, n, warmup=1):
            """Mean ms of fn() over n calls after warmup, each from the
            seeded state; fn's results are returned."""
            times, outs = [], []
            for i in range(warmup + n):
                restore()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = fn()
                e1.record()
                torch.cuda.synchronize()
                if i >= warmup:
                    times.append(e0.elapsed_time(e1))
                    outs.append(out)
            return sum(times) / len(times), outs

        for ft in (False, True):
            gen = torch.Generator(device=dev).manual_seed(3000 + ft)
            ms, outs = timed(lambda: step(det.proto_state(), bs, bt,
                                          forward_target=ft,
                                          generator=gen)[1], 5)
            if ft:
                transfer = [float(m["transfer_loss_gt"]) for m in outs]
                s.say("train_step_ft1_transfer_loss_gt", transfer)
                assert min(transfer) > 0, transfer
            s.say(f"train_step_ft{int(ft)}_ms", ms)
            s.say(f"train_step_ft{int(ft)}_img_s", n_img * 1e3 / ms)
            parts = {}
            for rep in range(4):  # the step cut at its parts; rep 0 warms up
                restore()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
                ev[0].record()
                ls, fs, acs, sms, new_proto = det.forward_train(
                    det.proto_state(), bs["images"], targets, "source",
                    generator=gen)
                ev[1].record()
                d_s = det.discriminator_losses(fs, acs, sms, 1.0, "source")
                ev[2].record()
                lt, ftg, act, smt, _ = det.forward_train(
                    new_proto, bt["images"], None, "target",
                    forward_target=ft, generator=gen)
                ev[3].record()
                d_t = det.discriminator_losses(ftg, act, smt, 0.0, "target")
                ev[4].record()
                total = (sum(ls.values()) + sum(d_s.values())
                         + sum(d_t.values()) + sum(lt.values()))
                opt.zero_grad(set_to_none=True)
                total.backward()
                ev[5].record()
                opt.step()
                sched.step()
                ev[6].record()
                torch.cuda.synchronize()
                names = ("g_source", "d_source", "g_target", "d_target",
                         "backward", "optimizer")
                assert not ft or float(lt["transfer_loss"]) > 0
                if rep:
                    for j, name in enumerate(names):
                        parts.setdefault(name, []).append(
                            ev[j].elapsed_time(ev[j + 1]))
                del ls, fs, acs, sms, lt, ftg, act, smt, total
            s.say(f"train_split_ft{int(ft)}_ms",
                  {k: sum(v) / len(v) for k, v in parts.items()})
        captured = []
        real = cg_mod.sample_target_nodes

        def capture(*a, **k):
            captured.append((a, k))
            return real(*a, **k)

        restore()
        cg_mod.sample_target_nodes = capture
        try:
            with torch.no_grad():
                det.forward_train(det.proto_state(), bt["images"], None,
                                  "target", forward_target=True)
        finally:
            cg_mod.sample_target_nodes = real
        a, k = captured[0]
        with torch.no_grad():
            n_nodes = int(real(*a, **k)[2].sum())
            s.say("sample_target_nodes_ms",
                  cuda_time(lambda: real(*a, **k), 10, 2))
        s.say("sample_target_nodes_valid", n_nodes)
        assert n_nodes > 0
        s.say("train_timing_peak_mem_gib",
              torch.cuda.max_memory_allocated() / 2 ** 30)

    s.phase("build", p_build)
    s.phase("k1_nms_vs_plain", p_nms)
    s.phase("k2_stem_vs_plain", p_stem)
    s.phase("small_input_card_vs_cpu", p_small)
    s.phase("main_path_full_width", p_main)
    if "main_path_full_width" in s.failed or "k2_stem_vs_plain" in s.failed:
        s.failed.append("timing (skipped)")
    else:
        s.phase("timing", p_time)
    s.phase("int8_calibrate", p_int8_calibrate)
    if "int8_calibrate" in s.failed:
        s.failed.append("int8 phases (skipped)")
    else:
        s.phase("k3_k6_vs_plain", p_int8_kernels)
        s.phase("int8_small_input_card_vs_cpu", p_int8_small)
        s.phase("int8_main_path_full_width", p_int8_main)
        if s.failed:
            s.failed.append("int8 timing (skipped)")
        else:
            s.phase("int8_timing", p_time_int8)
    s.phase("train_small_card_vs_cpu", p_train_small)
    s.phase("train_main_path_full_width", p_train_main)
    if "train_main_path_full_width" in s.failed:
        s.failed.append("training loop and timing (skipped)")
    else:
        s.phase("train_loop_with_validation", p_train_loop)
        s.phase("train_timing", p_train_time)

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
