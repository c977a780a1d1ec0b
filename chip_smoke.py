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
     band); then the counts per kernel function of ``stem`` and
     ``stem_int8``; fail unless ``stem`` has HMMA (K2's bf16 conv1_2),
     every ``stem_f32_kernel`` HMMA on TF32 operands (K2's float32 3xTF32),
     every ``stem_int8_kernel`` IMMA and no IDP4A (K5's convs on the
     tensor cores, no ``__dp4a`` left), and ``conv0`` IMMA (K3's conv);
  2. TF32 off for cuDNN and matmul;
  3. K1 (NMS) against its plain version: sorted synthetic sets, K = 512 and
     1000, B = 4, without labels and with int64 and int32 labels, invalid
     rows mixed in; keep masks must be equal;
  4. K2 (fused VGG stem) against its plain version on a normalised 800x1344
     batch (B = 1, the single-image path's, 2 and 4) with the model's own
     conv1_1/conv1_2 weights: float32 within
     atol/rtol 1e-4; bfloat16 within rtol 2**-7 and atol 2**-8 of the
     largest output (see tests/test_torch_kernels.py for why);
  5. small-input agreement: the port on the card against the port's plain
     path on the CPU (which tests/test_torch_*.py hold against scan_tpu),
     128x192, float32, all three TEST.MODEs;
  6. the fp main path: ``build_detector`` on the C2F config (full VGG16,
     256-channel FPN and heads) at 800x1344, batch 4, seeded weights and a
     seeded uint8 batch, TEST.MODE common/precision/light in float32 and
     bfloat16. The launch counters are zeroed before and read after (the
     towers' fused GroupNorm, ``group_norm_relu``, counted in each forward
     and launched in every one; the VGG body's ``bias_relu`` 11 times in
     each, once a conv of stages 2-5); the candidate sets entering NMS in
     precision mode are held against the plain NMS;
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
     kernels (and K2, the fused GroupNorm and ``bias_relu``: the int8
     towers and body keep their modules) not;
 11. timing with CUDA events: each kernel and its plain version at the
     checks' shapes; K1 and K3 also as their raw launches captured in a
     CUDA graph (device time without the wrapper's host work), K1 beside
     its launch floor (empty kernels on the same two grids, timed the same
     way), both beside PERF.md's times of their earlier designs; cuDNN's
     conv/relu/conv/relu/maxpool as the fp stem's library call (K2
     float32's ratio to it printed), the default int8 chain
     (im2col + ``torch._int_mm``) as the yardstick of K3 and K5, K2's
     TFLOP/s and K5's TOP/s, K2 float32 beside both its bounds (the CUDA
     cores' 67 TFLOP/s and the TF32 tensor cores' 495 for its three
     products a product) and PERF.md's time of its CUDA-core design, K2
     bf16 and float32 and K5 without their conv1_2 (the ``*_probe`` entry
     points) to split their time, K5 beside its earlier time, the fused
     GroupNorm on the tensors of a batch-8 precision forward at each FPN
     level in bf16 and float32 (``time_group_norm``: against its plain
     version, then timed beside the modules it replaced and its bound), the
     VGG body's ``bias_relu`` on the tensors of a batch-8 precision forward
     at each stage's shape and mode in bf16 and float32
     (``time_bias_relu``: equal to the module path, timed beside it, its
     plain version, its bound and cuDNN's one-call conv + bias + ReLU, with
     the wrapper's host time a call), fp
     and int8 forward img/s at bfloat16,
     precision, batch 8 (int8 for each stem variant), and both forwards cut
     at their layers; the fp forward of a detector built for training
     (float32 masters cast at use) in turns with the bf16-parameter one;
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
     (the counters zeroed before and read after: K2 twice a step,
     ``bias_relu`` twice a VGG forward (the frozen stage 2), no other
     kernel, the fused GroupNorm neither), then one step of each variant under
     ``torch.cuda.set_sync_debug_mode("error")``; every loss finite, the
     trained parameters moved and the frozen ones not, the prototype
     counter and values advanced; peak device memory;
 14. ``train_loop_with_validation``: ``do_train_da`` for 4 iterations with
     SOLVER.VAL_ITER 2 and a seeded validation set of 4 frames at 800x1344,
     written to disk as PNGs with a COCO json and read by the port's
     ``COCODataset`` and eval loader (COCO AP through
     ``engine/inference.py::inference``): K1, K2 and the fused GroupNorm
     launch in each validation, K2 twice a training step and the GroupNorm
     never; AP50 printed;
 15. ``train_timing``: ms per DA step and img/s (source + target) in each
     variant, CUDA events after warm-up, each step from phase 13's seeded
     state (so the True variant's GST has nodes, checked); the step split
     into G source, D source, G target, D target, backward and optimizer;
     ``sample_target_nodes`` alone at full width;
 16. ``weights_reference_pth``: reference-layout files at C2F's full width
     under a temporary directory (a seeded caffe VGG16 ImageNet file, bare
     and under ``state_dict`` with ``module.`` prefixes, and a full SCAN
     checkpoint in the layout of
     ``tests/test_checkpoint_roundtrip.py::_make_reference_ckpt``), the
     ImageNet file also as ``vgg16_caffe-292e1171.pth`` in a cache directory
     set as ``SCAN_TPU_CACHE_DIR`` for the rest of the run: the C2F config's
     own ``MODEL.WEIGHT`` URL resolves to the cached file and
     ``Checkpointer.load`` puts the file's tensors in the VGG body (and from
     the wrapped file); the full checkpoint's every converted tensor equals
     the file's at its port name, ``load_dis=False`` keeps the
     discriminators and ``True`` loads them, the prototype is the file's
     and its counter kept; the loaded detector's forward runs on the card;
 17. ``train_bf16_small_card_vs_cpu``: the bf16 DA step (float32 masters)
     of the full-width C2F model at 128x192, batch 2 + 2, each
     ``forward_target`` variant, on the card and on the CPU from the same
     seeded weights, with a float32 CPU step beside: each metric and each
     parameter group's update (relative L2) within the bound stated in
     ``p_train_bf16_small`` (twice the CPU's own bf16-float32 distance);
     target node masks counted;
 18. ``train_bf16_main_path_full_width``: phase 13 in bf16 (``train_main``):
     K2 twice a step in bf16 and no other kernel, every parameter and
     momentum buffer float32, the trained parameters moved and the frozen
     ones not, one step of each variant under
     ``torch.cuda.set_sync_debug_mode("error")``, every loss finite, peak
     memory;
 19. ``train_bf16_timing``: phase 15 in bf16 (``train_time``) at 800x1344,
     and whole steps at ``bench.py``'s 672x1344;
 20. ``train_ca_out_full_width``: ``configs/epm/da_ga_ca_cityscapes_VGG_16_FPN_4x.yaml``
     (GA + CA, no condgraph) at full width with IMS_PER_BATCH cut from 16
     to 4 + 4 (printed): a DA step in each CENTER_AWARE_TYPE and, with
     USE_DIS_OUT, in each OUTMAP_OP, float32 and bf16, at 800x1344 (losses
     finite, the families present, K2 twice a step) and at 128x192 on the
     card and the CPU from the same weights (float32 as phase 12, bf16 as
     phase 17); one float32 and one bf16 step timed;
 21. ``disk_tree``: a Cityscapes-shaped C2F tree under a temporary directory
     at the catalog's paths (``SCAN_TPU_DATA_DIR``): 8 source and 8 fogged
     target training frames and 32 fogged validation frames, phase 13's
     seeded scenes as 1024x2048 PNGs (written with ``zlib``, no Pillow)
     with COCO jsons; the test resize (666x1332) and the 672x1344 buckets
     asserted;
 22. ``cli_train_da_from_disk``: ``tools/train_net_da.py``'s ``main`` on the
     C2F config at full width, float32, batch 4 + 4, VAL_ITER 2, its
     ``MODEL.WEIGHT`` URL loaded from phase 16's cache,
     CHECKPOINT_PERIOD 2: MAX_ITER 4, then the same command with MAX_ITER
     6, which must restore iteration 4 from ``last_checkpoint`` with
     parameters, momentum and scheduler state equal to the file's, then a
     straight 6-iteration run; counters zeroed before each run (K2 twice a
     step, K1 and K2 in each validation); the resumed run's source and
     target index streams equal the straight run's, its last two
     ``loss_total`` within 1e-3 relative of the straight run's; the
     iteration time and the data wait per step (host blocked on the loader);
 23. ``cli_test_net_from_disk``: ``tools/test_net.py``'s ``main`` on the
     resumed run's ``model_final``, bf16, precision, batch 8, over the 32
     frames, fp (K1 and K2 launch) and int8 with PALLAS_STEM_INT8 and one
     calibration batch (K5 and K1, not K2); its last stdout line is JSON
     with AP and AP50; the native library is the one keyed for this host and
     resized every frame, and decoded them where it has the codecs (else
     Pillow did); the eval through the loader end to end in img/s, first
     pass (decode and resize) and second (the eval cache), the loader's
     wait per batch, the pageable host->card copy of a batch, the forward
     alone at 672x1344, one PNG decode and one resize;
 24. ``cli_train_net_from_disk``: ``tools/train_net.py``'s ``main`` (source
     only) on the C2F config from phase 16's ImageNet file, bf16, batch 4,
     MAX_ITER 4, CHECKPOINT_PERIOD 2: K2 once a step and no other kernel,
     the VGG body at step 0 the file's, every loss finite; then
     ``tools/remove_solver_states.py`` on its directory (the slim file holds
     the model and the iteration only) and ``test_net`` on the slim file,
     whose last stdout line is JSON with AP and AP50.

The R-101 and ATSS configs (every ResNet body loaded, as its config loads
it, from a seeded full-width Detectron R-101 pickle that ``Checkpointer``
reads; the head's cls_logits bias set to -2 on the eval paths, so scores
spread above INFERENCE_TH and NMS has work), after phase 20:

 25. ``resnet_small_card_vs_cpu``: ``configs/epm/da_ga_ca_cityscapes_R_101_FPN_4x.yaml``
     at full width, 128x192, float32, TF32 off, on the card and the CPU
     from the same weights: the backbone's features within 1e-4 of each
     level's largest value, detections matched as in phase 5, one GA + CA
     DA step as phase 12 (metrics rtol 1e-4, updates within 2e-3 + 2e-3);
 26. ``r101_main_path_full_width``: that config's eval forward at
     800x1344, batch 4, float32 and bf16, counters zeroed before and read
     after (K1 once a forward, no K2, no int8 kernel), NMS's candidate sets
     against the plain NMS; the bf16 forward at batch 8 timed, with its
     peak memory, and cut at body, backbone, head and postprocess;
 27. ``r101_train_full_width``: its GA + CA DA step, batch 4 + 4 at
     800x1344, float32 and bf16 (float32 masters): every loss finite, the
     frozen stem, stage 1 and every FrozenBatchNorm buffer unchanged, every
     trainable parameter moved, no kernel launched; 2 steps timed and the
     peak memory; in bf16 also the step with the body's convs rounding to
     bf16 instead of ``float_output``, in turns;
 28. ``atss_small_card_vs_cpu``: phase 25 for
     ``configs/epm/da_ga_sim10k_VGG_16_FPN_4x_atss.yaml`` with the
     center-aware discriminators turned on as well;
 29-30. ``atss_main_path_full_width``: phase 26 for the ATSS config (K1 and
     K2 once a forward), then phase 27 for it as written (GA) and with CA
     (K2 twice a step, nothing else);
 31. ``cli_r101_from_pkl`` (after phase 24): ``train_net_da`` on the GA + CA
     R-101 config from the disk tree (its datasets are the tree's C2F sets),
     ``MODEL.WEIGHT`` the seeded pickle written into the tree, bf16, batch
     4 + 4, MAX_ITER 2, VAL_ITER 2: K1 in validation and no K2,
     ``model_final``'s stem and stage 1 the pickle's; ``catalog://`` of the
     config family resolves to the pickle in the weight cache; then
     ``test_net`` on the ATSS config from phase 16's ImageNet VGG16 over
     the tree's 32 fogged frames (``DATASETS.TEST`` cut to them: the
     config's car-only set is not in the tree), K1 and K2 4 times each, its
     last stdout line JSON.

The two-stage detector (``modeling/generalized_rcnn.py::FasterRCNN``;
maskrcnn-benchmark's e2e_mask_rcnn_R_50_FPN_1x and
e2e_keypoint_rcnn_R_50_FPN_1x set in code, the R-50 body from a seeded
Detectron blob set, cls_score's bias at 3 for classes 1-4 so ML-NMS has
candidates, SGD at 0.0025), after phase 30:

 32. ``two_stage_small_card_vs_cpu``: both configs at full width, 128x192,
     64 proposals and 20 detections an image, float32, TF32 off, card
     against CPU from the same weights: K1's keep masks against the plain
     NMS, the card's and the CPU's keep masks and detections compared
     (flips counted), every loss within rtol 1e-4, one SGD update within
     2e-3 + 2e-3;
 33. ``mask_rcnn_main_path_full_width``: batch 2 at 800x1344, eval in
     float32 and bf16 (K1 6 times a forward, every NMS set against the
     plain version, masks (2, 100, 28, 28)), the bf16 eval timed and cut at
     its parts (ROIAlign's share of the RoI stage), 2 SGD steps in float32
     and bf16 over masters (K1 5 times a step, every trainable parameter
     moved, the frozen ones not), each timed from the seeded state; then at
     scan_tpu's PRE_NMS_TOP_N 6000 / 12,000: K1 at K = 6000 and 12,000 on
     real proposals, each set against the plain version;
 34. ``keypoint_rcnn_full_width``: the bf16 eval (keypoints (2, 100, 17,
     3)), timed and cut, and one SGD step in float32 and bf16, timed.

The rest of the detector surface, after phase 34 (C2F with another body,
seeded weights; eval paths with the head's cls bias at -2):

 35. ``mobile_small_card_vs_cpu``: C2F on MobileNetV2 and on each FBNet arch
     (scale 1, divisor 1) at 128x192, card against CPU from the same
     weights (``body_small``): float32 (TF32 off) features and detections,
     bf16 eval detectors within twice the CPU's bf16-float32 distance;
     MobileNetV2 also one float32 DA step;
 36. ``mnv2_main_path_full_width``: ``eval_main`` (float32 and bf16 at batch
     4 through ``compute_predictions``, K1 once a forward, no K2, NMS sets
     against the plain NMS, the bf16 forward at batch 8 timed and cut at
     its parts), the DA step in float32 and bf16 over masters, both
     ``forward_target`` variants (``body_train``: no kernel, timed, peak
     memory), and the int8 eval with the body fp (``body_int8``: K1 only);
 37. ``fbnet_full_width``: phase 36's eval and DA step for ``default``, one
     bf16 eval forward at batch 4 for each other arch (K1 once), timed;
 38. ``vgg_bn_full_width``: C2F with ``MODEL.BACKBONE.VGG_W_BN``: card
     against CPU, eval, DA steps (K2 never), and K2's count on one plain
     VGG16 forward beside one VGG16-BN forward (1 and 0);
 39. ``deform_conv_card_vs_cpu``: ``deform_conv2d`` at C2F's P3 size
     (4, 100, 168, 256) -> 256, 3x3, offsets within +-4 px, DCNv1 and v2,
     card against CPU in float32 (rtol 1e-4), timed beside cuDNN's plain
     3x3 conv;
 40. ``single_image_path``: a seeded 1024x2048 PNG, ``python -m
     scan_tpu_torch.cli detect --output`` as a process and as a module in
     this process (K2 and K1 once, K1's B = 1 candidate set against the
     plain NMS), the two runs' detections matched as sets (label, box
     within 0.5 px, score within 1e-4), every box inside the frame, the
     ``Predictor`` per frame (decode to detections, preprocess, the
     forward alone; float32 and bf16), ``scan_tpu_torch/tools/demo.py``'s
     drawn PNG.

Profiling, data parallelism and the harnesses, after phase 40:

 41. ``profile_inference_full_width``: ``tools/profile_inference.py`` on
     C2F, bf16, precision, batch 8 at 800x1344 with ``--trace``: its rows
     against the ``timing`` phase's forward, ``trace_summary`` of the trace
     (K2 and K1 in it, the window and the device's busy time);
 42. ``train_bf16_trace``: one C2F bf16 DA step, 4 + 4 at 800x1344, in
     each ``forward_target`` variant under ``utils.profiler.torch_trace``:
     the device's busy time against the traced window and the untraced
     step, the kernel count, the top kernels and host ops;
 43. ``dp_nccl_world1_full_width``: the DP DA step under NCCL at world 1
     (a ``file://`` store) against the plain step from the same state,
     float32, both variants; the all-reduce alone on the flat vector;
 44. ``tools_on_card``: ``stability_run`` (300 iterations at 256x512,
     killed at 150), ``nan_bisect`` from its checkpoint,
     ``train_net_da --use-tensorboard`` and ``loader_bench``;
 45. ``da_efficacy_smoke``: both arms of ``tools/da_efficacy.py`` at 60
     iterations.

Phase 3 also holds K1 to its plain version at K = 2049, 4096, 6000 and
12,000 and times it at K = 1000-12,000 (B = 2, the RPN's IoU 0.7).

Every number is printed with the card's name and power limit; everything is
also written to ``chiprun_out/chip_smoke.json``. The line before the last is
the per-kernel JSON; the last line is the device JSON.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import io
import itertools
import json
import math
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
C2F = HERE / "configs" / "scan" / "scan_vgg16_cityscapace_to_foggy.yaml"
H, W = 800, 1344
CITY_H, CITY_W = 1024, 2048  # Cityscapes' frame size
CATEGORIES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
              "bicycle")
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_S = 67e12  # CUDA cores
PEAK_BF16_S = 989e12  # tensor cores, dense
PEAK_INT8_S = 1979e12  # tensor cores, dense
PEAK_TF32_S = 495e12  # tensor cores, dense
PAD1 = ((1, 1), (1, 1))
# the VGG body's convs after K2 (stages 2-5), each followed by ``bias_relu``
# in an fp eval forward; 2 of them (frozen stage 2) in a training forward
VGG_CONVS, VGG_FROZEN_CONVS = 11, 2
# PERF.md's times of the designs that the kernels replaced (NVIDIA H100
# 80GB HBM3, 700.00 W): K1's wrapper at (4, 512), K3, K2 float32 (CUDA
# cores) and K5 (``__dp4a`` conv1_1) and its probe at (4, 800, 1344)
EARLIER_MS = {"nms_sorted": 0.0794, "conv0_s8": 0.740,
              "vgg_stem_fused_float32": 11.87, "fused_stem_int8": 1.478,
              "fused_stem_int8_without_conv1_2": 0.989}
SASS_OPS = ("HMMA", "IMMA", "I2F", "F2I", "FRND", "F2F", "MUFU")
# per kernel function: the mnemonic patterns counted
SASS_FN_OPS = {"HMMA": r"\bHMMA\b", "HMMA_TF32": r"\bHMMA\.\S*TF32",
               "IMMA": r"\bIMMA\b", "IDP4A": r"\bIDP\.?4A"}


def sass_functions(text):
    """``cuobjdump --dump-sass`` text -> {kernel function name: its
    counts of ``SASS_FN_OPS``}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = {op: len(re.findall(pat, body))
                             for op, pat in SASS_FN_OPS.items()}
    return out


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


def write_png(path, rgb):
    """(h, w, 3) uint8 -> an 8-bit RGB PNG, with the standard library's
    zlib only (no Pillow): each row filter 0, one IDAT chunk."""
    import numpy as np

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


def write_coco(ann_file, img_dir, frames, boxes, labels):
    """``frames`` (n, h, w, 3) uint8 as PNGs in ``img_dir`` and their GT
    (integer xyxy boxes, ends exclusive as the scenes fill them; labels
    1..8) as a COCO json at ``ann_file``. Returns the bytes written."""
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.dirname(ann_file), exist_ok=True)
    images, annotations, n_bytes = [], [], 0
    for i, frame in enumerate(frames):
        name = f"frame_{i:04d}.png"
        path = os.path.join(img_dir, name)
        write_png(path, frame)
        n_bytes += os.path.getsize(path)
        h, w = frame.shape[:2]
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for (x0, y0, x1, y1), c in zip(boxes[i], labels[i]):
            x1, y1 = min(x1, w), min(y1, h)
            annotations.append(dict(
                id=len(annotations) + 1, image_id=i + 1, category_id=int(c),
                bbox=[x0, y0, x1 - x0, y1 - y0], area=(x1 - x0) * (y1 - y0),
                iscrowd=0))
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=[
            dict(id=k + 1, name=n) for k, n in enumerate(CATEGORIES)]), f)
    return n_bytes


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
    from scan_tpu_torch.ops.cuda import (bias_relu_kernel, build,
                                         conv0_kernel, group_norm_kernel,
                                         nms_kernel, phase_max_kernel,
                                         stem_int8_kernel, stem_kernel)

    s = Smoke(args.seed)
    dev = torch.device("cuda")
    print(s.card, flush=True)
    st = {}  # state handed from phase to phase
    # data trees and checkpoints; removed when the script ends
    tmp_root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))

    int8_kernels = {
        "conv0_s8": conv0_kernel.conv0_s8,
        "phase_max_requant": phase_max_kernel.phase_max_requant,
        "fused_stem_int8": stem_int8_kernel.fused_stem_int8,
        "pair_phase_max_s8": phase_max_kernel.pair_phase_max_s8,
    }
    counters = {"nms_sorted": nms_kernel.nms_sorted,
                "vgg_stem_fused": stem_kernel.fused_stem,
                "group_norm_relu": group_norm_kernel.group_norm_relu,
                "bias_relu": bias_relu_kernel.bias_relu,
                **int8_kernels}

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
        # per kernel function (each template instance, the probes too)
        fns = {}
        for name, kernel in (("stem", "stem_f32_kernel"),
                             ("stem", "stem_bf16_kernel"),
                             ("stem_int8", "stem_int8_kernel")):
            got = {f: c for f, c in sass_functions(
                build.dump_sass(name)).items() if kernel in f}
            assert got, f"no {kernel} in {name}'s SASS"
            fns.update(got)
            for f, c in got.items():
                if kernel == "stem_f32_kernel":
                    assert c["HMMA_TF32"] > 0, f"K2 float32: no TF32 HMMA in {f}"
                if kernel == "stem_bf16_kernel":
                    assert c["HMMA"] > 0, f"K2 bf16: no HMMA in {f}"
                if kernel == "stem_int8_kernel":
                    assert c["IMMA"] > 0, f"K5: no IMMA in {f}"
                    assert c["IDP4A"] == 0, f"K5: IDP4A in {f}"
        s.say("sass_counts_by_function", fns)
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
        lib = build.load("nms")
        lib.scan_nms_max_k.restype = ctypes.c_int
        assert lib.scan_nms_max_k() == nms_kernel.MAX_K, lib.scan_nms_max_k()
        # K past the earlier design's 2048 too: the RPN's K is 6000 a level
        # at scan_tpu's test default and 12,000 at its train default
        for k in (512, 1000, 2049, 4096, 6000, 12000):
            b = 4 if k <= 1000 else 2
            boxes, valid, labels = sorted_set(b, k, 8, s.seed + k)
            boxes = boxes * max(1.0, (k / 1000) ** 0.5)  # a fair share kept
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
                assert 0 < int(want.sum()) < int(valid.sum()), k
        # K1 at the RPN's K, B = 2: the raw launch in a CUDA graph (device
        # time) and the wrapper, beside the bound (the IoU pairs on the
        # CUDA cores; the bytes are a few hundred KB)
        times = {}
        for k in (1000, 2000, 6000, 12000):
            boxes, valid, labels = sorted_set(2, k, 8, s.seed + k + 1)
            boxes = boxes * max(1.0, (k / 1000) ** 0.5)
            words = (k + 63) // 64
            buf = torch.empty(2 * k * (8 * words + 1), dtype=torch.uint8,
                              device=dev)
            keep = buf[2 * k * 8 * words:].view(torch.bool).view(2, k)
            launch = nms_kernel._lib()

            def raw():
                err = launch(boxes.data_ptr(), valid.data_ptr(), None, 0, 2, k,
                             0.7, 1, buf.data_ptr(), keep.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"nms: CUDA error {err}"
            dev_ms = graph_ms(raw, n=10, reps=5)
            assert torch.equal(keep, nms_kernel.nms_sorted_plain(
                boxes, valid, None, 0.7)), f"K1's timed launch at K={k}"
            wrap_ms = cuda_time(lambda: nms_kernel.nms_sorted(
                boxes, valid, None, 0.7), 20)
            ops = 2 * k * (k - 1) / 2 * 14
            nbytes = boxes.numel() * 4 + 2 * valid.numel()
            bound = max(ops / PEAK_FP32_S, nbytes / PEAK_BYTES_S) * 1e3
            times[k] = dict(ms=dev_ms, wrapper_ms=wrap_ms, bound_ms=bound)
            s.say(f"time_k1_K{k}", f"graph_ms={dev_ms} wrapper_ms={wrap_ms} "
                  f"bound_ms={bound} (B=2, no labels, IoU 0.7 as the RPN)")
        st["k1_by_k"] = times

    # ---- 4 ------------------------------------------------------------
    def p_stem():
        det = build_detector(c2f(), device=dev, seed=s.seed)
        im, _ = images(4, H, W, s.seed)
        x = det._prep_images(im)
        st["stem_x"] = x
        c0, c1 = det.backbone.body.conv0, det.backbone.body.conv1
        st["stem_w"] = (c0.weight, c0.bias, c1.weight, c1.bias)
        errs = {}
        for b in (1, 2, 4):  # 1: the single-image path's batch
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
            gn, br = {}, {}
            for dt, det in dets.items():
                for mode in ("common", "precision", "light"):
                    det.test_mode = mode
                    st["capture"] = mode == "precision"
                    n0 = group_norm_kernel.group_norm_relu.launches
                    b0 = bias_relu_kernel.bias_relu.launches
                    preds = compute_predictions(det, [batch], progress_every=0)
                    st["capture"] = False
                    gn[f"{dt}_{mode}"] = \
                        group_norm_kernel.group_norm_relu.launches - n0
                    br[f"{dt}_{mode}"] = \
                        bias_relu_kernel.bias_relu.launches - b0
                    s.say(f"main_{dt}_{mode}",
                          f"detections={check_preds(preds, 4)} "
                          f"group_norm_relu={gn[f'{dt}_{mode}']} "
                          f"bias_relu={br[f'{dt}_{mode}']}")
            st["launches"] = counts()
        finally:
            pp_mod.nms_keep_mask = real
        s.say("main_path_launches", st["launches"])
        assert st["launches"]["nms_sorted"] > 0
        assert st["launches"]["vgg_stem_fused"] > 0
        assert all(v > 0 for v in gn.values()), gn  # every fp eval forward
        # one forward a mode: every conv of VGG stages 2-5
        assert all(v == VGG_CONVS for v in br.values()), br
        assert (st["launches"]["bias_relu"]
                == VGG_CONVS * st["launches"]["vgg_stem_fused"]), st["launches"]
        st["gn_by_forward"] = gn
        st["br_by_forward"] = br
        assert not any(st["launches"][k] for k in int8_kernels), \
            "an int8 kernel launched on the fp path"
        for boxes, scores, valid, labels, thr, keep in captured:
            order = torch.sort(-torch.where(valid, scores, torch.tensor(
                nms_mod.NEG_INF, device=dev)), dim=-1, stable=True).indices
            b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            v = torch.gather(valid, 1, order)
            lab = None if labels is None else torch.gather(labels, 1, order)
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
            assert launched["group_norm_relu"] == 0, name
            assert launched["bias_relu"] == 0, name
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
                               bytes=nbytes, bound_ms=bound, bound_by="bytes"
                               if nbytes / PEAK_BYTES_S > flops / peak
                               else "operations",
                               tflops=flops / kms / 1e9)
            s.say(f"time_stem_{name}",
                  f"ms={kms} plain_ms={pms} library_ms={lms} bound_ms={bound} "
                  f"kernel_TFLOP/s={flops / kms / 1e9} "
                  f"kernel/library={kms / lms} (B={bs}, {hh}x{ww})")
        bf, f32 = times["bfloat16"], times["float32"]
        xf = x.float().contiguous()
        for tag, symbol, dt in (("bfloat16", "scan_stem_probe", torch.bfloat16),
                                ("float32", "scan_stem_f32_probe",
                                 torch.float32)):
            pk = packs[dt]
            out = torch.empty((bs, hh // 2, ww // 2, 64), dtype=dt,
                              device=dev)
            t = times[tag]
            t["without_conv1_2_ms"] = probe_ms(
                build.load("stem"), symbol, 6,
                [v.data_ptr() for v in (xf, pk.w0, pk.b0, pk.w1, pk.b1, out)],
                bs, hh, ww)
            s.say(f"time_stem_{tag}_without_conv1_2",
                  f"ms={t['without_conv1_2_ms']} "
                  f"share={t['without_conv1_2_ms'] / t['ms']}")
        # float32: three TF32 products a product, so the least time for its
        # float32-accurate work is three times its FLOPs on the TF32 tensor
        # cores; the CUDA cores' bound is the one the earlier design had
        f32["cuda_core_bound_ms"] = f32["bound_ms"]
        f32["bound_ms"] = max(3 * flops / PEAK_TF32_S,
                              f32["bytes"] / PEAK_BYTES_S) * 1e3
        s.say("time_stem_float32_bounds",
              f"ms={f32['ms']} kernel_TFLOP/s={f32['tflops']} (counting "
              f"{flops / bs / 1e9} GFLOP an image) 3xTF32_bound_ms="
              f"{f32['bound_ms']} cuda_core_bound_ms="
              f"{f32['cuda_core_bound_ms']} kernel/library="
              f"{f32['ms'] / f32['library_ms']} library_ms={f32['library_ms']}"
              f" earlier design's ms={EARLIER_MS['vgg_stem_fused_float32']}"
              " (PERF.md)")
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
        # the eval forward of a detector that trains: float32 masters cast at
        # use, the same weights; in turns with the bf16-parameter detector
        masters = build_detector(c2f("bfloat16", "precision"), device=dev,
                                 seed=s.seed, train=True).eval()
        turns = []
        for tag, d in (("cast", det), ("masters", masters),
                       ("masters", masters), ("cast", det)):
            turns.append((tag, cuda_time(
                lambda: d.forward_inference(im, sizes), 5, 2)))
        with torch.no_grad():
            a = det.forward_inference(im, sizes)
            b = masters.forward_inference(im, sizes)
        mean = {t: sum(ms for tt, ms in turns if tt == t) / 2
                for t in ("cast", "masters")}
        s.say("forward_bf16_cast_vs_masters_ms",
              f"turns={turns} mean={mean} masters/cast="
              f"{mean['masters'] / mean['cast']} spread of cast="
              f"{abs(turns[0][1] - turns[3][1]) / mean['cast']}; valid "
              f"equal={bool(torch.equal(a['valid'], b['valid']))} "
              f"max|score diff|={float((a['scores'] - b['scores']).abs().max())}")
        st["eval_masters"] = dict(turns=turns, mean=mean)
        del masters

        time_parts("forward", det, im, sizes,
                   lambda x: det.backbone.body._stage1_fp(x))
        kernels.append(time_group_norm())
        kernels.append(time_bias_relu())

    @torch.no_grad()
    def time_group_norm():
        """The fused GroupNorm on the tensors the main path gives it: one
        precision forward at batch 8 in each dtype, the first call at each
        FPN level kept; the kernel against its plain version (float32 within
        1e-5 of the largest output, bf16 within one bf16 ulp as in
        tests/test_torch_group_norm.py), timed in a CUDA graph beside the
        wrapper, the plain version, the modules it replaced (bias add,
        GroupNorm, ReLU) and its bound (three passes of the bytes)."""
        real = group_norm_kernel.group_norm_relu
        im8, sizes8 = images(8, H, W, s.seed + 4)
        levels = []
        for dt in ("bfloat16", "float32"):
            det, seen = st["dets"][dt], {}

            def capture(y, *a):
                seen.setdefault(tuple(y.shape), (y, *a))
                return real(y, *a)
            capture.launches = 0  # the wrapper counts on the module's name
            det.test_mode = "precision"
            group_norm_kernel.group_norm_relu = capture
            try:
                det.forward_inference(im8, sizes8)
            finally:
                group_norm_kernel.group_norm_relu = real
            assert len(seen) == 5, sorted(seen)
            for shape, args in sorted(seen.items(), reverse=True):
                y, bias, weight, gn_bias, groups, eps = args
                got = real(*args).float()
                want = group_norm_kernel.group_norm_relu_plain(
                    y.float(), bias, weight, gn_bias, groups, eps)
                big = float(want.abs().max())
                err = float((got - want).abs().max())
                if dt == "float32":
                    ratio = err / (1e-5 * big)
                else:  # one bf16 ulp, no finer than that of 2^-8 of big
                    def ulp(t):
                        e = torch.frexp(t.abs().clamp_min(
                            torch.finfo(torch.float32).tiny))[1]
                        return torch.ldexp(torch.ones_like(t), e - 8)
                    want = want.to(torch.bfloat16).float()
                    tol = torch.maximum(ulp(want), ulp(torch.tensor(
                        big * 2 ** -8, device=dev)))
                    ratio = float(((got - want).abs() / tol).max())
                assert ratio <= 1.0, (dt, shape, ratio)
                ms = graph_ms(lambda: real(*args))
                wrapper = cuda_time(lambda: real(*args), 20)
                plain = cuda_time(lambda: group_norm_kernel.
                                  group_norm_relu_plain(*args), 5, 1)
                modules = cuda_time(lambda: F.relu(F.group_norm(
                    (y if bias is None else y + bias).permute(0, 3, 1, 2),
                    groups, weight, gn_bias, eps)).permute(0, 2, 3, 1), 20)
                bound = 3 * y.numel() * y.element_size() / PEAK_BYTES_S * 1e3
                row = dict(dtype=dt, shape=list(shape), ms=ms,
                           wrapper_ms=wrapper, plain_ms=plain,
                           modules_ms=modules, bound_ms=bound,
                           roofline_pct=100 * bound / ms, max_abs_err=err,
                           err_over_limit=ratio)
                levels.append(row)
                s.say(f"time_group_norm_relu_{dt}_{shape[1]}x{shape[2]}",
                      " ".join(f"{k}={v}" for k, v in row.items()))
        p3 = levels[0]
        return dict(
            name="group_norm_relu", route="cuda",
            source="scan_tpu_torch/csrc/group_norm.cu", replaces=None,
            launches=st["launches"]["group_norm_relu"],
            max_abs_err=p3["max_abs_err"], ms=p3["ms"],
            plain_ms=p3["plain_ms"], bound_ms=p3["bound_ms"],
            bound_by="bytes", library_ms=p3["modules_ms"], dtype=p3["dtype"],
            shape="B={} {}x{}x{}".format(*p3["shape"]),
            timing="wrapper in a CUDA graph", wrapper_ms=p3["wrapper_ms"],
            launches_by_forward=st["gn_by_forward"], levels=levels)

    @torch.no_grad()
    def time_bias_relu():
        """The VGG body's bias + ReLU (+ pool) kernel on the tensors the main
        path gives it: one precision forward at batch 8 in each dtype, the
        first call of each shape and mode kept with its conv's input. The
        kernel equal (``torch.equal``) to the module path (bias add,
        ``F.relu``, ``F.max_pool2d``), timed in a CUDA graph beside its bound
        (one read of the conv's output, one write of the result), the plain
        version and the module path it replaced; its wrapper's host time a
        call, alone and under ``profiler.recording()``, beside that of the
        module path's ops; and, as a yardstick the port never calls, cuDNN's
        conv + bias + ReLU in one call (``torch.cudnn_convolution_relu``,
        then ``F.max_pool2d`` at a stage's end) beside the unbiased conv and
        the kernel."""
        from scan_tpu_torch.utils import profiler

        def host_us(fn, n=200):
            """Host us a call of ``fn``, enqueued ``n`` times."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            us = 1e6 * (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
            return us

        def modules(y, bias, pool):
            x = F.relu(y.add_(bias))
            if pool:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            return x

        real = bias_relu_kernel.bias_relu
        im8, sizes8 = images(8, H, W, s.seed + 5)
        rows, per_forward = [], {}
        for dt in ("bfloat16", "float32"):
            det, seen, inputs, calls = st["dets"][dt], {}, [], {}
            body = det.backbone.body
            convs = [getattr(body, f"conv{i}") for i in range(2, 13)]

            def capture(y, bias, pool):
                key = (tuple(y.shape), pool)
                seen.setdefault(key, (y.clone(), bias, inputs[-1]))
                calls[key] = calls.get(key, 0) + 1
                return real(y, bias, pool)
            capture.launches = 0  # the wrapper counts on the module's name
            for conv in convs:
                def unbiased(x, conv=conv):
                    inputs.append((x, conv))
                    return type(conv).forward_unbiased(conv, x)
                conv.forward_unbiased = unbiased
            det.test_mode = "precision"
            bias_relu_kernel.bias_relu = capture
            try:
                det.forward_inference(im8, sizes8)
            finally:
                bias_relu_kernel.bias_relu = real
                for conv in convs:
                    del conv.forward_unbiased
            assert capture.launches == VGG_CONVS, capture.launches
            assert len(seen) == 8, sorted(seen)  # 4 stages x 2 modes
            for (shape, pool), (y, bias, (x, conv)) in seen.items():
                want = modules(y.clone(), bias, pool)
                got = real(y.clone(), bias, pool)
                equal = bool(torch.equal(got, want))
                assert equal, (dt, shape, pool)
                yy = y.clone()
                ms = graph_ms(lambda: real(yy, bias, pool))
                plain = cuda_time(lambda: bias_relu_kernel.bias_relu_plain(
                    yy, bias, pool), 20)
                mod = cuda_time(lambda: modules(yy, bias, pool), 20)
                host = host_us(lambda: real(yy, bias, pool))
                with profiler.recording():
                    host_rec = host_us(lambda: real(yy, bias, pool))
                profiler.reset()
                host_mod = host_us(lambda: modules(yy, bias, pool))
                xc = x.to(y.dtype).permute(0, 3, 1, 2)
                w = conv.weight.to(y.dtype)
                conv_ms = cuda_time(lambda: F.conv2d(xc, w, None, padding=1), 10)
                conv_bias_ms = cuda_time(lambda: F.conv2d(xc, w, bias,
                                                          padding=1), 10)

                def fused():
                    z = torch.cudnn_convolution_relu(xc, w, bias, (1, 1),
                                                     (1, 1), (1, 1), 1)
                    return F.max_pool2d(z, 2, 2) if pool else z
                try:
                    cudnn_ms = cuda_time(fused, 10)
                except RuntimeError as e:  # a yardstick, not a check
                    cudnn_ms = f"refused: {str(e)[:120]}"
                nbytes = (y.numel() + got.numel()) * y.element_size()
                bound = nbytes / PEAK_BYTES_S * 1e3
                row = dict(dtype=dt, shape=list(shape), pool=pool, ms=ms,
                           bound_ms=bound, roofline_pct=100 * bound / ms,
                           plain_ms=plain, modules_ms=mod, host_us=host,
                           host_us_recording=host_rec, modules_host_us=host_mod,
                           conv_ms=conv_ms, conv_bias_ms=conv_bias_ms,
                           conv_plus_kernel_ms=conv_ms + ms,
                           cudnn_conv_relu_ms=cudnn_ms, equal=equal)
                rows.append(row)
                s.say(f"time_bias_relu_{dt}_{shape[1]}x{shape[2]}x{shape[3]}"
                      f"_{'pool' if pool else 'inplace'}",
                      " ".join(f"{k}={v}" for k, v in row.items()))
            # a forward's 11 calls: stages 3-5 run their first shape twice
            assert sum(calls.values()) == VGG_CONVS, calls
            pick = {(tuple(r["shape"]), r["pool"]): r for r in rows
                    if r["dtype"] == dt}
            per_forward[dt] = {k: sum(n * pick[c][k] for c, n in calls.items())
                               for k in ("ms", "bound_ms", "modules_ms")}
            s.say(f"time_bias_relu_{dt}_per_forward", per_forward[dt])
        s2 = rows[0]
        return dict(
            name="bias_relu", route="cuda",
            source="scan_tpu_torch/csrc/bias_relu.cu", replaces=None,
            launches=st["launches"]["bias_relu"], max_abs_err=0.0,
            ms=s2["ms"], plain_ms=s2["plain_ms"], bound_ms=s2["bound_ms"],
            bound_by="bytes", library_ms=s2["modules_ms"], dtype=s2["dtype"],
            shape="B={} {}x{}x{}".format(*s2["shape"]),
            timing="wrapper in a CUDA graph", host_us=s2["host_us"],
            launches_by_forward=st["br_by_forward"], per_forward=per_forward,
            calls=rows)

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
              f"share={k5['without_conv1_2_ms'] / k5['ms']}; earlier "
              f"design's ms={EARLIER_MS['fused_stem_int8']}, without "
              f"conv1_2 {EARLIER_MS['fused_stem_int8_without_conv1_2']} "
              "(PERF.md)")

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
    from scan_tpu_torch.data import build as data_build
    from scan_tpu_torch.data.datasets.coco import COCODataset
    from scan_tpu_torch.engine import inference as inference_mod
    from scan_tpu_torch.engine import trainer
    from scan_tpu_torch.engine.train_step import make_da_train_step
    from scan_tpu_torch.modeling.condgraph import module as cg_mod
    from scan_tpu_torch.modeling.condgraph import sampling
    from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer

    def train_setup(cfg, device):
        det = build_detector(cfg, device=device, seed=s.seed, train=True)
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

    def train_main(dtype, key):
        """The DA step's main path at full width in ``dtype``; the state
        goes to ``st[key]`` (``train`` for float32, ``train_bf16``), and
        every record is named after ``key``."""
        for k in ("dets", "int8_dets", "int8_det", "train", "train_init"):
            st.pop(k, None)  # free the card
        torch.cuda.empty_cache()
        cfg = c2f(dtype)
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
                s.say(f"{key}_step{i}_ft{int(ft)}",
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
        s.say(f"{key}_target_nodes_valid", nodes)
        s.say(f"{key}_dbscan_candidates_kept",
              [tuple(int(v) for v in c) for c in dbscan])
        assert len(nodes) == variants.count(True) and nodes[0] > 0, nodes
        torch.cuda.synchronize()
        launched = counts()
        s.say(f"{key}_main_launches", launched)
        assert launched["vgg_stem_fused"] == 2 * len(variants), launched
        # the frozen stage 2 of each VGG forward takes the bias + ReLU kernel
        assert launched["bias_relu"] == (
            VGG_FROZEN_CONVS * launched["vgg_stem_fused"]), launched
        assert not any(v for k, v in launched.items()
                       if k not in ("vgg_stem_fused", "bias_relu"))
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
            s.say(f"{key}_sync_free_ft{int(ft)}",
                  f"loss_total={float(metrics['loss_total'])}")
        moved = {k for k, p in det.named_parameters()
                 if not torch.equal(p.detach(), start[k])}
        trainable = set(start) - frozen
        # float32 masters and momentum whatever the compute dtype
        low = [k for k, p in det.named_parameters() if p.dtype != torch.float32]
        low += [i for i, v in enumerate(opt.state.values())
                if v["momentum_buffer"].dtype != torch.float32]
        assert not low and len(opt.state) == len(trainable), low[:5]
        s.say(f"{key}_params", f"dtype={dtype} all float32, "
              f"{len(opt.state)} float32 momentum buffers; "
              f"trainable={len(trainable)} moved="
              f"{len(moved & trainable)} frozen={len(frozen)} "
              f"frozen_moved={len(moved & frozen)} counter={int(proto.counter)} "
              f"proto_max_change={float((proto.prototype - proto0).abs().max())}")
        assert moved == trainable, sorted(trainable - moved)[:5]
        assert frozen == {f"backbone.body.conv{i}.{t}" for i in range(4)
                          for t in ("weight", "bias")}
        assert int(proto.counter) == cfg.MODEL.MIDDLE_HEAD.PROTO_ITER
        assert float((proto.prototype - proto0).abs().max()) > 0
        s.say(f"{key}_peak_mem_gib",
              torch.cuda.max_memory_allocated() / 2 ** 30)
        st[key] = (cfg, det, opt, sched, step, batches)
        st[f"{key}_init"] = init
        st[f"{key}_k2_per_step"] = per_step

    def p_train_main():
        train_main("float32", "train")

    def p_train_bf16_main():
        train_main("bfloat16", "train_bf16")

    def val_tree(root, n, seed):
        """A COCO validation set on disk: n seeded noise frames at H x W
        with 6 GT boxes each, read back through the port's ``COCODataset``
        and eval loader (batch 2)."""
        g = torch.Generator().manual_seed(seed)
        frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                               dtype=torch.uint8).numpy()
        boxes, labels = [], []
        for _ in range(n):
            xy = torch.rand(6, 2, generator=g) * torch.tensor([W * 0.7, H * 0.7])
            wh = torch.rand(6, 2, generator=g) * 200 + 20
            boxes.append(torch.cat([xy, xy + wh], -1).int().tolist())
            labels.append(torch.randint(1, 9, (6,), generator=g).tolist())
        ann = str(root / "annotations.json")
        write_coco(ann, str(root / "images"), frames, boxes, labels)
        return COCODataset(ann, str(root / "images"),
                           remove_images_without_annotations=False)

    def p_train_loop():
        cfg, det, _, _, step, batches = st["train"]
        cfg = cfg.clone()
        cfg.SOLVER.MAX_ITER, cfg.SOLVER.VAL_ITER = 4, 2
        loader_val = data_build.DetectionLoader(
            val_tree(tmp_root / "val_800x1344", 4, s.seed + 20), cfg, False, 2)
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
            assert c["group_norm_relu"] > 0, c
            assert c["bias_relu"] == VGG_CONVS * c["vgg_stem_fused"], c
        in_val = {k: sum(c[k] for c, _ in vals) for k in total}
        train_k2 = total["vgg_stem_fused"] - in_val["vgg_stem_fused"]
        assert (total["bias_relu"] - in_val["bias_relu"]
                == VGG_FROZEN_CONVS * train_k2), (total, in_val)
        s.say("train_loop_launches", f"total={total} in_validation={in_val} "
              f"K2_in_training={train_k2} best_metric={best}")
        assert len(vals) == 2 and train_k2 == 2 * cfg.SOLVER.MAX_ITER
        assert total["group_norm_relu"] == in_val["group_norm_relu"], \
            "the fused GroupNorm launched in a training step"
        st["val_launches"] = vals[0][0]
        for k in st.get("kernels") or []:
            if k["name"] in ("nms_sorted", "vgg_stem_fused", "group_norm_relu",
                             "bias_relu"):
                k["validation_launches_per_pass"] = vals[0][0][k["name"]]
            if k["name"] == "vgg_stem_fused":
                k["train_launches_per_step"] = st["train_k2_per_step"]

    def train_time(key, other_sizes=()):
        """Every timed step starts from the seeded state of
        ``train_main`` (restored outside the timed span, the momentum
        kept), where GST has target nodes: the True variant times the
        branch it is named for. ``other_sizes`` (h, w) are timed too,
        whole steps only, on scenes drawn at that size."""
        cfg, det, opt, sched, step, batches = st[key]
        init = st[f"{key}_init"]
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

        for hw in other_sizes:
            bs2, bt2 = train_batches(4, *hw, s.seed + 10, dev, n_boxes=100,
                                     k=16, scenes=True)
            for ft in (False, True):
                gen = torch.Generator(device=dev).manual_seed(3000 + ft)
                ms, outs = timed(lambda: step(det.proto_state(), bs2, bt2,
                                              forward_target=ft,
                                              generator=gen)[1], 5)
                tag = f"{key}_step_{hw[0]}x{hw[1]}_ft{int(ft)}"
                if ft:
                    transfer = [float(m["transfer_loss_gt"]) for m in outs]
                    s.say(f"{tag}_transfer_loss_gt", transfer)
                    assert min(transfer) > 0, transfer
                s.say(f"{tag}_ms", ms)
                s.say(f"{tag}_img_s", n_img * 1e3 / ms)
            del bs2, bt2
        for ft in (False, True):
            gen = torch.Generator(device=dev).manual_seed(3000 + ft)
            ms, outs = timed(lambda: step(det.proto_state(), bs, bt,
                                          forward_target=ft,
                                          generator=gen)[1], 5)
            if ft:
                transfer = [float(m["transfer_loss_gt"]) for m in outs]
                s.say(f"{key}_step_ft1_transfer_loss_gt", transfer)
                assert min(transfer) > 0, transfer
            s.say(f"{key}_step_ft{int(ft)}_ms", ms)
            s.say(f"{key}_step_ft{int(ft)}_img_s", n_img * 1e3 / ms)
            st.setdefault("step_ms", {})[f"{key}_ft{int(ft)}"] = ms
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
            s.say(f"{key}_split_ft{int(ft)}_ms",
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
            s.say(f"{key}_sample_target_nodes_ms",
                  cuda_time(lambda: real(*a, **k), 10, 2))
        s.say(f"{key}_sample_target_nodes_valid", n_nodes)
        assert n_nodes > 0
        s.say(f"{key}_timing_peak_mem_gib",
              torch.cuda.max_memory_allocated() / 2 ** 30)

    def p_train_time():
        train_time("train")

    # ---- 16-18: the port's own entry points, from files on disk ---------
    from scan_tpu_torch import native
    from scan_tpu_torch.config.paths_catalog import DatasetCatalog
    from scan_tpu_torch.data import transforms
    from scan_tpu_torch.data.datasets import coco as coco_mod
    from scan_tpu_torch.engine import train_step as train_step_mod
    from scan_tpu_torch.tools import test_net, train_net_da
    from scan_tpu_torch.utils.checkpoint import Checkpointer

    def p_disk_tree():
        """Cityscapes-shaped C2F tree at the catalog's paths: 8 source and
        8 fogged target training frames, 32 fogged validation frames, PNG
        at 1024x2048, phase 13's seeded scenes with 16 GT boxes a frame."""
        root = tmp_root / "datasets"
        t0 = time.time()
        n_bytes = 0
        specs = (("cityscapes_train_cocostyle", 8, False),
                 ("cityscapes_foggy_train_cocostyle", 8, True),
                 ("cityscapes_foggy_val_cocostyle", 32, True))
        DatasetCatalog.DATA_DIR = str(root)
        os.environ["SCAN_TPU_DATA_DIR"] = str(root)
        for k, (name, n, fog) in enumerate(specs):
            args = DatasetCatalog.get(name)["args"]
            g = torch.Generator().manual_seed(s.seed + 40 + k)
            frames, boxes, labels = [], [], []
            for _ in range(n // 8):
                b, lab, mask = gt_boxes(g, 8, CITY_H, CITY_W, 16, 16)
                im = scene(g, b, lab, mask, CITY_H, CITY_W)
                if fog:
                    im = (im.float() * 0.55 + 200 * 0.45).to(torch.uint8)
                frames += list(im.numpy())
                boxes += b.int().tolist()
                labels += lab.tolist()
            n_bytes += write_coco(args["ann_file"], args["root"], frames,
                                  boxes, labels)
            st.setdefault("disk_frames", {})[name] = frames[0]
        s.say("disk_tree", f"{sum(n for _, n, _ in specs)} PNG frames at "
              f"{CITY_H}x{CITY_W}, {n_bytes / 2 ** 20:.1f} MiB, written in "
              f"{time.time() - t0:.2f} s")
        cfg = c2f()
        val = data_build.make_data_loaders_test(cfg)[0]
        src = data_build.make_data_loader_source(cfg)
        frame = val.dataset.load_image(0)
        assert frame.shape == (CITY_H, CITY_W, 3)
        assert np.array_equal(
            frame, st["disk_frames"]["cityscapes_foggy_val_cocostyle"])
        resized = transforms.get_resize_hw(CITY_W, CITY_H, 800, 1333)
        s.say("disk_tree_shapes", f"resize={resized} test_bucket="
              f"{val.buckets} train_bucket={src.buckets}")
        assert resized == (666, 1332)
        assert val.buckets == [(672, 1344)] and src.buckets == [(672, 1344)]
        assert len(val.dataset) == 32

    @contextlib.contextmanager
    def instrumented():
        """Record, while the CLIs run: each loader iteration's wait for
        every batch and the indices it yielded; each training step's call
        time and loss_total (a device scalar, read afterwards); launches
        per validation; each checkpoint restore, held against its file;
        and which decode and resize ran (native or Pillow)."""
        rec = dict(streams=[], steps=[], vals=[], restores=[],
                   use={k: 0 for k in ("native_decode", "pil_decode",
                                       "native_resize", "pil_resize")})
        real = dict(iter=data_build.DetectionLoader.__iter__,
                    make_step=train_step_mod.make_da_train_step,
                    inference=inference_mod.inference,
                    load=Checkpointer.load,
                    decode=native.decode_image,
                    pil_decode=coco_mod.pil_decode,
                    resize=native.resize_image_u8,
                    pil_resize=transforms.pil_resize)

        def timed_iter(loader):
            stream = dict(train=loader.is_train, seed=loader.seed, waits=[],
                          indices=[])
            rec["streams"].append(stream)
            inner = real["iter"](loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(inner)
                    except StopIteration:
                        return
                    stream["waits"].append(time.perf_counter() - t0)
                    stream["indices"].append(batch["indices"].tolist())
                    yield batch
            finally:
                inner.close()

        def make_step(*a, **k):
            step = real["make_step"](*a, **k)

            def timed_step(*sa, **sk):
                t0 = time.perf_counter()
                proto, metrics = step(*sa, **sk)
                rec["steps"].append((t0, metrics["loss_total"]))
                return proto, metrics
            return timed_step

        def counted(detector, data_loader):
            torch.cuda.synchronize()
            c0 = counts()
            out = real["inference"](detector, data_loader)
            torch.cuda.synchronize()
            rec["vals"].append({k: v - c0[k] for k, v in counts().items()})
            return out

        def checked_load(ckpt, f=None, load_dis=True, load_opt_sch=True):
            it = real["load"](ckpt, f, load_dis, load_opt_sch)
            path = ckpt.get_checkpoint_file() if ckpt.has_checkpoint() else f
            entry = dict(iteration=it, path=path)
            if path and ckpt.optimizer is not None:
                saved = torch.load(model_zoo.resolve_weight_uri(path),
                                   map_location="cpu", weights_only=True)
            if path and ckpt.optimizer is not None and "model" not in saved:
                entry["reference_file"] = True  # the ImageNet VGG, iteration 0
            elif path and ckpt.optimizer is not None:
                own = ckpt.detector.state_dict()
                entry["model_diff"] = [k for k, v in saved["model"].items()
                                       if not torch.equal(own[k].cpu(), v)]
                mom = ckpt.optimizer.state_dict()["state"]
                entry["momentum_diff"] = [
                    i for i, v in saved["optimizer"]["state"].items()
                    if not torch.equal(mom[i]["momentum_buffer"].cpu(),
                                       v["momentum_buffer"])]
                entry["scheduler_equal"] = \
                    ckpt.scheduler.state_dict() == saved["scheduler"]
            rec["restores"].append(entry)
            return it

        def use(key, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if key != "native_decode" or out is not None:
                    rec["use"][key] += 1
                return out
            return wrapped

        data_build.DetectionLoader.__iter__ = timed_iter
        train_step_mod.make_da_train_step = make_step
        inference_mod.inference = counted
        Checkpointer.load = checked_load
        native.decode_image = use("native_decode", real["decode"])
        coco_mod.pil_decode = use("pil_decode", real["pil_decode"])
        native.resize_image_u8 = use("native_resize", real["resize"])
        transforms.pil_resize = use("pil_resize", real["pil_resize"])
        try:
            yield rec
        finally:
            data_build.DetectionLoader.__iter__ = real["iter"]
            train_step_mod.make_da_train_step = real["make_step"]
            inference_mod.inference = real["inference"]
            Checkpointer.load = real["load"]
            native.decode_image = real["decode"]
            coco_mod.pil_decode = real["pil_decode"]
            native.resize_image_u8 = real["resize"]
            transforms.pil_resize = real["pil_resize"]

    def check_native(rec):
        """The native library was built for this host and resized every
        frame; decode was native where the library has the codecs, else
        Pillow (the card's machine lacks libpng's and libjpeg's headers)."""
        lib = native.get_lib()
        assert lib.path == native.target()[0], (lib.path, native.target())
        codecs = native.has_codecs()
        use = rec["use"]
        assert use["native_resize"] > 0 and use["pil_resize"] == 0, use
        if codecs:
            assert use["native_decode"] > 0 and use["pil_decode"] == 0, use
        else:
            assert use["native_decode"] == 0 and use["pil_decode"] > 0, use
        return dict(library=lib.path.name, codecs=codecs, **use)

    def cli_train_run(rec, out, max_iter, period):
        """``train_net_da.main`` on the C2F config from the disk tree:
        full width, float32, batch 4 + 4; launches counted around it."""
        n0 = (len(rec["steps"]), len(rec["vals"]), len(rec["streams"]))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        train_net_da.main(["--config-file", str(C2F), "OUTPUT_DIR", str(out),
                           "TPU.COMPUTE_DTYPE", "float32",
                           "SOLVER.IMS_PER_BATCH", "4", "SOLVER.VAL_ITER", "2",
                           "SOLVER.CHECKPOINT_PERIOD", str(period),
                           "SOLVER.MAX_ITER", str(max_iter)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        total = counts()
        steps = rec["steps"][n0[0]:]
        vals = rec["vals"][n0[1]:]
        streams = [x for x in rec["streams"][n0[2]:] if x["train"]]
        in_val = {k: sum(v[k] for v in vals) for k in total}
        train_k2 = total["vgg_stem_fused"] - in_val["vgg_stem_fused"]
        for v in vals:
            assert v["nms_sorted"] > 0 and v["vgg_stem_fused"] > 0, v
            assert v["group_norm_relu"] > 0, v
            assert v["bias_relu"] == VGG_CONVS * v["vgg_stem_fused"], v
        assert not any(total[k] for k in int8_kernels), total
        assert total["group_norm_relu"] == in_val["group_norm_relu"], \
            "the fused GroupNorm launched in a training step"
        assert train_k2 == 2 * len(steps), (train_k2, len(steps))
        assert (total["bias_relu"] - in_val["bias_relu"]
                == VGG_FROZEN_CONVS * train_k2), (total, in_val)
        # data wait per step: source + target, blocked in next()
        waits = [sum(x["waits"][i] for x in streams)
                 for i in range(len(steps))]
        return dict(steps=steps, vals=vals, streams=streams, waits=waits,
                    wall=wall, total=total, train_k2=train_k2)

    def p_cli_train():
        for key in ("train", "train_init"):  # free phase 13's model
            st.pop(key, None)
        torch.cuda.empty_cache()
        out, straight_out = tmp_root / "c2f_train", tmp_root / "c2f_straight"
        with instrumented() as rec:
            a = cli_train_run(rec, out, 4, 2)
            saved = sorted(os.listdir(out))
            s.say("cli_train_run4", f"wall={a['wall']:.2f} s launches="
                  f"{a['total']} K2_in_training={a['train_k2']} "
                  f"validations={len(a['vals'])} files={saved}")
            assert len(a["steps"]) == 4 and len(a["vals"]) == 2
            assert {"model_0000002.pth", "model_0000004.pth",
                    "model_final.pth", "last_checkpoint"} <= set(saved)
            assert Checkpointer(str(out), None).get_checkpoint_file() \
                .endswith("model_final.pth")
            b = cli_train_run(rec, out, 6, 2)
            restore = rec["restores"][-1]
            s.say("cli_train_resume", restore)
            assert restore["iteration"] == 4, restore
            assert not restore["model_diff"] and not restore["momentum_diff"]
            assert restore["scheduler_equal"]
            assert len(b["steps"]) == 2
            c = cli_train_run(rec, straight_out, 6, 100)
            assert len(c["steps"]) == 6 and c["train_k2"] == 12
            st["cli_weight"] = str(out / "model_final.pth")
            st["cli_use"] = check_native(rec)
        s.say("cli_native", st["cli_use"])
        for tag, run in (("resumed", b), ("straight", c)):
            for kind, seed in (("source", 1234), ("target", 1235)):
                idx = [x["indices"] for x in run["streams"] if x["seed"] == seed]
                assert len(idx) == 1, (tag, kind, len(idx))
                run[kind] = idx[0]
        assert b["source"] == c["source"][4:] and b["target"] == c["target"][4:]
        s.say("cli_train_streams", f"resumed source={b['source']} "
              f"target={b['target']}: equal to the straight run's "
              "iterations 4-5")
        got = [float(l) for _, l in b["steps"]]
        want = [float(l) for _, l in c["steps"]][4:]
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        s.say("cli_train_loss_total", f"resumed={got} straight={want} "
              f"worst_rel={worst}")
        # the card's cuDNN may sum a convolution's gradient in another
        # order from run to run: the bound is 1e-3 relative, not equality
        assert worst <= 1e-3, worst
        # iteration wall: from one step's call to the next (the loop waits
        # on the step before, so this is the card's step plus the data
        # wait); the iterations that end with a validation or a checkpoint
        # and the first (cuDNN's first calls) are left out
        t = [t0 for t0, _ in c["steps"]]
        clean = [i for i in range(1, len(t) - 1) if (i + 1) % 2]
        iter_ms = [1e3 * (t[i + 1] - t[i]) for i in clean]
        wait_ms = [1e3 * c["waits"][i + 1] for i in clean]
        s.say("cli_train_iteration_ms", iter_ms)
        s.say("cli_train_data_wait_ms_per_step", {
            "straight_all": [1e3 * w for w in c["waits"]],
            "clean": wait_ms})
        st["cli_train"] = dict(iter_ms=iter_ms, wait_ms=wait_ms,
                               launches=c["total"])
        shutil.rmtree(straight_out, ignore_errors=True)

    def p_cli_test():
        out = tmp_root / "c2f_test"
        base = ["--config-file", str(C2F), "MODEL.WEIGHT", st["cli_weight"],
                "OUTPUT_DIR", str(out), "TPU.COMPUTE_DTYPE", "bfloat16",
                "TEST.MODE", "precision", "TEST.IMS_PER_BATCH", "8"]
        int8 = ["TPU.INT8_INFERENCE", "True", "TPU.PALLAS_STEM_INT8", "True",
                "TPU.INT8_CALIB_BATCHES", "1"]
        with instrumented() as rec:
            for tag, extra in (("fp", []), ("int8", int8)):
                buf = io.StringIO()
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.time()
                with contextlib.redirect_stdout(buf):
                    test_net.main(base + extra)
                torch.cuda.synchronize()
                wall = time.time() - t0
                c = counts()
                last = buf.getvalue().strip().splitlines()[-1]
                res = json.loads(last)
                s.say(f"cli_test_{tag}", f"wall={wall:.2f} s launches={c} "
                      f"restored={rec['restores'][-1]['iteration']} "
                      f"stdout_last={last}")
                assert {"AP", "AP50"} <= set(res), res
                assert c["nms_sorted"] > 0, c
                if tag == "fp":
                    assert c["vgg_stem_fused"] > 0
                    assert c["group_norm_relu"] > 0, c
                    assert c["bias_relu"] == VGG_CONVS * c["vgg_stem_fused"], c
                    assert not any(c[k] for k in int8_kernels), c
                else:
                    assert c["fused_stem_int8"] > 0 and c["vgg_stem_fused"] == 0
                    assert c["group_norm_relu"] == 0 == c["bias_relu"], c
                    assert not any(c[k] for k in int8_kernels
                                   if k != "fused_stem_int8"), c
                st.setdefault("cli_test_launches", {})[tag] = c
            use = check_native(rec)
            s.say("cli_test_native", use)
            # the loader's share: the same eval, a first pass (decode and
            # resize) and a second (from the eval cache), end to end
            cfg = c2f("bfloat16")
            cfg.TEST.IMS_PER_BATCH = 8
            det = build_detector(cfg, device=dev, seed=s.seed)
            Checkpointer(str(out / "timing"), det).load(st["cli_weight"],
                                                        load_dis=False)
            loader = data_build.make_data_loaders_test(cfg)[0]
            rates = {}
            for pass_ in ("first", "cached"):
                n0 = len(rec["streams"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                preds = compute_predictions(det, loader, progress_every=0)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                waits = rec["streams"][n0]["waits"]
                rates[pass_] = len(preds) / dt
                s.say(f"cli_eval_{pass_}_pass", f"{len(preds)} frames, "
                      f"{rates[pass_]:.2f} img/s end to end, loader wait "
                      f"ms per batch {[round(1e3 * w, 2) for w in waits]}")
                st.setdefault("cli_eval", {})[pass_] = dict(
                    img_s=rates[pass_], wait_ms=[1e3 * w for w in waits])
        batch = next(iter(loader))
        images = batch["images"]

        def copy():
            return torch.as_tensor(images).to(dev)

        copy_ms = cuda_time(copy, 10, 2)
        im = copy()
        sizes = torch.as_tensor(batch["sizes"]).to(dev)
        fwd_ms = cuda_time(lambda: det.forward_inference(im, sizes), 5, 2)
        path = os.path.join(loader.dataset.root,
                            loader.dataset.get_img_info(0)["file_name"])
        t0 = time.perf_counter()
        for _ in range(5):
            frame = coco_mod._load_rgb(path)
        decode_ms = 1e3 * (time.perf_counter() - t0) / 5
        buf = np.zeros((672, 1344, 3), np.uint8)
        t0 = time.perf_counter()
        for _ in range(5):
            native.resize_image_u8(frame, buf, 666, 1332)
        resize_ms = 1e3 * (time.perf_counter() - t0) / 5
        s.say("cli_eval_parts", f"pageable host->card copy of a batch "
              f"{images.shape} u8 ({images.nbytes / 2 ** 20:.1f} MiB): "
              f"{copy_ms:.3f} ms; forward alone at 672x1344 b8: {fwd_ms:.2f} "
              f"ms ({8e3 / fwd_ms:.2f} img/s); decode a 1024x2048 PNG "
              f"({'native' if use['codecs'] else 'Pillow'}): "
              f"{decode_ms:.2f} ms; native resize to 666x1332: "
              f"{resize_ms:.2f} ms; timing's forward at 800x1344 b8: "
              f"{s.record.get('forward_bf16_precision_b8_img_s')} img/s")
        st["cli_eval"].update(copy_ms=copy_ms, forward_ms=fwd_ms,
                              decode_ms=decode_ms, resize_ms=resize_ms)
        for k in st.get("kernels") or []:
            for tag, c in st.get("cli_test_launches", {}).items():
                k[f"cli_test_{tag}_launches"] = c[k["name"]]
            if "cli_train" in st:
                k["cli_train_launches"] = st["cli_train"]["launches"][k["name"]]

    # ---- 16-20: reference weights, bf16 training, CA and OUT -----------
    from scan_tpu_torch.tools import remove_solver_states, train_net
    from scan_tpu_torch.utils import model_zoo, torch_weights
    epm_ca = HERE / "configs" / "epm" / "da_ga_ca_cityscapes_VGG_16_FPN_4x.yaml"
    vgg_idx = torch_weights.VGG16_TORCH_CONV_IDX
    vgg_ch = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)

    def imagenet_vgg(seed):
        """A caffe VGG16 ImageNet file's layout, ``features.{idx}.*``, at
        full width, seeded (the released file is not in the repo)."""
        g = torch.Generator().manual_seed(seed)
        sd, cin = {}, 3
        for idx, ch in zip(vgg_idx, vgg_ch):
            sd[f"features.{idx}.weight"] = torch.randn(
                ch, cin, 3, 3, generator=g) * math.sqrt(2.0 / (9 * ch))
            sd[f"features.{idx}.bias"] = torch.randn(ch, generator=g) * 0.1
            cin = ch
        return sd

    def reference_ckpt(seed):
        """A full reference SCAN checkpoint at C2F's full width, in the
        layout of tests/test_checkpoint_roundtrip.py::_make_reference_ckpt:
        VGG16 + FPN, 4-conv FCOS towers, the RNN condgraph with its
        prototype, five CKA discriminators, and a GA entry nothing
        converts."""
        g = torch.Generator().manual_seed(seed)

        def t(*shape, std=0.01):
            return torch.randn(*shape, generator=g) * std

        def tower(prefix, n, ch=256, gn=True):
            out, step = {}, 3 if gn else 2
            for i in range(n):
                out[f"{prefix}.{i * step}.weight"] = t(ch, ch, 3, 3)
                out[f"{prefix}.{i * step}.bias"] = t(ch)
                if gn:
                    out[f"{prefix}.{i * step + 1}.weight"] = 1 + t(ch)
                    out[f"{prefix}.{i * step + 1}.bias"] = t(ch)
            return out

        bb = {f"body.{k}": v for k, v in imagenet_vgg(seed).items()}
        for ref_i, cin in zip((3, 4, 5), (256, 512, 512)):
            bb[f"fpn.fpn_inner{ref_i}.weight"] = t(256, cin, 1, 1, std=0.05)
            bb[f"fpn.fpn_inner{ref_i}.bias"] = t(256)
            bb[f"fpn.fpn_layer{ref_i}.weight"] = t(256, 256, 3, 3, std=0.02)
            bb[f"fpn.fpn_layer{ref_i}.bias"] = t(256)
        for p_ in ("p6", "p7"):
            bb[f"fpn.top_blocks.{p_}.weight"] = t(256, 256, 3, 3, std=0.02)
            bb[f"fpn.top_blocks.{p_}.bias"] = t(256)
        fcos = {f"head.{k}": v for name in ("cls_tower", "bbox_tower")
                for k, v in tower(name, 4).items()}
        for name, o in (("cls_logits", 8), ("bbox_pred", 4), ("centerness", 1)):
            fcos[f"head.{name}.weight"] = t(o, 256, 3, 3)
            fcos[f"head.{name}.bias"] = t(o)
        for l in range(5):
            fcos[f"head.scales.{l}.scale"] = torch.ones(1)
        mh = tower("head_in.middle_tower", 2)
        mh["head_out.middle_tower.0.weight"] = t(256, 265, 3, 3)
        mh["head_out.middle_tower.0.bias"] = t(256)
        mh["prototype"] = t(9, 256, 3, std=1.0)
        for name, o, i in (("proto_cls_hidden", 512, 256), ("proto_cls", 9, 512),
                           ("cond_2", 256, 512)):
            mh[f"{name}.weight"], mh[f"{name}.bias"] = t(o, i), t(o)
        for lin in ("linear_q", "linear_k", "linear_v", "linear_final"):
            mh[f"multihead_attn.{lin}.weight"] = t(256, 256, std=0.06)
            mh[f"multihead_attn.{lin}.bias"] = t(256)
        mh["multihead_attn.layer_norm.weight"] = 1 + t(256)
        mh["multihead_attn.layer_norm.bias"] = t(256)
        for layer, in_sz in ((0, 256), (1, 512)):
            mh[f"cond_rnn.weight_ih_l{layer}"] = t(512, in_sz, std=0.05)
            mh[f"cond_rnn.weight_hh_l{layer}"] = t(512, 512, std=0.05)
            mh[f"cond_rnn.bias_ih_l{layer}"] = t(512)
            mh[f"cond_rnn.bias_hh_l{layer}"] = t(512)
        mh["cond_nx1.weight"] = t(256, 512, 3, 1, std=0.03)
        mh["cond_nx1.bias"] = t(256)
        ckpt = {"model_backbone": bb, "model_fcos": fcos, "middle_head": mh,
                "model_dis_P3": tower("dis_tower", 4), "iteration": 20000}
        for layer in ("P3", "P4", "P5", "P6", "P7"):
            dis = tower("dis_tower", 4)
            for c in range(8):
                dis[f"classifier_cls_{c}.0.weight"] = t(128, 257, 3, 3)
                dis[f"classifier_cls_{c}.0.bias"] = t(128)
                dis[f"classifier_cls_{c}.2.weight"] = t(1, 128, 3, 3)
                dis[f"classifier_cls_{c}.2.bias"] = t(1)
            ckpt[f"model_dis_{layer}_CON"] = dis
        return ckpt

    def p_weights():
        """16. Reference .pth files at C2F full width: the config's own
        MODEL.WEIGHT URL resolves through SCAN_TPU_CACHE_DIR to the cached
        ImageNet file and loads the VGG body; so does the file under
        state_dict with module. prefixes; a full SCAN checkpoint's every
        converted tensor lands at its port name, load_dis=False keeps the
        discriminators, and the loaded detector's forward runs on the card."""
        root = tmp_root / "weights"
        cache = root / "cache"
        cache.mkdir(parents=True)
        sd = imagenet_vgg(s.seed + 60)
        t0 = time.time()
        torch.save(sd, root / "vgg16_caffe.pth")
        shutil.copy(root / "vgg16_caffe.pth", cache / "vgg16_caffe-292e1171.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   root / "vgg16_wrapped.pth")
        full = reference_ckpt(s.seed + 61)
        torch.save(full, root / "scan_c2f.pth")
        written = time.time() - t0
        os.environ["SCAN_TPU_CACHE_DIR"] = str(cache)  # for the CLIs below
        st["imagenet_file"] = str(root / "vgg16_caffe.pth")
        cfg = c2f()
        url = cfg.MODEL.WEIGHT
        resolved = model_zoo.resolve_weight_uri(url)
        assert resolved == str(cache / "vgg16_caffe-292e1171.pth"), resolved

        def body_equal(det):
            body = det.backbone.body
            return all(torch.equal(getattr(body, f"conv{i}").weight.cpu(),
                                   sd[f"features.{idx}.weight"])
                       and torch.equal(getattr(body, f"conv{i}").bias.cpu(),
                                       sd[f"features.{idx}.bias"])
                       for i, idx in enumerate(vgg_idx))

        det = build_detector(cfg, device=dev, seed=s.seed)
        for name in (url, str(root / "vgg16_wrapped.pth")):
            with torch.no_grad():
                det.backbone.body.conv5.weight.zero_()
            t0 = time.time()
            it = Checkpointer(str(root / "ck"), det).load(name)
            s.say("weights_imagenet_load",
                  f"{name} -> iteration {it} in {time.time() - t0:.2f} s")
            assert it == 0 and body_equal(det), name
        n_bytes = os.path.getsize(root / "scan_c2f.pth")
        before = {k: v.clone() for k, v in det.state_dict().items()}
        t0 = time.time()
        assert Checkpointer(str(root / "ck"), det).load(
            str(root / "scan_c2f.pth"), load_dis=False) == 0
        load_s = time.time() - t0
        converted, proto = torch_weights.convert_reference(full, det)
        own = det.state_dict()
        dis = [k for k in own if k.startswith("dis_")]
        for k in dis:
            assert torch.equal(own[k], before[k]), k
        landed = [k for k in converted if not k.startswith("dis_")]
        for k in landed:
            assert torch.equal(own[k].cpu(), converted[k]), k
        assert torch.equal(det.prototype.cpu(), proto)
        assert int(det.proto_counter) == int(before["proto_counter"])
        Checkpointer(str(root / "ck"), det).load(str(root / "scan_c2f.pth"))
        own = det.state_dict()
        for k in converted:
            assert torch.equal(own[k].cpu(), converted[k]), k
        im, sizes = images(2, H, W, s.seed + 62)
        zero_counts()
        out = det.forward_inference(im, sizes)
        torch.cuda.synchronize()
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        s.say("weights_reference_pth",
              f"files written in {written:.2f} s; full checkpoint "
              f"{n_bytes / 2 ** 20:.1f} MiB loaded in {load_s:.2f} s, "
              f"{len(converted)} tensors converted ({len(landed)} without "
              f"the discriminators), {len(dis)} discriminator entries kept "
              f"under load_dis=False; forward detections="
              f"{int(out['valid'].sum())} launches={counts()}")
        del det

    def group_dist(d, ref, groups):
        """Per parameter group, the L2 norm of the update d - ref over that
        of ref (dicts of updates)."""
        out = {}
        for g, keys in groups.items():
            num = sum(float(((d[k] - ref[k]) ** 2).sum()) for k in keys)
            den = sum(float((ref[k] ** 2).sum()) for k in keys)
            out[g] = (num / max(den, 1e-30)) ** 0.5
        return out

    def bf16_agree(tag, card, cpu16, cpu32):
        """The bf16 bound: each metric of the card within max(2 x the
        CPU's own bf16-float32 distance, 2**-7 of the value: two bf16 ulps,
        K2's bf16 tolerance, 2**-16 absolute: the GST transfer loss, ~1e-3,
        is 1 - cos of two adjacency matrices plus a KL, differences of
        terms of order 1, so its bf16 error is absolute), each parameter
        group's update within max(2 x that distance, 2e-3) in relative L2.
        (m, updates, groups) per run."""
        (mc, uc, groups), (m16, u16, _), (m32, u32, _) = card, cpu16, cpu32
        assert set(mc) == set(m16) == set(m32)
        worst = []
        for k in m16:
            d, own = abs(mc[k] - m16[k]), abs(m32[k] - m16[k])
            worst.append((d / max(2 * own, 2 ** -7 * abs(m16[k]), 2 ** -16),
                          k))
        dc = group_dist(uc, u16, groups)
        d32 = group_dist(u32, u16, groups)
        for g in groups:
            worst.append((dc[g] / max(2 * d32[g], 2e-3), g))
        ratio, where = max(worst)
        values = (f"card/cpu16/cpu32 = {mc[where]}/{m16[where]}/{m32[where]}"
                  if where in m16 else "")
        s.say(tag, f"worst ratio to the bound {ratio} at {where} {values}; "
              f"update distance card-cpu {dc}, cpu bf16-f32 {d32}")
        assert ratio <= 1.0, (tag, ratio, where)

    def run_step(det, cfg, bs, bt, ft, reset=None):
        """One DA step from ``reset`` (a state dict) with a fresh optimizer:
        (host metrics, updates, the solver's groups)."""
        if reset is not None:
            det.load_state_dict(reset)
        opt = make_optimizer(cfg, det)
        step = make_da_train_step(det, opt, make_lr_scheduler(cfg, opt))
        groups = {}
        for g in opt.param_groups:
            ids = {id(p) for p in g["params"]}
            groups[g["label"]] = [k for k, p in det.named_parameters()
                                  if id(p) in ids]
        before = {k: p.detach().float().cpu().clone()
                  for k, p in det.named_parameters()}
        _, metrics = step(det.proto_state(), bs, bt, forward_target=ft)
        host = {k: float(v) for k, v in metrics.items()}
        upd = {k: p.detach().float().cpu() - before[k]
               for k, p in det.named_parameters()}
        bad = [k for k, v in host.items() if not math.isfinite(v)]
        bad += [k for k, v in upd.items() if not torch.isfinite(v).all()]
        assert not bad, f"non-finite on {det.pixel_mean.device}: {bad[:5]}"
        return host, upd, groups

    def p_train_bf16_small():
        """17. The bf16 DA step, card against CPU, 128x192, batch 2 + 2,
        each variant, every BASE_LR 0.1, from the same seeded weights. The
        bound is measured, as in tests/test_torch_train_bf16.py: cuDNN and
        oneDNN sum in other orders and round at other places (a bias fused
        or added apart), and one bf16 ulp of difference spreads through the
        layers, so the card is held to twice the CPU's own distance between
        its bf16 and float32 steps (the CPU tests measure the port at
        0.1-0.7x of that distance from scan_tpu's jitted bf16 step), with
        floors (``bf16_agree``) of two bf16 ulps of a metric, 2**-16 absolute
        and 2e-3 for an update. One sample of each distance is a noisy
        yardstick: with independent roundings on the two devices a metric
        exceeds twice the other's distance about a third of the time, which
        the floors absorb (on an H100 the GST transfer loss, 8.6e-4, lay
        6.8e-6 from the CPU's against 2.6e-6 between the CPU's bf16 and
        float32). Target node masks may differ in bf16 and are counted, not
        asserted."""
        cfgs = {}
        for dt in ("float32", "bfloat16"):
            cfg = c2f(dt)
            cfg.TPU.MAX_NODES, cfg.TPU.MAX_TARGET_POINTS = 64, 64
            cfg.TPU.MAX_BOXES = 8
            for k in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
                cfg.SOLVER[k].BASE_LR = 0.1
            cfgs[dt] = cfg
        cpu = torch.device("cpu")
        for ft in (False, True):
            runs, masks = {}, {}
            for name, dt, device in (("card", "bfloat16", dev),
                                     ("cpu16", "bfloat16", cpu),
                                     ("cpu32", "float32", cpu)):
                det = build_detector(cfgs[dt], device=device, seed=s.seed,
                                     train=True)
                bs, bt = train_batches(2, 128, 192, s.seed + 5, device)
                rec = []
                real = cg_mod.sample_target_nodes

                def recording(*a, **k):
                    out = real(*a, **k)
                    rec.append(out[2].cpu())
                    return out
                cg_mod.sample_target_nodes = recording
                try:
                    runs[name] = run_step(det, cfgs[dt], bs, bt, ft)
                finally:
                    cg_mod.sample_target_nodes = real
                masks[name] = rec
                del det
            same = [bool(torch.equal(a, b))
                    for a, b in zip(masks["card"], masks["cpu16"])]
            s.say(f"train_bf16_small_ft{int(ft)}_masks",
                  f"target node masks equal card/cpu in bf16: {same}; "
                  f"loss_total card/cpu16/cpu32="
                  f"{[runs[n][0]['loss_total'] for n in runs]}")
            bf16_agree(f"train_bf16_small_ft{int(ft)}", runs["card"],
                       runs["cpu16"], runs["cpu32"])

    def p_train_bf16_time():
        # bench.py's train metric is the bf16 DA step at 672x1344
        train_time("train_bf16", other_sizes=((672, 1344),))
        for k in st.get("kernels") or []:
            if k["name"] == "vgg_stem_fused":
                k["train_bf16_launches_per_step"] = st["train_bf16_k2_per_step"]

    def p_ca_out():
        """20. configs/epm/da_ga_ca_cityscapes_VGG_16_FPN_4x.yaml (GA + CA,
        no condgraph) at full width, IMS_PER_BATCH cut from 16 to 4 + 4: a
        DA step in each CENTER_AWARE_TYPE, and with USE_DIS_OUT (no config
        in configs/ turns it on) in each OUTMAP_OP, float32 and bf16, at
        800x1344 (losses finite, every family present, K2 twice a step) and
        at 128x192 on the card and the CPU from the same weights (float32:
        metrics rtol 1e-4, updates within p_train_small's bound; bf16: the
        bound of p_train_bf16_small)."""
        for k in ("train_bf16", "train_bf16_init"):
            st.pop(k, None)
        torch.cuda.empty_cache()
        base = get_default_cfg()
        base.merge_from_file(str(epm_ca))
        s.say("ca_out_config", f"{epm_ca.name}: SOLVER.IMS_PER_BATCH cut "
              f"from {base.SOLVER.IMS_PER_BATCH} to 4 + 4; MODEL.WEIGHT "
              f"{base.MODEL.WEIGHT} not loaded (seeded weights); "
              f"condgraph {base.MODEL.MIDDLE_HEAD.CONDGRAPH_ON}")
        big = train_batches(4, H, W, s.seed + 10, dev, n_boxes=100, k=16,
                            scenes=True)
        cpu = torch.device("cpu")
        small = {d: train_batches(2, 128, 192, s.seed + 5, d)
                 for d in (dev, cpu)}
        variants = [(t, None) for t in ("ca_feature", "ca_loss", "focal")]
        variants += [("ca_feature", op)
                     for op in ("sigmoid", "maxpool", "attreg", "none")]
        small_runs = {}
        for dt in ("float32", "bfloat16"):
            for op in (None, "sigmoid", "maxpool", "attreg", "none"):
                cfg = base.clone()
                cfg.TPU.COMPUTE_DTYPE = dt
                cfg.SOLVER.IMS_PER_BATCH = 4
                cfg.TPU.MAX_BOXES = 100
                if op:
                    cfg.MODEL.ADV.USE_DIS_OUT = True
                    cfg.MODEL.ADV.OUTMAP_OP = op
                det = build_detector(cfg, device=dev, seed=s.seed, train=True)
                host = build_detector(cfg, device=cpu, seed=s.seed, train=True)
                init = {k: v.clone() for k, v in det.state_dict().items()}
                init_cpu = {k: v.clone() for k, v in host.state_dict().items()}
                for ca_type, op_ in variants:
                    if op_ != op:
                        continue
                    for d in (det, host):
                        for name in d.dis_names:
                            if name.endswith("_CA"):
                                getattr(d, name).center_aware_type = ca_type
                    tag = f"{dt}_{ca_type}_{op or 'no_out'}"
                    zero_counts()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    m, _, _ = run_step(det, cfg, *big, False, reset=init)
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                    c = counts()
                    fams = sorted({k.split("_")[3] for k in m
                                   if k.startswith("loss_adv")})
                    s.say(f"ca_out_{tag}", f"800x1344 b4+4 step {wall:.3f} s "
                          f"(with the host's copies), loss_total="
                          f"{m['loss_total']} families={fams} launches={c}")
                    assert all(math.isfinite(v) for v in m.values()), m
                    assert fams == sorted(["GA", "CA"] + (["OUT"] if op else []))
                    assert c["vgg_stem_fused"] == 2
                    assert c["bias_relu"] == 2 * VGG_FROZEN_CONVS, c
                    assert not any(v for k, v in c.items()
                                   if k not in ("vgg_stem_fused", "bias_relu"))
                    small_runs[(dt, tag.split("_", 1)[1], "card")] = run_step(
                        det, cfg, *small[dev], False, reset=init)
                    small_runs[(dt, tag.split("_", 1)[1], "cpu")] = run_step(
                        host, cfg, *small[cpu], False, reset=init_cpu)
                if op is None:  # one step timed, after the warm one above
                    det.load_state_dict(init)
                    opt = make_optimizer(cfg, det)
                    step = make_da_train_step(det, opt)
                    ms = cuda_time(lambda: step(None, *big), 2, 1)
                    s.say(f"ca_out_{dt}_step_ms", f"{ms} ({8e3 / ms} img/s; "
                          "CUDA events over 2 steps after a warm one)")
                del det, host
                torch.cuda.empty_cache()
        for (dt, name, where), run in small_runs.items():
            if where != "card" or dt != "float32":
                continue
            mc, uc, _ = run
            mw, uw, _ = small_runs[(dt, name, "cpu")]
            worst = max(abs(mc[k] - mw[k]) / max(abs(mw[k]), 1e-12) for k in mw)
            ratio, at = delta_bound(uc, uw, 2e-3, 2e-3)
            s.say(f"ca_out_small_float32_{name}", f"card vs cpu: metrics "
                  f"worst_rel={worst} update bound ratio={ratio} at {at}")
            assert set(mc) == set(mw) and worst <= 1e-4, worst
            assert ratio <= 1.0, (ratio, at)
            bf16_agree(f"ca_out_small_bfloat16_{name}",
                       small_runs[("bfloat16", name, "card")],
                       small_runs[("bfloat16", name, "cpu")],
                       small_runs[("float32", name, "cpu")])

    def p_cli_train_net():
        """24. tools/train_net.py's main on the disk tree: source-only, bf16,
        batch 4, MAX_ITER 4, CHECKPOINT_PERIOD 2, from the ImageNet file:
        K2 once a step and nothing else, the VGG body at step 0 the file's;
        then remove_solver_states on its directory and test_net on the slim
        file (its last stdout line is JSON)."""
        out = tmp_root / "c2f_train_net"
        sd = torch.load(st["imagenet_file"], weights_only=True)
        real = train_step_mod.make_source_only_train_step
        steps, at_start = [], []

        def make(det, opt, sched=None):
            body = det.backbone.body
            at_start.append(all(
                torch.equal(getattr(body, f"conv{i}").weight.cpu(),
                            sd[f"features.{idx}.weight"])
                for i, idx in enumerate(vgg_idx)))
            step = real(det, opt, sched)

            def timed_step(*a, **k):
                t0 = time.perf_counter()
                proto, metrics = step(*a, **k)
                steps.append((t0, metrics["loss_total"]))
                return proto, metrics
            return timed_step

        train_step_mod.make_source_only_train_step = make
        zero_counts()
        t0 = time.time()
        try:
            train_net.main(["--config-file", str(C2F), "OUTPUT_DIR", str(out),
                            "MODEL.WEIGHT", st["imagenet_file"],
                            "TPU.COMPUTE_DTYPE", "bfloat16",
                            "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_ITER", "4",
                            "SOLVER.CHECKPOINT_PERIOD", "2"])
        finally:
            train_step_mod.make_source_only_train_step = real
        torch.cuda.synchronize()
        wall = time.time() - t0
        c = counts()
        losses = [float(l) for _, l in steps]
        iter_ms = [1e3 * (b[0] - a[0]) for a, b in zip(steps, steps[1:])]
        files = sorted(os.listdir(out))
        s.say("cli_train_net", f"wall={wall:.2f} s launches={c} "
              f"loss_total={losses} iteration_ms={iter_ms} files={files}")
        assert at_start == [True] and len(steps) == 4
        assert all(math.isfinite(v) for v in losses)
        assert c["vgg_stem_fused"] == 4, c
        assert c["bias_relu"] == VGG_FROZEN_CONVS * 4, c
        assert not any(v for k, v in c.items()
                       if k not in ("vgg_stem_fused", "bias_relu")), c
        assert {"model_0000002.pth", "model_0000004.pth",
                "model_final.pth"} <= set(files)
        slim = str(tmp_root / "slim" / "model_slim.pth")
        remove_solver_states.main([str(out), slim])
        kept = torch.load(slim, weights_only=True)
        assert sorted(kept) == ["iteration", "model"], sorted(kept)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            test_net.main(["--config-file", str(C2F), "MODEL.WEIGHT", slim,
                           "OUTPUT_DIR", str(tmp_root / "slim_test"),
                           "TPU.COMPUTE_DTYPE", "bfloat16", "TEST.MODE",
                           "precision", "TEST.IMS_PER_BATCH", "8"])
        last = buf.getvalue().strip().splitlines()[-1]
        s.say("cli_train_net_slim_test_net", f"slim keys={sorted(kept)} "
              f"stdout_last={last}")
        assert {"AP", "AP50"} <= set(json.loads(last))
        st["cli_train_net"] = dict(iter_ms=iter_ms, launches=c)
        for k in st.get("kernels") or []:
            k["cli_train_net_launches"] = c[k["name"]]

    # ---- 25-31: ResNet-101 and ATSS --------------------------------------
    from scan_tpu_torch.modeling.atss.atss import atss_postprocess
    from scan_tpu_torch.modeling.layers import Conv, FrozenBatchNorm
    from scan_tpu_torch.utils.c2_loading import convert_c2_resnet
    r101_ca = HERE / "configs" / "epm" / "da_ga_ca_cityscapes_R_101_FPN_4x.yaml"
    atss_cfg = HERE / "configs" / "epm" / "da_ga_sim10k_VGG_16_FPN_4x_atss.yaml"

    def epm(path, dtype="float32", opts=()):
        """An EPM config at full width, IMS_PER_BATCH cut from 16 to 4 + 4
        (one card's batch), 100 GT slots."""
        cfg = get_default_cfg()
        cfg.merge_from_file(str(path))
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.SOLVER.IMS_PER_BATCH = 4
        cfg.TPU.MAX_BOXES = 100
        cfg.merge_from_list(list(opts))
        return cfg

    def free_card():
        for k in ("dets", "int8_dets", "int8_det", "train", "train_init",
                  "train_bf16", "train_bf16_init", "r101", "atss"):
            st.pop(k, None)
        torch.cuda.empty_cache()

    def detectron_r101(body, seed):
        """A seeded Detectron blob dict for ``body`` (a port ResNet), in
        the names of scan_tpu/utils/c2_loading.py:3-12: convs at He scale
        (conv1 over the caffe input's ~60 std), folded BNs near identity,
        the residual branches' last BN at 0.2, as a trained body damps
        them, so 101 layers stay finite; with a classifier and momentum
        blobs, under ``blobs``."""
        rng = np.random.RandomState(seed)
        sd = body.state_dict()
        blobs = {}

        def put(name, key, gain=1.0):
            shape = tuple(sd[key].shape)
            if name.endswith("_w"):
                v = rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))
                v = v / 60.0 if name == "conv1_w" else v
            elif name.endswith("_s"):
                v = gain * (1 + 0.1 * rng.randn(*shape))
            else:
                v = 0.1 * rng.randn(*shape)
            blobs[name] = v.astype(np.float32)

        put("conv1_w", "stem_conv1.weight")
        put("res_conv1_bn_s", "stem_bn1.weight")
        put("res_conv1_bn_b", "stem_bn1.bias")
        for si, n in enumerate(body.stage_blocks, 1):
            for b in range(n):
                p, blk = f"res{si + 1}_{b}_branch", f"layer{si}_block{b}"
                for br, i in zip("abc", (1, 2, 3)):
                    put(f"{p}2{br}_w", f"{blk}.conv{i}.weight")
                    put(f"{p}2{br}_bn_s", f"{blk}.bn{i}.weight",
                        0.2 if br == "c" else 1.0)
                    put(f"{p}2{br}_bn_b", f"{blk}.bn{i}.bias")
                if b == 0:
                    put(f"{p}1_w", f"{blk}.downsample_conv.weight")
                    put(f"{p}1_bn_s", f"{blk}.downsample_bn.weight")
                    put(f"{p}1_bn_b", f"{blk}.downsample_bn.bias")
        momentum = {k + "_momentum": np.zeros_like(v)
                    for k, v in list(blobs.items())[:4]}
        blobs["fc1000_w"] = rng.randn(1000, 2048).astype(np.float32) * 0.01
        return {"blobs": dict(blobs, **momentum), "model_iter": 0}

    def r101_pickle():
        """The seeded full-width R-101 pickle (written once), also in the
        weight cache as catalog://ImageNetPretrained/MSRA/R-101's file."""
        if "r101_pkl" not in st:
            body = build_detector(epm(r101_ca), device="cpu").backbone.body
            data = detectron_r101(body, s.seed + 80)
            path = tmp_root / "R-101.pkl"
            t0 = time.time()
            with open(path, "wb") as f:
                pickle.dump(data, f, protocol=2)
            cache = Path(os.environ.get("SCAN_TPU_CACHE_DIR",
                                        tmp_root / "cache"))
            cache.mkdir(parents=True, exist_ok=True)
            os.environ["SCAN_TPU_CACHE_DIR"] = str(cache)
            shutil.copy(path, cache / "R-101.pkl")
            st["r101_pkl"] = str(path)
            st["r101_blobs"] = data["blobs"]
            s.say("r101_pickle", f"{path.stat().st_size / 2 ** 20:.1f} MiB "
                  f"Detectron pickle written in {time.time() - t0:.2f} s")
        return st["r101_pkl"]

    def seeded(det, cls_bias=None):
        """``det`` from the R-101 pickle when its body is a ResNet (the
        configs' ImageNet body, loaded by ``Checkpointer``); with
        ``cls_bias`` the head's cls_logits bias set to it, so scores spread
        above INFERENCE_TH and NMS has work."""
        if hasattr(det.backbone.body, "stem_conv1"):
            t0 = time.time()
            it = Checkpointer(str(tmp_root / "ck_unused"), det).load(
                r101_pickle())
            assert it == 0
            st["r101_pkl_load_s"] = time.time() - t0
        if cls_bias is not None:
            with torch.no_grad():
                det.fcos.cls_logits.bias.fill_(cls_bias)
        return det

    def frozen_state(det):
        """The names of the frozen parameters and the FrozenBN buffers."""
        names = {k for k, p in det.named_parameters() if not p.requires_grad}
        for mname, m in det.named_modules():
            if isinstance(m, FrozenBatchNorm):
                names |= {f"{mname}.{b}" for b, _ in m.named_buffers()}
        return names

    def small_card_vs_cpu(key, path, opts=()):
        """Card against CPU at 128x192, float32, TF32 off, from the same
        seeded weights (cls bias 0: spread scores): the backbone's
        features within 1e-4 of each level's largest value, the detections
        matched as sets (p_small's bounds, boxes 0.03 px, scores 1.1e-4),
        and one DA step (every BASE_LR 0.1): metrics within rtol 1e-4,
        every update within p_train_small's bound (2e-3 + 2e-3)."""
        cfg = epm(path, opts=opts)
        for k in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
            cfg.SOLVER[k].BASE_LR = 0.1
        h, w = 128, 192
        cpu = torch.device("cpu")
        dets = {d: seeded(build_detector(cfg, device=d, seed=s.seed,
                                         train=True), cls_bias=0.0)
                for d in (dev, cpu)}
        im, sizes = images(2, h, w, s.seed + 1)
        with torch.no_grad():
            fg, fc = (dets[d].backbone(dets[d]._prep_images(x))
                      for d, x in ((dev, im), (cpu, im.cpu())))
            worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                        for a, b in zip(fg, fc))
            got = {k: v.cpu() for k, v in
                   dets[dev].forward_inference(im, sizes).items()}
            want = dets[cpu].forward_inference(im.cpu(), sizes.cpu())
        share = matched_share(got, want, box_atol=0.03, score_atol=1.1e-4)
        s.say(f"{key}_small_forward", f"features worst rel={worst} valid="
              f"{want['valid'].sum(1).tolist()} matched={share}")
        assert worst <= 1e-4, worst
        assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
        assert share == 1.0 and int(want["valid"].sum()) > 0, share
        init = {d: {k: v.clone() for k, v in dets[d].state_dict().items()}
                for d in dets}
        batches = {d: train_batches(2, h, w, s.seed + 5, d) for d in dets}
        mc, uc, _ = run_step(dets[dev], cfg, *batches[dev], False,
                             reset=init[dev])
        mw, uw, _ = run_step(dets[cpu], cfg, *batches[cpu], False,
                             reset=init[cpu])
        worst_m = max(abs(mc[k] - mw[k]) / max(abs(mw[k]), 1e-12) for k in mw)
        ratio, at = delta_bound(uc, uw, 2e-3, 2e-3)
        fams = sorted({k.split("_")[3] for k in mw if k.startswith("loss_adv")})
        s.say(f"{key}_small_step", f"families={fams} metrics worst_rel="
              f"{worst_m} loss_total card/cpu={mc['loss_total']}/"
              f"{mw['loss_total']} update bound ratio={ratio} at {at}")
        assert set(mc) == set(mw) and worst_m <= 1e-4, worst_m
        assert ratio <= 1.0, (ratio, at)
        assert "CA" in fams

    def check_nms_sets(captured, tag):
        """Every candidate set captured entering NMS against the plain NMS."""
        assert captured, f"{tag}: no NMS input captured"
        for boxes, scores, valid, labels, thr, keep in captured:
            order = torch.sort(-torch.where(valid, scores, torch.tensor(
                nms_mod.NEG_INF, device=dev)), dim=-1, stable=True).indices
            b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            v = torch.gather(valid, 1, order)
            lab = None if labels is None else torch.gather(labels, 1, order)
            want = torch.zeros_like(valid).scatter(
                1, order, nms_kernel.nms_sorted_plain(b, v, lab, thr))
            assert torch.equal(keep, want), f"{tag}: NMS sets disagree"
        v = captured[-1][2]
        s.say(f"{tag}_nms_candidates", f"{len(captured)} sets, valid_in="
              f"{v.sum(1).tolist()} K={v.shape[1]}")
        assert int(v.sum()) > 0, f"{tag}: NMS had no candidates"

    @contextlib.contextmanager
    def capturing_nms():
        captured = []
        real = pp_mod.nms_keep_mask

        def recording(boxes, scores, valid, thr, labels=None, **kw):
            keep = real(boxes, scores, valid, thr, labels=labels, **kw)
            captured.append((boxes, scores, valid, labels, thr, keep))
            return keep

        pp_mod.nms_keep_mask = recording
        try:
            yield captured
        finally:
            pp_mod.nms_keep_mask = real

    def eval_main(key, path, k2_per_forward, opts=()):
        """The eval main path at full width, batch 4, 800x1344, float32 and
        bf16, through ``compute_predictions``: counters zeroed before and
        read after (K1 once a forward, K2 ``k2_per_forward`` times, no int8
        kernel); NMS's candidate sets against the plain NMS; then the bf16
        forward at batch 8 timed (img/s) with its peak memory. ``opts``
        are config overrides (another body)."""
        free_card()
        im, sizes = images(4, H, W, s.seed)
        batch = dict(images=im.cpu().numpy(), sizes=sizes.cpu().numpy(),
                     scales=np.ones((4, 2), np.float32), indices=np.arange(4))
        dets = {dt: seeded(build_detector(epm(path, dt, opts), device=dev,
                                          seed=s.seed), cls_bias=-2.0)
                for dt in ("float32", "bfloat16")}
        torch.cuda.synchronize()
        zero_counts()
        with capturing_nms() as captured:
            for dt, det in dets.items():
                preds = compute_predictions(det, [batch], progress_every=0)
                n = check_preds(preds, 4)
                s.say(f"{key}_main_{dt}", f"detections={n}")
                assert all(0 < x <= 100 for x in n), n
        torch.cuda.synchronize()
        c = counts()
        s.say(f"{key}_main_launches", c)
        assert c["nms_sorted"] == 2, c
        assert c["vgg_stem_fused"] == 2 * k2_per_forward, c
        assert c["group_norm_relu"] > 0, c
        # 0 on the ResNet bodies
        assert c["bias_relu"] == VGG_CONVS * c["vgg_stem_fused"], c
        assert not any(c[k] for k in int8_kernels), c
        check_nms_sets(captured, f"{key}_main")
        st.setdefault("new_launches", {})[f"{key}_eval"] = {
            k: v // 2 for k, v in c.items()}
        det = dets["bfloat16"]
        del dets
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        im8, sizes8 = images(8, H, W, s.seed + 2)
        ms = cuda_time(lambda: det.forward_inference(im8, sizes8), 5, 2)
        s.say(f"{key}_forward_bf16_b8", f"ms={ms} img/s={8e3 / ms} peak_gib="
              f"{torch.cuda.max_memory_allocated() / 2 ** 30} (batch 8, "
              f"800x1344, CUDA events over 5 after 2 warm)")
        st.setdefault("new_times", {})[f"{key}_eval_bf16_b8"] = dict(
            ms=ms, img_s=8e3 / ms,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        with torch.no_grad():  # the forward cut at its layers, each alone
            x = det._prep_images(im8)
            feats = list(det.backbone(x))
            act_maps, parts = None, {}
            if det.condgraph_on:
                raw = feats
                parts["condgraph"] = lambda: det.middle_head(  # noqa: E731
                    raw, det.proto_state(), "inference")
                feats, _, act_maps, _ = parts["condgraph"]()
            head = det._head(feats)
            if det.atss_on:
                anchors = det._anchors(feats)
                tail = lambda: atss_postprocess(  # noqa: E731
                    det.atss_cfg, det.pp_cfg, anchors, *head, sizes8)
            else:
                cls_maps, sig = mix_cls_maps(det.test_mode, head[0],
                                             act_maps)
                pp = dataclasses.replace(det.pp_cfg, apply_sigmoid=sig)
                locs = compute_locations([(f.shape[1], f.shape[2])
                                          for f in feats], det.strides,
                                         device=dev)
                tail = lambda: fcos_postprocess(  # noqa: E731
                    pp, locs, cls_maps, head[1], head[2], sizes8)
            parts.update({"body": lambda: det.backbone.body(x),
                          "backbone": lambda: det.backbone(x),
                          "head": lambda: det._head(feats),
                          "postprocess": tail})
            for name, fn in parts.items():
                part_ms = cuda_time(fn, 5, 1)
                s.say(f"{key}_forward_part_{name}_ms", part_ms)
                st["new_times"][f"{key}_eval_part_{name}"] = part_ms

    def train_main_new(key, path, k2_per_step, variants):
        """The DA step at full width, batch 4 + 4 at 800x1344, float32
        (TF32 off) and bf16 over float32 masters, seeded scenes: per
        ``variants`` entry (tag, extra opts) one warm step from the seeded
        state, every loss finite, the frozen parameters and FrozenBN
        buffers unchanged, every trainable parameter moved, launches K2
        ``k2_per_step`` a step and nothing else; then 2 steps timed (CUDA
        events, each from the seeded state) and the peak memory."""
        free_card()
        batches = train_batches(4, H, W, s.seed + 10, dev, n_boxes=100, k=16,
                                scenes=True)
        for dt in ("float32", "bfloat16"):
            for tag, opts in variants:
                cfg = epm(path, dt, opts)
                det = seeded(build_detector(cfg, device=dev, seed=s.seed,
                                            train=True))
                frozen = frozen_state(det)
                init = {k: v.clone() for k, v in det.state_dict().items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                m, _, _ = run_step(det, cfg, *batches, False)
                torch.cuda.synchronize()
                c = counts()
                after = det.state_dict()
                moved = {k for k, p in det.named_parameters()
                         if not torch.equal(p.detach(), init[k])}
                trainable = {k for k, p in det.named_parameters()
                             if p.requires_grad}
                still = [k for k in frozen if not torch.equal(after[k], init[k])]
                fams = sorted({k.split("_")[3] for k in m
                               if k.startswith("loss_adv")})
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                s.say(f"{key}_train_{dt}_{tag}", f"loss_total="
                      f"{m['loss_total']} families={fams} launches={c} "
                      f"trainable={len(trainable)} moved="
                      f"{len(moved & trainable)} frozen={len(frozen)} "
                      f"frozen_changed={len(still)} peak_gib={peak}")
                assert all(math.isfinite(v) for v in m.values()), m
                assert moved == trainable, sorted(trainable - moved)[:5]
                assert not still, still[:5]
                assert c["vgg_stem_fused"] == k2_per_step, c
                assert c["bias_relu"] == (
                    VGG_FROZEN_CONVS * c["vgg_stem_fused"]), c
                assert not any(v for k, v in c.items()
                               if k not in ("vgg_stem_fused", "bias_relu")), c
                st.setdefault("new_launches", {})[f"{key}_da_step"] = c
                opt = make_optimizer(cfg, det)
                step = make_da_train_step(det, opt)

                def timed():
                    det.load_state_dict(init)
                    step(None, *batches)
                ms = cuda_time(timed, 2, 1)
                s.say(f"{key}_train_{dt}_{tag}_step_ms", f"{ms} ({8e3 / ms} "
                      "img/s; CUDA events over 2 steps after a warm one, "
                      "each from the seeded state)")
                st.setdefault("new_times", {})[f"{key}_da_{dt}_{tag}"] = dict(
                    ms=ms, img_s=8e3 / ms, peak_gib=peak)
                if dt == "bfloat16" and hasattr(det.backbone.body, "stem_conv1"):
                    # what the float32 conv results cost: the same step with
                    # the body's convs rounding to bf16, in turns
                    convs = [mm for mm in det.backbone.body.modules()
                             if isinstance(mm, Conv)]
                    turns = []
                    for fo in (True, False, False, True):
                        for mm in convs:
                            mm.float_output = fo
                        turns.append((fo, cuda_time(timed, 2, 1)))
                    for mm in convs:
                        mm.float_output = True
                    s.say(f"{key}_train_bf16_float_output_turns", turns)
                    st["new_times"][f"{key}_float_output_turns"] = turns
                del det, opt, step
                torch.cuda.empty_cache()

    def p_r101_small():
        small_card_vs_cpu("r101", r101_ca)

    def p_r101_main():
        eval_main("r101", r101_ca, 0)

    def p_r101_train():
        train_main_new("r101", r101_ca, 0, [("ga_ca", ())])

    def p_atss_small():
        small_card_vs_cpu("atss", atss_cfg,
                          ("MODEL.ADV.USE_DIS_CENTER_AWARE", True))

    def p_atss_main():
        eval_main("atss", atss_cfg, 1)
        train_main_new("atss", atss_cfg, 2, [
            ("ga", ()), ("ga_ca", ("MODEL.ADV.USE_DIS_CENTER_AWARE", True))])

    def p_cli_r101():
        """31. The entry points on the new configs, from the disk tree:
        train_net_da on da_ga_ca_cityscapes_R_101_FPN_4x.yaml (its datasets
        are the tree's C2F sets) with MODEL.WEIGHT the seeded R-101 pickle
        written into the tree, bf16, batch 4 + 4, MAX_ITER 2, VAL_ITER 2:
        K1 in validation, no K2; model_final's frozen stem and stage 1 are
        the pickle's; then test_net on the ATSS config from phase 16's
        ImageNet VGG16 file over the tree's fogged validation set
        (DATASETS.TEST cut to it: the config's own car-only set is not in
        the tree): K1 and K2 launch, its last stdout line is JSON."""
        free_card()
        pkl = Path(DatasetCatalog.DATA_DIR) / "pretrained_models" / "R-101.pkl"
        pkl.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(r101_pickle(), pkl)
        assert model_zoo.resolve_weight_uri(
            "catalog://ImageNetPretrained/MSRA/R-101") == str(
            Path(os.environ["SCAN_TPU_CACHE_DIR"]) / "R-101.pkl")
        out = tmp_root / "r101_train"
        zero_counts()
        t0 = time.time()
        train_net_da.main(["--config-file", str(r101_ca), "OUTPUT_DIR",
                           str(out), "MODEL.WEIGHT", str(pkl),
                           "TPU.COMPUTE_DTYPE", "bfloat16",
                           "SOLVER.IMS_PER_BATCH", "4", "SOLVER.VAL_ITER", "2",
                           "SOLVER.CHECKPOINT_PERIOD", "2",
                           "SOLVER.MAX_ITER", "2"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        c = counts()
        state = torch.load(out / "model_final.pth", map_location="cpu",
                           weights_only=True)
        blobs = st["r101_blobs"]
        same = all(torch.equal(state["model"][f"backbone.body.{k}"],
                               torch.from_numpy(v)) for k, v in
                   convert_c2_resnet(blobs).items()
                   if k.startswith(("stem_", "layer1_")))
        s.say("cli_r101_train_net_da", f"wall={wall:.2f} s launches={c} "
              f"iteration={state['iteration']} frozen body == pickle: {same}")
        assert state["iteration"] == 2 and same
        assert c["nms_sorted"] > 0 and c["vgg_stem_fused"] == 0, c
        assert c["group_norm_relu"] > 0 and c["bias_relu"] == 0, c
        assert not any(c[k] for k in int8_kernels), c
        st.setdefault("new_launches", {})["r101_validation"] = c
        buf = io.StringIO()
        zero_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            test_net.main(["--config-file", str(atss_cfg), "MODEL.WEIGHT",
                           st["imagenet_file"], "OUTPUT_DIR",
                           str(tmp_root / "atss_test"), "TPU.COMPUTE_DTYPE",
                           "bfloat16", "TEST.IMS_PER_BATCH", "8",
                           "DATASETS.TEST", "('cityscapes_foggy_val_cocostyle',)"])
        torch.cuda.synchronize()
        c = counts()
        last = buf.getvalue().strip().splitlines()[-1]
        s.say("cli_atss_test_net", f"wall={time.time() - t0:.2f} s "
              f"launches={c} stdout_last={last}")
        assert {"AP", "AP50"} <= set(json.loads(last))
        assert c["nms_sorted"] == 4 and c["vgg_stem_fused"] == 4, c
        assert c["group_norm_relu"] > 0, c
        assert c["bias_relu"] == VGG_CONVS * 4, c
        st.setdefault("new_launches", {})["atss_validation"] = c

    # ---- 32-34: the two-stage detector (Faster / Mask / Keypoint R-CNN) --
    from scan_tpu_torch.modeling import roi_heads as roi_mod
    from scan_tpu_torch.modeling import rpn_anchor as rpn_mod
    from scan_tpu_torch.modeling.generalized_rcnn import FasterRCNN
    box_scales = (0.25, 0.125, 0.0625, 0.03125)

    def rcnn_cfg(kind, dtype="float32", pre_test=1000, pre_train=2000,
                 post=None, dets=100):
        """maskrcnn-benchmark's configs/e2e_mask_rcnn_R_50_FPN_1x.yaml
        (``kind`` "mask") or e2e_keypoint_rcnn_R_50_FPN_1x.yaml
        ("keypoint"), set in code on the defaults; ``pre_test`` /
        ``pre_train`` are the RPN's PRE_NMS_TOP_N_TEST / _TRAIN (the
        configs' 1000 / 2000; scan_tpu's defaults 6000 / 12000). ``post``
        cuts POST_NMS_TOP_N_TEST / _TRAIN (1000 / 2000) and ``dets``
        DETECTIONS_PER_IMG (100), scale only, for the CPU's side of a
        card-against-CPU check."""
        cfg = get_default_cfg()
        m = cfg.MODEL
        m.BACKBONE.CONV_BODY = "R-50-FPN"
        m.RESNETS.BACKBONE_OUT_CHANNELS = 256
        r = m.RPN
        r.USE_FPN = True
        r.ANCHOR_STRIDE = (4, 8, 16, 32, 64)
        r.PRE_NMS_TOP_N_TRAIN, r.PRE_NMS_TOP_N_TEST = pre_train, pre_test
        r.POST_NMS_TOP_N_TEST = r.FPN_POST_NMS_TOP_N_TEST = post or 1000
        r.POST_NMS_TOP_N_TRAIN = post or 2000
        m.ROI_HEADS.DETECTIONS_PER_IMG = dets
        m.ROI_HEADS.USE_FPN = True
        b = m.ROI_BOX_HEAD
        b.FEATURE_EXTRACTOR, b.PREDICTOR = "FPN2MLPFeatureExtractor", "FPNPredictor"
        b.POOLER_RESOLUTION, b.POOLER_SCALES = 7, box_scales
        b.POOLER_SAMPLING_RATIO, b.MLP_HEAD_DIM = 2, 1024
        b.NUM_CLASSES = 81 if kind == "mask" else 2
        head = m.ROI_MASK_HEAD if kind == "mask" else m.ROI_KEYPOINT_HEAD
        head.POOLER_RESOLUTION, head.POOLER_SCALES = 14, box_scales
        head.POOLER_SAMPLING_RATIO = 2
        head.SHARE_BOX_FEATURE_EXTRACTOR = False
        if kind == "mask":
            head.FEATURE_EXTRACTOR = "MaskRCNNFPNFeatureExtractor"
            head.PREDICTOR, head.RESOLUTION = "MaskRCNNC4Predictor", 28
            m.MASK_ON = True
        else:
            head.NUM_CLASSES, head.RESOLUTION = 17, 56
            m.KEYPOINT_ON = True
        cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (800,), 1333
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 800, 1333
        cfg.DATALOADER.SIZE_DIVISIBILITY = 32
        cfg.TPU.COMPUTE_DTYPE = dtype
        return cfg

    def rcnn(kind, dtype, device, train=False, **kw):
        """``FasterRCNN`` with seeded weights, the body from a seeded
        Detectron blob set at its scales (``detectron_r101`` fits any
        depth), and cls_score's bias at 3 for classes 1-4: at random init
        81-way scores are ~0.012, under SCORE_THRESH 0.05, and ML-NMS would
        have no candidate."""
        det = FasterRCNN(rcnn_cfg(kind, dtype, **kw), device=device,
                         seed=s.seed, train=train)
        blobs = detectron_r101(det.backbone.body, s.seed + 90)["blobs"]
        det.backbone.body.load_state_dict(
            {k: torch.from_numpy(v) for k, v in
             convert_c2_resnet(blobs).items()})
        if kind == "mask":
            with torch.no_grad():
                det.roi_box.cls_score.bias[1:5] = 3.0
        return det

    def rcnn_batch(kind, b, h, w, seed, device, n_gt=8):
        """Normalised seeded scenes (BGR255 less PIXEL_MEAN) with n_gt
        boxes an image in 16 slots, their bitmap masks (the box less a
        2 px border) and 17 visible keypoints inside each."""
        g = torch.Generator().manual_seed(seed)
        boxes, labels, mask = gt_boxes(g, b, h, w, 16, n_gt)
        if kind != "mask":
            labels = mask.int()
        im = scene(g, boxes, labels, mask, h, w)
        cfg = rcnn_cfg(kind)
        x = (im.float().flip(-1) - torch.tensor(cfg.INPUT.PIXEL_MEAN)) \
            / torch.tensor(cfg.INPUT.PIXEL_STD)
        tg = dict(boxes=boxes, labels=labels, mask=mask)
        if kind == "mask":
            gm = torch.zeros(b, 16, h, w, dtype=torch.uint8)
            for i in range(b):
                for j in range(n_gt):
                    x0, y0, x1, y1 = (int(v) for v in boxes[i, j])
                    gm[i, j, y0 + 2:min(y1, h) - 2, x0 + 2:min(x1, w) - 2] = 1
            tg["gt_masks"] = gm
        else:
            kp = torch.zeros(b, 16, 17, 3)
            lo, span = boxes[..., :2], (boxes[..., 2:] - boxes[..., :2])
            kp[..., :2] = lo[:, :, None] + torch.rand(b, 16, 17, 2,
                                                      generator=g) * span[:, :, None]
            kp[..., 2] = 2.0 * mask[:, :, None]
            tg["gt_keypoints"] = kp
        sizes = torch.tensor([[h, w]] * b, dtype=torch.int32)
        return (x.contiguous().to(device), sizes.to(device),
                {k: v.to(device) for k, v in tg.items()})

    @contextlib.contextmanager
    def capturing_rcnn_nms():
        """Record every NMS the RPN and the box postprocess run."""
        captured = []
        mods = (rpn_mod, roi_mod)
        reals = [m.nms_keep_mask for m in mods]

        def recording(boxes, scores, valid, thr, labels=None, **kw):
            keep = reals[0](boxes, scores, valid, thr, labels=labels, **kw)
            captured.append((boxes, scores, valid, labels, thr, keep))
            return keep

        for m in mods:
            m.nms_keep_mask = recording
        try:
            yield captured
        finally:
            for m, real in zip(mods, reals):
                m.nms_keep_mask = real

    def moved_and_frozen(det, init):
        frozen = frozen_state(det)
        after = det.state_dict()
        moved = {k for k, p in det.named_parameters()
                 if not torch.equal(p.detach(), init[k])}
        trainable = {k for k, p in det.named_parameters() if p.requires_grad}
        still = [k for k in frozen if not torch.equal(after[k], init[k])]
        return moved, trainable, still

    def sgd(det):
        # maskrcnn-benchmark's SOLVER (BASE_LR 0.02 at IMS_PER_BATCH 16,
        # momentum 0.9, decay 1e-4), the rate scaled linearly to batch 2
        return torch.optim.SGD([p for p in det.parameters() if p.requires_grad],
                               lr=0.0025, momentum=0.9, weight_decay=1e-4)

    def rcnn_step(det, opt, x, sizes, tg):
        losses = det.forward_train(x, tg, sizes)
        opt.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        opt.step()
        return {k: float(v.detach()) for k, v in losses.items()}

    def p_two_stage_small():
        """32. Card against CPU at 128x192, full width, float32, TF32 off,
        the same seeded weights, Mask R-CNN and Keypoint R-CNN: K1's keep
        masks on the card equal the plain NMS on the same inputs; the card's
        and the CPU's keep masks and detections compared (near ties that
        float32 rounding moves are counted and printed); every loss within
        rtol 1e-4; one SGD step's update of every parameter within 2e-3 of
        its tensor's largest + 2e-3 of the whole update's (p_train_small's
        bound)."""
        h, w = 128, 192
        cpu = torch.device("cpu")
        for kind in ("mask", "keypoint"):
            # 64 proposals and 20 detections an image: the CPU's side runs
            # the full-width heads (the keypoint head's 8 x 512 convs) too
            dets = {d: rcnn(kind, "float32", d, train=True, post=64, dets=20)
                    for d in (dev, cpu)}
            data = {d: rcnn_batch(kind, 2, h, w, s.seed + 30, d)
                    for d in (dev, cpu)}
            outs, caps = {}, {}
            for d in (dev, cpu):
                with capturing_rcnn_nms() as captured, torch.no_grad():
                    outs[d] = dets[d].forward_inference(*data[d][:2])
                caps[d] = captured
            check_nms_sets(caps[dev], f"two_stage_small_{kind}")
            flips = [int((a[5].cpu() != b[5]).sum())
                     for a, b in zip(caps[dev], caps[cpu])]
            got = {k: v.cpu() for k, v in outs[dev].items()}
            want = outs[cpu]
            share = matched_share(got, want, box_atol=0.03, score_atol=1.1e-4)
            v = want["valid"]
            branch = "masks" if kind == "mask" else "keypoints"
            both = v & got["valid"]
            s.say(f"two_stage_small_{kind}_forward", f"valid={v.sum(1).tolist()}"
                  f" card={got['valid'].sum(1).tolist()} matched={share} "
                  f"keep-mask flips card/cpu per NMS={flips} {branch} max diff "
                  f"on slots valid in both="
                  f"{float((got[branch][both] - want[branch][both]).abs().max())}")
            assert len(caps[dev]) == 6 and int(v.sum()) > 0, len(caps[dev])
            assert share >= 0.98, share
            init = {d: {k: t.clone() for k, t in dets[d].state_dict().items()}
                    for d in dets}
            losses, upd = {}, {}
            for d in dets:
                losses[d] = rcnn_step(dets[d], sgd(dets[d]), data[d][0],
                                      data[d][1], data[d][2])
                upd[d] = {k: (t.detach().cpu() - init[d][k].cpu()) for k, t in
                          dets[d].named_parameters() if t.requires_grad}
            worst = max(abs(losses[dev][k] - losses[cpu][k])
                        / max(abs(losses[cpu][k]), 1e-12) for k in losses[cpu])
            ratio, at = delta_bound(upd[dev], upd[cpu], 2e-3, 2e-3)
            s.say(f"two_stage_small_{kind}_step", f"losses card={losses[dev]} "
                  f"cpu={losses[cpu]} worst_rel={worst} update bound ratio="
                  f"{ratio} at {at}")
            assert worst <= 1e-4, worst
            assert ratio <= 1.0, (ratio, at)
            assert all(losses[cpu][k] > 0 for k in losses[cpu]), losses[cpu]
            del dets
        torch.cuda.empty_cache()

    def rcnn_eval(key, det, x, sizes, expect_branch):
        """One eval forward with the counters zeroed before and read after
        (K1 once a level in the RPN and once in the box head), the NMS sets
        against the plain version, and the branch's output checked."""
        torch.cuda.synchronize()
        zero_counts()
        with capturing_rcnn_nms() as captured, torch.no_grad():
            out = det.forward_inference(x, sizes)
        torch.cuda.synchronize()
        c = counts()
        check_nms_sets(captured, key)
        nv = out["valid"].sum(1).tolist()
        ks = [cap[2].shape[1] for cap in captured]
        s.say(f"{key}_eval", f"launches={c} K per NMS={ks} valid={nv}")
        assert c["nms_sorted"] == 6, c
        assert not any(v for k, v in c.items() if k != "nms_sorted"), c
        assert all(n > 0 for n in nv), nv
        assert tuple(out[expect_branch].shape[:2]) == (
            2, det.box_cfg.detections_per_img)
        for t in out.values():
            assert torch.isfinite(t.float()).all()
        st.setdefault("new_launches", {})[key] = c
        return out, ks

    def rcnn_train(key, kind, dtype, x, sizes, tg, steps=2, **kw):
        """``steps`` SGD steps from the seeded state, the counters read
        after (K1 5 times a step, in the RPN), then the step timed."""
        det = rcnn(kind, dtype, dev, train=True, **kw)
        opt = sgd(det)
        init = {k: v.clone() for k, v in det.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with capturing_rcnn_nms() as captured:
            losses = [rcnn_step(det, opt, x, sizes, tg) for _ in range(steps)]
        torch.cuda.synchronize()
        c = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moved, trainable, still = moved_and_frozen(det, init)
        assert all(p.dtype == torch.float32 for p in det.parameters())
        s.say(f"{key}_train_{dtype}", f"losses={losses} launches={c} "
              f"trainable={len(trainable)} moved={len(moved & trainable)} "
              f"frozen_changed={len(still)} peak_gib={peak}")
        assert all(math.isfinite(v) and v >= 0 for ls in losses
                   for v in ls.values()), losses
        assert all(v > 0 for v in losses[0].values()), losses[0]
        assert moved == trainable and not still, sorted(trainable - moved)[:5]
        assert c["nms_sorted"] == 5 * steps, c
        assert not any(v for k, v in c.items() if k != "nms_sorted"), c
        st.setdefault("new_launches", {})[f"{key}_train_step"] = {
            k: v // steps for k, v in c.items()}
        def timed():
            det.load_state_dict(init)
            rcnn_step(det, opt, x, sizes, tg)
        ms = cuda_time(timed, 2, 1)
        s.say(f"{key}_train_{dtype}_step_ms", f"{ms} ({2e3 / ms} img/s; "
              "batch 2 at 800x1344, CUDA events over 2 steps after a warm "
              "one, each from the seeded state)")
        st.setdefault("new_times", {})[f"{key}_train_{dtype}"] = dict(
            ms=ms, img_s=2e3 / ms, peak_gib=peak)
        return det, captured

    def rcnn_roi_share(key, det, x, sizes, train_rois=None):
        """The eval forward cut at its layers, each timed alone; the share
        of the RoI stage (poolers, box head, postprocess, branch head) that
        the poolers (ROIAlign) take."""
        with torch.no_grad():
            feats = list(det.backbone(x))
            obj, reg = det.rpn(feats)
            anchors = det._anchors(feats, det.rpn_cfg_test)
            props = rpn_mod.rpn_proposals(det.rpn_cfg_test, anchors, obj, reg,
                                          sizes)
            b, n = props["boxes"].shape[:2]
            rois = props["boxes"].reshape(-1, 4)
            bidx = torch.arange(b, device=dev).repeat_interleave(n)
            pooled = roi_mod.fpn_pooler(det.box_cfg, feats[:4], rois, bidx)
            cls, bb = det.roi_box(pooled)
            dets_ = roi_mod.roi_box_postprocess(
                det.box_cfg, cls.reshape(b, n, -1), bb.reshape(b, n, -1),
                props["boxes"], props["valid"], sizes)
            drois = dets_["boxes"].reshape(-1, 4)
            dbidx = torch.arange(b, device=dev).repeat_interleave(
                drois.shape[0] // b)
            bcfg = det.mask_cfg if det.mask_on else det.kp_cfg
            bhead = det.roi_mask if det.mask_on else det.roi_keypoint
            bpooled = roi_mod.pool_branch(det.box_cfg, bcfg, feats[:4], drois,
                                          dbidx)
            parts = {
                "backbone": lambda: det.backbone(x),
                "rpn_head": lambda: det.rpn(feats),
                "proposals": lambda: rpn_mod.rpn_proposals(
                    det.rpn_cfg_test, anchors, obj, reg, sizes),
                "box_pooler": lambda: roi_mod.fpn_pooler(
                    det.box_cfg, feats[:4], rois, bidx),
                "box_head": lambda: det.roi_box(pooled),
                "box_postprocess": lambda: roi_mod.roi_box_postprocess(
                    det.box_cfg, cls.reshape(b, n, -1), bb.reshape(b, n, -1),
                    props["boxes"], props["valid"], sizes),
                "branch_pooler": lambda: roi_mod.pool_branch(
                    det.box_cfg, bcfg, feats[:4], drois, dbidx),
                "branch_head": lambda: bhead(bpooled),
            }
            if train_rois is not None:  # the training RoIs, 2 x 2000
                tr, tb = train_rois
                parts["train_box_pooler"] = lambda: roi_mod.fpn_pooler(
                    det.box_cfg, feats[:4], tr, tb)
                tpooled = roi_mod.fpn_pooler(det.box_cfg, feats[:4], tr, tb)
                parts["train_box_head"] = lambda: det.roi_box(tpooled)
                parts["train_branch_pooler"] = lambda: roi_mod.pool_branch(
                    det.box_cfg, bcfg, feats[:4], tr, tb)
                tbp = roi_mod.pool_branch(det.box_cfg, bcfg, feats[:4], tr, tb)
                parts["train_branch_head"] = lambda: bhead(tbp)
            times = {k: cuda_time(fn, 5, 1) for k, fn in parts.items()}
        roi = ("box_pooler", "box_head", "box_postprocess", "branch_pooler",
               "branch_head")
        share = (times["box_pooler"] + times["branch_pooler"]) / sum(
            times[k] for k in roi)
        times["roi_align_share_eval"] = share
        if train_rois is not None:
            tro = ("train_box_pooler", "train_box_head", "train_branch_pooler",
                   "train_branch_head")
            times["roi_align_share_train_forward"] = (
                times["train_box_pooler"] + times["train_branch_pooler"]) / sum(
                times[k] for k in tro)
        s.say(f"{key}_parts_ms", times)
        st.setdefault("new_times", {})[f"{key}_parts"] = times

    def p_mask_rcnn_main():
        """33. Mask R-CNN R-50-FPN (e2e_mask_rcnn_R_50_FPN_1x) at full width,
        batch 2 at 800x1344: eval in float32 and bf16 (masks (2, 100, 28,
        28)), 2 SGD steps in float32 and in bf16 over masters, timed, peak
        memory; then at scan_tpu's PRE_NMS_TOP_N 6000 / 12000, so that K1
        runs at K = 6000 and 12,000 on real proposals, each set held to
        the plain NMS; ROIAlign's share of the RoI stage."""
        free_card()
        x, sizes, tg = rcnn_batch("mask", 2, H, W, s.seed + 31, dev, n_gt=12)
        for dt in ("float32", "bfloat16"):
            det = rcnn("mask", dt, dev)
            out, _ = rcnn_eval(f"mask_rcnn_eval_{dt}", det, x, sizes, "masks")
            assert tuple(out["masks"].shape) == (2, 100, 28, 28)
            if dt == "bfloat16":
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_time(lambda: det.forward_inference(x, sizes), 5, 2)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                s.say("mask_rcnn_eval_bf16_ms", f"{ms} ({2e3 / ms} img/s; "
                      f"peak {peak} GiB; batch 2 at 800x1344, CUDA events "
                      "over 5 after 2 warm)")
                st.setdefault("new_times", {})["mask_rcnn_eval_bf16"] = dict(
                    ms=ms, img_s=2e3 / ms, peak_gib=peak)
                with torch.no_grad():  # the training RoIs for the share
                    feats = list(det.backbone(x))
                    obj, reg = det.rpn(feats)
                    props = rpn_mod.rpn_proposals(
                        det.rpn_cfg_train,
                        det._anchors(feats, det.rpn_cfg_train), obj, reg,
                        sizes)
                tr = props["boxes"].reshape(-1, 4)
                tb = torch.arange(2, device=dev).repeat_interleave(
                    tr.shape[0] // 2)
                rcnn_roi_share("mask_rcnn_bf16", det, x, sizes, (tr, tb))
            del det
            torch.cuda.empty_cache()
        st["new_launches"]["mask_rcnn_eval"] = st["new_launches"].pop(
            "mask_rcnn_eval_float32")
        st["new_launches"].pop("mask_rcnn_eval_bfloat16")
        for dt in ("float32", "bfloat16"):
            det, _ = rcnn_train("mask_rcnn", "mask", dt, x, sizes, tg)
            del det
            torch.cuda.empty_cache()
        # scan_tpu's defaults: K = 6000 a level at test, 12,000 at train
        det = rcnn("mask", "bfloat16", dev, pre_test=6000, pre_train=12000)
        _, ks = rcnn_eval("mask_rcnn_eval_pre6000", det, x, sizes, "masks")
        assert max(ks) == 6000, ks
        st["new_launches"].pop("mask_rcnn_eval_pre6000")
        del det
        torch.cuda.empty_cache()
        det, captured = rcnn_train("mask_rcnn_pre12000", "mask", "bfloat16",
                                   x, sizes, tg, steps=1, pre_test=6000,
                                   pre_train=12000)
        ks = [cap[2].shape[1] for cap in captured]
        check_nms_sets(captured, "mask_rcnn_train_pre12000")
        s.say("mask_rcnn_train_pre12000_K", ks)
        assert max(ks) == 12000, ks
        del det, captured
        torch.cuda.empty_cache()

    def p_keypoint_rcnn():
        """34. Keypoint R-CNN R-50-FPN (e2e_keypoint_rcnn_R_50_FPN_1x: 2
        classes, 17 keypoints, 8 x 512 convs) at full width, batch 2 at
        800x1344: the bf16 eval (keypoints (2, 100, 17, 3)), timed, and
        one SGD step in float32 and in bf16 over masters, timed."""
        free_card()
        x, sizes, tg = rcnn_batch("keypoint", 2, H, W, s.seed + 32, dev,
                                  n_gt=12)
        det = rcnn("keypoint", "bfloat16", dev)
        out, _ = rcnn_eval("keypoint_rcnn_eval", det, x, sizes, "keypoints")
        assert tuple(out["keypoints"].shape) == (2, 100, 17, 3)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time(lambda: det.forward_inference(x, sizes), 5, 2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s.say("keypoint_rcnn_eval_bf16_ms", f"{ms} ({2e3 / ms} img/s; peak "
              f"{peak} GiB)")
        st.setdefault("new_times", {})["keypoint_rcnn_eval_bf16"] = dict(
            ms=ms, img_s=2e3 / ms, peak_gib=peak)
        rcnn_roi_share("keypoint_rcnn_bf16", det, x, sizes)
        del det
        torch.cuda.empty_cache()
        for dt in ("float32", "bfloat16"):
            det, _ = rcnn_train("keypoint_rcnn", "keypoint", dt, x, sizes, tg,
                                steps=1)
            del det
            torch.cuda.empty_cache()

    # ---- 35-40: MobileNetV2, FBNet and VGG16-BN bodies, deform conv, the
    # single-image path ------------------------------------------------------
    from scan_tpu_torch.demo import Predictor
    from scan_tpu_torch.modeling.backbone.fbnet import FBNET_ARCHS
    from scan_tpu_torch.ops.deform_conv import deform_conv2d
    from scan_tpu_torch.tools import demo as demo_tool
    mnv2 = ("MODEL.BACKBONE.CONV_BODY", "MNV2-FPN-RETINANET")
    vgg_bn = ("MODEL.BACKBONE.VGG_W_BN", True)

    def fbnet(arch):
        return ("MODEL.BACKBONE.CONV_BODY", "FBNet", "MODEL.FBNET.ARCH", arch)

    def level_dist(a, b, ref):
        """Per level: max|a - b| over the largest |ref| of the level."""
        return [float((x.float().cpu() - y.float().cpu()).abs().max()
                      / z.float().cpu().abs().max())
                for x, y, z in zip(a, b, ref)]

    def body_small(key, opts, dtypes=("float32", "bfloat16"), step=False):
        """C2F on another body at full width, 128x192, card against CPU
        from the same seeded weights (cls bias 0: spread scores). float32,
        TF32 off: each C level within 1e-3 of its largest value (the
        per-channel norms of the mobile bodies spread float32 rounding over
        the deep levels' few pixels), the same number of valid detections,
        at least 95% of the CPU's matched (boxes 0.05 px, scores 1e-3).
        bf16 (an eval detector, bf16 parameters): each level's card-CPU
        distance within twice the CPU's own bf16-float32 distance, the
        card's detections finite. With ``step`` one float32 DA step
        (forward_target False) on each: metrics within rtol 1e-3."""
        h, w = 128, 192
        roles = (("card", dev), ("cpu", torch.device("cpu")))
        im, sizes = images(2, h, w, s.seed + 1)
        feats = {}
        for dt in dtypes:
            cfg = epm(C2F, dt, opts)
            pair = {role: build_detector(cfg, device=d, seed=s.seed)
                    for role, d in roles}
            with torch.no_grad():
                for d in pair.values():
                    d.fcos.cls_logits.bias.zero_()
                for role, x in (("card", im), ("cpu", im.cpu())):
                    feats[dt, role] = pair[role].backbone.body(
                        pair[role]._prep_images(x))
                got = {k: v.cpu() for k, v in
                       pair["card"].forward_inference(im, sizes).items()}
                want = pair["cpu"].forward_inference(im.cpu(), sizes.cpu())
            card = level_dist(feats[dt, "card"], feats[dt, "cpu"],
                              feats[dt, "cpu"])
            if dt == "float32":
                share = matched_share(got, want, box_atol=0.05,
                                      score_atol=1e-3)
                tight = matched_share(got, want, box_atol=0.03,
                                      score_atol=1.1e-4)
                s.say(f"{key}_small_float32", f"C levels card-cpu rel={card} "
                      f"valid={want['valid'].sum(1).tolist()} matched="
                      f"{share} (at 0.03 px / 1.1e-4: {tight})")
                assert max(card) <= 1e-3, card
                assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
                assert share >= 0.95 and int(want["valid"].sum()) > 0, share
            else:
                own = level_dist(feats[dt, "cpu"], feats["float32", "cpu"],
                                 feats["float32", "cpu"])
                card = level_dist(feats[dt, "card"], feats[dt, "cpu"],
                                  feats["float32", "cpu"])
                v = got["valid"]
                s.say(f"{key}_small_bf16", f"C levels card-cpu rel={card} "
                      f"cpu bf16-float32 rel={own} valid={v.sum(1).tolist()}")
                assert all(c <= 2 * o for c, o in zip(card, own)), (card, own)
                assert torch.isfinite(got["boxes"][v]).all()
                assert torch.isfinite(got["scores"][v]).all()
            if step and dt == "float32":
                m = {}
                for role, d in roles:
                    det = build_detector(cfg, device=d, seed=s.seed,
                                         train=True)
                    m[role], _, _ = run_step(det, cfg, *train_batches(
                        2, h, w, s.seed + 5, d), False)
                mc, mw = m["card"], m["cpu"]
                worst = max(abs(mc[k] - mw[k]) / max(abs(mw[k]), 1e-12)
                            for k in mw)
                s.say(f"{key}_small_step", f"metrics worst_rel={worst} "
                      f"loss_total card/cpu={mc['loss_total']}/"
                      f"{mw['loss_total']}")
                assert set(mc) == set(mw) and worst <= 1e-3, worst
            del pair

    def body_train(key, opts, k2_per_step=0, dtypes=("float32", "bfloat16")):
        """The DA step of C2F on another body at full width, batch 4 + 4 at
        800x1344 (seeded scenes), float32 (TF32 off) and bf16 over float32
        masters, in both ``forward_target`` variants, each from the seeded
        state: every loss finite, the frozen parameters unchanged and every
        trainable backbone parameter moved, K2 ``k2_per_step`` a step and
        no other kernel; then each variant timed (CUDA events over 2 steps
        after a warm one, each from the seeded state) with the peak
        memory."""
        free_card()
        batches = train_batches(4, H, W, s.seed + 10, dev, n_boxes=100, k=16,
                                scenes=True)
        for dt in dtypes:
            cfg = epm(C2F, dt, opts)
            det, _, _, step = train_setup(cfg, dev)
            frozen = {k for k, p in det.named_parameters()
                      if not p.requires_grad}
            init = {k: v.clone() for k, v in det.state_dict().items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            for ft in (True, False):
                det.load_state_dict(init)
                gen = torch.Generator(device=dev).manual_seed(3000 + ft)
                _, metrics = step(det.proto_state(), *batches,
                                  forward_target=ft, generator=gen)
                m = {k: float(v) for k, v in metrics.items()}
                assert all(math.isfinite(v) for v in m.values()), m
                assert ("transfer_loss_gt" in m) == ft
                after = dict(det.named_parameters())
                moved = {k for k, p in after.items()
                         if not torch.equal(p.detach(), init[k])}
                body = {k for k, p in after.items() if p.requires_grad
                        and k.startswith("backbone.")}
                still = [k for k in frozen if k in moved]
                s.say(f"{key}_train_{dt}_ft{int(ft)}",
                      f"loss_total={m['loss_total']} trainable_backbone="
                      f"{len(body)} moved={len(body & moved)} frozen="
                      f"{len(frozen)} frozen_moved={len(still)}")
                assert body <= moved, sorted(body - moved)[:5]
                assert not still, still[:5]
            torch.cuda.synchronize()
            c = counts()
            s.say(f"{key}_train_{dt}_launches", c)
            assert c["vgg_stem_fused"] == 2 * k2_per_step, c
            assert not any(v for k, v in c.items() if k != "vgg_stem_fused"), c
            st.setdefault("new_launches", {})[f"{key}_da_step"] = {
                k: v // 2 for k, v in c.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            for ft in (True, False):
                def timed():
                    det.load_state_dict(init)
                    step(det.proto_state(), *batches, forward_target=ft,
                         generator=torch.Generator(device=dev).manual_seed(1))
                ms = cuda_time(timed, 2, 1)
                s.say(f"{key}_train_{dt}_ft{int(ft)}_step_ms",
                      f"{ms} ({8e3 / ms} img/s source + target; peak "
                      f"{peak} GiB)")
                st.setdefault("new_times", {})[
                    f"{key}_da_{dt}_ft{int(ft)}"] = dict(
                    ms=ms, img_s=8e3 / ms, peak_gib=peak)
            del det, step
            torch.cuda.empty_cache()

    def body_int8(key, opts):
        """The int8 eval (TPU.INT8_INFERENCE, bf16) of C2F on a body that
        stays fp (``scan_tpu`` passes ``quant`` only to a body with that
        field): calibrated on one seeded batch of 4, then
        ``compute_predictions`` at batch 4, 800x1344 (K1 once, no K2, no
        int8 stem kernel), and the forward at batch 8 timed."""
        free_card()
        cfg = epm(C2F, "bfloat16", opts + ("TPU.INT8_INFERENCE", True))
        det = build_detector(cfg, device=dev, seed=s.seed)
        with torch.no_grad():
            det.fcos.cls_logits.bias.fill_(-2.0)
        im, sizes = images(4, H, W, s.seed)
        det.calibrate_int8([im])
        body_q = [n for n, m in det.backbone.body.named_modules()
                  if getattr(m, "quant", False)]
        fpn_q = [n for n, m in det.backbone.fpn.named_modules()
                 if getattr(m, "quant", False)]
        assert not body_q and fpn_q, (body_q, fpn_q)
        batch = dict(images=im.cpu().numpy(), sizes=sizes.cpu().numpy(),
                     scales=np.ones((4, 2), np.float32), indices=np.arange(4))
        torch.cuda.synchronize()
        zero_counts()
        preds = compute_predictions(det, [batch], progress_every=0)
        torch.cuda.synchronize()
        c = counts()
        n = check_preds(preds, 4)
        s.say(f"{key}_int8_eval", f"detections={n} launches={c} "
              f"int8 convs: body 0, fpn {len(fpn_q)}")
        assert c["nms_sorted"] == 1 and sum(c.values()) == 1, c
        st.setdefault("new_launches", {})[f"{key}_int8_eval"] = c
        im8, sizes8 = images(8, H, W, s.seed + 2)
        ms = cuda_time(lambda: det.forward_inference(im8, sizes8), 5, 2)
        s.say(f"{key}_int8_forward_b8", f"ms={ms} img/s={8e3 / ms}")
        st.setdefault("new_times", {})[f"{key}_int8_eval_b8"] = dict(
            ms=ms, img_s=8e3 / ms)
        del det
        torch.cuda.empty_cache()

    def p_mobile_small():
        """35. MobileNetV2 and the five FBNet archs (scale 1, divisor 1)
        card against CPU (``body_small``), MobileNetV2 with a DA step."""
        body_small("mnv2", mnv2, step=True)
        for arch in sorted(FBNET_ARCHS):
            body_small(f"fbnet_{arch}", fbnet(arch))

    def depthwise_probe():
        """MobileNetV2's body at batch 8, 800x1344, bf16 (an eval detector):
        its 17 depthwise convs alone, each on a seeded input of its own
        shape, as the body runs them (channels_last) and on NCHW-contiguous
        copies, summed; then the body under ``torch.profiler``, the 8
        kernels with the most device time."""
        from torch.profiler import ProfilerActivity, profile

        free_card()
        det = build_detector(epm(C2F, "bfloat16", mnv2), device=dev,
                             seed=s.seed)
        body = det.backbone.body
        x = det._prep_images(images(8, H, W, s.seed)[0])
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda m, a: seen.append((m, tuple(a[0].shape))))
            for n, m in body.named_modules() if n.endswith("depthwise")]
        with torch.no_grad():
            body(x)
        for h in hooks:
            h.remove()
        g = torch.Generator(device=dev).manual_seed(s.seed)
        total = {"channels_last": 0.0, "nchw": 0.0}
        for m, shp in seen:
            xin = torch.randn(shp, generator=g, device=dev,
                              dtype=torch.bfloat16).permute(0, 3, 1, 2)
            for tag, xi, wi in (("channels_last", xin, m.weight),
                                ("nchw", xin.contiguous(),
                                 m.weight.contiguous())):
                total[tag] += cuda_time(lambda: F.conv2d(
                    xi, wi, None, m.stride, m.padding, 1, m.groups), 5, 2)
        body_ms = cuda_time(lambda: body(x), 5, 2)
        s.say("mnv2_depthwise_bf16_b8", f"{len(seen)} convs, sum "
              f"channels_last={total['channels_last']} ms nchw="
              f"{total['nchw']} ms; the body {body_ms} ms")
        st.setdefault("new_times", {})["mnv2_depthwise_bf16_b8"] = dict(
            total, body_ms=body_ms)
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            body(x)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
                rows.append((t / 1e3, e.count, e.key[:70]))
        rows.sort(reverse=True)
        s.say("mnv2_body_profile_top8", f"(device ms, calls, name) "
              f"{rows[:8]}" if rows else "no device time in the trace "
              "(not measured)")
        del det

    def p_mnv2_main():
        """36. C2F on MobileNetV2: the eval main path (``eval_main``, K1
        once a forward, no K2), its depthwise convs and body profile
        (``depthwise_probe``), the DA steps (``body_train``) and the int8
        eval (``body_int8``)."""
        eval_main("mnv2", C2F, 0, mnv2)
        depthwise_probe()
        body_train("mnv2", mnv2)
        body_int8("mnv2", mnv2)

    def p_fbnet_main():
        """37. C2F on FBNet ``default``: eval and DA steps as MobileNetV2's;
        each other arch one bf16 eval forward at batch 4, 800x1344 (K1
        once, no K2), timed."""
        eval_main("fbnet_default", C2F, 0, fbnet("default"))
        body_train("fbnet_default", fbnet("default"))
        im, sizes = images(4, H, W, s.seed)
        for arch in sorted(set(FBNET_ARCHS) - {"default"}):
            free_card()
            det = build_detector(epm(C2F, "bfloat16", fbnet(arch)),
                                 device=dev, seed=s.seed)
            with torch.no_grad():
                det.fcos.cls_logits.bias.fill_(-2.0)
                torch.cuda.synchronize()
                zero_counts()
                out = det.forward_inference(im, sizes)
                torch.cuda.synchronize()
            c = counts()
            v = out["valid"]
            assert c["nms_sorted"] == 1 and c["group_norm_relu"] > 0, c
            assert sum(c.values()) == 1 + c["group_norm_relu"], c
            assert int(v.sum()) > 0 and torch.isfinite(out["boxes"][v]).all()
            ms = cuda_time(lambda: det.forward_inference(im, sizes), 3, 1)
            s.say(f"fbnet_{arch}_eval_bf16_b4", f"ms={ms} img/s={4e3 / ms} "
                  f"valid={v.sum(1).tolist()} launches={c}")
            st.setdefault("new_times", {})[f"fbnet_{arch}_eval_bf16_b4"] = \
                dict(ms=ms, img_s=4e3 / ms)
            del det

    def p_vgg_bn():
        """38. C2F on VGG16 with BN: card against CPU (``body_small``), the
        eval main path (K1 once a forward, K2 never), the DA steps (no
        kernel) and K2's count on one plain VGG forward beside it (1)."""
        body_small("vgg_bn", vgg_bn)
        eval_main("vgg_bn", C2F, 0, vgg_bn)
        im, sizes = images(1, H, W, s.seed)
        plain = build_detector(epm(C2F, "bfloat16"), device=dev, seed=s.seed)
        bn = build_detector(epm(C2F, "bfloat16", vgg_bn), device=dev,
                            seed=s.seed)
        got = {}
        for tag, d in (("vgg", plain), ("vgg_bn", bn)):
            torch.cuda.synchronize()
            zero_counts()
            d.forward_inference(im, sizes)
            torch.cuda.synchronize()
            c = counts()
            got[tag] = (c["vgg_stem_fused"], c["bias_relu"])
        s.say("k2_and_bias_relu_launches_one_forward",
              f"plain VGG16={got['vgg']} VGG16-BN={got['vgg_bn']}")
        assert got == {"vgg": (1, VGG_CONVS), "vgg_bn": (0, 0)}, got
        del plain, bn
        body_train("vgg_bn", vgg_bn)

    def p_deform():
        """39. ``deform_conv2d`` at C2F's P3 size, (4, 100, 168, 256) ->
        256, 3x3, offsets seeded within +-4 px, with and without the DCNv2
        mask and a bias, card against CPU in float32 (TF32 off): within
        rtol 1e-4 and 1e-4 of the output's largest value; timed on the
        card, beside cuDNN's plain 3x3 conv of the same shapes (the zero
        offset case's library call) and the bound."""
        g = torch.Generator().manual_seed(s.seed + 39)
        b, h, w, c, o = 4, 100, 168, 256, 256
        x = torch.randn(b, h, w, c, generator=g)
        off = (torch.rand(b, h, w, 18, generator=g) * 8 - 4)
        wt = torch.randn(3, 3, c, o, generator=g) / math.sqrt(9 * c)
        bias = torch.randn(o, generator=g)
        mask = torch.rand(b, h, w, 9, generator=g)
        xd, offd, wd, bd, md = (t.to(dev) for t in (x, off, wt, bias, mask))
        for tag, m_c, m_d in (("dcn_v1", None, None), ("dcn_v2", mask, md)):
            want = deform_conv2d(x, off, wt, bias, m_c)
            got = deform_conv2d(xd, offd, wd, bd, m_d).cpu()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            s.say(f"deform_{tag}_check", f"max_abs_err={err} max|cpu|={scale}")
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
            ms = cuda_time(lambda: deform_conv2d(xd, offd, wd, bd, m_d), 5, 2)
            st.setdefault("new_times", {})[f"deform_{tag}"] = ms
            s.say(f"deform_{tag}_ms", ms)
        xc = xd.permute(0, 3, 1, 2)
        wc = wd.permute(3, 2, 0, 1).contiguous()
        lib = cuda_time(lambda: F.conv2d(xc, wc, bd, padding=1), 5, 2)
        flops = 2 * b * h * w * 9 * c * o
        nbytes = 4 * (x.numel() + off.numel() + mask.numel() + wt.numel()
                      + b * h * w * o)
        bound = max(flops / PEAK_FP32_S, nbytes / PEAK_BYTES_S) * 1e3
        s.say("deform_library_conv3x3_ms", f"{lib} (cuDNN, float32, TF32 "
              f"off, zero offsets' equivalent); bound_ms={bound} (float32 "
              f"CUDA cores, {flops / 1e9:.1f} GFLOP)")
        st["new_times"]["deform_library_conv3x3"] = lib
        st["new_times"]["deform_bound"] = bound

    def p_single_image():
        """40. The single-image path: a seeded 1024x2048 PNG; a C2F
        checkpoint of the seeded detector with cls_logits' bias drawn per
        class from a seeded N(0, 0.5) (so there are detections, and the
        classes' scores do not tie); ``python -m scan_tpu_torch.cli detect``
        on it as a process (exit 0, the JSON written, every box inside the
        frame) and the same module run in this process with the counters
        zeroed (K2 and K1 launched, K1's keep mask at B = 1 against the
        plain NMS on the path's own candidates). The in-process run takes
        PyTorch's default TF32 settings for its span (cuDNN's float32
        convs in TF32, matmuls not), as the fresh process has them; the
        two runs' detections must then match as sets: as many, and each
        with one of the same label in the other run whose box lies within
        0.5 px and whose score within 1e-4 (the same kernels on the same
        inputs; the bounds leave room for an algorithm cuDNN picks
        otherwise in another process). ``Predictor.detect`` per frame (ms,
        after 2 warm frames): decode to detections, and the forward alone,
        float32 (the config's) and bf16; ``scan_tpu_torch/tools/demo.py``
        on the same file writes a drawn PNG."""
        free_card()
        root = tmp_root / "single_image"
        root.mkdir(exist_ok=True)
        g = torch.Generator().manual_seed(s.seed + 40)
        boxes, labels, mask = gt_boxes(g, 1, CITY_H, CITY_W, 8, 8)
        frame = scene(g, boxes, labels, mask, CITY_H, CITY_W)[0].numpy()
        png = root / "frame.png"
        write_png(png, frame)
        det = build_detector(c2f(), device=dev, seed=s.seed)
        with torch.no_grad():
            bias = det.fcos.cls_logits.bias
            bias.copy_(0.5 * torch.randn(bias.shape, generator=g).to(bias))
        weights = Checkpointer(str(root / "ckpt"), det).save("model_final")
        del det
        out_json = root / "dets.json"
        argv = ["detect", "--config-file", str(C2F), "--weights", weights,
                "--confidence-threshold", "0", "--output", str(out_json),
                str(png)]
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "scan_tpu_torch.cli",
                               *argv], cwd=HERE, capture_output=True,
                              text=True, timeout=600)
        s.say("cli_detect_process", f"rc={proc.returncode} "
              f"{time.time() - t0:.1f} s; {proc.stdout.splitlines()[:1]}")
        assert proc.returncode == 0, proc.stderr[-2000:]
        res = json.loads(out_json.read_text())
        def check_json():
            dets = json.loads(out_json.read_text())[str(png)]
            out_json.unlink()
            assert dets and all(
                set(d) == {"box", "score", "label", "label_name"}
                for d in dets)
            for d in dets:
                x1, y1, x2, y2 = d["box"]
                assert 0 <= x1 <= x2 <= CITY_W and 0 <= y1 <= y2 <= CITY_H, d
            return dets

        dets = check_json()
        torch.cuda.synchronize()
        zero_counts()
        old_argv = sys.argv
        sys.argv = ["scan_tpu_torch.cli", *argv]
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        # a fresh process's defaults, as the subprocess above ran
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            import runpy
            with capturing_nms() as captured:
                runpy.run_module("scan_tpu_torch.cli", run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), e.code
        finally:
            sys.argv = old_argv
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        torch.cuda.synchronize()
        c = counts()
        s.say("cli_detect_launches", c)
        assert c == dict(c, nms_sorted=1, vgg_stem_fused=1,
                         bias_relu=VGG_CONVS) and sum(
            c.values()) == 2 + VGG_CONVS + c["group_norm_relu"], c
        assert c["group_norm_relu"] > 0, c
        assert [cap[0].shape[0] for cap in captured] == [1], [
            cap[0].shape for cap in captured]
        check_nms_sets(captured, "single_image")
        again = check_json()

        def matched(xs, ys):
            return sum(any(
                x["label"] == y["label"]
                and abs(x["score"] - y["score"]) <= 1e-4
                and max(abs(a - b) for a, b in zip(x["box"], y["box"])) <= 0.5
                for y in ys) for x in xs)
        fwd, back = matched(again, dets), matched(dets, again)
        scores = sorted(d["score"] for d in dets)
        gap = min((b - a for a, b in zip(scores, scores[1:])), default=None)
        s.say("cli_detect_in_process_vs_process", f"detections "
              f"{len(again)}/{len(dets)}, matched {fwd} and {back} (label, "
              f"box within 0.5 px, score within 1e-4); distinct scores "
              f"{len(set(scores))}, least gap {gap}")
        assert len(again) == len(dets) == fwd == back, (len(again), len(dets),
                                                        fwd, back)
        st.setdefault("new_launches", {})["single_image"] = c
        from PIL import Image

        for dt in ("float32", "bfloat16"):
            pred = Predictor(c2f(dt), weights, confidence_threshold=0.0)
            decode = lambda: np.asarray(  # noqa: E731
                Image.open(png).convert("RGB"))
            for _ in range(2):
                pred.detect(decode())
            torch.cuda.synchronize()
            t0 = time.time()
            n = 5
            for _ in range(n):
                found = pred.detect(decode())
            frame_ms = (time.time() - t0) * 1e3 / n
            batch, size = pred.preprocess(frame)
            assert pred._bucket == (800, 1344) and size == (666, 1332), (
                pred._bucket, size)
            fwd_ms = cuda_time(lambda: pred.forward(batch, size), 5, 2)
            pre_t0 = time.time()
            for _ in range(n):
                pred.preprocess(frame)
            pre_ms = (time.time() - pre_t0) * 1e3 / n
            s.say(f"single_image_{dt}", f"decode_to_detections_ms={frame_ms} "
                  f"forward_ms={fwd_ms} preprocess_ms={pre_ms} "
                  f"detections={len(found)} (1024x2048 PNG, 800x1344 "
                  "bucket, host clock over 5 frames after 2 warm)")
            st.setdefault("new_times", {})[f"single_image_{dt}"] = dict(
                frame_ms=frame_ms, forward_ms=fwd_ms, preprocess_ms=pre_ms)
            del pred
        written = demo_tool.main(["--config-file", str(C2F), "--weights",
                                  weights, "--images", str(png), "--out-dir",
                                  str(root / "drawn"),
                                  "--confidence-threshold", "0.3"])
        drawn = np.asarray(Image.open(written[0]).convert("RGB"))
        s.say("tools_demo", f"wrote {written[0]} shape={drawn.shape} "
              f"changed_pixels={int((drawn != frame).any(-1).sum())}")
        assert drawn.shape == frame.shape and (drawn != frame).any()

    # ---- 41-45: profiling, data parallelism, the harnesses ---------------
    import torch.distributed as dist

    from scan_tpu_torch.engine.dp import make_dp_da_train_step
    from scan_tpu_torch.parallel import mesh
    from scan_tpu_torch.tools import (da_efficacy, loader_bench, nan_bisect,
                                      profile_inference, stability_run,
                                      trace_summary)
    from scan_tpu_torch.utils import profiler

    def kernel_names(summary, part):
        return [k for k in summary["device_kernels"] if part in k["name"]]

    def say_trace(tag, summary, top=8):
        busy, window = summary["device_busy_ms"], summary["window_ms"]
        s.say(f"{tag}_trace", f"window_ms={window} device_busy_ms={busy} "
              f"idle_share={1 - busy / window if window else None} "
              f"total_self_ms={summary['total_ms']}")
        s.say(f"{tag}_top_device_kernels", [
            (k["name"][:90], k["count"], k["total_ms"])
            for k in summary["device_kernels"][:top]])
        s.say(f"{tag}_top_host_ops", [
            (k["name"][:60], k["count"], k["total_ms"])
            for k in summary["host_ops"][:top]])

    def p_profile_inference():
        """41. ``tools/profile_inference.py`` on C2F, bf16, precision,
        batch 8 at 800x1344, 5 calls a prefix after 2 warm-up calls (CUDA
        events), with ``--trace``: the whole-forward row within 25% of the
        ``timing`` phase's forward; each prefix no faster than the one
        before it, less the spread of the ``timing`` phase's own turns (at
        least 5%); ``trace_summary`` of the trace lists K2's and K1's
        kernels and ``window_ms > device_busy_ms > 0``. The counters are
        zeroed before and read after."""
        free_card()
        trace_dir = tmp_root / "profile_trace"
        zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = profile_inference.main([
                "--batch", "8", "--iters", "5", "--mode", "precision",
                "--trace", str(trace_dir), "--seed", str(s.seed)])
        torch.cuda.synchronize()
        launched = counts()
        for line in buf.getvalue().splitlines():
            print(line)
        ms = {k: v * 1e3 for k, v in rows.items()}
        s.say("profile_inference_rows_ms", ms)
        s.say("profile_inference_launches", launched)
        st.setdefault("new_launches", {})["profile_inference"] = launched
        timing = s.record.get("forward_bf16_precision_b8_ms")
        turns = [t for tag, t in st.get("eval_masters", {}).get("turns", [])
                 if tag == "cast"]
        spread = max(abs(turns[0] - turns[-1]) / (sum(turns) / len(turns)),
                     0.05) if len(turns) > 1 else 0.05
        s.say("profile_inference_vs_timing",
              f"full={ms['full(+postprocess)']} timing={timing} "
              f"spread={spread}")
        assert timing and abs(ms["full(+postprocess)"] / timing - 1) <= 0.25
        vals = list(ms.values())
        assert all(b >= a * (1 - spread) for a, b in zip(vals, vals[1:])), ms
        assert launched["vgg_stem_fused"] > 0 and launched["nms_sorted"] > 0
        assert (launched["bias_relu"]
                == VGG_CONVS * launched["vgg_stem_fused"]), launched
        summary = trace_summary.summarise(     # every op, for the search
            str(trace_dir / profiler.TRACE_FILE), 1 << 30)
        say_trace("profile_inference", summary)
        assert kernel_names(summary, "stem_bf16_kernel"), "no K2 in the trace"
        assert kernel_names(summary, "nms_"), "no K1 in the trace"
        assert summary["window_ms"] > summary["device_busy_ms"] > 0

    def p_train_bf16_trace():
        """42. One C2F bf16 DA step (float32 masters), 4 + 4 at 800x1344,
        seeded scenes, from the seeded state, in each ``forward_target``
        variant (three untraced steps of each first, the last two timed with
        CUDA events, each from the restored state), under
        ``utils.profiler.torch_trace``: the traced window, the device's busy
        time (the union of its kernels) and idle share, the busy time over
        the untraced step's time, the kernel count, the top device kernels
        and host ops. Asserted: the trace parsed and K2 launched twice in
        it."""
        free_card()
        cfg = c2f("bfloat16")
        det, _, _, step = train_setup(cfg, dev)
        init = {k: v.detach().clone() for k, v in det.state_dict().items()}
        bs, bt = train_batches(4, H, W, s.seed + 10, dev, n_boxes=100, k=16,
                               scenes=True)

        def restore():
            with torch.no_grad():
                for k, v in det.state_dict().items():
                    v.copy_(init[k])
            torch.cuda.synchronize()

        for ft in (True, False):
            untraced = []
            for rep in range(3):  # rep 0 warms up
                restore()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                step(det.proto_state(), bs, bt, forward_target=ft)
                e1.record()
                torch.cuda.synchronize()
                if rep:
                    untraced.append(e0.elapsed_time(e1))
            restore()
            trace_dir = tmp_root / f"train_trace_ft{int(ft)}"
            with profiler.torch_trace(str(trace_dir)):
                _, metrics = step(det.proto_state(), bs, bt,
                                  forward_target=ft)
            summary = trace_summary.summarise(
                str(trace_dir / profiler.TRACE_FILE), 1 << 30)
            say_trace(f"train_bf16_ft{int(ft)}", summary, top=12)
            n_kernels = sum(k["count"] for k in summary["device_kernels"])
            k2 = sum(k["count"] for k in kernel_names(summary,
                                                      "stem_bf16_kernel"))
            k2_ms = sum(k["total_ms"] for k in kernel_names(
                summary, "stem_bf16_kernel"))
            step_ms = sum(untraced) / len(untraced)
            s.say(f"train_bf16_ft{int(ft)}_trace_counts",
                  f"K2={k2} ({k2_ms} ms) loss_total="
                  f"{float(metrics['loss_total'])} kernel_launches="
                  f"{n_kernels} untraced_step_ms={untraced} device_busy/"
                  f"untraced_step={summary['device_busy_ms'] / step_ms} "
                  f"(the profiler's own host work stretches the traced "
                  f"window; the kernels' busy time over the step's untraced "
                  f"time bounds the idle share from below)")
            assert k2 == 2, k2
        del det, step

    def p_dp_nccl():
        """43. NCCL at world 1 (``init_process_group`` through a ``file://``
        store under the run's temporary directory, so no port is opened),
        the port's DP DA step (``make_dp_da_train_step``) at C2F 4 + 4,
        800x1344, float32 with TF32 off, from the seeded state, against the
        plain step (``make_da_train_step``) from the same state, fresh SGD
        state each, in both ``forward_target`` variants, with cuDNN and
        PyTorch asked for deterministic algorithms for the phase. Every
        parameter, the prototype and the metrics of the DP step must equal
        the plain step's within the distance between two plain steps of the
        same state (so bit for bit where those agree): at world 1 the
        all-reduce returns its input and the division by 1 is exact, so
        only the card's own run-to-run differences (atomics in a backward)
        remain. K2 twice a step. Step times (CUDA events, each after a warm
        step) and the all-reduce alone on the flat vector's size. The group
        is destroyed at the end."""
        free_card()
        store = tmp_root / "nccl_store"
        flags = (torch.backends.cudnn.deterministic,
                 torch.are_deterministic_algorithms_enabled())
        mesh.maybe_init_distributed(True, device="cuda",
                                    init_method=f"file://{store}", rank=0,
                                    world_size=1, timeout_s=300)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            cfg = c2f("float32")
            det, _, _, _ = train_setup(cfg, dev)
            init = {k: v.detach().clone() for k, v in det.state_dict().items()}
            bs, bt = train_batches(4, H, W, s.seed + 10, dev, n_boxes=100,
                                   k=16, scenes=True)

            def run(make, ft, timed=False):
                with torch.no_grad():
                    for k, v in det.state_dict().items():
                        v.copy_(init[k])
                opt = make_optimizer(cfg, det)
                step = make(det, opt, make_lr_scheduler(cfg, opt))
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                proto, metrics = step(det.proto_state(), bs, bt,
                                      forward_target=ft)
                e1.record()
                torch.cuda.synchronize()
                out = dict(state={k: v.detach().clone() for k, v in
                                  det.state_dict().items()},
                           metrics={k: v.clone() for k, v in metrics.items()},
                           ms=e0.elapsed_time(e1),
                           numel=getattr(step, "reduce", None)
                           and step.reduce.numel)
                return out

            def dist_of(a, b):
                keys = set(a["state"]) | {"m:" + k for k in a["metrics"]}
                d = {}
                for k in keys:
                    x = a["metrics"][k[2:]] if k.startswith("m:") else \
                        a["state"][k]
                    y = b["metrics"][k[2:]] if k.startswith("m:") else \
                        b["state"][k]
                    d[k] = float((x.double() - y.double()).abs().max())
                return d

            launches = {}
            numel = 0
            for ft in (True, False):
                plain1 = run(make_da_train_step, ft)
                plain2 = run(make_da_train_step, ft)
                zero_counts()
                dp1 = run(make_dp_da_train_step, ft)
                torch.cuda.synchronize()
                c = counts()
                for k, v in c.items():
                    launches[k] = launches.get(k, 0) + v
                numel = dp1["numel"]
                noise = dist_of(plain1, plain2)
                got = dist_of(dp1, plain1)
                bad = [k for k in got if got[k] > noise[k]]
                exact = sum(v == 0 for v in got.values())
                s.say(f"dp_world1_ft{int(ft)}",
                      f"tensors+metrics={len(got)} bit_equal={exact} "
                      f"plain_vs_plain_max={max(noise.values())} "
                      f"dp_vs_plain_max={max(got.values())} over_bound="
                      f"{bad[:5]} K2={c['vgg_stem_fused']} plain_ms="
                      f"{plain2['ms']} dp_ms={dp1['ms']} (first DP step "
                      f"of a fresh SGD; plain after a warm one)")
                assert not bad, bad[:5]
                assert c["vgg_stem_fused"] == 2, c
                assert c["bias_relu"] == 2 * VGG_FROZEN_CONVS, c
                assert not any(v for k, v in c.items()
                               if k not in ("vgg_stem_fused", "bias_relu")), c
            st.setdefault("new_launches", {})["dp_step"] = launches
            flat = torch.zeros(numel, dtype=torch.float32, device=dev)
            ar_ms = cuda_time(lambda: dist.all_reduce(flat), 10, 2)
            s.say("dp_all_reduce_ms", f"{ar_ms} (NCCL, world 1, {numel} "
                  f"float32 = {numel * 4 / 2 ** 20:.1f} MiB: every gradient, "
                  "the float metrics, the prototype)")
            st["dp_all_reduce"] = dict(ms=ar_ms, numel=numel)
        finally:
            torch.backends.cudnn.deterministic = flags[0]
            torch.use_deterministic_algorithms(flags[1])
            if dist.is_initialized():
                dist.destroy_process_group()

    def p_tools_on_card():
        """44. The harnesses on the card, cut to fit the run (each cut
        listed): ``stability_run`` with 300 iterations (not 2,000) on
        frames of 256x512 (not its 512x1024), 16 + 16 training and 16 val
        frames (not 32 + 32 + 8), batch 4 + 4, float32, validation every 75
        iterations and a checkpoint every 50, SIGKILLed once its log shows
        iteration 150, then resumed: all four asserts (at 60 iterations the
        validation AP of a random init swings too far between runs for its
        collapse check; 400 at 512x1024 passed); ``nan_bisect`` from its
        last checkpoint for 3 iterations (finite);
        ``train_net_da --use-tensorboard`` for 2 iterations on the same set
        (events under OUTPUT_DIR/tb where ``tensorboard`` imports, else its
        one warning); ``loader_bench --n 16 --threads 1 2 4 8`` at
        1024x2048."""
        free_card()
        root = tmp_root / "tools"
        data, out = root / "data", root / "stab"
        opts = ["INPUT.MIN_SIZE_RANGE_TRAIN", "(-1,-1)",
                "INPUT.MIN_SIZE_TRAIN", "(256,)", "INPUT.MAX_SIZE_TRAIN",
                "512", "INPUT.MIN_SIZE_TEST", "256", "INPUT.MAX_SIZE_TEST",
                "512", "SOLVER.IMS_PER_BATCH", "4"]
        t0 = time.time()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                summary = stability_run.main([
                    "--iters", "300", "--kill-frac", "0.5", "--val-iter",
                    "75", "--ckpt-period", "50", "--out", str(out), "--data",
                    str(data), "--n-train", "16", "--n-val", "16", "--hw",
                    "256", "512", "--timeout", "400", *opts])
        except SystemExit as e:  # the tool's own verdict: a failed phase
            raise AssertionError(f"stability_run: {e}\n{buf.getvalue()}")
        print(buf.getvalue())
        s.say("stability_run", f"{summary} wall_s={time.time() - t0:.1f}")
        last = stability_run.progress(str(out / "run.log"))
        assert last == 300, last
        real_dir = DatasetCatalog.DATA_DIR
        DatasetCatalog.DATA_DIR = str(data)
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = nan_bisect.main([
                    "--config-file", str(C2F), "--ckpt",
                    str(out / "model_0000300.pth"), "--until", "303", *opts,
                    "OUTPUT_DIR", str(root / "bisect")])
            s.say("nan_bisect", f"rc={rc} {buf.getvalue().splitlines()[-2:]}")
            assert rc == 0
            t0 = time.time()
            tb_out = root / "tb_run"
            train_net_da.main([
                "--config-file", str(C2F), "--use-tensorboard",
                "MODEL.WEIGHT", "", "SOLVER.MAX_ITER", "2",
                "SOLVER.VAL_ITER", "2", "OUTPUT_DIR", str(tb_out), *opts])
        finally:
            DatasetCatalog.DATA_DIR = real_dir
        tb = tb_out / "tb"
        events = sorted(os.listdir(tb)) if tb.exists() else []
        log = (tb_out / "log.txt").read_text()
        s.say("train_net_da_tensorboard", f"events={events} warning="
              f"{'tensorboard unavailable' in log} "
              f"wall_s={time.time() - t0:.1f}")
        assert events or "tensorboard unavailable" in log
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = loader_bench.main(["--n", "16", "--threads", "1", "2", "4",
                                      "8"])
        for r in rows:
            s.say(f"loader_bench_t{r['threads']}_{r['pass']}", r)
        assert len(rows) == 8

    def p_da_efficacy_smoke():
        """45. Both arms of ``tools/da_efficacy.py`` cut to 60 iterations
        (not 1,500), 16 + 16 training and 8 val images (not 64 + 64 + 32),
        validation every 30 iterations, at its 320x416 frames, float32:
        both arms complete, their validations parse, every loss is finite;
        both AP50s and the margin printed. The margin is the tool's own
        claim, settled by a full-size run, not by this smoke."""
        root = tmp_root / "da_efficacy"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = da_efficacy.main([
                "--data-root", str(root / "data"), "--out-root",
                str(root / "out"), "--iters", "60", "--n-train", "16",
                "--n-val", "8", "SOLVER.VAL_ITER", "30"])
        print("\n".join(buf.getvalue().splitlines()[-4:]))
        s.say("da_efficacy_smoke", f"source_only_AP50="
              f"{res['source_only']['ap50']} da_AP50={res['da']['ap50']} "
              f"gain={res['gain']} margin={res['margin']} verdict="
              f"{res['verdict']} (60 iterations: not the claim's run) "
              f"wall_s={time.time() - t0:.1f}")
        for arm in ("source_only", "da"):
            assert len(res[arm]["validations"]) == 2, res[arm]
            assert res[arm]["loss_readings"] > 0


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
    s.phase("weights_reference_pth", p_weights)
    s.phase("train_bf16_small_card_vs_cpu", p_train_bf16_small)
    s.phase("train_bf16_main_path_full_width", p_train_bf16_main)
    if "train_bf16_main_path_full_width" in s.failed:
        s.failed.append("train_bf16_timing (skipped)")
    else:
        s.phase("train_bf16_timing", p_train_bf16_time)
    s.phase("train_ca_out_full_width", p_ca_out)
    s.phase("resnet_small_card_vs_cpu", p_r101_small)
    s.phase("r101_main_path_full_width", p_r101_main)
    s.phase("r101_train_full_width", p_r101_train)
    s.phase("atss_small_card_vs_cpu", p_atss_small)
    s.phase("atss_main_path_full_width", p_atss_main)
    s.phase("two_stage_small_card_vs_cpu", p_two_stage_small)
    s.phase("mask_rcnn_main_path_full_width", p_mask_rcnn_main)
    s.phase("keypoint_rcnn_full_width", p_keypoint_rcnn)
    s.phase("mobile_small_card_vs_cpu", p_mobile_small)
    s.phase("mnv2_main_path_full_width", p_mnv2_main)
    s.phase("fbnet_full_width", p_fbnet_main)
    s.phase("vgg_bn_full_width", p_vgg_bn)
    s.phase("deform_conv_card_vs_cpu", p_deform)
    s.phase("single_image_path", p_single_image)
    s.phase("profile_inference_full_width", p_profile_inference)
    s.phase("train_bf16_trace", p_train_bf16_trace)
    s.phase("dp_nccl_world1_full_width", p_dp_nccl)
    s.phase("tools_on_card", p_tools_on_card)
    s.phase("da_efficacy_smoke", p_da_efficacy_smoke)
    s.phase("disk_tree", p_disk_tree)
    if "disk_tree" in s.failed:
        s.failed.append("entry points from disk (skipped)")
    else:
        s.phase("cli_train_da_from_disk", p_cli_train)
        if "cli_train_da_from_disk" in s.failed:
            s.failed.append("cli_test_net_from_disk (skipped)")
        else:
            s.phase("cli_test_net_from_disk", p_cli_test)
        s.phase("cli_train_net_from_disk", p_cli_train_net)
        s.phase("cli_r101_from_pkl", p_cli_r101)

    shutil.rmtree(tmp_root, ignore_errors=True)
    for k in st.get("kernels") or []:  # launches on the later paths
        for path, c in st.get("new_launches", {}).items():
            k[f"{path}_launches"] = c[k["name"]]
        if k["name"] == "nms_sorted" and "k1_by_k" in st:
            k["by_k"] = st["k1_by_k"]
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
