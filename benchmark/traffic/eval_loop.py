"""Traffic ``eval_loop``: ``test_net``'s evaluation loop over a seeded pool
of host uint8 batches of target (fogged) scenes, closed loop with one
batch queued ahead.

The loop is a frozen copy of ``scan_tpu_torch/engine/inference.py``'s
``compute_predictions``: each batch is copied to the card from host
memory, run through ``forward_inference``, and the previous batch's
detections are copied back before the next batch is handed off. A
batch's latency runs from its hand-off to its detections on the host.
After the window a sample of its batches, drawn from the seed, is run
through the plain reference in float32 and compared.
"""

import gc
import time

import numpy as np
import torch

from benchmark.harness import compare, core, program, scenes, trace, weights
from benchmark.reference import model as ref_model


def predict(det, pool, device, seconds=None, batches=None):
    """The evaluation loop for ``seconds`` (or ``batches`` batches).
    Returns (outputs by batch, latencies s, elapsed s)."""
    outputs, lat = [], []
    pending = None

    def collect(out, t_hand):
        outputs.append({k: v.cpu().numpy() for k, v in out.items()})
        lat.append(time.perf_counter() - t_hand)

    t0 = time.perf_counter()
    i = 0
    while True:
        b = pool[i % len(pool)]
        t_hand = time.perf_counter()
        images = torch.as_tensor(np.asarray(b["images"])).to(
            device, non_blocking=True)
        sizes = torch.as_tensor(np.asarray(b["sizes"])).to(device)
        out = det.forward_inference(images, sizes)
        if pending is not None:
            collect(*pending)
        pending = (out, t_hand)
        i += 1
        if (batches is not None and i >= batches) or (
                seconds is not None and time.perf_counter() - t0 >= seconds):
            break
    collect(*pending)
    return outputs, lat, time.perf_counter() - t0


def make_pool(cell, device):
    """Host batches (numpy) of fogged target scenes."""
    t = cell.work["traffic"]
    pool = []
    for i in range(t["pool"]):
        _, bt = scenes.batch_pair(scenes.item_seed(cell.seed, i), t, device)
        pool.append({"images": bt["images"].cpu().numpy(),
                     "sizes": bt["sizes"].cpu().numpy()})
    return pool


def run(cell, faults=None):
    device = torch.device(cell.device)
    work, t = cell.work, cell.work["traffic"]
    torch.backends.cudnn.allow_tf32 = work["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = work["tf32"]
    pool = make_pool(cell, device)
    pcfg = program.port_cfg(cell.cfg, work)
    w = weights.make_weights(cell.cfg, cell.seed, device,
                             work["cls_bias_offset"], work["reg_bias_px"])
    det = program.build_detector(pcfg, w, device, train=False)
    del w
    if work.get("calibrate_batches"):  # the int8 control's static scales
        det.calibrate_int8([b["images"] for b in pool[:work["calibrate_batches"]]])
    if faults:
        faults(det)
    predict(det, pool, device, batches=work["warmup_batches"])
    core.sync(device)
    setup_s = time.time() - cell.start
    outs, lat, elapsed = predict(det, pool, device, seconds=cell.seconds)
    n = len(outs)
    images = n * t["batch"]
    failed = sum(int(not np.isfinite(o["scores"]).all()) for o in outs)
    dev = core.device_info(torch, work["chips"])
    metrics = {"eval_img_s": {"value": images / elapsed, "unit": "img/s"},
               "eval_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)),
                               "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    names = {m["name"] for m in cell.end_to_end()}
    metrics = {k: v for k, v in metrics.items() if k in names}
    breakdown = None
    if cell.trace:
        import scan_tpu_torch.modeling.detector as detector_module
        for name in ("backbone", "middle_head", "fcos"):
            trace.wrap_forward(getattr(det, name), name)
        for fn in ("mix_cls_maps", "fcos_postprocess"):
            trace.wrap_function(detector_module, fn, "postprocess")
        k = work["trace_batches"]
        s, tw = trace.profile(lambda: predict(det, pool, device, batches=k), k)
        ctx = type("Ctx", (), dict(summary=s, window_s=tw,
                                   unit_s=elapsed / n, cfg=cell.cfg,
                                   work=work))
        metrics = core.read_layers(cell, ctx)
        dev.update(busy_s=s["busy_s"], window_s=tw)
        breakdown = trace.breakdown(s)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    # the reference over a sample of the window's batches
    rng = np.random.default_rng(scenes.item_seed(cell.seed, -1))
    picks = sorted(rng.choice(n, min(work["check_batches"], n),
                              replace=False))
    ref = ref_outputs(cell, device, [pool[i % len(pool)] for i in picks])
    readings = compare.eval_readings([outs[i] for i in picks], ref,
                                     cell.cfg["TEST"]["DETECTIONS_PER_IMG"])
    ok, checks = compare.judge(readings, work["limits"])
    return dict(correct=ok and failed == 0, attempted=n, failed=failed,
                metrics=metrics, device=dev, checks=checks,
                breakdown=breakdown, readings=readings)


def ref_outputs(cell, device, batches):
    """The plain reference's detections, float32 with TF32 off: the top
    ``ref_per_img`` after NMS (more than the system keeps, so a detection
    the two sides rank on either side of the last slot still matches)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = weights.make_weights(cell.cfg, cell.seed, device,
                             cell.work["cls_bias_offset"],
                             cell.work["reg_bias_px"])
    with torch.device(device):
        det = ref_model.Detector(cell.cfg)
    det.load_state_dict(w)
    del w
    c = cell.cfg
    pp = {"thresh": c["MODEL"]["FCOS"]["INFERENCE_TH"],
          "top_n": c["MODEL"]["FCOS"]["PRE_NMS_TOP_N"],
          "nms": c["MODEL"]["FCOS"]["NMS_TH"], "cap": c["TPU"]["NMS_CAP"],
          "per_img": cell.work["ref_per_img"]}
    out = []
    for b in batches:
        r = det.forward_inference(torch.as_tensor(b["images"]).to(device),
                                  torch.as_tensor(b["sizes"]).to(device), pp)
        out.append({k: v.cpu().numpy() for k, v in r.items()})
    return out
