"""The port's own spans and counters (``utils/profiler.py``: ``span``,
``count``, ``recording``, ``snapshot``) on the CPU, on the C2F detector at
VGG width / 8 and 64x96 images:

* with nothing recording, a span site calls neither ``record_function`` nor
  ``torch.cuda.Event`` and keeps no record, and the outputs of
  ``forward_inference`` and of a DA step are bitwise those of a run that
  records;
* under ``torch.profiler`` and under ``recording()``, every ``scan/`` span
  is there, nested as the layers are, and ``snapshot()`` counts each call;
  the host stamps are the trace's own clock;
* each ``scan/`` layer span holds the aten ops of the benchmark's
  ``bench/`` wrapper of the same name;
* the NMS counters are the sums of the masks entering and leaving K1;
* the recorder's arithmetic (self time, roots, capacity, reset), and each
  per-layer reader of ``benchmark/metrics`` that reads the recorder, on a
  made-up snapshot.
"""

import collections
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import trace as bench_trace
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.train_step import make_da_train_step
from scan_tpu_torch.modeling import detector as detector_module
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.modeling.fcos import postprocess
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2F = os.path.join(REPO, "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
B, H, W = 2, 64, 96
# each span's parent, in a DA step (GST on) and in an eval forward
STEP_TREE = {"step": None, "prep": "step", "backbone": "step",
             "middle_head": "step", "gst_sample": "middle_head",
             "fcos": "step", "fcos_loss": "step", "discriminator": "step",
             "backward": "step", "optimizer": "step"}
INFERENCE_TREE = {"inference": None, "prep": "inference",
                  "backbone": "inference", "middle_head": "inference",
                  "fcos": "inference", "postprocess": "inference",
                  "nms": "postprocess"}
# calls of each span: two domains, the head and its loss on the source
STEP_CALLS = {"step": 1, "prep": 2, "backbone": 2, "middle_head": 2,
              "gst_sample": 1, "fcos": 1, "fcos_loss": 1, "discriminator": 2,
              "backward": 1, "optimizer": 1}


def tiny_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 64
    cfg.TPU.MAX_TARGET_POINTS = 64
    cfg.TPU.MAX_BOXES = 8
    cfg.TPU.VGG_WIDTH_DIV = 8
    return cfg


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, B, H, W, 3)).astype(np.uint8)
    boxes = np.zeros((B, 8, 4), np.float32)
    labels = np.zeros((B, 8), np.int32)
    mask = np.zeros((B, 8), bool)
    for b in range(B):
        for j in range(3):
            x0, y0 = rng.rand(2) * [60, 30]
            w, h = rng.rand(2) * [40, 30] + 8
            boxes[b, j] = [x0, y0, x0 + w, y0 + h]
            labels[b, j] = rng.randint(1, 9)
            mask[b, j] = True
    sizes = np.asarray([[H, W]] * B, np.int32)
    return (dict(images=images[0], sizes=sizes, boxes=boxes, labels=labels,
                 mask=mask), dict(images=images[1]))


def build():
    """A fresh seeded detector (float32 masters) and its DA step."""
    cfg = tiny_cfg()
    det = build_detector(cfg, device="cpu", train=True)
    opt = make_optimizer(cfg, det)
    return det, make_da_train_step(det, opt, make_lr_scheduler(cfg, opt))


def run(det, step, batches):
    """One DA step with GST on, then one eval forward on the target batch:
    (metrics, parameters, detections)."""
    bs, bt = batches
    _, metrics = step(det.proto_state(), bs, bt, forward_target=True)
    out = det.forward_inference(torch.as_tensor(bt["images"]),
                                torch.as_tensor(bs["sizes"]))
    return metrics, det.state_dict(), out


@pytest.fixture(autouse=True)
def clean_recorder():
    profiler.reset()
    yield
    profiler.reset()


def test_spans_off_call_nothing_and_change_nothing(monkeypatch, batches):
    calls = collections.Counter()

    def counting(name, real):
        def stub(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return stub

    monkeypatch.setattr(profiler, "record_function",
                        counting("record_function", profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("Event", torch.cuda.Event))
    assert not torch.autograd._profiler_enabled()
    off = run(*build(), batches)
    assert calls == {} and profiler.RECORDER.records == []
    assert profiler.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}
    with profiler.recording():
        on = run(*build(), batches)
    assert calls["record_function"] == len(profiler.RECORDER.records) > 0
    for got, want in zip(on, off):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _trace_spans(trace):
    """scan/ ranges of the Chrome trace: [(name, parent name, start us, end
    us)], each range's parent the innermost scan/ range holding it on its
    thread."""
    evs = sorted((e for e in trace["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(profiler.SPAN_PREFIX)),
                 key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    n = len(profiler.SPAN_PREFIX)
    out, stack = [], []
    for e in evs:
        while stack and (stack[-1]["tid"] != e["tid"] or
                         stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]):
            stack.pop()
        parent = stack[-1]["name"][n:] if stack else None
        out.append((e["name"][n:], parent, e["ts"], e["ts"] + e["dur"]))
        stack.append(e)
    return out


def _profiled(fn, tmp_path):
    """Run ``fn`` under ``torch.profiler`` (the CPU); its Chrome trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_spans_nest_as_the_layers_and_count_their_calls(how, batches,
                                                        tmp_path):
    det, step = build()
    run(det, step, batches)  # warm: the first record_function is slow
    profiler.reset()
    if how == "profiler":
        trace = _profiled(lambda: run(det, step, batches), tmp_path)
    else:
        with profiler.recording():
            run(det, step, batches)
    records = profiler.RECORDER.records
    parents = [(r[0], r[1][0] if r[1] else None) for r in records]
    split = parents.index(("inference", None))
    assert set(parents[:split]) == set(STEP_TREE.items())
    assert set(parents[split:]) == set(INFERENCE_TREE.items())
    roots = [r[2] for r in records]
    assert roots == [0] * split + [1] * (len(records) - split)
    snap = profiler.snapshot()
    want = collections.Counter(STEP_CALLS)
    want.update({k: 1 for k in INFERENCE_TREE})
    assert {k: v["calls"] for k, v in snap["spans"].items()} == want
    for name, s in snap["spans"].items():
        assert s["host_ms"] >= s["host_self_ms"] > 0, name
        assert s["device_ms"] is None, name  # no card
    assert set(snap["counters"]) == {"nms.candidates", "nms.kept"}
    if how == "recording":
        return
    got = _trace_spans(trace)
    assert [(n, p) for n, p, _, _ in got] == parents
    # the recorder's host stamps on the trace's clock, to 200 us
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    for rec, (_, _, start, end) in zip(records, got):
        assert abs(rec[3] / 1e3 - (start + base)) < 200, rec[0]
        assert abs(rec[4] / 1e3 - (end + base)) < 200, rec[0]


def _ops_inside(trace, prefix):
    """name -> Counter of the outermost aten ops (those no aten op holds)
    held by a ``prefix<name>`` range, at any depth, on their thread."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in evs if e.get("cat") == "user_annotation"
              and e["name"].startswith(prefix)]
    ops, end = [], {}
    for e in sorted((e for e in evs if e.get("cat") == "cpu_op"
                     and e["name"].startswith("aten::")),
                    key=lambda e: (e["tid"], e["ts"], -e["dur"])):
        if e["ts"] >= end.get(e["tid"], float("-inf")):
            ops.append(e)
            end[e["tid"]] = e["ts"] + e["dur"]
    out = collections.defaultdict(collections.Counter)
    for r in ranges:
        name = r["name"][len(prefix):]
        for op in ops:
            if (op["tid"] == r["tid"] and op["ts"] >= r["ts"]
                    and op["ts"] + op["dur"] <= r["ts"] + r["dur"]):
                out[name][op["name"]] += 1
    return out


def test_scan_spans_hold_the_bench_wrappers_ops(monkeypatch, batches,
                                                tmp_path):
    """The harness's wrappers (read only) around the same detector: each
    ``scan/`` layer span holds exactly the aten ops of its ``bench/``
    namesake, but for the discriminators' weights (``lambda * loss``, one
    ``aten::mul`` a discriminator, outside their modules)."""
    det, step = build()
    for attr in ("mix_cls_maps", "fcos_postprocess"):  # restored after
        monkeypatch.setattr(detector_module, attr,
                            getattr(detector_module, attr))
        bench_trace.wrap_function(detector_module, attr, "postprocess")
    for name in ("backbone", "middle_head", "fcos"):
        bench_trace.wrap_forward(getattr(det, name), name)
    for name in det.dis_names:
        bench_trace.wrap_forward(getattr(det, name), "discriminator")
    run(det, step, batches)
    trace = _profiled(lambda: run(det, step, batches), tmp_path)
    scan = _ops_inside(trace, profiler.SPAN_PREFIX)
    bench = _ops_inside(trace, "bench/")
    for name in ("backbone", "middle_head", "fcos", "postprocess"):
        assert bench[name] and scan[name] == bench[name], name
    glue = scan["discriminator"] - bench["discriminator"]
    assert glue == {"aten::mul": 2 * len(det.dis_names)}
    assert not bench["discriminator"] - scan["discriminator"]


def test_nms_counters_are_the_masks_sums(monkeypatch):
    """Boxes in clusters of one label, so K1 suppresses: the counters are
    the sums of the valid mask entering ``nms_keep_mask`` and of the mask
    it returns, over two calls."""
    seen = []
    real = postprocess.nms_keep_mask

    def spy(boxes, scores, valid, thresh, labels=None):
        keep = real(boxes, scores, valid, thresh, labels=labels)
        seen.append((int(valid.sum()), int(keep.sum())))
        return keep

    monkeypatch.setattr(postprocess, "nms_keep_mask", spy)
    g = torch.Generator().manual_seed(0)
    n = 300
    centre = torch.randint(0, 6, (B, n), generator=g).float()[..., None] * 40
    xy = centre + torch.rand(B, n, 2, generator=g) * 8
    boxes = torch.cat([xy, xy + 30], -1)
    scores = torch.rand(B, n, generator=g)
    labels = torch.randint(1, 3, (B, n), generator=g)
    valid = torch.rand(B, n, generator=g) < 0.8
    cfg = postprocess.PostProcessConfig(nms_thresh=0.5, nms_cap=256,
                                        fpn_post_nms_top_n=100)
    with profiler.recording():
        for _ in range(2):
            postprocess.select_detections(cfg, boxes, scores, labels, valid)
    got = profiler.snapshot()["counters"]
    candidates, kept = (sum(s) for s in zip(*seen))
    assert got == {"nms.candidates": candidates, "nms.kept": kept}
    assert 0 < kept < candidates
    postprocess.select_detections(cfg, boxes, scores, labels, valid)
    assert profiler.snapshot()["counters"] == got  # nothing records now


def test_recorder_self_time_roots_capacity_and_reset(monkeypatch):
    clock = iter(range(0, 10 ** 9, 10 ** 6))  # 1 ms a stamp
    monkeypatch.setattr(profiler.time, "time_ns", lambda: next(clock))
    rec = profiler.Recorder(capacity=4)
    a = rec.open("a")          # 0
    b = rec.open("b")          # 1
    rec.close(b)               # 2
    c = rec.open("b")          # 3
    rec.close(c)               # 4
    rec.close(a)               # 5
    d = rec.open("a")          # 6
    e = rec.open("c")          # dropped: capacity 4
    rec.close(e)
    rec.close(d)               # 7
    rec.count("n", 3)
    rec.count("n", torch.tensor([True, False, True]))
    for _ in range(5):  # kept until the snapshot, folded at the capacity
        rec.count("m", torch.ones(2, dtype=torch.bool))
    assert len(rec.tensor_counts["m"]) == 2
    snap = rec.snapshot()
    assert snap["spans"] == {
        "a": {"calls": 2, "host_ms": 6.0, "host_self_ms": 4.0,
              "device_ms": None},
        "b": {"calls": 2, "host_ms": 2.0, "host_self_ms": 2.0,
              "device_ms": None}}
    assert snap["counters"] == {"n": 5, "m": 10} and snap["dropped"] == 1
    assert [r[2] for r in rec.records] == [0, 0, 0, 1]
    assert rec._stack() == []
    rec.reset()
    assert rec.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}
    assert rec.open("x")[2] == 0  # roots count again from 0


READERS = {
    # metric: (made-up spans and counters, the value it reads)
    "train.host_enqueue_ms": ({"step": (4, 80.0, None)}, 20.0),
    "train.gst_ms": ({"step": (4, 80.0, 900.0), "gst_sample": (4, 8.0, 6.0)},
                     1.5),
    "train.optimizer_ms": ({"step": (2, 9.0, 1.0),
                            "optimizer": (2, 1.0, 3.0)}, 1.5),
    "eval.prep_ms": ({"inference": (20, 100.0, 600.0),
                      "prep": (20, 2.0, 40.0)}, 2.0),
    "eval.host_enqueue_ms": ({"inference": (20, 100.0, 600.0)}, 5.0),
    "eval.postprocess_host_ms": ({"inference": (20, 100.0, 600.0),
                                  "postprocess": (20, 30.0, 18.0)}, 1.5),
    "eval.nms_keep_pct": ({"nms.candidates": 400, "nms.kept": 100}, 25.0),
}


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_up_snapshot(name, monkeypatch):
    made, want = READERS[name]
    spans = {k: {"calls": v[0], "host_ms": v[1], "host_self_ms": v[1],
                 "device_ms": v[2]}
             for k, v in made.items() if isinstance(v, tuple)}
    counters = {k: v for k, v in made.items() if not isinstance(v, tuple)}
    snap = {"spans": spans, "counters": counters, "dropped": 0}
    reader = _reader(name)
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    assert reader.read(None) == pytest.approx(want)
    # off the card (no device interval), or with nothing recorded: None
    for s in spans.values():
        s["device_ms"] = None
    if name.startswith("eval.nms"):
        counters["nms.candidates"] = 0
    if "host" not in name:
        assert reader.read(None) is None
    empty = {"spans": {}, "counters": {}, "dropped": 0}
    monkeypatch.setattr(profiler, "snapshot", lambda: empty)
    assert reader.read(None) is None
    # a program without a recorder of its own (the parent's)
    monkeypatch.delattr(profiler, "snapshot")
    assert reader.read(None) is None


def test_allreduce_span_around_the_fused_mean(tmp_path):
    """``FusedMean`` in a one-rank gloo group (a ``file://`` store, no
    port): one ``allreduce`` span a call, the mean of one rank unchanged."""
    import torch.distributed as dist

    from scan_tpu_torch.engine.dp import FusedMean

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.tensor([1.0, 2.0, 3.0])
        opt = torch.optim.SGD([p], lr=0.1)
        with profiler.recording():
            metrics, _ = FusedMean()(opt, {"loss": torch.tensor(1.5)}, None)
    finally:
        dist.destroy_process_group()
    assert float(metrics["loss"]) == 1.5
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    spans = profiler.snapshot()["spans"]
    assert list(spans) == ["allreduce"] and spans["allreduce"]["calls"] == 1
