"""The port's profiling and logging tools on the CPU: ``utils/profiler.py``
(``Timer`` against ``scan_tpu``'s, ``synced_time``, ``torch_trace``),
``tools/profile_inference.py`` at narrow width with a trace,
``tools/trace_summary.py`` on that trace and on a hand-made one whose
self times and device union are known, and ``utils/tensorboard.py``'s
events read back. No JAX runs here; ``scan_tpu``'s ``Timer`` imports none.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from scan_tpu.utils import profiler as jax_profiler
from scan_tpu_torch.tools import trace_summary
from scan_tpu_torch.utils import profiler
from scan_tpu_torch.utils.tensorboard import TensorboardLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["TPU.VGG_WIDTH_DIV", "8", "MODEL.FCOS.NUM_CONVS_REG", "1",
          "MODEL.FCOS.NUM_CONVS_CLS", "1"]


def test_timer_matches_scan_tpu(monkeypatch):
    """Same totals, averages, diffs and call counts on the same clock."""
    ticks = iter([0.0, 0.5, 1.0, 2.5, 3.0, 3.25] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    got, want = profiler.Timer(), jax_profiler.Timer()
    for timer in (got, want):
        assert timer.average_time == 0.0
    seen = {id(got): [], id(want): []}
    for timer in (got, want):
        for average in (True, False, True):
            timer.tic()
            seen[id(timer)].append(timer.toc(average=average))
    assert seen[id(got)] == seen[id(want)] == [0.5, 1.5, 0.75]
    for attr in ("total_time", "calls", "diff", "average_time"):
        assert getattr(got, attr) == getattr(want, attr), attr
    got.reset()
    assert (got.calls, got.total_time, got.average_time) == (0, 0.0, 0.0)


def test_synced_time_and_traces(tmp_path):
    """``torch_trace`` records its block; ``trace_calls`` only the call
    after its warm-up calls."""
    x = torch.randn(64, 64)
    dt, out = profiler.synced_time(lambda a: {"y": [a @ a]}, x)
    assert dt > 0 and torch.equal(out["y"][0], x @ x)
    with profiler.torch_trace(str(tmp_path), cuda=False):
        torch.relu(x @ x)
    summary = trace_summary.summarise(str(tmp_path / profiler.TRACE_FILE))
    names = [op["name"] for op in summary["host_ops"]]
    assert "aten::mm" in names and "aten::relu" in names
    assert summary["device_kernels"] == [] and summary["device_busy_ms"] == 0
    out = profiler.trace_calls(str(tmp_path / "calls"),
                               lambda: torch.relu(x @ x), warmup=2,
                               cuda=False)
    assert torch.equal(out, torch.relu(x @ x))
    summary = trace_summary.summarise(
        str(tmp_path / "calls" / profiler.TRACE_FILE))
    counts = {op["name"]: op["count"] for op in summary["host_ops"]}
    assert counts["aten::mm"] == 1 and counts["aten::relu"] == 1


def _event(name, cat, ts, dur, tid=1, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def test_trace_summary_self_time_and_device_union(tmp_path):
    """Nested host ops subtract their children; kernels on two streams
    overlap, so the busy time is their union, not their sum."""
    events = [
        _event("outer", "cpu_op", 0, 100),
        _event("inner", "cpu_op", 10, 30),
        _event("inner", "cpu_op", 50, 20),
        _event("leaf", "cpu_op", 55, 5),
        _event("other_thread", "cpu_op", 20, 40, tid=2),
        _event("k_a", "kernel", 30, 40, tid=7, pid=0),
        _event("k_b", "kernel", 60, 30, tid=8, pid=0),
        _event("k_a", "kernel", 150, 10, tid=7, pid=0),
        _event("launch", "cuda_runtime", 5, 2),
        {"ph": "i", "name": "marker", "ts": 1000, "pid": 1, "tid": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace_summary.summarise(str(path), top_n=10)
    host = {op["name"]: op for op in out["host_ops"]}
    assert host["outer"]["total_ms"] == pytest.approx(0.050)  # 100 - 30 - 20
    assert host["inner"]["count"] == 2
    assert host["inner"]["total_ms"] == pytest.approx(0.045)  # 30 + 20 - 5
    assert host["inner"]["mean_ms"] == pytest.approx(0.0225)
    assert host["leaf"]["total_ms"] == pytest.approx(0.005)
    assert host["other_thread"]["total_ms"] == pytest.approx(0.040)
    totals = [op["total_ms"] for op in out["host_ops"]]
    assert totals == sorted(totals, reverse=True)
    kernels = {op["name"]: op for op in out["device_kernels"]}
    assert kernels["k_a"]["count"] == 2
    assert kernels["k_a"]["total_ms"] == pytest.approx(0.050)
    assert [op["name"] for op in out["device_kernels"]] == ["k_a", "k_b"]
    assert out["device_busy_ms"] == pytest.approx(0.070)  # [30, 90] + [150, 160]
    assert out["window_ms"] == pytest.approx(0.160)  # 0 .. 160
    assert out["total_ms"] == pytest.approx(0.140 + 0.080)


def _launch(ts, corr, tid=1):
    return dict(_event("cudaLaunchKernel", "cuda_runtime", ts, 2, tid=tid),
                args={"correlation": corr})


def _op(name, cat, ts, dur, corr):
    return dict(_event(name, cat, ts, dur, tid=7, pid=0),
                args={"correlation": corr})


def test_trace_summary_spans_table(tmp_path):
    """Device time by the innermost ``scan/`` span open at each launch on
    the launching thread, else on any thread (tid 2, the autograd engine's,
    opens none); the idle gaps named by the span of the op after them; the
    device's copy of a span (``gpu_user_annotation``) is not a host span."""
    events = [
        _event("scan/step", "user_annotation", 0, 1000),
        _event("scan/prep", "user_annotation", 0, 5),
        _event("scan/backbone", "user_annotation", 10, 190),
        _event("scan/backward", "user_annotation", 300, 600),
        _event("scan/step", "gpu_user_annotation", 0, 2000, tid=7, pid=0),
        _launch(2, 0), _launch(20, 1), _launch(250, 2), _launch(400, 3, tid=2),
        _launch(950, 4), _launch(1100, 5),
        _op("k_prep", "kernel", 10, 5, 0),
        _op("k_bb", "kernel", 100, 50, 1),
        _op("k_step", "kernel", 260, 40, 2),
        _op("k_bwd", "kernel", 500, 100, 3),
        _op("k_step", "kernel", 960, 10, 4),
        _op("copy", "gpu_memcpy", 1200, 20, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans = trace_summary.summarise(str(path))["spans"]
    assert spans["layers"] == pytest.approx(
        {"backward": 0.1, "backbone": 0.05, "step": 0.05,
         "unattributed": 0.02, "prep": 0.005})
    assert list(spans["layers"]) == ["backward", "backbone", "step",
                                     "unattributed", "prep"]
    assert [(g["before"], g["op"], g["gap_ms"]) for g in spans["idle_gaps"]] \
        == [("step", "k_step", pytest.approx(0.36)),
            ("unattributed", "copy", pytest.approx(0.23)),
            ("backward", "k_bwd", pytest.approx(0.2)),
            ("step", "k_step", pytest.approx(0.11)),
            ("backbone", "k_bb", pytest.approx(0.085))]


def test_profile_inference_on_cpu_writes_rows_and_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    proc = subprocess.run(
        [sys.executable, "-m", "scan_tpu_torch.tools.profile_inference",
         "--device", "cpu", "--batch", "2", "--iters", "1", "--hw", "96",
         "128", "--trace", str(trace_dir), *NARROW],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    prefixes = [r["prefix"] for r in rows if "prefix" in r]
    assert prefixes == ["backbone", "+condgraph", "+fcos_head",
                        "full(+postprocess)"]
    assert all(r["ms_per_batch"] > 0 and r["clock"] == "host"
               and r["batch"] == 2 for r in rows if "prefix" in r)
    assert proc.stdout.count("[warmup]") == 4
    assert "img_per_sec" in rows[3]
    summary = trace_summary.main([str(trace_dir / profiler.TRACE_FILE), "8"])
    host = summary["host_ops"]
    assert len(host) == 8 and summary["window_ms"] > 0
    totals = [op["total_ms"] for op in host]
    assert totals == sorted(totals, reverse=True)
    assert any("conv" in op["name"] for op in host)
    snap = [r for r in rows if "trace" in r][0]["snapshot"]
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    assert calls == {"inference": 1, "prep": 1, "backbone": 1,
                     "middle_head": 1, "fcos": 1, "postprocess": 1, "nms": 1}
    assert set(snap["counters"]) == {"nms.candidates", "nms.kept"}
    assert summary["spans"] == {"layers": {}, "idle_gaps": []}  # no card


def _scalars(log_dir):
    """tag -> [(step, value)] from the event files: TFRecords (length,
    its CRC, an ``Event`` proto, its CRC) read without TensorFlow."""
    from tensorboard.compat.proto import event_pb2

    got = {}
    for name in sorted(os.listdir(log_dir)):
        data = (log_dir / name).read_bytes()
        off = 0
        while off < len(data):
            (n,) = struct.unpack_from("<Q", data, off)
            event = event_pb2.Event.FromString(data[off + 12:off + 12 + n])
            off += 12 + n + 4
            for v in event.summary.value:
                value = v.simple_value if v.HasField("simple_value") else \
                    float(np.frombuffer(v.tensor.tensor_content, np.float32)[0]
                          if v.tensor.tensor_content else v.tensor.float_val[0])
                got.setdefault(v.tag, []).append((event.step, value))
    return got


def test_tensorboard_logger_events_read_back(tmp_path):
    tb = TensorboardLogger(str(tmp_path))
    assert tb._writer is not None
    tb.log_scalars({"loss_total": 1.5, "val/AP50": 0.3}, step=20)
    tb.log_scalars({"loss_total": torch.tensor(1.25)}, step=40)
    tb.flush()
    assert any("tfevents" in f for f in os.listdir(tmp_path))
    assert _scalars(tmp_path) == {"loss_total": [(20, 1.5), (40, 1.25)],
                                  "val/AP50": [(20, pytest.approx(0.3))]}
