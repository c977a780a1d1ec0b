"""Spans around the layers, a short ``torch.profiler`` slice, and the
reduction of its Chrome trace to device time by span.

The system has no spans of its own yet, so the harness puts
``record_function`` ranges around the calls into each layer from here
(``bench/<name>``): around a module's ``forward``, or around a function
looked up by name on a module of the system. The backward is the
autograd engine's own ``autograd::engine::evaluate_function`` ranges, the
optimizer ``Optimizer.step``'s. Each device operation is attributed to
the innermost span open on the host thread that launched it, when it was
launched (the launch's ``correlation`` id ties the two). The device's busy
time is the union of its operations' intervals (``trace_summary``'s
arithmetic).
"""

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function"
OPTIMIZER = "Optimizer.step"


def wrap_forward(module, name):
    """Run ``module.forward`` inside the span ``bench/<name>``."""
    inner = module.forward

    def forward(*args, **kw):
        with torch.profiler.record_function(f"bench/{name}"):
            return inner(*args, **kw)

    module.forward = forward


def wrap_function(owner, attr, name):
    """Replace ``owner.attr`` (a function the system looks up there at
    call time) by one that runs it inside the span ``bench/<name>``."""
    inner = getattr(owner, attr)

    def fn(*args, **kw):
        with torch.profiler.record_function(f"bench/{name}"):
            return inner(*args, **kw)

    setattr(owner, attr, fn)


def union_seconds(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _span_name(name):
    if name.startswith("bench/"):
        return name[len("bench/"):]
    if name.startswith(BACKWARD):
        return "backward"
    if name.startswith(OPTIMIZER):
        return "optimizer"
    return None


def _attribute(spans, launches):
    """correlation -> the innermost span open on the launching thread at
    the launch (spans of one thread nest)."""
    by_tid = {}
    for corr, (tid, ts) in launches.items():
        by_tid.setdefault(tid, []).append((ts, corr))
    out = {}
    for tid, items in by_tid.items():
        sp = sorted(spans.get(tid, ()), key=lambda x: (x[0], -x[1]))
        stack, j = [], 0
        for ts, corr in sorted(items):
            while j < len(sp) and sp[j][0] <= ts:
                while stack and stack[-1][1] < sp[j][0]:
                    stack.pop()
                stack.append(sp[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = stack[-1][2] if stack else None
    return out


def reduce_trace(trace):
    """A Chrome trace (dict) -> summary: ``ops`` [(name, span, start_s,
    dur_s)] of the device operations, ``busy_s`` (their union), and the
    host ``gaps``."""
    events = trace.get("traceEvents", trace)
    spans = {}  # tid -> [(start, end, name)]
    launches = {}  # correlation -> (tid, ts)
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            if "correlation" in args:
                launches[args["correlation"]] = (ev["tid"], ev["ts"])
        else:
            span = _span_name(ev.get("name", ""))
            if span is not None:
                spans.setdefault(ev["tid"], []).append(
                    (ev["ts"], ev["ts"] + ev["dur"], span))
    where = _attribute(spans, launches)
    ops = [(ev["name"], where.get((ev.get("args") or {}).get("correlation")),
            ev["ts"] * 1e-6, ev["dur"] * 1e-6) for ev in device]
    busy = union_seconds([(s, s + d) for _, _, s, d in ops])
    return {"ops": ops, "busy_s": busy}


def span_seconds(summary, span):
    """Device seconds of the operations attributed to ``span``."""
    return sum(d for _, w, _, d in summary["ops"] if w == span)


def kernel_seconds(summary, needle):
    """(device seconds, launches) of the operations whose name holds
    ``needle``."""
    hits = [d for n, _, _, d in summary["ops"] if needle in n]
    return sum(hits), len(hits)


def breakdown(summary):
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps named by the span the next
    operation was launched in."""
    by_name = {}
    for n, _, _, d in summary["ops"]:
        by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for n, w, s, d in sorted(summary["ops"], key=lambda o: o[2]):
        if end is not None and s > end:
            gaps.append((f"before {w or 'unattributed'}: {n[:60]}", s - end))
        end = s + d if end is None else max(end, s + d)
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in gaps]}


def profile(fn, units):
    """Run ``fn()`` (``units`` steps or batches, ending in a synchronize)
    under the profiler. Returns (summary, window_s)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    summary = reduce_trace(trace)
    summary["units"] = units
    return summary, window
