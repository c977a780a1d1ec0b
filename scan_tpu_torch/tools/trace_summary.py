"""Summarise a ``torch.profiler`` Chrome trace into a compact JSON table
(counterpart of ``tools/trace_summary.py``, which reads an XProf
``.xplane.pb``).

    python -m scan_tpu_torch.tools.trace_summary <trace.json> [top_n]

Reads the trace that ``utils/profiler.torch_trace`` writes and prints one
JSON object: ``total_ms`` (the self time of every op listed) and the top-N
device kernels and host ops by total self time, each with its name, count,
total and mean, listed separately. A kernel's self time is its duration; a
host op's is its duration less that of the ops nested in it on its
thread. ``window_ms`` is the traced window (the first event's start to the
last one's end, any thread or stream), and ``device_busy_ms`` the union of
the kernels' intervals over the device's streams in it; ``1 -
device_busy_ms / window_ms`` is the device's idle share.

``spans`` reads the program's own ``scan/`` spans (``utils/profiler.span``):
each device operation (kernel, copy, fill) goes to the innermost ``scan/``
span open at its launch (matched by ``correlation``) on the launching
thread, else on any thread (the backward's kernels launch from the autograd
engine's threads while ``scan/backward`` waits on the caller's). ``layers``
is the device ms of each innermost span name, ``idle_gaps`` the ten longest
gaps between device operations, each named by the span of the operation
after it.
"""

import bisect
import json
import sys
from collections import defaultdict

from ..utils.profiler import SPAN_PREFIX

KERNEL = "kernel"
HOST_OP = "cpu_op"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")


def _table(rows, top_n):
    """(name, self_us) pairs -> the top-N by total self time."""
    agg = defaultdict(lambda: [0, 0.0])
    for name, us in rows:
        agg[name][0] += 1
        agg[name][1] += us
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top_n]
    return [{"name": name, "count": n, "total_ms": us / 1e3,
             "mean_ms": us / 1e3 / n} for name, (n, us) in top]


def _host_self(events):
    """(name, self_us) of the host ops: nested ops on one thread are
    subtracted from the op that encloses them."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e["pid"], e["tid"])].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end, name, self_us]
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                _, name, us = stack.pop()
                out.append((name, us))
            if stack:
                stack[-1][2] -= e["dur"]
            stack.append([e["ts"] + e["dur"], e["name"], float(e["dur"])])
        out.extend((name, us) for _, name, us in stack)
    return out


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def _innermost(spans, starts, tid, ts):
    """The name of the innermost span open at ``ts``: on thread ``tid`` if
    one is, else on any thread; None outside every span. ``spans`` are
    (start, end, tid, name) sorted by start then by end, the outer first,
    ``starts`` their starts."""
    other = None
    for start, end, span_tid, name in reversed(
            spans[:bisect.bisect_right(starts, ts)]):
        if end >= ts:
            if span_tid == tid:
                return name
            other = other or name
    return other


def _spans(events, top_n=10):
    """The ``spans`` table: device ms by innermost ``scan/`` span and the
    ``top_n`` longest idle gaps named by span."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["tid"],
                     e["name"][len(SPAN_PREFIX):]) for e in events
                    if e["name"].startswith(SPAN_PREFIX)
                    and e.get("cat") != "gpu_user_annotation"),
                   key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
              if e.get("cat") in LAUNCHES
              and "correlation" in (e.get("args") or {})}
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_OPS:
            where = launch.get((e.get("args") or {}).get("correlation"))
            name = _innermost(spans, starts, *where) if where else None
            ops.append((e["ts"], e["dur"], e["name"], name or "unattributed"))
    layers = defaultdict(float)
    gaps, end = [], None
    for ts, dur, op, name in sorted(ops):
        layers[name] += dur
        if end is not None and ts > end:
            gaps.append({"before": name, "op": op[:60],
                         "gap_ms": (ts - end) / 1e3})
        end = ts + dur if end is None else max(end, ts + dur)
    gaps.sort(key=lambda g: -g["gap_ms"])
    return {"layers": {k: v / 1e3 for k, v in sorted(
                layers.items(), key=lambda kv: -kv[1])},
            "idle_gaps": gaps[:top_n]}


def summarise(path, top_n=25):
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == KERNEL]
    host = [e for e in events if e.get("cat") == HOST_OP]
    kernel_rows = [(e["name"], float(e["dur"])) for e in kernels]
    host_rows = _host_self(host)
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events)) if events else 0.0
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total = sum(us for _, us in kernel_rows) + sum(us for _, us in host_rows)
    return {"total_ms": total / 1e3, "window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_kernels": _table(kernel_rows, top_n),
            "host_ops": _table(host_rows, top_n),
            "spans": _spans(events)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    top = int(argv[1]) if len(argv) > 1 else 25
    out = summarise(argv[0], top)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
