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
"""

import json
import sys
from collections import defaultdict

KERNEL = "kernel"
HOST_OP = "cpu_op"


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
            "host_ops": _table(host_rows, top_n)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    top = int(argv[1]) if len(argv) > 1 else 25
    out = summarise(argv[0], top)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
