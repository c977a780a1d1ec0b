"""Profiling and timing utilities (counterpart of
``scan_tpu/utils/profiler.py``).

The reference's only instrumentation is a wall-clock Timer around eval and
loss meters in the train loop (reference ``fcos_core/utils/timer.py``,
``engine/trainer.py:426-463``). On the card: a ``torch.profiler`` trace
of the host's ops and the device's kernels, written as a Chrome trace JSON
(``tools/trace_summary.py`` reads it), of a block (``torch_trace``) or of
one call after warm-up calls (``trace_calls``), and a timer that waits for
the device, since CUDA launches return before the work is done.

The program's own spans and counters (``span``, ``count``) mark its layers
from the inside: the detector's forwards, the train step's backward,
all-reduce and optimizer, GST's node sampling, NMS. They record only while
a ``torch.profiler`` records or inside ``recording()``; otherwise a span
site costs one flag check and launches, allocates and records nothing. A
recording span opens ``record_function("scan/<name>")``, so it shows in
the Chrome trace beside the kernels it launches, stamps its host start and
end with ``time.time_ns()`` (the trace's clock: an event's ``ts +
baseTimeNanoseconds / 1e3``), and on the card records a pair of timing
events on the current stream. ``snapshot()`` sums the records by name;
``reset()`` clears them.
"""

import contextlib
import os
import threading
import time

import torch
from torch.profiler import record_function

SPAN_PREFIX = "scan/"
MAX_SPANS = 1 << 14


class Timer:
    """Reference utils/timer.py semantics."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls > 0 else 0.0


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_trace(log_dir: str, cuda=None):
    """Trace the block with ``torch.profiler``: the host's ops, and the
    device's kernels when ``cuda`` (default: a card is there). Writes
    ``log_dir/trace.json``, a Chrome trace. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def trace_calls(log_dir: str, fn, warmup: int = 1, cuda=None):
    """Trace one call of ``fn`` after ``warmup`` calls under the profiler's
    warm-up schedule (the tracer starts during those, so it loses no event
    of the traced call) into ``log_dir/trace.json``. Returns the traced
    call's output."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warmup, active=1,
                                   repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(warmup + 1):
            out = fn()
            _sync(out)
            prof.step()
    return out


def _sync(out):
    """Wait for the device of the first tensor found in ``out``."""
    import torch

    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))


def synced_time(fn, *args):
    """(seconds, output) of ``fn(*args)`` with the device's work included:
    the output's device is synchronised before the clock stops (nothing to
    wait for on the CPU)."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    return time.perf_counter() - t0, out


class _NoSpan:
    """What ``span`` returns when nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """Bounded in-memory spans and counters of one process. A record is
    ``[name, parent record or None, root id, host start ns, host end ns,
    start event, end event]``; the root id numbers the outermost spans (a
    step, a batch), the events are None off the card. Spans past
    ``capacity`` open their ``record_function`` but are not kept
    (``dropped`` counts them)."""

    def __init__(self, capacity=MAX_SPANS):
        self.capacity = capacity
        self.forced = 0  # depth of ``recording()`` blocks
        self._local = threading.local()  # the open spans of each thread
        self._events = []  # timing events free for reuse
        self.records = []
        self.reset()

    def reset(self):
        """Forget every record and counter; their events go back to the
        pool."""
        for rec in self.records:
            if rec[5] is not None:
                self._events += rec[5:7]
        self.records = []
        self.roots = 0
        self.dropped = 0
        self.host_counts = {}
        self.tensor_counts = {}

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        return (self._events.pop() if self._events
                else torch.cuda.Event(enable_timing=True))

    def open(self, name):
        """Start a span; returns its record (None when dropped)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if len(self.records) >= self.capacity:
            self.dropped += 1
            stack.append(parent)  # its children nest under the kept parent
            return None
        if parent is None:
            root = self.roots
            self.roots += 1
        else:
            root = parent[2]
        rec = [name, parent, root, time.time_ns(), None, None, None]
        if torch.cuda.is_initialized():
            rec[5], rec[6] = self._event(), self._event()
            rec[5].record()
        self.records.append(rec)
        stack.append(rec)
        return rec

    def close(self, rec):
        self._stack().pop()
        if rec is not None:
            if rec[6] is not None:
                rec[6].record()
            rec[4] = time.time_ns()

    def count(self, name, value):
        """A host int is added at once; a tensor is kept and summed by
        ``snapshot``, so counting launches nothing while spans record (the
        first sum a process launches loads its kernel: 24 ms of host time
        on an H100). ``capacity`` tensors of one name are folded into one
        sum on their device."""
        if not isinstance(value, torch.Tensor):
            self.host_counts[name] = self.host_counts.get(name, 0) + int(value)
            return
        held = self.tensor_counts.setdefault(name, [])
        held.append(value)
        if len(held) >= self.capacity:
            held[:] = [_sum(held)]

    def snapshot(self):
        """Wait for the card and sum the closed records by name: ``spans``
        {name: {calls, host_ms, host_self_ms, device_ms}} (``device_ms``
        None off the card), ``counters`` {name: int}, ``dropped``."""
        done = [r for r in self.records if r[4] is not None]
        if torch.cuda.is_initialized() and any(r[5] is not None
                                               for r in done):
            torch.cuda.synchronize()
        inner = {}  # id(parent) -> host ns of its closed children
        for rec in done:
            if rec[1] is not None:
                inner[id(rec[1])] = inner.get(id(rec[1]), 0) + rec[4] - rec[3]
        spans = {}
        for rec in done:
            s = spans.setdefault(rec[0], {"calls": 0, "host_ms": 0.0,
                                          "host_self_ms": 0.0,
                                          "device_ms": None})
            ns = rec[4] - rec[3]
            s["calls"] += 1
            s["host_ms"] += ns / 1e6
            s["host_self_ms"] += (ns - inner.get(id(rec), 0)) / 1e6
            if rec[5] is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + rec[5].elapsed_time(
                    rec[6])
        counters = dict(self.host_counts)
        for name, held in self.tensor_counts.items():
            counters[name] = counters.get(name, 0) + int(_sum(held))
        return {"spans": spans, "counters": counters, "dropped": self.dropped}


def _sum(tensors):
    """The sum of every element of ``tensors`` (one device), as a tensor."""
    return torch.stack([t.sum() for t in tensors]).sum()


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = record_function(SPAN_PREFIX + self.name)
        self.range.__enter__()
        self.rec = RECORDER.open(self.name)

    def __exit__(self, *exc):
        RECORDER.close(self.rec)
        self.range.__exit__(*exc)
        return False


RECORDER = Recorder()


def span(name):
    """A context manager around one layer's work, ``scan/<name>`` in the
    trace; a no-op unless spans are recording."""
    if RECORDER.forced or torch.autograd._profiler_enabled():
        return _Span(name)
    return _NO_SPAN


def count(name, value):
    """Add ``value`` to the counter ``name``: a host int, or a tensor whose
    elements' sum ``snapshot()`` adds (the tensor is kept until then and
    must not be written in place). A no-op unless spans are recording."""
    if RECORDER.forced or torch.autograd._profiler_enabled():
        RECORDER.count(name, value)


@contextlib.contextmanager
def recording():
    """Record spans and counters in the block without a profiler (tests and
    one-off measurements)."""
    RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        RECORDER.forced -= 1


def snapshot():
    """``Recorder.snapshot`` of the process's recorder."""
    return RECORDER.snapshot()


def reset():
    """Clear the process's records and counters."""
    RECORDER.reset()
