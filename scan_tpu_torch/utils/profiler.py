"""Profiling and timing utilities (counterpart of
``scan_tpu/utils/profiler.py``).

The reference's only instrumentation is a wall-clock Timer around eval and
loss meters in the train loop (reference ``fcos_core/utils/timer.py``,
``engine/trainer.py:426-463``). On the card: a ``torch.profiler`` trace
of the host's ops and the device's kernels, written as a Chrome trace JSON
(``tools/trace_summary.py`` reads it), of a block (``torch_trace``) or of
one call after warm-up calls (``trace_calls``), and a timer that waits for
the device, since CUDA launches return before the work is done.
"""

import contextlib
import os
import time


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
