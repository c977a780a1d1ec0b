"""Smoothed training metrics (a copy of ``scan_tpu/utils/metric_logger.py``;
reference ``fcos_core/utils/metric_logger.py``)."""

from collections import defaultdict, deque


class SmoothedValue:
    """Median/avg over a window plus a global average
    (reference metric_logger.py:10-40)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        # NaN-honest: Python sorted() over a NaN-polluted window has
        # undefined NaN placement, so the old midpoint pick could return a
        # stale finite value and HIDE a training collapse (seen in the
        # round-4 stability run: global_avg went nan at iter 1840 while the
        # median column kept printing finite numbers). Any non-finite entry
        # in the window now makes the median nan.
        d = list(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        if any(v != v for v in d):
            return float("nan")
        d.sort()
        return d[n // 2] if n % 2 else 0.5 * (d[n // 2 - 1] + d[n // 2])

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )
