"""What every cell's run shares: the cell's files, the clock of set-up,
the device line, the per-layer readers, the isolation check and the
result line."""

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scan_tpu")


def process_start():
    """The epoch second this process started (``/proc``), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime"):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``scan_tpu_torch`` is not ``scan_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files, found by name
    under ``root`` (the checkout)."""

    def __init__(self, name, seed, seconds, trace, overrides=None,
                 root=ROOT):
        here = Path(root) / "benchmark"
        self.bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry
        self.work = json.loads((here / "workloads" / f"{name}.json").read_text())
        self.overrides = dict(overrides or {})
        self.work.update(self.overrides)
        self.work["chips"] = entry["chips"]
        config = {c["name"]: c for c in self.bench["configs"]}[entry["config"]]
        self.config = json.loads((Path(root) / config["file"]).read_text())
        self.cfg = self.config["cfg"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.start = process_start()
        self.device = "cuda"

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def read_layers(cell, ctx):
    """Each per-layer metric of the cell from its reader
    ``metrics/<name>.py``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.per_layer():
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(torch, count):
    if not torch.cuda.is_available():  # a rehearsal on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def emit(cell, correct, attempted, failed, metrics, device, checks,
         breakdown=None):
    """The checks on stderr, then the one result line on stdout (the
    checks last in it). Exits 3, printing no result, when a forbidden
    module was loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
