#!/usr/bin/env python3
"""The benchmark of ``scan_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
workload file ``benchmark/workloads/<cell>.json`` names the traffic kind
(``benchmark/traffic/<kind>.py``) and the configuration
(``benchmark/configs/<config>.json``). Set-up makes the weights and the
traffic from the seed on the card and warms up the cell's shapes; the
window then runs for ``--seconds``; the outputs of the timed path are then
compared with the plain reference (``benchmark/reference``). With
``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<name>.py``),
read from a short profiled slice after the window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error. Exits non-zero and prints no result
without enough CUDA cards, or when JAX or the JAX package was loaded.
Kernel builds and caches stay in ``build/`` inside the checkout.
"""

import argparse
import importlib
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    cell = core.Cell(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    need = cell.work["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = cell.work["traffic"]["kind"]
    traffic = importlib.import_module(f"benchmark.traffic.{kind}")
    r = traffic.run(cell)
    core.emit(cell, r["correct"], r["attempted"], r["failed"], r["metrics"],
              r["device"], r["checks"], r["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
