"""On the card, at each cell's own size: the readings of sound runs over a
dozen seeds, of the control (the same program a precision lower: TF32 on
for a float32 cell, its w8a8 int8 path for a bf16 one) and of the planted
faults over three, all in one process. Each reading is printed as a JSON
line (``CONTROL {...}``; run with ``-s``) before the test asserts that
every sound run is correct and every control and fault run is not.

    python -m pytest benchmark/tests/test_bench_control.py -m gpu -s
"""

import importlib
import json

import pytest
import torch

from benchmark.harness import core
from benchmark.tests import faults

SOUND_SEEDS = [2 ** 31 + 101 * i for i in range(12)]
CONTROL_SEEDS = SOUND_SEEDS[:3]
CONTROL = {
    "da_step": {"tf32": True},
    "dp_da_step": {"tf32": True},
    "eval_loop": {"overrides": ["TPU.INT8_INFERENCE", True],
                  "calibrate_batches": 2},
}
CELLS = ["scan_c2f.da_gst_f32", "scan_c2f.eval_bf16_b8", "epm_r101.da_f32",
         "epm_r101.da_f32.x4"]
# the four-card cell reads its other sound seeds in its full sets, and a
# state left unchanged reads 1 by its measure: one run shows the test sees it
FEWER = {"epm_r101.da_f32.x4": {"sound": 3, "state_unchanged": 1}}
FAULTS = {"da_step": faults.DA_FAULTS, "dp_da_step": faults.DP_FAULTS,
          "eval_loop": faults.EVAL_FAULTS}


@pytest.fixture
def card(request):
    name = request.node.callspec.params["name"]
    chips = {w["name"]: w["chips"] for w in json.loads(
        (core.ROOT / "BENCHMARK.json").read_text())["workloads"]}[name]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")


def readings(name, seed, overrides=None, fault=None):
    """One run's correct flag and readings, with no measured window."""
    import scan_tpu_torch.engine.dp as dp

    cell = core.Cell(name, seed, 0.0, False, overrides)
    kind = cell.work["traffic"]["kind"]
    dist = dp.dist  # a fault may patch it in this process
    try:
        r = importlib.import_module(f"benchmark.traffic.{kind}").run(
            cell, fault)
    finally:
        dp.dist = dist
    return r["correct"], r["readings"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(card, name):
    kind = json.load(open(core.HERE / "workloads" / f"{name}.json"))[
        "traffic"]["kind"]
    fewer = FEWER.get(name, {})
    plan = [("sound", s, None, None)
            for s in SOUND_SEEDS[:fewer.get("sound", 12)]]
    plan += [("control", s, CONTROL[kind], None) for s in CONTROL_SEEDS]
    plan += [(f, s, None, fn) for f, fn in FAULTS[kind].items()
             for s in CONTROL_SEEDS[:fewer.get(f, 3)]]
    got = []
    for arm, seed, over, fault in plan:
        ok, r = readings(name, seed, over, fault)
        print("CONTROL", json.dumps({"cell": name, "arm": arm, "seed": seed,
                                     "correct": ok, "readings": r}),
              flush=True)
        got.append((arm, ok))
    assert all(ok for arm, ok in got if arm == "sound")
    assert not any(ok for arm, ok in got if arm != "sound")
