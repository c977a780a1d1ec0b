"""A whole run on the CPU at a small size, past the harness's look for a
card, with the timed path sound and then broken underneath: the sound run
comes out correct, each fault's run does not, under the cells' own
limits."""

import importlib

import pytest
import torch

from benchmark.traffic import dp_da_step

from benchmark.harness import core
from benchmark.tests import faults

SMALL = {"batch": 2, "pad": [64, 128], "frame": [128, 256],
         "min_size_range": [60, 64], "max_size": 128, "pool": 3,
         "max_boxes": 10, "boxes_mean": 3, "boxes_max": 6}


def run(name, fault=None):
    cell = core.Cell(name, 2 ** 31 + 29, 0.0, False)
    cell.device = "cpu"
    cell.work["traffic"].update(SMALL)
    cell.work["check_steps"] = 2
    cell.work["check_batches"] = 2
    kind = cell.work["traffic"]["kind"]
    return importlib.import_module(f"benchmark.traffic.{kind}").run(
        cell, fault)


@pytest.mark.parametrize("name", ["scan_c2f.da_gst_f32", "epm_r101.da_f32"])
@pytest.mark.parametrize("fault", [None, *faults.DA_FAULTS])
def test_da_step(name, fault):
    r = run(name, fault and faults.DA_FAULTS[fault])
    assert r["correct"] == (fault is None), r["checks"]


@pytest.mark.parametrize("fault", [None, *faults.EVAL_FAULTS])
def test_eval_loop(fault):
    r = run("scan_c2f.eval_bf16_b8", fault and faults.EVAL_FAULTS[fault])
    assert r["correct"] == (fault is None), r["checks"]


def test_dp_rank_that_loads_jax_prints_no_result(monkeypatch):
    """The four-card cell on gloo: a rank other than 0 that loaded JAX
    exits non-zero, and rank 0 then gives no result."""
    cell = core.Cell("epm_r101.da_f32.x4", 2 ** 31 + 31, 0.0, False)
    traffic = {**cell.work["traffic"], **SMALL, "batch": 4, "pool": 2}
    cell = core.Cell("epm_r101.da_f32.x4", 2 ** 31 + 31, 0.0, False,
                     {"traffic": traffic, "check_steps": 1})
    cell.device = "cpu"
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # four processes share the host
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.raises(RuntimeError, match=r"a rank failed: \[3, 3, 3\]"):
            dp_da_step.run(cell, faults.loads_jax_off_rank0)
    finally:
        torch.set_num_threads(threads)
