"""Data-parallel training from the port's CLIs (the counterpart of
``tests/test_dp_cli.py``): ``python -m torch.distributed.run --standalone
--nproc-per-node 2`` (``--standalone`` picks a free local port) of
``train_net_da --distributed --use-tensorboard`` and of ``train_net
--distributed``, ``MODEL.DEVICE cpu`` (gloo), on ``tools/stability_run.py``'s
synthetic Cityscapes-shaped set at 64x128, the C2F model cut as in
``tests/test_torch_harnesses.py``. ``train_net_da`` runs 2 iterations with a
validation at 2: the log says ``data-parallel over 2 processes``, the run
exits 0, rank 0 alone logs and writes each checkpoint once, and TensorBoard
events are written. A batch that does not split over the processes raises.
"""

import os
import subprocess
import sys

import pytest

from scan_tpu_torch.tools.stability_run import make_synth_cityscapes
from test_torch_harnesses import C2F, CUT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_cli_data"))
    return make_synth_cityscapes(root, n_train=4, n_val=4, hw=(64, 128))


def torchrun(data, module, args, timeout=240):
    env = dict(os.environ, SCAN_TPU_DATA_DIR=data, PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", f"scan_tpu_torch.tools.{module}",
         "--distributed", "--config-file", C2F, *args, *CUT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_train_net_da_two_processes(data, tmp_path):
    out = tmp_path / "out"
    proc = torchrun(data, "train_net_da", [
        "--use-tensorboard", "MODEL.WEIGHT", "", "SOLVER.MAX_ITER", "2",
        "SOLVER.VAL_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "100",
        "SOLVER.INITIAL_AP50", "0", "TEST.IMS_PER_BATCH", "2",
        "OUTPUT_DIR", str(out)])
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert log.count("data-parallel over 2 processes") == 1
    assert log.count("saved checkpoint") == log.count("model_final.pth")
    assert log.count("model_final.pth") == 1
    assert "validation @2:" in log
    files = sorted(os.listdir(out))
    assert "model_final.pth" in files and "last_checkpoint" in files
    assert not [f for f in files if f.endswith(".tmp")], files
    assert (out / "log.txt").read_text().count("iter: 2") == 1
    assert any("tfevents" in f for f in os.listdir(out / "tb"))


def test_train_net_two_processes(data, tmp_path):
    out = tmp_path / "out"
    proc = torchrun(data, "train_net", [
        "MODEL.WEIGHT", "", "SOLVER.MAX_ITER", "2",
        "SOLVER.CHECKPOINT_PERIOD", "100", "OUTPUT_DIR", str(out)])
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert log.count("data-parallel over 2 processes") == 1
    assert log.count("saved checkpoint") == 1
    assert "model_final.pth" in os.listdir(out)


def test_batch_that_does_not_split_raises(data, tmp_path):
    proc = torchrun(data, "train_net_da", [
        "MODEL.WEIGHT", "", "SOLVER.MAX_ITER", "2", "TEST.IMS_PER_BATCH", "3",
        "OUTPUT_DIR", str(tmp_path / "out")])
    assert proc.returncode != 0
    assert "TEST.IMS_PER_BATCH=3 does not split over 2 processes" in (
        proc.stdout + proc.stderr)
