"""The port's training harnesses and small tools on the CPU.

* ``tools/stability_run.py`` drives ``train_net_da`` on its synthetic
  Cityscapes-shaped set (8 + 8 frames of 64x128, 4 fogged val frames) for
  40 iterations, SIGKILLs it once the log shows iteration 30 (a periodic
  checkpoint) and relaunches it; all four of its assertions must pass. To
  fit the CPU the C2F model is cut: VGG width / 8, one conv in each FCOS
  tower and the condgraph's input tower, the CON discriminator on P7 only
  with one shared conv.
* ``tools/nan_bisect.py`` from that run's checkpoint at 30: two finite
  steps; then from a copy with a NaN in ``fcos.bbox_pred.weight``, which it
  must report at the first step and save the state and batches before it.
* ``tools/loader_bench.py`` with ``--n 4``.
* ``tools/da_efficacy.py``'s ``generate`` writes the same bytes and
  annotations as ``tools/da_efficacy.py``'s for one seed, and
  ``parse_validations`` agrees on the same text.

``VisTools`` and ``tools/webcam.py`` are held in
``tests/test_torch_package_surface.py``, which is lighter.
"""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scan_tpu_torch.tools import da_efficacy, loader_bench, nan_bisect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2F = os.path.join(REPO, "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
CUT = [
    "MODEL.DEVICE", "cpu", "TPU.VGG_WIDTH_DIV", "8",
    "INPUT.MIN_SIZE_RANGE_TRAIN", "(-1,-1)", "INPUT.MIN_SIZE_TRAIN", "(64,)",
    "INPUT.MAX_SIZE_TRAIN", "128", "INPUT.MIN_SIZE_TEST", "64",
    "INPUT.MAX_SIZE_TEST", "128", "SOLVER.IMS_PER_BATCH", "2",
    "TPU.MAX_BOXES", "4", "TPU.MAX_NODES", "32",
    "TPU.MAX_TARGET_POINTS", "32", "MODEL.FCOS.NUM_CONVS_REG", "1",
    "MODEL.FCOS.NUM_CONVS_CLS", "1", "MODEL.MIDDLE_HEAD.NUM_CONVS_IN", "1",
    "MODEL.ADV.CON_NUM_SHARED_CONV_P7", "1",
    *[x for p in ("P3", "P4", "P5", "P6")
      for x in (f"MODEL.ADV.USE_DIS_{p}_CON", "False")],
]


def _load_reference_tool(name):
    """``tools/<name>.py`` of the repo (a script directory, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def stability(tmp_path_factory):
    root = tmp_path_factory.mktemp("stability")
    out, data = root / "out", root / "data"
    proc = subprocess.run(
        [sys.executable, "-m", "scan_tpu_torch.tools.stability_run",
         "--iters", "40", "--kill-frac", "0.75", "--val-iter", "20",
         "--ckpt-period", "10", "--out", str(out), "--data", str(data),
         "--n-train", "8", "--n-val", "4", "--hw", "64", "128",
         "--min-readings", "2", "--timeout", "150", *CUT],
        cwd=REPO, capture_output=True, text=True, timeout=200,
        env=dict(os.environ, PYTHONPATH=REPO))
    return proc, out, data


def test_stability_run_passes_its_asserts(stability):
    proc, out, _ = stability
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    summary = json.loads([line for line in proc.stdout.splitlines()
                          if line.startswith("{")][-1])
    assert summary["verdict"] == "PASS" and summary["killed_at"] == 30
    assert summary["validations"] == 2 and summary["best_ckpts"] >= 1
    assert summary["tail"] < summary["head"]
    log = (out / "run.log").read_text()
    assert "restored" in log and "at iteration 30" in log
    assert (out / "stability_run.log").read_text().startswith(
        "# STABILITY RUN PASS")


def test_stability_check_log_reports_each_failure():
    """A log that breaks each assertion names it."""
    text = ("iter: 20 x loss_total: 2.0 (2.0)\n"
            "iter: 40 x loss_total: nan (nan)\n"
            "validation @40: AP50=0.0\n")
    failures, _ = _stability_tool().check_log(text, 40, 30, 2)
    joined = "\n".join(failures)
    for want in ("no 'restored", "non-finite loss", "validation fired 1",
                 "no best-AP50"):
        assert want in joined, failures


def _stability_tool():
    from scan_tpu_torch.tools import stability_run

    return stability_run


def test_nan_bisect_from_checkpoint(stability, tmp_path, monkeypatch,
                                    capsys):
    proc, out, data = stability
    assert proc.returncode == 0
    from scan_tpu_torch.config.paths_catalog import DatasetCatalog

    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", str(data))
    args = ["--config-file", C2F, "--until", "32", *CUT,
            "OUTPUT_DIR", str(tmp_path / "bisect")]
    ckpt = out / "model_0000030.pth"
    assert nan_bisect.main(["--ckpt", str(ckpt), *args]) == 0
    said = capsys.readouterr().out
    assert "restored" in said and "at iteration 30" in said
    assert "iter 32: loss_total=" in said and "no nonfinite" in said

    state = torch.load(ckpt, weights_only=True)
    state["model"]["fcos.bbox_pred.weight"][0, 0, 0, 0] = float("nan")
    bad = tmp_path / "bad.pth"
    torch.save(state, bad)
    prev = tmp_path / "prev"
    assert nan_bisect.main(["--ckpt", str(bad), "--save-prev", str(prev),
                            *args[:-1], str(tmp_path / "bisect2")]) == 1
    said = capsys.readouterr().out
    assert "FIRST NONFINITE at iter 31" in said
    saved = torch.load(prev / "prenan.pth", weights_only=True)
    assert saved["iteration"] == 30
    assert torch.isnan(saved["model"]["fcos.bbox_pred.weight"]).any()
    batches = np.load(prev / "batches.npz")
    assert batches["s_images"].shape[0] == 2 and "t_images" in batches


def test_loader_bench_prints_rows(capsys):
    rows = loader_bench.main(["--n", "4", "--hw", "64", "128", "--threads",
                              "1", "2", "--batch", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines == rows and len(rows) == 2 * 2
    assert [(r["threads"], r["pass"]) for r in rows] == [
        (1, "cold"), (1, "cached"), (2, "cold"), (2, "cached")]
    for r in rows:
        assert r["img_per_sec"] > 0 and r["native"]
        assert r["decode"] == ("native" if r["codecs"] else "pillow")


def test_da_efficacy_generate_and_parse_match_reference(tmp_path):
    ref = _load_reference_tool("da_efficacy")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    da_efficacy.generate(str(ours), 3, 2, (96, 128), seed=5)
    ref.generate(str(theirs), 3, 2, (96, 128), seed=5)
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert len(files) == 3 + 3 + 2 + 3
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    for f in files:
        assert filecmp.cmp(ours / f, theirs / f, shallow=False), f
    text = ("x validation @250: AP50=12.5\nvalidation @500: AP=3e-1\n"
            "validation @750: AP50=nan\n")
    assert da_efficacy.parse_validations(text) == ref.parse_validations(text)
    assert da_efficacy.parse_validations(text) == [(250, 12.5), (500, 0.3)]
    assert da_efficacy.lr_decay_opts(1500) == ref.lr_decay_opts(1500)
