"""The harness is driven by data: cells, configurations and per-layer
metrics are files found by the names in ``BENCHMARK.json``."""

import json
import shutil

from benchmark.harness import core

ROOT = core.ROOT


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        work = json.loads((core.HERE / "workloads" / f"{w['name']}.json").read_text())
        kind = work["traffic"]["kind"]
        assert (core.HERE / "traffic" / f"{kind}.py").is_file()
    for m in b["per_layer"]:
        assert (core.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_file_dropped_into_a_copy_is_found(tmp_path):
    (tmp_path / "benchmark").mkdir()
    for sub in ("workloads", "configs"):
        shutil.copytree(core.HERE / sub, tmp_path / "benchmark" / sub)
    b = bench()
    work = json.loads((core.HERE / "workloads" / "scan_c2f.da_gst_f32.json").read_text())
    work["traffic"]["batch"] = 2
    (tmp_path / "benchmark" / "workloads" / "scan_c2f.da_half.json").write_text(
        json.dumps(work))
    b["workloads"].append({"name": "scan_c2f.da_half", "config": "scan_c2f",
                           "traffic": "da_half", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.Cell("scan_c2f.da_half", 2 ** 31 + 5, 1, False, root=tmp_path)
    assert cell.work["traffic"]["batch"] == 2
    assert cell.cfg["MODEL"]["BACKBONE"]["CONV_BODY"] == "VGG-16-FPN-RETINANET"
    # a metric without a ``workloads`` key reaches every cell of its metric
    assert [m["name"] for m in cell.end_to_end()] == ["setup_s"]
    b["per_layer"].append({"name": "x.setup_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.Cell("scan_c2f.da_half", 1, 1, False, root=tmp_path)
    assert [m["name"] for m in cell.per_layer()] == ["x.setup_ms"]


def test_per_layer_metrics_follow_their_cells():
    cell = core.Cell("epm_r101.da_f32", 1, 1, True)
    names = {m["name"] for m in cell.per_layer()}
    assert "train.backward_ms" in names
    assert "train.condgraph_ms" not in names  # EPM has no condgraph
    assert not any(n.startswith("eval.") for n in names)
    assert {m["name"] for m in cell.end_to_end()} == {"train_img_s", "setup_s"}


def test_readers_return_none_where_nothing_was_read():
    cell = core.Cell("scan_c2f.da_gst_f32", 1, 1, True)
    summary = {"ops": [("sgemm", "backward", 0.0, 0.01)], "busy_s": 0.01,
               "units": 2}
    ctx = type("Ctx", (), dict(summary=summary, window_s=0.02, unit_s=0.5,
                               cfg=cell.cfg, work=cell.work))
    got = core.read_layers(cell, ctx)
    assert got["train.backward_ms"]["value"] == 5.0
    assert got["train.device_idle_pct"]["value"] == 50.0
    for name in ("train.backbone_ms", "train.condgraph_ms",
                 "train.k2_roofline_pct"):
        assert name not in got  # nothing launched there: left out
    assert 0 < got["train.mfu_pct"]["value"] < 100


def test_step_mfu_counts_the_global_batch_once():
    """Four cards, each on its quarter of a 4x batch in the same time a
    step, read the one-card cell's share of their four-fold peak."""
    def mfu(name):
        cell = core.Cell(name, 1, 1, True)
        summary = {"ops": [], "busy_s": 1.0, "units": 2}
        ctx = type("Ctx", (), dict(summary=summary, window_s=2.0,
                                   unit_s=0.5, cfg=cell.cfg, work=cell.work))
        return core.read_layers(cell, ctx)["train.mfu_pct"]["value"]

    assert abs(mfu("epm_r101.da_f32.x4") - mfu("epm_r101.da_f32")) < 1e-9
