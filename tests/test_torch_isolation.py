"""The port stands alone: importing every ``scan_tpu_torch`` module loads no
JAX, flax or ``scan_tpu`` module, and its entry points default to the card.

Runs in a subprocess, so the JAX that other tests import is not in the way.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, pkgutil, importlib, sys
import scan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scan_tpu_torch.__path__,
                                               "scan_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
             or m == "scan_tpu" or m.startswith("scan_tpu."))

import torch
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.inference import compute_predictions
from scan_tpu_torch.modeling.detector import build_detector
cfg = get_default_cfg()
cfg.merge_from_file("configs/scan/scan_vgg16_cityscapace_to_foggy.yaml")
try:
    build_detector(cfg)
    raised = False
except RuntimeError:
    raised = True
from scan_tpu_torch.modeling.generalized_rcnn import FasterRCNN
cfg = get_default_cfg()
cfg.MODEL.BACKBONE.CONV_BODY = "R-50-FPN"
try:
    FasterRCNN(cfg)
    rcnn_raised = False
except RuntimeError:
    rcnn_raised = True
print(json.dumps({"modules": names, "bad": bad, "raised": raised,
                  "rcnn_raised": rcnn_raised,
                  "cuda": torch.cuda.is_available()}))
"""


def test_port_imports_no_jax_and_defaults_to_the_card():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "scan_tpu_torch.modeling.detector" in res["modules"]
    for name in ("ops.cuda.nms_kernel", "ops.cuda.stem_kernel", "ops.quant",
                 "ops.cuda.conv0_kernel", "ops.cuda.phase_max_kernel",
                 "ops.cuda.stem_int8_kernel", "ops.focal_loss", "ops.iou_loss",
                 "modeling.fcos.targets", "modeling.fcos.loss",
                 "modeling.condgraph.sampling", "modeling.discriminator.grl",
                 "modeling.discriminator.discriminators", "solver.build",
                 "engine.train_step", "engine.trainer",
                 "evaluation.coco_eval", "utils.metric_logger",
                 "config.paths_catalog", "native", "data", "data.build",
                 "data.transforms", "data.datasets.coco",
                 "data.datasets.voc_xml", "data.datasets.concat",
                 "data.datasets.list_dataset", "evaluation.voc_eval",
                 "utils.checkpoint", "utils.logger", "utils.collect_env",
                 "utils.model_zoo", "utils.torch_weights",
                 "tools.test_net", "tools.train_net_da", "tools.train_net",
                 "tools.remove_solver_states", "modeling.backbone.resnet",
                 "modeling.anchors", "modeling.retinanet",
                 "modeling.atss.atss", "data.stats", "utils.c2_loading",
                 "modeling.generalized_rcnn", "modeling.rpn_anchor",
                 "modeling.roi_heads", "ops.roi_align"):
        assert "scan_tpu_torch." + name in res["modules"], name
    assert res["bad"] == []
    if not res["cuda"]:
        assert res["raised"], "build_detector(cfg) must raise without a card"
        assert res["rcnn_raised"], "FasterRCNN(cfg) must raise without a card"
