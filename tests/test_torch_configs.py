"""Every config in ``configs/`` builds in the port, on the CPU, at its own
widths (no forward): ``build_detector`` with the seeded init, for training
and for evaluation. The R-101 configs get a ResNet-101 body with its
FrozenBatchNorms, the ATSS config an ATSS head, the rest VGG16 and FCOS.
"""

import glob
import os

import pytest
import torch

from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.backbone.resnet import ResNet
from scan_tpu_torch.modeling.backbone.vgg import VGG16
from scan_tpu_torch.modeling.detector import build_detector

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*", "*.yaml")))


def test_configs_are_the_fourteen():
    assert len(CONFIGS) == 14
    assert sum("R_101" in c for c in CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(c)
                                               for c in CONFIGS])
def test_every_config_builds(path):
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    det = build_detector(cfg, device="cpu", train=True)
    body = det.backbone.body
    if "R_101" in path:
        assert isinstance(body, ResNet) and sum(body.stage_blocks) == 33
        assert body.channels == (256, 512, 1024, 2048)
    else:
        assert isinstance(body, VGG16)
    assert type(det.fcos).__name__ == ("ATSSHead" if "atss" in path
                                       else "FCOSHead")
    assert det.num_classes == (cfg.MODEL.ATSS.NUM_CLASSES if "atss" in path
                               else cfg.MODEL.FCOS.NUM_CLASSES)
    assert all(p.dtype == torch.float32 for p in det.parameters())
    assert len(det.dis_names) > 0
