"""The port's VGG16-FPN against ``scan_tpu``'s on the CPU, float32.

Same seeded NHWC input, ``scan_tpu``'s initialised parameters carried across
by ``scan_tpu_torch/utils/jax_weights.py``; C1..C5 and P3..P7 must agree
within rtol 1e-4, atol 1e-5 (float32 convolutions summed in another order).
Small sizes: VGG width / 4 and a 64x96 input; one variant also shortens the
stages and the FPN inputs, as ``TPU.VGG_STAGE_BLOCKS`` / ``FPN_IN_FEATURES``
allow.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.backbone.build import build_backbone as jax_build_backbone
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.backbone.build import build_backbone
from scan_tpu_torch.utils.jax_weights import convert_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")

VARIANTS = {
    "vgg16": [],
    # shortened stages and FPN inputs, and the FPN's other switches
    "short": ["TPU.VGG_STAGE_BLOCKS", [1, 1, 1, 1, 1],
              "TPU.FPN_IN_FEATURES", [3, 4], "MODEL.FPN.USE_GN", True,
              "MODEL.FPN.USE_RELU", True, "MODEL.RETINANET.USE_C5", True],
    "no_top": ["TPU.FPN_TOP_BLOCK", "none"],
}


def _cfg(base, variant):
    cfg = base
    cfg.merge_from_file(C2F)
    cfg.TPU.VGG_WIDTH_DIV = 4
    cfg.merge_from_list(VARIANTS[variant])
    return cfg


def port_backbone_from_jax(cfg, params):
    bb = build_backbone(cfg)
    sd = {k[len("backbone."):]: v
          for k, v in convert_params({"backbone": params}).items()}
    bb.load_state_dict(sd, strict=True)
    return bb.eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_backbone_matches_scan_tpu(variant):
    jbb = jax_build_backbone(_cfg(jax_default_cfg(), variant))
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    params = jbb.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jax.device_get(jbb.apply(params, jnp.asarray(x)))
    bb = port_backbone_from_jax(_cfg(get_default_cfg(), variant),
                                jax.device_get(params))
    with torch.no_grad():
        got = bb(torch.from_numpy(x))
        body = bb.body(torch.from_numpy(x))
    assert len(got) == len(want)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, lvl
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"P{lvl + 3}")
    jbody = jax.device_get(jbb.body_cls(**jbb.body_kwargs).apply(
        {"params": params["params"]["body"]}, jnp.asarray(x)))
    for i, (g, w) in enumerate(zip(body, jbody)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"C{i + 1}")


def test_public_layout_is_nhwc_over_channels_last():
    cfg = _cfg(get_default_cfg(), "vgg16")
    bb = build_backbone(cfg).eval()
    with torch.no_grad():
        outs = bb(torch.zeros(1, 64, 96, 3))
    assert [tuple(o.shape) for o in outs] == [
        (1, 8, 12, 256), (1, 4, 6, 256), (1, 2, 3, 256), (1, 1, 2, 256),
        (1, 1, 1, 256)]
    # NHWC views of channels_last memory: the last dim is contiguous
    assert all(o.stride(-1) == 1 for o in outs)
