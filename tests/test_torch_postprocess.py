"""The port's FCOS head, mode mixing and postprocess against ``scan_tpu``'s.

Head: ``scan_tpu``'s ``FCOSHead`` parameters carried across by
``scan_tpu_torch/utils/jax_weights.py``; logits, box regression and
centerness must agree within rtol 1e-4, atol 1e-5 (float32 convolutions
summed in another order), with the cls tower and without it (light mode).

Postprocess: both get identical inputs. ``valid`` and ``labels`` must be
equal and so must the boxes on valid slots (decode and clip are the same
float32 additions and clamps); scores on valid slots may differ by the last
bit of the sigmoid, so they are held to rtol 1e-6. Invalid slots are not
compared: ``torch.topk`` orders NEG_INF ties differently from
``lax.top_k``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.fcos.head import FCOSHead as JaxFCOSHead
from scan_tpu.modeling.fcos.module import mix_cls_maps as jax_mix_cls_maps
from scan_tpu.modeling.fcos.postprocess import PostProcessConfig as JaxPPConfig
from scan_tpu.modeling.fcos.postprocess import fcos_postprocess as jax_postprocess
from scan_tpu.ops.locations import compute_locations as jax_locations
from scan_tpu_torch.modeling.fcos.head import FCOSHead
from scan_tpu_torch.modeling.fcos.module import mix_cls_maps
from scan_tpu_torch.modeling.fcos.postprocess import PostProcessConfig, fcos_postprocess
from scan_tpu_torch.ops.locations import compute_locations
from scan_tpu_torch.utils.jax_weights import convert_params

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
STRIDES = (8, 16, 32, 64, 128)
NC = 9


def test_locations_match():
    for g, w in zip(compute_locations(SHAPES, STRIDES),
                    jax_locations(SHAPES, STRIDES)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("compute_cls", [True, False])
def test_head_matches_scan_tpu(compute_cls):
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, h, w, 256).astype(np.float32) for h, w in SHAPES[:3]]
    jhead = JaxFCOSHead(num_classes=NC, num_convs_cls=1, num_convs_reg=2,
                        num_levels=3)
    jf = [jnp.asarray(f) for f in feats]
    params = jhead.init(jax.random.PRNGKey(4), jf)
    want = jax.device_get(jhead.apply(params, jf, compute_cls))
    head = FCOSHead(NC, num_convs_cls=1, num_convs_reg=2, num_levels=3)
    sd = {k[len("fcos."):]: v for k, v in
          convert_params({"fcos": jax.device_get(params)}).items()}
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats], compute_cls)
    assert len(got[0]) == (3 if compute_cls else 0)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


def _head_outputs(seed, b=2):
    rng = np.random.RandomState(seed)
    logits = [(rng.randn(b, h, w, NC - 1) * 2 - 1).astype(np.float32)
              for h, w in SHAPES]
    act = [rng.dirichlet(np.ones(NC), (b, h, w)).astype(np.float32)
           for h, w in SHAPES]
    reg = [np.exp(rng.randn(b, h, w, 4) * 0.5 + 3).astype(np.float32)
           for h, w in SHAPES]
    ctr = [rng.randn(b, h, w, 1).astype(np.float32) for h, w in SHAPES]
    return logits, act, reg, ctr


@pytest.mark.parametrize("mode", ["common", "precision", "light"])
@pytest.mark.parametrize("pre_top,cap,min_size", [(50, 64, 0.0), (4000, 512, 8.0)])
def test_postprocess_matches_scan_tpu(mode, pre_top, cap, min_size):
    logits, act, reg, ctr = _head_outputs(len(mode) + pre_top)
    sizes = np.asarray([[128, 192], [100, 150]], np.int32)
    kw = dict(pre_nms_thresh=0.05, pre_nms_top_n=pre_top, nms_thresh=0.6,
              fpn_post_nms_top_n=20, min_size=min_size, num_classes=NC,
              nms_cap=cap)

    jcls, sig = jax_mix_cls_maps(mode, [jnp.asarray(x) for x in logits],
                                 [jnp.asarray(x) for x in act])
    want = jax.device_get(jax_postprocess(
        JaxPPConfig(apply_sigmoid=sig, **kw), jax_locations(SHAPES, STRIDES),
        jcls, [jnp.asarray(x) for x in reg], [jnp.asarray(x) for x in ctr],
        jnp.asarray(sizes)))

    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    tcls, tsig = mix_cls_maps(mode, t(logits), t(act))
    assert tsig == sig
    for g, w in zip(tcls, jcls):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    got = {k: v.numpy() for k, v in fcos_postprocess(
        PostProcessConfig(apply_sigmoid=sig, **kw),
        compute_locations(SHAPES, STRIDES), tcls, t(reg), t(ctr),
        torch.from_numpy(sizes)).items()}

    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() >= 10, "the case needs detections to compare"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_array_equal(got["labels"][~v], 0)
    np.testing.assert_array_equal(got["boxes"][v], want["boxes"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v],
                               rtol=1e-6, atol=0)
