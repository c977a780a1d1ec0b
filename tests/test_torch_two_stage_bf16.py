"""The port's two-stage detector in bfloat16 against ``scan_tpu``'s jitted
``FasterRCNN`` step, on the CPU (the inputs of ``test_torch_two_stage.py``:
R-50-FPN at narrow widths, both branches, batch 2 at 64x96).

``scan_tpu`` trains in bf16 with ``TPU.COMPUTE_DTYPE bfloat16`` over
float32 parameters; the port's detector built with ``train=True`` keeps
float32 masters and casts at use. ``scan_tpu`` has no bf16 test of this
model, so the bound is measured, as ``test_torch_train_bf16.py`` measures
it: each loss, and the gradient of the summed loss of each top-level group
(``backbone``, ``rpn``, ``roi_box``, ``roi_mask``, ``roi_keypoint``) as a
relative L2 norm, lies within 2x the distance between ``scan_tpu``'s own
jitted bf16 and float32 steps on the same inputs (both printed). The
features of the two packages' bf16 FPNs already differ by an ulp here and
there (``test_torch_resnet.py``), and the RPN, the proposals and the heads
carry that on.

Where ``scan_tpu`` rounds is measured, not assumed: on ``scan_tpu``'s own
jitted bf16 features, the port's RPN head (its 1x1 convs rounding to bf16,
then cast to float32) gives ``rpn_losses`` within rtol 1e-6 of the jitted
step's (the float32 sums over the anchors run in another order); with
float32 results (``float_output``, which the FCOS logits need) they lie
more than 1e-5 away (measured ~2e-4). Every parameter and gradient of the
port stays float32; a detector built for evaluation holds bf16 convs,
float32 Dense layers and float32 FrozenBatchNorm buffers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.rpn_anchor import rpn_losses as jax_rpn_losses
from scan_tpu_torch.modeling.layers import Conv, FrozenBatchNorm, Linear
from scan_tpu_torch.modeling.rpn_anchor import rpn_losses
from scan_tpu_torch.utils.jax_weights import convert_params

from test_torch_two_stage import (TRANSPOSED, images, jax_detector,
                                  jax_params, port_detector,
                                  port_loss_and_grads, summed_loss_and_grads,
                                  targets)

GROUPS = ("backbone", "rpn", "roi_box", "roi_mask", "roi_keypoint")


def _group_dist(a, b, group, keys):
    ks = [k for k in keys if k.startswith(group + ".")]
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in ks)
    den = sum(float((b[k] ** 2).sum()) for k in ks)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def steps():
    params = jax_params()
    want16, g16 = summed_loss_and_grads(jax_detector(dtype="bfloat16"),
                                        params)
    want32, g32 = summed_loss_and_grads(jax_detector(), params)
    return params, want16, g16, want32, g32


def test_bf16_step_within_twice_scan_tpus_own_bf16_distance(steps):
    params, want16, g16, want32, g32 = steps
    det = port_detector(params, dtype="bfloat16", train=True)
    got, grads = port_loss_and_grads(det)
    assert all(p.dtype == torch.float32 for p in det.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    for k in want16:
        own = abs(float(want16[k]) - float(want32[k]))
        dist = abs(got[k] - float(want16[k]))
        print(f"{k}: port-jit {dist:.3g}, scan_tpu bf16-f32 {own:.3g}")
        assert dist <= 2 * own + 1e-6 * abs(float(want16[k])), k
    j16 = convert_params(g16, TRANSPOSED)
    j32 = convert_params(g32, TRANSPOSED)
    keys = sorted(grads)
    port = {k: grads[k] for k in keys}
    for group in GROUPS:
        own = _group_dist(j16, j32, group, keys)
        dist = _group_dist(port, j16, group, keys)
        print(f"{group}: port-jit {dist:.3g}, scan_tpu bf16-f32 {own:.3g}")
        assert 0 < own and dist <= 2 * own, group


def test_rpn_rounds_as_the_jitted_step(steps):
    params = steps[0]
    jdet = jax_detector(dtype="bfloat16")
    tj = {k: jnp.asarray(v) for k, v in targets().items()}

    def loss(p, x):
        f = list(jdet.backbone.apply(p["backbone"], x))
        obj, reg = jdet.rpn_head.apply(p["rpn"], f)
        losses = jax_rpn_losses(jdet.rpn_cfg_train,
                                jdet._anchors(f, jdet.rpn_cfg_train), obj,
                                reg, tj["boxes"], tj["mask"])
        return sum(losses.values()), (f, losses)

    (_, (feats, want)), _ = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(images()))
    det = port_detector(params, dtype="bfloat16", train=True)
    feats = [torch.from_numpy(np.array(f.astype(jnp.float32))).to(
        torch.bfloat16) for f in feats]
    tb = torch.from_numpy(targets()["boxes"])
    tm = torch.from_numpy(targets()["mask"])
    with torch.no_grad():
        anchors = det._anchors(feats, det.rpn_cfg_train)
        got = rpn_losses(det.rpn_cfg_train, anchors, *det.rpn(feats), tb, tm)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
        for m in (det.rpn.cls_logits, det.rpn.bbox_pred):
            m.float_output = True
        other = rpn_losses(det.rpn_cfg_train, anchors, *det.rpn(feats), tb,
                           tm)
    assert any(abs(float(other[k]) - float(want[k])) > 1e-5 * float(want[k])
               for k in want)


def test_eval_detector_casts_convs_only(steps):
    det = port_detector(steps[0], dtype="bfloat16")
    for m in det.modules():
        if isinstance(m, Conv):
            assert m.weight.dtype == torch.bfloat16
        elif isinstance(m, Linear):
            assert m.weight.dtype == torch.float32
        elif isinstance(m, FrozenBatchNorm):
            assert m.running_var.dtype == torch.float32
    assert det.roi_mask.conv5_mask.weight.dtype == torch.bfloat16
    out = det.forward_inference(torch.from_numpy(images()),
                                torch.from_numpy(np.asarray(
                                    [[64, 96], [56, 80]], np.int32)))
    assert out["masks"].dtype == torch.float32
    assert bool(out["valid"].any())
