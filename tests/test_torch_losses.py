"""The port's training losses and FCOS targets against ``scan_tpu``'s, on the CPU.

Same seeded numpy inputs through ``scan_tpu``'s jnp functions and the
port's torch ones, float32:

* focal losses (sigmoid, softmax, BCE, binary adversarial) and the IoU
  loss: values within rtol 1e-5 (sums of a few hundred float32 terms in
  another order), gradients within rtol 1e-4 of the largest;
* the IoU loss's gradient stays finite where masked rows hold inf or
  negative garbage (the double ``where``, PARITY #17);
* FCOS targets: labels equal, regression targets equal (the same
  subtractions), centerness within 1e-6;
* ``fcos_losses`` on head outputs over the five levels: within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.fcos import loss as jloss
from scan_tpu.modeling.fcos import targets as jtargets
from scan_tpu.ops import focal_loss as jfocal
from scan_tpu.ops.iou_loss import iou_loss as jiou
from scan_tpu.ops.locations import compute_locations as jlocations
from scan_tpu_torch.modeling.fcos import loss as tloss
from scan_tpu_torch.modeling.fcos import targets as ttargets
from scan_tpu_torch.ops import focal_loss as tfocal
from scan_tpu_torch.ops.iou_loss import iou_loss as tiou
from scan_tpu_torch.ops.locations import compute_locations as tlocations

SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
STRIDES = (8, 16, 32, 64, 128)


def _grad_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _value_and_grads(jfn, tfn, *arrays, argnums=(0,)):
    want, jgrads = jax.value_and_grad(jfn, argnums=argnums)(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for i in argnums:
        ts[i].requires_grad_(True)
    got = tfn(*ts)
    got.backward()
    return got.item(), float(want), [ts[i].grad.numpy() for i in argnums], jgrads


def test_sigmoid_focal_loss():
    rng = np.random.RandomState(0)
    logits = (rng.randn(300, 8) * 3).astype(np.float32)
    labels = rng.randint(0, 9, 300).astype(np.int32)
    valid = rng.rand(300) > 0.2
    got, want, g, jg = _value_and_grads(
        lambda x, t, v: jfocal.sigmoid_focal_loss(x, t, valid_mask=v),
        lambda x, t, v: tfocal.sigmoid_focal_loss(x, t, valid_mask=v),
        logits, labels, valid)
    assert got == pytest.approx(want, rel=1e-5)
    _grad_close(g[0], jg[0])


def test_softmax_and_bce_focal_losses():
    rng = np.random.RandomState(1)
    logits = (rng.randn(200, 9) * 2).astype(np.float32)
    labels = rng.randint(0, 9, 200).astype(np.int32)
    valid = rng.rand(200) > 0.3
    for kw in ({}, {"valid_mask": valid}):
        got, want, g, jg = _value_and_grads(
            lambda x, t: jfocal.softmax_focal_loss(x, t, **kw),
            lambda x, t: tfocal.softmax_focal_loss(
                x, t, **{k: torch.from_numpy(v) for k, v in kw.items()}),
            logits, labels)
        assert got == pytest.approx(want, rel=1e-5)
        _grad_close(g[0], jg[0])
    onehot = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 200)]
    got, want, g, jg = _value_and_grads(
        jfocal.bce_focal_loss, tfocal.bce_focal_loss, logits[:, :2], onehot)
    assert got == pytest.approx(want, rel=1e-5)
    _grad_close(g[0], jg[0])
    target = np.float32(1.0)
    got, want, g, jg = _value_and_grads(
        lambda x: jfocal.binary_adversarial_focal_loss(x, target),
        lambda x: tfocal.binary_adversarial_focal_loss(x, 1.0), logits)
    assert got == pytest.approx(want, rel=1e-5)
    _grad_close(g[0], jg[0])


def test_iou_loss_and_its_gradient_at_masked_rows():
    rng = np.random.RandomState(2)
    pred = (rng.rand(100, 4) * 50).astype(np.float32)
    target = (rng.rand(100, 4) * 50).astype(np.float32)
    weight = rng.rand(100).astype(np.float32)
    valid = rng.rand(100) > 0.4
    pred[~valid] = np.inf  # an overflowed exp where nothing supervises
    target[~valid] = -5.0
    got, want, g, jg = _value_and_grads(
        lambda p, t, w: jiou(p, t, weight=w, valid_mask=jnp.asarray(valid)),
        lambda p, t, w: tiou(p, t, weight=w, valid_mask=torch.from_numpy(valid)),
        pred, target, weight)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5)
    assert np.isfinite(g[0]).all()
    assert (g[0][~valid] == 0).all()
    _grad_close(g[0], jg[0])
    got, want, _, _ = _value_and_grads(jiou, tiou, pred[valid], target[valid])
    assert got == pytest.approx(want, rel=1e-5)


def _gt(rng, b=2, g=6):
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(g - 1 - i):
            x0, y0 = rng.rand(2) * [80, 50]
            w, h = rng.rand(2) * [60, 40] + 4
            boxes[i, j] = [x0, y0, x0 + w, y0 + h]
            labels[i, j] = rng.randint(1, 9)
            mask[i, j] = True
    boxes[0, -1] = [10, 10, 30, 30]  # a padded slot holding a box: ignored
    labels[0, -1] = 3
    return boxes, labels, mask


def test_fcos_targets_equal():
    rng = np.random.RandomState(3)
    boxes, labels, mask = _gt(rng)
    num_points = [h * w for h, w in SHAPES]
    locs = np.concatenate([np.asarray(l) for l in jlocations(SHAPES, STRIDES)])
    soi = np.asarray(jtargets.expand_soi(num_points))
    want_l, want_r = jax.device_get(jtargets.compute_targets(
        jnp.asarray(locs), jnp.asarray(soi), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(mask)))
    t_locs = torch.cat(tlocations(SHAPES, STRIDES))
    np.testing.assert_array_equal(t_locs.numpy(), locs)
    t_soi = ttargets.expand_soi(num_points)
    np.testing.assert_array_equal(t_soi.numpy(), soi)
    got_l, got_r = ttargets.compute_targets(
        t_locs, t_soi, torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask))
    assert (want_l > 0).sum() > 10, "the test needs positives"
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_allclose(
        ttargets.centerness_targets(got_r).numpy(),
        np.asarray(jtargets.centerness_targets(jnp.asarray(want_r))),
        rtol=1e-6, atol=1e-6)


def test_fcos_losses():
    rng = np.random.RandomState(4)
    boxes, labels, mask = _gt(rng)
    maps = {k: [(rng.randn(2, h, w, c) * s).astype(np.float32)
                for h, w in SHAPES]
            for k, c, s in (("cls", 8, 2.0), ("ctr", 1, 1.0))}
    maps["reg"] = [np.exp(rng.randn(2, h, w, 4)).astype(np.float32) * 10
                   for h, w in SHAPES]
    want = jax.device_get(jloss.fcos_losses(
        jlocations(SHAPES, STRIDES), *[list(map(jnp.asarray, maps[k]))
                                       for k in ("cls", "reg", "ctr")],
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask)))
    got = tloss.fcos_losses(
        tlocations(SHAPES, STRIDES), *[list(map(torch.from_numpy, maps[k]))
                                       for k in ("cls", "reg", "ctr")],
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-5), k
    assert float(want["loss_reg"]) > 0
    # no positives: reg and centerness are 0, cls divides by the batch size
    none = tloss.fcos_losses(
        tlocations(SHAPES, STRIDES), *[list(map(torch.from_numpy, maps[k]))
                                       for k in ("cls", "reg", "ctr")],
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.zeros(mask.shape, dtype=torch.bool))
    assert none["loss_reg"].item() == 0.0 and none["loss_centerness"].item() == 0.0
