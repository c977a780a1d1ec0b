"""The port's public layer surface (``scan_tpu_torch/layers.py``) and
``evaluation/expected_results.py`` against ``scan_tpu``'s, on the CPU.

* Every name of ``scan_tpu.layers.__all__`` is in the port's ``__all__``
  and resolves to a callable, the reused ones to the port's own functions
  (``safe_l2_norm``, ``upsample_nearest_2x``, ``meanshift_high_mode``,
  ``deform_conv2d``), not copies.
* ``smooth_l1_loss`` (mean and sum, differences on both sides of beta and
  exactly 0), ``kl_loss``, ``cosine_loss`` (some rows masked out, one row
  exactly zero) and ``supcon_loss_with_prototype`` (anchors with and
  without a positive, with and without ``valid_mask``): values within
  1e-6 relative and the gradients of every differentiable input within
  1e-6 of each gradient's largest value, the detached inputs getting none
  in both packages.
* ``check_expected_results``: the same verdict as ``scan_tpu``'s on passing,
  failing, missing and empty expectations, and the same log messages.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scan_tpu.layers as jl
import scan_tpu_torch.layers as tl
from scan_tpu.evaluation.expected_results import \
    check_expected_results as jax_check
from scan_tpu_torch.evaluation.expected_results import check_expected_results


def test_every_name_resolves():
    assert set(jl.__all__) <= set(tl.__all__)
    for name in tl.__all__:
        assert callable(getattr(tl, name)), name
    from scan_tpu_torch.modeling import layers as ml
    from scan_tpu_torch.modeling.backbone import fpn
    from scan_tpu_torch.modeling.condgraph import sampling
    from scan_tpu_torch.ops import deform_conv, nms
    assert tl.safe_l2_norm is ml.safe_l2_norm
    assert tl.meanshift_high_mode is sampling.meanshift_high_mode
    assert tl.deform_conv2d is deform_conv.deform_conv2d
    assert tl.ml_nms is nms.ml_nms
    x = torch.arange(6.0).reshape(1, 1, 2, 3)
    np.testing.assert_array_equal(
        tl.interpolate_nearest_2x(x).numpy(),
        np.asarray(jl.interpolate_nearest_2x(jnp.asarray(x.numpy()))))
    assert torch.equal(tl.interpolate_nearest_2x(x),
                       fpn.upsample_nearest_2x(x))


def _compare(jfn, tfn, args, diff, kwargs=None, n_out=1):
    """Values and gradients (of the sum of the outputs, each output weighted
    by a seeded cotangent) of ``jfn`` and ``tfn`` on ``args``; ``diff`` names
    the positions to differentiate."""
    kwargs = kwargs or {}
    rng = np.random.RandomState(9)
    cots = [rng.randn() for _ in range(n_out)]

    def jloss(*a):
        out = jfn(*a, **kwargs)
        out = out if isinstance(out, tuple) else (out,)
        return sum(c * o for c, o in zip(cots, out)), out

    (_, want), grads = jax.value_and_grad(jloss, diff, has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    got = tfn(*targs, **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    sum(c * o for c, o in zip(cots, got)).backward()
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(float(w), rel=1e-6, abs=1e-12)
    for i, gw in zip(diff, grads):
        gw = np.asarray(gw)
        gt = targs[i].grad
        if gt is None:  # detached in the port: jax.grad gives zeros
            assert not np.abs(gw).any(), i
            continue
        np.testing.assert_allclose(gt.numpy(), gw, rtol=0,
                                   atol=1e-6 * max(np.abs(gw).max(), 1e-30))
    return got, want


@pytest.mark.parametrize("size_average", [True, False])
def test_smooth_l1_loss(size_average):
    rng = np.random.RandomState(0)
    a = rng.randn(6, 4).astype(np.float32) * 0.3
    b = a + rng.choice([0.0, 0.05, -0.05, 0.5, -0.8], (6, 4)).astype(np.float32)
    _compare(jl.smooth_l1_loss, tl.smooth_l1_loss, [a, b], (0, 1),
             dict(size_average=size_average))


def test_kl_loss_detaches_its_target():
    rng = np.random.RandomState(1)
    a, b = (rng.randn(5, 9).astype(np.float32) for _ in range(2))
    _compare(jl.kl_loss, tl.kl_loss, [a, b], (0, 1))


def test_cosine_loss():
    rng = np.random.RandomState(2)
    batch = rng.randn(7, 8).astype(np.float32)
    glb = rng.randn(7, 8).astype(np.float32)
    batch[3] = 0.0  # a zero row: safe_l2_norm's finite gradient
    label = np.asarray([1, 0, 1, 1, 0, 1, 1], np.float32)
    _compare(jl.cosine_loss, tl.cosine_loss, [batch, glb, label], (0, 1),
             n_out=2)


@pytest.mark.parametrize("with_valid", [False, True])
def test_supcon_loss_with_prototype(with_valid):
    rng = np.random.RandomState(3)
    feats = rng.randn(10, 16).astype(np.float32)
    protos = rng.randn(4, 16).astype(np.float32)
    labels = rng.randint(0, 6, 10).astype(np.int32)  # 4, 5: no positive
    proto_labels = np.arange(4).astype(np.int32)
    kw = dict(temperature=0.1)
    if with_valid:
        kw["valid_mask"] = rng.rand(10) > 0.3
        jfn = lambda *a, valid_mask, **k: jl.supcon_loss_with_prototype(  # noqa: E731
            *a, valid_mask=jnp.asarray(valid_mask), **k)
        tfn = lambda *a, valid_mask, **k: tl.supcon_loss_with_prototype(  # noqa: E731
            *a, valid_mask=torch.from_numpy(valid_mask), **k)
    else:
        jfn, tfn = jl.supcon_loss_with_prototype, tl.supcon_loss_with_prototype
    assert (labels >= 4).any() and (labels < 4).any()
    _compare(jfn, tfn, [feats, labels, protos, proto_labels], (0, 2), kw)


EXPECTED = [
    ("pass", [("bbox", "AP", 0.40, 0.01), ("bbox", "AP50", 0.60, 0.02)]),
    ("fail", [("bbox", "AP", 0.40, 0.001), ("bbox", "AP50", 0.60, 0.02)]),
    ("missing", [("bbox", "APs", 0.2, 0.01)]),
    ("empty", []),
]


@pytest.mark.parametrize("case,expected", EXPECTED, ids=[e[0] for e in EXPECTED])
def test_check_expected_results(case, expected, caplog):
    results = {"AP": 0.405, "AP50": 0.61}
    with caplog.at_level(logging.INFO):
        want = jax_check(results, expected, sigma_tol=4)
        jax_msgs = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = check_expected_results(results, expected, sigma_tol=4)
        msgs = [r.getMessage() for r in caplog.records]
    assert got is want
    assert got == (case in ("pass", "empty"))
    assert msgs == jax_msgs
