"""The port's NMS against ``scan_tpu``'s: keep masks must be exactly equal.

On the CPU the port's greedy core is its plain version
(``scan_tpu_torch/ops/cuda/nms_kernel.py::nms_sorted_plain``); it is held
against ``scan_tpu.ops.nms.nms_keep_mask`` (XLA) and against the Pallas
kernel ``nms_pallas_sorted`` in interpret mode, as
``tests/test_pallas_nms.py`` runs it. Cases cover K not a multiple of 128,
invalid rows, labels (ML-NMS) and a batch of images in one call. Kernel K1
itself is held against the plain version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from scan_tpu.ops.pallas.nms_kernel import nms_pallas_sorted
from scan_tpu_torch.ops import nms as tnms
from scan_tpu_torch.ops.cuda import nms_kernel


def _case(seed, k, n_labels=0, invalid_frac=0.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    valid = rng.uniform(0, 1, k) >= invalid_frac
    labels = (rng.randint(1, n_labels + 1, k).astype(np.int32)
              if n_labels else None)
    return boxes, scores, valid, labels


def _jax_keep(boxes, scores, valid, labels, thr):
    return np.asarray(jax_nms_keep_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
        labels=None if labels is None else jnp.asarray(labels)))


@pytest.mark.parametrize("k", [100, 200, 333])
@pytest.mark.parametrize("n_labels", [0, 4])
@pytest.mark.parametrize("invalid_frac", [0.0, 0.3])
def test_keep_mask_matches_xla(k, n_labels, invalid_frac):
    boxes, scores, valid, labels = _case(k + n_labels, k, n_labels, invalid_frac)
    want = _jax_keep(boxes, scores, valid, labels, 0.6)
    got = tnms.nms_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), 0.6,
        labels=None if labels is None else torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum(), "the case must suppress something"


def test_batched_nms_and_ml_nms_match_per_image():
    cases = [_case(s, 150, 3, 0.2) for s in range(3)]
    boxes, scores, valid, labels = (
        np.stack([c[i] for c in cases]) for i in range(4))
    got_ml = tnms.ml_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(labels), torch.from_numpy(valid), 0.5)
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), 0.5)
    for i in range(3):
        np.testing.assert_array_equal(
            got_ml[i].numpy(),
            _jax_keep(boxes[i], scores[i], valid[i], labels[i], 0.5))
        np.testing.assert_array_equal(
            got[i].numpy(), _jax_keep(boxes[i], scores[i], valid[i], None, 0.5))


@pytest.mark.parametrize("k,n_labels", [(96, 0), (130, 4)])
def test_sorted_core_matches_pallas_interpret(k, n_labels):
    boxes, scores, valid, labels = _case(7 + k, k, n_labels, 0.2)
    order = np.argsort(-scores, kind="stable")
    boxes, valid = boxes[order], valid[order]
    labels = None if labels is None else labels[order]
    want = np.asarray(nms_pallas_sorted(
        jnp.asarray(boxes), jnp.asarray(valid),
        None if labels is None else jnp.asarray(labels), 0.5, interpret=True))
    got = nms_kernel.nms_sorted(
        torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
        None if labels is None else torch.from_numpy(labels)[None], 0.5)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_threshold_compares_in_float32():
    # two boxes whose IoU rounds to float32(0.6) exactly: the double 0.6 is
    # below float32(0.6), so a comparison in double would suppress
    # ('+1' areas 100 and 60, intersection 60: IoU = float32(60 / 100))
    boxes = torch.tensor([[0.0, 0.0, 9.0, 9.0], [0.0, 0.0, 9.0, 5.0]])
    keep = nms_kernel.nms_sorted_plain(boxes[None], torch.ones(1, 2, dtype=torch.bool),
                                       None, 0.6)
    want = np.asarray(nms_pallas_sorted(
        jnp.asarray(boxes.numpy()), jnp.ones((2,), bool), None, 0.6,
        interpret=True))
    np.testing.assert_array_equal(keep[0].numpy(), want)
    assert keep[0].tolist() == [True, True]


def test_cpu_wrapper_does_not_launch():
    before = nms_kernel.nms_sorted.launches
    boxes, scores, valid, _ = _case(0, 64)
    tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
             torch.from_numpy(valid), 0.5)
    assert nms_kernel.nms_sorted.launches == before

