"""The port's graph-node sampling against ``scan_tpu``'s, on the CPU, float32.

Same seeded inputs through ``scan_tpu/modeling/condgraph/sampling.py`` and
``scan_tpu_torch/modeling/condgraph/sampling.py``:

* ``_even_subset_mask`` over every (n, want) of a grid, equal;
* ``sample_source_nodes``: node masks and labels equal, nodes within 1e-6
  (they are gathered rows, so equal in fact), act labels equal;
* ``sample_target_nodes`` for ``dbscan``, ``score_threshold``, ``kmeans`` and
  ``mean_shift``: node masks and labels equal, nodes within 1e-6;
* ``density_cluster_drop_first``: keep masks equal on seeded candidate sets
  whose squared distances straddle eps^2. The adjacency compares
  |a|^2 + |b|^2 - 2ab, summed in another order in each framework, with
  eps^2; the test counts the pairs within 1e-5 relative of the boundary,
  where the two could disagree, and prints the count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.modeling.condgraph import sampling as js
from scan_tpu.ops.locations import compute_locations as jlocations
from scan_tpu_torch.modeling.condgraph import sampling as ts
from scan_tpu_torch.ops.locations import compute_locations as tlocations

SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
STRIDES = (8, 16, 32, 64, 128)


def _assert_nodes(got, want):
    g_nodes, g_labels, g_valid = (t.numpy() for t in got[:3])
    w_nodes, w_labels, w_valid = (np.asarray(t) for t in want[:3])
    np.testing.assert_array_equal(g_valid, w_valid)
    np.testing.assert_array_equal(g_labels, w_labels)
    np.testing.assert_allclose(g_nodes, w_nodes, rtol=0, atol=1e-6)


def test_even_subset_mask_grid():
    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 7, 40, 97):
        sel = rng.rand(n) > 0.4
        for want in range(0, n + 3):
            got = ts._even_subset_mask(torch.from_numpy(sel), torch.tensor(want))
            exp = js._even_subset_mask(jnp.asarray(sel), jnp.asarray(want))
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp),
                                          err_msg=f"n={n} want={want}")


@pytest.mark.parametrize("max_nodes", [64, 16])
def test_sample_source_nodes(max_nodes):
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in SHAPES]
    boxes = np.zeros((2, 4, 4), np.float32)
    labels = np.zeros((2, 4), np.int32)
    mask = np.zeros((2, 4), bool)
    boxes[0, :2] = [[4, 4, 40, 44], [30, 10, 90, 60]]
    boxes[1, :3] = [[0, 0, 20, 20], [50, 20, 95, 63], [10, 30, 60, 60]]
    labels[0, :2], labels[1, :3] = [2, 7], [1, 8, 3]
    mask[0, :2] = mask[1, :3] = True
    want = js.sample_source_nodes(
        jlocations(SHAPES, STRIDES), [jnp.asarray(f) for f in feats],
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), max_nodes)
    got = ts.sample_source_nodes(
        tlocations(SHAPES, STRIDES), [torch.from_numpy(f) for f in feats],
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), max_nodes)
    _assert_nodes(got, want)
    assert int(got[2].sum()) > 4, "the test needs nodes"
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _target_inputs(seed, scale=3.0):
    rng = np.random.RandomState(seed)
    feats = [(rng.rand(2, h, w, 32) * 2).astype(np.float32) for h, w in SHAPES]
    acts = []
    for h, w in SHAPES:
        logits = rng.randn(2, h, w, 9) * scale
        e = np.exp(logits - logits.max(-1, keepdims=True))
        acts.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return feats, acts


@pytest.mark.parametrize("cfg", ["dbscan", "score_threshold", "kmeans",
                                 "mean_shift"])
def test_sample_target_nodes(cfg):
    feats, acts = _target_inputs(2)
    kw = dict(max_nodes=64, sampling_cfg=cfg, score_threshold=0.5,
              dbscan_eps=3.0, dbscan_thr=0.05, max_candidates_per_level=48)
    want = js.sample_target_nodes([jnp.asarray(f) for f in feats],
                                  [jnp.asarray(a) for a in acts], **kw)
    got = ts.sample_target_nodes([torch.from_numpy(f) for f in feats],
                                 [torch.from_numpy(a) for a in acts], **kw)
    _assert_nodes(got, want)
    assert bool(got[3]) == bool(want[3])
    assert int(got[2].sum()) > 0, "the test needs nodes"


def _clustered_points(rng, k=96, c=16):
    centers = rng.randn(4, c).astype(np.float32) * 2.0
    pts = centers[rng.randint(0, 4, k)] + rng.randn(k, c).astype(np.float32) * 0.45
    pts[rng.rand(k) > 0.8] = rng.randn(c) * 4.0  # scattered noise rows
    valid = rng.rand(k) > 0.15
    return (pts * valid[:, None]).astype(np.float32), valid


@pytest.mark.parametrize("seed", range(6))
def test_density_cluster_keep_masks_equal(seed):
    rng = np.random.RandomState(seed)
    pts, valid = _clustered_points(rng)
    eps = 3.0
    want = np.asarray(js.density_cluster_drop_first(jnp.asarray(pts),
                                                    jnp.asarray(valid), eps))
    got = ts.density_cluster_drop_first(torch.from_numpy(pts),
                                        torch.from_numpy(valid), eps).numpy()
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    pair = valid[:, None] & valid[None, :]
    near = int((np.abs(d2 - eps * eps) <= 1e-5 * eps * eps)[pair].sum())
    inside = int((d2 <= eps * eps)[pair].sum())
    print(f"seed {seed}: {inside} of {int(pair.sum())} valid pairs within "
          f"eps, {near} within 1e-5 relative of eps^2, kept "
          f"{int(want.sum())} of {int(valid.sum())}")
    assert 0 < want.sum() < valid.sum(), "the clustering must drop something"
    np.testing.assert_array_equal(got, want)
