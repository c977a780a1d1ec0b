"""The port's segmentation masks and keypoints (``scan_tpu_torch/structures/
masks.py``, its own numpy copy) against ``scan_tpu.structures.masks``.

The upstream test's two polygons (a concave one and a square) scaled to a
160x120 canvas, plus a seeded random polygon; both packages take the same
inputs. In poly mode and in mask mode, after resize (down and up),
both flips and a crop: the rasters (``to_bitmask_array``) equal, the
traced contours (``convert("poly")``: ``_find_contours`` /
``_trace_component``) equal vertex for vertex, and the mask-mode
conversions of the traced polygons equal. Keypoints: both flips and a
resize equal, the left/right permutation included. All exact: the
arithmetic is numpy's in both.
"""

import numpy as np
import pytest

from scan_tpu.structures import masks as jm
from scan_tpu_torch.structures import masks as tm

SIZE = (160, 120)  # (w, h)


def _polys():
    concave = np.asarray([
        423.0, 306.5, 406.5, 277.0, 400.0, 271.5, 389.5, 277.0, 387.5, 292.0,
        384.5, 295.0, 374.5, 220.0, 378.5, 210.0, 391.0, 200.5, 404.0, 199.5,
        414.0, 203.5, 425.5, 221.0, 438.5, 297.0, 423.0, 306.5]) / 4.0
    square = np.asarray([100, 100, 200, 100, 200, 200, 100, 200]) / 4.0 - 10
    rng = np.random.RandomState(0)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
    rad = rng.uniform(10, 30, 9)
    star = np.stack([60 + rad * np.cos(ang), 80 + rad * np.sin(ang)], 1)
    return [[concave, square], [star.reshape(-1)]]


def _pair(mode):
    polys = _polys()
    p = [jm.SegmentationMask(polys, SIZE, "poly"),
         tm.SegmentationMask(polys, SIZE, "poly")]
    return p if mode == "poly" else [m.convert("mask") for m in p]


OPS = {
    "identity": lambda m: m,
    "resize_down": lambda m: m.resize((100, 70)),
    "resize_up": lambda m: m.resize((230, 170)),
    "flip_lr": lambda m: m.transpose(tm.FLIP_LEFT_RIGHT),
    "flip_tb": lambda m: m.transpose(tm.FLIP_TOP_BOTTOM),
    "crop": lambda m: m.crop([40, 30, 120, 90]),
    "crop_past_the_edge": lambda m: m.crop([-5, 60, 300, 200]),
}


@pytest.mark.parametrize("mode", ["poly", "mask"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_rasters_and_contours_equal(mode, op):
    want, got = (OPS[op](m) for m in _pair(mode))
    assert type(got).__module__ == tm.__name__
    assert got.size == want.size and got.mode == want.mode == mode
    w_bits, g_bits = want.to_bitmask_array(), got.to_bitmask_array()
    assert g_bits.shape == w_bits.shape and w_bits.any()
    np.testing.assert_array_equal(g_bits, w_bits)
    w_poly, g_poly = (m.convert("mask").convert("poly") for m in (want, got))
    assert len(g_poly) == len(w_poly)
    for gi, wi in zip(g_poly.instances, w_poly.instances):
        assert len(gi.polygons) == len(wi.polygons) > 0
        for gp, wp in zip(gi.polygons, wi.polygons):
            np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(g_poly.convert("mask").to_bitmask_array(),
                                  w_poly.convert("mask").to_bitmask_array())


def test_contour_tracer_on_thin_and_isolated_shapes():
    m = np.zeros((12, 14), bool)
    m[2, 2] = True                    # an isolated pixel
    m[5, 3:11] = True                 # a one-pixel line
    m[7:11, 6:9] = True               # a block
    m[8, 7] = False                   # with a hole (external contour only)
    m[1:4, 11] = True
    m[3, 12] = True                   # 8-connected diagonal
    got, want = tm._find_contours(m), jm._find_contours(m)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_person_keypoints_flip_and_resize():
    rng = np.random.RandomState(1)
    kp = np.concatenate([rng.uniform(0, 150, (3, 17, 2)),
                         rng.randint(0, 3, (3, 17, 1))], -1)
    a, b = jm.PersonKeypoints(kp, SIZE), tm.PersonKeypoints(kp, SIZE)
    assert tm.PersonKeypoints.NAMES == jm.PersonKeypoints.NAMES
    assert tm._flip_inds() == jm._flip_inds()
    for op in (lambda k: k.transpose(tm.FLIP_LEFT_RIGHT),
               lambda k: k.transpose(tm.FLIP_TOP_BOTTOM),
               lambda k: k.resize((80, 200))):
        w, g = op(a), op(b)
        assert g.size == w.size
        np.testing.assert_array_equal(g.keypoints, w.keypoints)
    flipped = b.transpose(tm.FLIP_LEFT_RIGHT).keypoints
    left, right = (tm.PERSON_KEYPOINT_NAMES.index(n)
                   for n in ("left_eye", "right_eye"))
    vis = kp[:, right, 2] > 0
    np.testing.assert_array_equal(flipped[vis, left, 0],
                                  SIZE[0] - kp[vis, right, 0] - 1)
    with pytest.raises(NotImplementedError):
        b.transpose(7)
