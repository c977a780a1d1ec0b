"""The traffic repeats for a seed and changes with it; valid sizes are
what the config's resize makes of a 1024x2048 frame."""

import numpy as np
import torch

from benchmark.harness import scenes

SMALL = {"batch": 2, "pad": [64, 128], "frame": [128, 256],
         "min_size_range": [60, 64], "max_size": 128, "max_boxes": 10,
         "boxes_mean": 3, "boxes_max": 6, "fog": 0.45}


def pair(seed):
    return scenes.batch_pair(scenes.item_seed(seed, 0), SMALL, "cpu")


def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_a_seed_repeats_and_another_differs():
    big = 2 ** 31 + 12345  # past 32 signed bits
    s1, t1 = pair(big)
    s2, t2 = pair(big)
    assert same(s1, s2) and same(t1, t2)
    s3, t3 = pair(big + 1)
    assert not torch.equal(s1["images"], s3["images"])
    assert not torch.equal(t1["images"], t3["images"])


def test_layout_inside_valid_area():
    s, t = pair(7)
    for i, (h, w) in enumerate(s["sizes"].tolist()):
        assert 60 <= h <= 64 and w == 2 * h
        assert int(s["images"][i, h:].sum()) == 0  # padding is 0
        b = s["boxes"][i][s["mask"][i]]
        assert (b[:, 2] <= w - 1).all() and (b[:, 3] <= h - 1).all()
        assert ((s["labels"][i] > 0) == s["mask"][i]).all()


def test_resize_of_a_cityscapes_frame():
    assert scenes.resize_hw(1024, 2048, 800, 1333) == (666, 1332)
    assert scenes.resize_hw(1024, 2048, 640, 1333) == (640, 1280)
    assert scenes.resize_hw(1024, 2048, 666, 1333) == (666, 1332)
    rng = np.random.default_rng(0)
    t = dict(SMALL, batch=64, frame=[1024, 2048], min_size_range=[640, 800],
             max_size=1333, pad=[672, 1344])
    sizes = scenes.draw_layout(rng, t)[0]
    assert sizes.max(0).tolist() == [666, 1332]
    assert (sizes[:, 0] >= 640).all()
