"""The operation counts from shapes against hand counts and against
PyTorch's own FLOP counter."""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import core
from benchmark.metrics import _counts


def test_two_conv_net_by_hand_and_by_torch():
    # conv 3->8 (frozen input) then conv 8->4 at stride 2 on 16x20
    c = _counts.Counter()
    c.conv(16, 20, 3, 8, dgrad=False)
    c.conv(16, 20, 8, 4, s=2)
    f1 = 2 * 16 * 20 * 8 * 3 * 9
    f2 = 2 * 8 * 10 * 4 * 8 * 9
    assert c.fwd == f1 + f2
    assert c.bwd == f1 + 2 * f2
    x = torch.randn(1, 3, 16, 20)
    w1 = torch.randn(8, 3, 3, 3, requires_grad=True)
    w2 = torch.randn(4, 8, 3, 3, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = F.conv2d(F.conv2d(x, w1, padding=1), w2, stride=2, padding=1)
        y.sum().backward()
    assert fc.get_total_flops() == c.fwd + c.bwd


def test_linear_and_levels():
    c = _counts.Counter()
    c.linear(5, 6, 7, train=False)
    assert (c.fwd, c.bwd) == (2 * 5 * 6 * 7, 0)
    assert _counts.levels(672, 1344) == [(84, 168), (42, 84), (21, 42),
                                         (11, 21), (6, 11)]


def test_cell_counts():
    c2f = core.Cell("scan_c2f.da_gst_f32", 1, 1, False).cfg
    r101 = core.Cell("epm_r101.da_f32", 1, 1, False).cfg
    ev = _counts.eval_flops(c2f, 8, 672, 1344)
    step = _counts.da_step_flops(c2f, 4, 672, 1344)
    # VGG16's stage 1 alone, per image: 2 HW 64 (27 + 576)
    stem = 2 * 672 * 1344 * 64 * (27 + 576)
    assert ev > 8 * stem and step > ev / 2
    assert 1e12 < ev < 1e13 and 1e13 < step < 1e14
    assert _counts.da_step_flops(r101, 4, 672, 1344) > step / 4


def test_stem_bound():
    b = _counts.stem_bound_s(4, 672, 1344, "float32")
    ops = 2.0 * 4 * 672 * 1344 * 64 * 603
    assert b == pytest.approx(max(ops / 495e12,
                                  (4 * 672 * 1344 * 12 + 605 * 256
                                   + 4 * 336 * 672 * 256) / 3.35e12))
    assert _counts.share(b, 0.0) is None
    assert _counts.share(1.0, 4.0) == 25.0
    assert math.isclose(_counts.share(b, b), 100.0)
