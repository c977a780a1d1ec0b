"""Anchor generation, Detectron lineage (counterpart of
``scan_tpu/modeling/anchors.py``).

Reference ``fcos_core/modeling/rpn/anchor_generator.py``: cell anchors from
``_generate_anchors`` (the classic rounding and '-1' centre math,
``anchor_generator.py:242-311``), shifted over the stride grid; the ATSS
sizes expand each level's size by its octave scales
(``anchor_generator.py:168-188``). The cell and grid anchors are computed
in numpy exactly as ``scan_tpu`` computes them; ``grid_anchors`` returns
them as float32 tensors on the features' device, made once per (shape,
stride, sizes, ratios, device), so a training step copies nothing from the
host after its first call.
"""

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def generate_cell_anchors(stride: int, sizes: Sequence[float],
                          aspect_ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) base anchors for one level (reference ``generate_anchors``)."""
    base = np.array([1, 1, stride, stride], np.float64) - 1
    w, h, x_ctr, y_ctr = _whctrs(base)
    size = w * h
    ratios = np.asarray(aspect_ratios, np.float64)
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)
    out = []
    scales = np.asarray(sizes, np.float64) / stride
    for a in ratio_anchors:
        w, h, x_ctr, y_ctr = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out).astype(np.float32)


def grid_anchors_np(h: int, w: int, stride: int, sizes: tuple,
                    aspect_ratios: tuple) -> np.ndarray:
    """(h * w * A, 4) anchors of one level, row-major over the grid, the A
    cell anchors of each location together."""
    cell = generate_cell_anchors(stride, sizes, aspect_ratios)
    shift_x = np.arange(0, w * stride, stride, dtype=np.float32)
    shift_y = np.arange(0, h * stride, stride, dtype=np.float32)
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                       sy.reshape(-1)], axis=1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


@lru_cache(maxsize=64)
def _grid_anchors(h, w, stride, sizes, aspect_ratios, device):
    return torch.from_numpy(
        grid_anchors_np(h, w, stride, sizes, aspect_ratios)).to(device)


def atss_level_sizes(anchor_sizes, octave: float, scales_per_octave: int):
    return [tuple(octave ** (i / float(scales_per_octave)) * size
                  for i in range(scales_per_octave))
            for size in anchor_sizes]


def grid_anchors(feature_shapes, strides, per_level_sizes, aspect_ratios,
                 device=None):
    """List of (HW * A, 4) float32 anchors per level on ``device``."""
    device = torch.device(device or "cpu")
    return [_grid_anchors(int(h), int(w), int(s), tuple(sz),
                          tuple(aspect_ratios), device)
            for (h, w), s, sz in zip(feature_shapes, strides, per_level_sizes)]
