"""FCOS location grids (counterpart of ``scan_tpu/ops/locations.py``).

Per-level (H*W, 2) grids of (x, y) pixel centres, stride*i + stride//2,
row-major over y (reference ``fcos_core/modeling/rpn/fcos/fcos.py:234-258``).
"""

import torch


def compute_locations_level(h: int, w: int, stride: int,
                            device=None) -> torch.Tensor:
    shift_x = torch.arange(0, w * stride, stride, dtype=torch.float32,
                           device=device)
    shift_y = torch.arange(0, h * stride, stride, dtype=torch.float32,
                           device=device)
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")  # (h, w)
    return torch.stack([sx.reshape(-1), sy.reshape(-1)], dim=1) + stride // 2


def compute_locations(feature_shapes, strides, device=None) -> list:
    """feature_shapes: list of (h, w); strides: list of int."""
    return [
        compute_locations_level(h, w, s, device)
        for (h, w), s in zip(feature_shapes, strides)
    ]
