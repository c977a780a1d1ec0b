"""Seeded Cityscapes-like scenes: the one traffic generator of every cell.

A copy of ``chip_smoke.py``'s ``gt_boxes`` / ``scene`` / ``train_batches``
generator, changed in three ways: the images are drawn on the card from a
``torch.Generator`` there; each image's valid size is what the config's
resize makes of a 1024x2048 frame (the rest of the padded batch is 0, as
the loader pads); the GT count is heavy-tailed. The boxes and sizes are
drawn on the host (a few hundred numbers), so a seed gives the same
batches on any card.

Parameters come from a workload file's ``traffic`` object:
``batch`` (images a domain), ``pad`` [H, W], ``frame`` [h, w] of the
original frames, ``min_size_range`` [lo, hi] (the resize's choices of the
short side, every whole number between),
``max_size``, ``max_boxes`` (GT slots), ``boxes_mean``, ``boxes_max`` (the
GT count an image: a geometric draw with that mean, capped), ``fog`` (the
target's blend towards grey 200).
"""

import numpy as np
import torch
import torch.nn.functional as F


def resize_hw(h, w, size, max_size):
    """The short side to ``size``, the long side capped at ``max_size``
    (the detector's Resize transform)."""
    lo, hi = float(min(h, w)), float(max(h, w))
    if hi / lo * size > max_size:
        size = int(round(max_size * lo / hi))
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def draw_layout(rng, t):
    """Host draws for one domain's batch: valid sizes (B, 2) and GT boxes
    (B, G, 4), labels (B, G), mask (B, G) inside each valid area."""
    b, g = t["batch"], t["max_boxes"]
    sizes = np.zeros((b, 2), np.int32)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    p = 1.0 / t["boxes_mean"]
    for i in range(b):
        lo, hi = t["min_size_range"]
        size = int(rng.integers(lo, hi + 1))
        h, w = resize_hw(*t["frame"], size, t["max_size"])
        sizes[i] = (h, w)
        k = min(int(rng.geometric(p)), t["boxes_max"], g)
        xy = rng.random((k, 2)) * (w * 0.7, h * 0.7)
        wh = rng.random((k, 2)) * (w * 0.3, h * 0.3)
        boxes[i, :k] = np.concatenate([xy, xy + wh + 16], 1)
        boxes[i, :k, 2] = np.minimum(boxes[i, :k, 2], w - 1)
        boxes[i, :k, 3] = np.minimum(boxes[i, :k, 3], h - 1)
        labels[i, :k] = rng.integers(1, 9, k)
        mask[i, :k] = True
    return sizes, boxes, labels, mask


def paint(gen, sizes, boxes, labels, mask, pad, device):
    """uint8 (B, H, W, 3) scenes on ``device``: a smooth background with a
    vertical gradient inside each valid area, each GT box filled with its
    class's colour, pixel noise of sd 8; zeros outside the valid area."""
    b = sizes.shape[0]
    ph, pw = pad
    img = torch.zeros((b, ph, pw, 3), device=device)
    colours = torch.rand(9, 3, generator=gen, device=device) * 255
    for i in range(b):
        h, w = (int(v) for v in sizes[i])
        low = torch.rand(1, 3, max(h // 64, 2), max(w // 64, 2),
                         generator=gen, device=device)
        bg = F.interpolate(low, size=(h, w), mode="bilinear",
                           align_corners=False)[0]
        bg = 60 + 140 * bg + torch.linspace(-30, 30, h, device=device)[
            None, :, None]
        img[i, :h, :w] = bg.permute(1, 2, 0)
        for j in np.flatnonzero(mask[i]):
            x0, y0, x1, y1 = (int(v) for v in boxes[i, j])
            img[i, y0:y1, x0:x1] = colours[int(labels[i, j])]
        noise = torch.randn((h, w, 3), generator=gen, device=device)
        img[i, :h, :w] += 8.0 * noise
    return img.clamp(0, 255).to(torch.uint8)


def batch_pair(seed, t, device):
    """One DA step's source and target batches for ``seed``: the source a
    scene at its GT boxes, the target a scene of its own, fogged."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    s_sizes, boxes, labels, mask = draw_layout(rng, t)
    src = paint(gen, s_sizes, boxes, labels, mask, t["pad"], device)
    t_sizes, *t_layout = draw_layout(rng, t)
    tgt = paint(gen, t_sizes, *t_layout, t["pad"], device)
    fogged = (tgt.float() * (1 - t["fog"]) + 200 * t["fog"]).to(torch.uint8)
    valid = torch.zeros(tgt.shape[:3], dtype=torch.bool, device=device)
    for i, (h, w) in enumerate(t_sizes):
        valid[i, :h, :w] = True
    tgt = torch.where(valid[..., None], fogged, tgt)
    batch_s = dict(images=src, sizes=torch.from_numpy(s_sizes).to(device),
                   boxes=torch.from_numpy(boxes).to(device),
                   labels=torch.from_numpy(labels).to(device),
                   mask=torch.from_numpy(mask).to(device))
    batch_t = dict(images=tgt, sizes=torch.from_numpy(t_sizes).to(device))
    return batch_s, batch_t


def item_seed(seed, index):
    """The seed of item ``index`` of a run's traffic (any run seed, also
    past 2**32, maps into numpy's and torch's ranges)."""
    return (int(seed) * 1_000_003 + 7919 * int(index)) % (1 << 62)
