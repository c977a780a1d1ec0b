"""ROIAlign / ROIPool over NHWC features (counterpart of
``scan_tpu/ops/roi_align.py``).

maskrcnn-benchmark's legacy (non-half-pixel) ROIAlign: RoI coordinates
scaled by ``spatial_scale``, each side at least 1, ``output_size`` bins a
side, ``sampling_ratio`` sample points per bin axis at the bin's
(i + 0.5) / sr fractions, bilinear interpolation with the sample clipped
into the map and zero where it lies outside (-1, size), and the mean over
the sr x sr samples. ``scan_tpu`` computes it in XLA, outside any Pallas
kernel, so the port's is plain PyTorch too.

Every output value is a weighted sum of 4 sr^2 feature rows. Gathering them
as ``scan_tpu``'s vmap does, an (R, s, s, sr^2, 4, C) tensor, takes GBs at
full width (2 x 2000 training RoIs, C = 256). Here the rows and weights go
to ``F.embedding_bag`` (``mode="sum"``, ``per_sample_weights``), which sums
them without materialising the gather, and whose backward scatters into one
gradient of the feature table. The weights are the bilinear ones times the
inside mask; the bag's sum is divided by sr^2 as ``jnp.mean`` divides. On
bf16 features ``scan_tpu`` multiplies by float32 weights, which promotes to
float32: the table is taken in float32 and the result is float32.

``roi_align_levels`` pools each RoI from one level of a pyramid, chosen
per RoI, in one call: the levels' maps are one table, and each RoI's scale,
map size and row offset are looked up by its level. ``fpn_pooler`` uses it
to pool each RoI only at its own level; ``scan_tpu`` pools every RoI at
every level and sums ``pooled * (level == l)``, which adds exact zeros for
finite features, so the result is the same.
"""

import torch
import torch.nn.functional as F

# index entries a call of embedding_bag takes at most: bounds the int64
# indices and float32 weights to 192 MB a chunk of RoIs
_MAX_ENTRIES = 1 << 24


def _axis_samples(lo, bin_size, s, sr, size):
    """Sample positions along one axis and their bilinear terms.

    lo, bin_size: (R,) float32; size: (R,) float32, the map's extent.
    Returns (i0, i1) int64 and (w0, w1, inside) float32, each (R, s, sr):
    the two cells each sample reads, their weights, and 1 where the sample
    lies inside (-1, size)."""
    dev = lo.device
    p = torch.arange(s, device=dev, dtype=torch.float32)
    i = torch.arange(sr, device=dev, dtype=torch.float32)
    pos = (lo[:, None, None] + p[None, :, None] * bin_size[:, None, None]) \
        + ((i + 0.5)[None, None, :] * bin_size[:, None, None]) / sr
    size = size[:, None, None]
    inside = ((pos > -1.0) & (pos < size)).to(torch.float32)
    pos = torch.minimum(torch.maximum(pos, torch.zeros_like(pos)), size - 1)
    i0 = torch.floor(pos)
    i1 = torch.minimum(i0 + 1, size - 1)
    frac = pos - i0
    # a NaN RoI reads cell 0 with NaN weights: NaN out, as in scan_tpu
    return (i0.nan_to_num(0.0).long(), i1.nan_to_num(0.0).long(),
            1.0 - frac, frac, inside)


def _align_bags(rois, scale, height, width, base, s, sr):
    """Rows and weights of the bags: (R * s * s, sr * sr * 4) each.

    rois (R, 4) image coordinates; scale, height, width (R,) float32 of the
    RoI's map; base (R,) int64, the row of the map's (y, x) = (0, 0) in the
    table (rows are y * width + x from there)."""
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    x2 = rois[:, 2] * scale
    y2 = rois[:, 3] * scale
    one = torch.ones_like(x1)
    bin_w = torch.maximum(x2 - x1, one) / s
    bin_h = torch.maximum(y2 - y1, one) / s
    ya, yb, hy, ly, in_y = _axis_samples(y1, bin_h, s, sr, height)
    xa, xb, hx, lx, in_x = _axis_samples(x1, bin_w, s, sr, width)
    r = rois.shape[0]
    w_row = width.long()[:, None, None]
    # (R, s_y, s_x, sr_y, sr_x, 4), the corners (y0, x0), (y0, x1), (y1, x0)
    # and (y1, x1)
    rows = [(ya, xa), (ya, xb), (yb, xa), (yb, xb)]
    weights = [(hy, hx), (hy, lx), (ly, hx), (ly, lx)]
    idx = torch.stack([
        (base[:, None, None, None, None]
         + (yy * w_row)[:, :, None, :, None] + xx[:, None, :, None, :])
        for yy, xx in rows], -1)
    inside = in_y[:, :, None, :, None] * in_x[:, None, :, None, :]
    wts = torch.stack([
        (wy[:, :, None, :, None] * wx[:, None, :, None, :]) * inside
        for wy, wx in weights], -1)
    return (idx.reshape(r * s * s, sr * sr * 4),
            wts.reshape(r * s * s, sr * sr * 4))


def _pool_table(table, rois, scale, height, width, base, s, sr):
    """(R, s, s, C) float32: each RoI's bags summed from ``table`` (N, C),
    in chunks of RoIs, divided by sr^2."""
    r = rois.shape[0]
    c = table.shape[-1]
    if r == 0:
        return table.new_zeros((0, s, s, c))
    per_roi = s * s * sr * sr * 4
    step = max(1, _MAX_ENTRIES // per_roi)
    outs = []
    for a in range(0, r, step):
        sl = slice(a, min(a + step, r))
        idx, wts = _align_bags(rois[sl], scale[sl], height[sl], width[sl],
                               base[sl], s, sr)
        outs.append(F.embedding_bag(idx, table, per_sample_weights=wts,
                                    mode="sum"))
    return (torch.cat(outs) / float(sr * sr)).reshape(r, s, s, c)


def roi_align(features, rois, batch_indices, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2):
    """features (B, H, W, C) NHWC; rois (R, 4) xyxy in image coordinates;
    batch_indices (R,) int. Returns (R, output_size, output_size, C)
    float32."""
    b, h, w, c = features.shape
    r = rois.shape[0]
    dev = rois.device
    full = lambda v: torch.full((r,), float(v), device=dev)  # noqa: E731
    base = batch_indices.long() * (h * w)
    return _pool_table(features.reshape(b * h * w, c).float(),
                       rois.float(), full(spatial_scale), full(h), full(w),
                       base, output_size, max(sampling_ratio, 1))


def roi_align_levels(features, rois, batch_indices, levels, scales,
                     output_size: int, sampling_ratio: int = 2):
    """Each RoI pooled from ``features[levels[r]]`` at ``scales[levels[r]]``:
    the same values as ``roi_align`` on that level alone. features: list of
    (B, H_l, W_l, C) NHWC maps; levels (R,) int in [0, len(features))."""
    b, c = features[0].shape[0], features[0].shape[-1]
    dev = rois.device
    sizes = [(f.shape[1], f.shape[2]) for f in features]
    offsets, n = [], 0
    for h, w in sizes:
        offsets.append(n)
        n += b * h * w
    table = torch.cat([f.reshape(-1, c).float() for f in features])
    lv = levels.long()

    def per_level(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)[lv]

    scale = per_level([float(x) for x in scales[:len(features)]],
                      torch.float32)
    height = per_level([float(h) for h, _ in sizes], torch.float32)
    width = per_level([float(w) for _, w in sizes], torch.float32)
    hw = per_level([h * w for h, w in sizes], torch.int64)
    base = per_level(offsets, torch.int64) + batch_indices.long() * hw
    return _pool_table(table, rois.float(), scale, height, width, base,
                       output_size, max(sampling_ratio, 1))


def roi_pool(features, rois, batch_indices, output_size: int,
             spatial_scale: float):
    """Max RoI pooling as ``scan_tpu``'s (a dense 4 x 4 grid of cells a bin,
    the max over them; reference ROIPool_cuda.cu). (R, s, s, C)."""
    b, h, w, c = features.shape
    s, sr = output_size, 4
    x1 = torch.round(rois[:, 0] * spatial_scale)
    y1 = torch.round(rois[:, 1] * spatial_scale)
    x2 = torch.round(rois[:, 2] * spatial_scale)
    y2 = torch.round(rois[:, 3] * spatial_scale)
    one = torch.ones_like(x1)
    roi_w = torch.maximum(x2 - x1 + 1, one)
    roi_h = torch.maximum(y2 - y1 + 1, one)
    g = torch.arange(s * sr, device=rois.device, dtype=torch.float32) + 0.5
    iy = y1[:, None] + g[None, :] * roi_h[:, None] / (s * sr)
    ix = x1[:, None] + g[None, :] * roi_w[:, None] / (s * sr)
    yy = torch.floor(iy).clamp(0, h - 1).long()
    xx = torch.floor(ix).clamp(0, w - 1).long()
    flat = features.reshape(b * h * w, c)
    idx = (batch_indices.long()[:, None, None] * (h * w)
           + yy[:, :, None] * w + xx[:, None, :])
    patch = flat[idx]  # (R, s * sr, s * sr, C)
    r = rois.shape[0]
    return patch.reshape(r, s, sr, s, sr, c).amax(dim=(2, 4))
