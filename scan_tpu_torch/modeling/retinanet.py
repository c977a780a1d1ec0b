"""RetinaNet's IoU matcher (counterpart of ``matcher_assign`` in
``scan_tpu/modeling/retinanet.py:103-118``), which the ATSS head's ``IoU``
positive type uses. The rest of ``retinanet.py`` (head, losses,
postprocess) belongs to the two-stage slice and is not ported yet.
"""

import torch


def matcher_assign(ious, fg_thresh, bg_thresh, allow_low_quality=True):
    """Reference Matcher semantics (``modeling/matcher.py``) over ious
    (..., L, G): each anchor's best gt; below ``bg_thresh`` -> -1
    (background), in [bg, fg) -> -2 (ignored); low-quality matches force
    each gt's best anchors positive. Returns the matched gt index (or -1 /
    -2), int64. Ties go to the first maximum, as ``jnp.argmax``'s."""
    vals = ious.amax(dim=-1)
    idx = ious.argmax(dim=-1)
    minus = lambda v: torch.full_like(idx, v)  # noqa: E731
    matches = torch.where(vals >= fg_thresh, idx, minus(-1))
    matches = torch.where((vals >= bg_thresh) & (vals < fg_thresh),
                          minus(-2), matches)
    if allow_low_quality:
        best_per_gt = ious.amax(dim=-2, keepdim=True)  # (..., 1, G)
        is_best = ious >= best_per_gt.clamp_min(1e-5)
        matches = torch.where(is_best.any(dim=-1), idx, matches)
    return matches
