"""The numbers that decide ``correct``: the system's outputs against the
plain reference's. Each function returns {name: reading}; a cell's
workload file gives each name its limit (``limits``), and a run is correct
when every reading is finite and within its limit."""

import math
import sys

import numpy as np


def _leaf_gaps(prog, ref, keep, tag=""):
    """Worst leaf of |‖p‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖), and
    the median leaf's gap; the worst leaf is named on stderr."""
    med = float(np.median([ref[k] for k in keep]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    print(f"{tag} worst leaf {worst}: {gaps[worst]!r}", file=sys.stderr)
    return gaps[worst], float(np.median(list(gaps.values())))


def moved_leaves(grad_ref):
    """The leaves compared: those whose first gradient in the reference is
    at least a thousandth of the median leaf's (the rest, such as a bias
    under softmax, move by round-off alone)."""
    med = float(np.median(list(grad_ref.values())))
    return sorted(k for k, v in grad_ref.items() if v >= 1e-3 * med)


def da_readings(prog, ref):
    """``prog`` and ``ref``: dicts with ``metrics`` (a list, one dict of
    loss terms a step), ``grad`` (leaf -> norm of the first gradient as
    the optimizer takes it: gradient plus weight decay), ``change`` (leaf
    -> norm of the change over the steps) and ``prototype`` (array or
    None)."""
    loss = 0.0
    for mp, mr in zip(prog["metrics"], ref["metrics"]):
        if set(mp) != set(mr):
            return {"loss": math.inf}
        floor = 1e-2 * abs(mr["loss_total"])
        loss = max(loss, max(abs(mp[k] - mr[k]) / max(abs(mr[k]), floor)
                             for k in mr))
    keep = moved_leaves(ref["grad"])
    out = {"loss": loss}
    out["grad"], out["grad_median"] = _leaf_gaps(prog["grad"], ref["grad"],
                                                 keep, "grad")
    out["change"], out["change_median"] = _leaf_gaps(
        prog["change"], ref["change"], keep, "change")
    if ref["prototype"] is not None:
        d = np.linalg.norm(prog["prototype"] - ref["prototype"])
        out["prototype"] = float(d / np.linalg.norm(ref["prototype"]))
    return {k: float(v) for k, v in out.items()}


def _iou(a, b):
    """IoU with '+1' areas, (N, 4) x (M, 4)."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _match(bp, sp, lp, br, lr):
    """One to one, greedily by the system's score: each of the system's
    detections takes the unmatched reference detection of its label with
    the highest IoU, if that is 0.5 or more. Returns the reference's
    matched flags and the IoU of each matched pair."""
    taken = np.zeros(len(br), bool)
    pairs = []
    if len(bp) and len(br):
        iou = _iou(bp, br) * (lp[:, None] == lr[None, :])
        for j in np.argsort(-sp, kind="stable"):
            cand = np.where(taken, -1.0, iou[j])
            k = int(cand.argmax())
            if cand[k] >= 0.5:
                taken[k] = True
                pairs.append(float(cand[k]))
    return taken, pairs


def eval_readings(prog, ref, per_img):
    """``prog``, ``ref``: lists of per-batch dicts of numpy arrays
    (B, K) ``scores``, ``labels``, ``valid`` and (B, K, 4) ``boxes``; the
    system keeps ``per_img`` detections an image, the reference more. The
    two sides' valid detections are matched one to one (``_match``).

    * ``unmatched``: the share of the system's detections left unmatched;
    * ``missed``: the share of the reference's best ``per_img``
      detections an image that no detection of the system matched;
    * ``mismatch``: the share of both, the system's detections and the
      reference's best ``per_img``, left without a partner (compared:
      the two apart each separate the int8 control by under 3x);
    * ``box_gap``: the median over matched pairs of 1 - IoU (the median:
      a pair matched across an NMS decision that the two sides took
      differently overlaps far less than the rest);
    * ``count_gap``: the widest gap, over images, between the system's
      count of valid detections and the reference's (capped at
      ``per_img``), as a share of the latter;
    * ``score_gap``: the widest gap between the two sides' scores at one
      rank, each image's ``per_img`` best valid scores sorted (read, not
      compared: bf16 and int8 read alike, see PERF.md)."""
    gap, count, miss, total, lost, due = 0.0, 0.0, 0, 0, 0, 0
    ious = []
    for p, r in zip(prog, ref):
        for i in range(p["scores"].shape[0]):
            vp, vr = p["valid"][i], r["valid"][i]
            sp = np.sort(np.where(vp, p["scores"][i], 0.0))[::-1][:per_img]
            sr = np.sort(np.where(vr, r["scores"][i], 0.0))[::-1][:per_img]
            gap = max(gap, float(np.abs(sp - sr).max()))
            order = np.argsort(-np.where(vr, r["scores"][i], -np.inf),
                               kind="stable")[:int(vr.sum())]
            br, lr = r["boxes"][i][order], r["labels"][i][order]
            taken, pairs = _match(p["boxes"][i][vp], p["scores"][i][vp],
                                  p["labels"][i][vp], br, lr)
            ious += pairs
            total += int(vp.sum())
            miss += int(vp.sum()) - len(pairs)
            best = min(len(order), per_img)
            due += best
            lost += best - int(taken[:best].sum())
            count = max(count, abs(int(vp.sum()) - best) / max(best, 1))
    return {"unmatched": miss / max(total, 1), "missed": lost / max(due, 1),
            "mismatch": (miss + lost) / max(total + due, 1),
            "box_gap": 1.0 - float(np.median(ious)) if ious else 1.0,
            "count_gap": count, "score_gap": gap}


def judge(readings, limits):
    """(correct, the checks as {name: {"value", "limit"}})."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
