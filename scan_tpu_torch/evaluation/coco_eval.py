"""Self-contained COCO-style bbox AP evaluation (numpy); a copy of
``scan_tpu/evaluation/coco_eval.py``, which the port does not import.

Parity target: reference ``fcos_core/data/datasets/evaluation/coco/
coco_eval.py:13-484`` which drives pycocotools' COCOeval. pycocotools is not
in this environment, so this module reimplements COCOeval's bbox protocol:

  * IoU thresholds 0.50:0.05:0.95 (10), recall sampled at 101 points;
  * area ranges all/small/medium/large on GT area (the annotation 'area'
    field when present, else box w*h);
  * maxDets (1, 10, 100); AP reported at 100;
  * greedy score-ordered matching, crowd GTs as ignore regions that can be
    matched repeatedly, out-of-range GTs ignored, unmatched detections with
    out-of-range areas ignored;
  * precision envelope (monotone non-increasing) before sampling.

Boxes cross this boundary in xywh with the reference's '+1' width
convention (BoxList.convert('xywh'), bounding_box.py:103-119), matching
what the reference feeds pycocotools.
"""

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def _iou_xywh(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools maskUtils.iou semantics for bbox: union excludes crowd GT."""
    if det.size == 0 or gt.size == 0:
        return np.zeros((det.shape[0], gt.shape[0]))
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    da = det[:, 2] * det[:, 3]
    ga = gt[:, 2] * gt[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0, None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0, None,
    )
    inter = ix * iy
    union = np.where(
        iscrowd[None, :], da[:, None], da[:, None] + ga[None, :] - inter
    )
    return inter / np.maximum(union, 1e-10)


def _evaluate_img(dets, det_scores, gts, gt_ignore, iscrowd, area_rng):
    """Per (image, category, area-range) matching over all IoU thresholds.

    Returns dict with per-threshold det matches / det ignores, and the
    number of non-ignored GTs.
    """
    t_n = len(IOU_THRS)
    lo, hi = area_rng
    g_ignore = gt_ignore.copy()
    g_areas = gts[:, 4] if gts.shape[1] > 4 else gts[:, 2] * gts[:, 3]
    g_ignore = g_ignore | (g_areas < lo) | (g_areas > hi)

    order_g = np.argsort(g_ignore, kind="stable")  # non-ignored first
    gts_s = gts[order_g]
    g_ignore_s = g_ignore[order_g]
    crowd_s = iscrowd[order_g]

    order_d = np.argsort(-det_scores, kind="stable")[:MAX_DETS]
    dets_s = dets[order_d]
    d_areas = dets_s[:, 2] * dets_s[:, 3]

    ious = _iou_xywh(dets_s, gts_s[:, :4], crowd_s)

    nd, ng = dets_s.shape[0], gts_s.shape[0]
    dt_m = np.zeros((t_n, nd), np.int64) - 1  # matched gt index or -1
    gt_m = np.zeros((t_n, ng), np.int64) - 1
    for ti, t in enumerate(IOU_THRS):
        for di in range(nd):
            best_iou = min(t, 1 - 1e-10)
            best_g = -1
            for gi in range(ng):
                if gt_m[ti, gi] >= 0 and not crowd_s[gi]:
                    continue
                # non-ignored gts all come first; stop at first ignored if a
                # match among non-ignored was found
                if best_g >= 0 and not g_ignore_s[best_g] and g_ignore_s[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                dt_m[ti, di] = best_g
                gt_m[ti, best_g] = di

    # detection ignore flags
    d_ignore = np.zeros((t_n, nd), bool)
    out_of_range = (d_areas < lo) | (d_areas > hi)
    for ti in range(t_n):
        matched = dt_m[ti] >= 0
        if ng == 0:
            d_ignore[ti] = out_of_range
            continue
        d_ignore[ti] = np.where(
            matched, g_ignore_s[np.maximum(dt_m[ti], 0)], out_of_range
        )
    npig = int(np.sum(~g_ignore_s))
    return {
        "scores": det_scores[order_d],
        "matched": dt_m >= 0,
        "d_ignore": d_ignore,
        "npig": npig,
    }


def _accumulate(per_img_results: List[dict]):
    """Accumulate one (category, area-range) stream into AP/AR."""
    t_n = len(IOU_THRS)
    npig = sum(r["npig"] for r in per_img_results)
    if npig == 0:
        return None
    scores = np.concatenate([r["scores"] for r in per_img_results])
    matched = np.concatenate([r["matched"] for r in per_img_results], axis=1)
    d_ignore = np.concatenate([r["d_ignore"] for r in per_img_results], axis=1)
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    d_ignore = d_ignore[:, order]

    precision = np.zeros((t_n, len(RECALL_THRS)))
    recall = np.zeros((t_n,))
    for ti in range(t_n):
        keep = ~d_ignore[ti]
        tps = np.cumsum(matched[ti] & keep)
        fps = np.cumsum(~matched[ti] & keep)
        rc = tps / npig
        pr = tps / np.maximum(tps + fps, 1e-10)
        # precision envelope
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, RECALL_THRS, side="left")
        prec_at = np.zeros(len(RECALL_THRS))
        valid = inds < len(pr)
        prec_at[valid] = pr[inds[valid]]
        precision[ti] = prec_at
        recall[ti] = rc[-1] if len(rc) else 0.0
    return {"precision": precision, "recall": recall, "npig": npig}


class COCOResults(dict):
    """AP summary (reference COCOResults, coco_eval.py:358-401)."""


def evaluate_detections(gt_by_image: Dict, predictions: Dict,
                        category_ids: Sequence) -> COCOResults:
    """Generic COCO-protocol evaluation.

    Args:
      gt_by_image: image_id -> list of dicts(bbox xywh, category_id, iscrowd,
        area, ignore).
      predictions: image_id -> dict(boxes_xywh (n,4), scores (n,),
        category_ids (n,)).
      category_ids: the evaluated category ids.

    Returns COCOResults with AP, AP50, AP75, APs, APm, APl, and per-category
    AP50s under 'per_category'.
    """
    img_ids = sorted(gt_by_image.keys())
    results_by_cat_area = defaultdict(list)

    for img_id in img_ids:
        gts_all = gt_by_image[img_id]
        preds = predictions.get(img_id)
        for cat in category_ids:
            g = [x for x in gts_all if x["category_id"] == cat]
            gt_arr = np.asarray(
                [list(x["bbox"]) + [x.get("area", x["bbox"][2] * x["bbox"][3])] for x in g],
                np.float64,
            ).reshape(-1, 5)
            gt_ign = np.asarray(
                [bool(x.get("ignore", 0)) or bool(x.get("iscrowd", 0)) for x in g],
                bool,
            )
            crowd = np.asarray([bool(x.get("iscrowd", 0)) for x in g], bool)
            if preds is None:
                det = np.zeros((0, 4))
                det_scores = np.zeros((0,))
            else:
                sel = preds["category_ids"] == cat
                det = preds["boxes_xywh"][sel]
                det_scores = preds["scores"][sel]
            if gt_arr.shape[0] == 0 and det.shape[0] == 0:
                continue
            for area_name, rng in AREA_RANGES.items():
                results_by_cat_area[(cat, area_name)].append(
                    _evaluate_img(det, det_scores, gt_arr, gt_ign, crowd, rng)
                )

    # accumulate
    acc = {}
    for key, res in results_by_cat_area.items():
        acc[key] = _accumulate(res)

    def mean_ap(area: str, thr_idx=None):
        vals = []
        for cat in category_ids:
            a = acc.get((cat, area))
            if a is None:
                continue
            p = a["precision"] if thr_idx is None else a["precision"][thr_idx : thr_idx + 1]
            vals.append(np.mean(p))
        return float(np.mean(vals)) if vals else -1.0

    out = COCOResults(
        AP=mean_ap("all"),
        AP50=mean_ap("all", 0),
        AP75=mean_ap("all", 5),
        APs=mean_ap("small"),
        APm=mean_ap("medium"),
        APl=mean_ap("large"),
    )
    out["per_category"] = {
        cat: (
            float(np.mean(acc[(cat, "all")]["precision"][0]))
            if acc.get((cat, "all")) is not None
            else -1.0
        )
        for cat in category_ids
    }
    return out


def xyxy_to_xywh_plus1(boxes_xyxy: np.ndarray) -> np.ndarray:
    """xyxy -> xywh with the reference's '+1' convention
    (BoxList.convert('xywh'))."""
    b = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
    return np.stack(
        [b[:, 0], b[:, 1], b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1],
        axis=1,
    )


def evaluate_coco_dataset(dataset, predictions_by_index: Dict[int, dict]) -> COCOResults:
    """Evaluate predictions against a COCO-style dataset (``scan_tpu``'s
    ``COCODataset`` API: ``coco.get_cat_ids()``, ``coco.img_to_anns``,
    ``id_to_img_map``, ``contiguous_category_id_to_json_id``, ``len``).

    predictions_by_index: dataset index -> dict(boxes (n,4) xyxy in ORIGINAL
    image coords, scores (n,), labels (n,) contiguous ids).
    """
    coco = dataset.coco
    cat_ids = coco.get_cat_ids()
    gt_by_image = {}
    preds = {}
    for index in range(len(dataset)):
        img_id = dataset.id_to_img_map[index]
        gt_by_image[img_id] = [
            {
                "bbox": a["bbox"],
                "category_id": a["category_id"],
                "iscrowd": a.get("iscrowd", 0),
                "area": a.get("area", a["bbox"][2] * a["bbox"][3]),
                "ignore": a.get("ignore", 0),
            }
            for a in coco.img_to_anns.get(img_id, [])
        ]
        p = predictions_by_index.get(index)
        if p is not None and len(p["scores"]):
            preds[img_id] = {
                "boxes_xywh": xyxy_to_xywh_plus1(p["boxes"]),
                "scores": np.asarray(p["scores"], np.float64),
                "category_ids": np.asarray(
                    [
                        dataset.contiguous_category_id_to_json_id[int(l)]
                        for l in p["labels"]
                    ]
                ),
            }
    return evaluate_detections(gt_by_image, preds, cat_ids)
