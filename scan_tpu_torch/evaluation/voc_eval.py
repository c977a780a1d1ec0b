"""Pascal-VOC detection evaluation (07 11-point metric by default); a copy
of ``scan_tpu/evaluation/voc_eval.py``, which the port does not import.

Parity target: reference ``fcos_core/data/datasets/evaluation/voc/
voc_eval.py:12-216`` — per-class AP with difficult-GT exclusion, greedy
max-IoU matching at 0.5, and the VOC07 11-point interpolated AP.
"""

from typing import Dict

import numpy as np


def voc_ap(rec, prec, use_07_metric=True):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_voc_dataset(dataset, predictions: Dict[int, dict],
                         iou_thresh: float = 0.5, use_07_metric: bool = True):
    """predictions: index -> dict(boxes xyxy original coords, scores, labels)."""
    num_classes = len(dataset.CLASSES)
    aps = {}
    for cls in range(1, num_classes):
        # gather GT
        gt = {}
        npos = 0
        for index in range(len(dataset)):
            boxes, labels, difficult, _ = dataset.get_groundtruth(index)
            sel = labels == cls
            b = boxes[sel]
            d = difficult[sel]
            gt[index] = {"boxes": b, "difficult": d, "matched": np.zeros(len(b), bool)}
            npos += int((~d).sum())

        dets = []
        for index, p in predictions.items():
            sel = np.asarray(p["labels"]) == cls
            for box, score in zip(np.asarray(p["boxes"])[sel], np.asarray(p["scores"])[sel]):
                dets.append((score, index, box))
        dets.sort(key=lambda x: -x[0])

        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, (score, index, box) in enumerate(dets):
            g = gt[index]
            if len(g["boxes"]) == 0:
                fp[di] = 1
                continue
            gx = g["boxes"]
            ixmin = np.maximum(gx[:, 0], box[0])
            iymin = np.maximum(gx[:, 1], box[1])
            ixmax = np.minimum(gx[:, 2], box[2])
            iymax = np.minimum(gx[:, 3], box[3])
            iw = np.maximum(ixmax - ixmin + 1, 0)
            ih = np.maximum(iymax - iymin + 1, 0)
            inter = iw * ih
            uni = (
                (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
                + (gx[:, 2] - gx[:, 0] + 1) * (gx[:, 3] - gx[:, 1] + 1)
                - inter
            )
            ious = inter / np.maximum(uni, 1e-10)
            jmax = int(np.argmax(ious))
            if ious[jmax] > iou_thresh:
                if not g["difficult"][jmax]:
                    if not g["matched"][jmax]:
                        tp[di] = 1
                        g["matched"][jmax] = True
                    else:
                        fp[di] = 1
            else:
                fp[di] = 1

        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / max(npos, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, 1e-10)
        aps[cls] = voc_ap(rec, prec, use_07_metric)

    m_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"AP50": m_ap, "map": m_ap, "per_category": aps}
