"""Training-set statistics used to configure models (counterpart of
``scan_tpu/data/stats.py``).

Reference ``fcos_core/modeling/rpn/atss/loss.py:41-60``
(``global_cat_distribution``): per-class instance counts over the training
annotations, which feed the ADAPT_ATSS per-class topk table. The reference
hardcodes one Cityscapes JSON path; here, as in ``scan_tpu``, the counts come
from the datasets the config names (TRAIN_SOURCE or TRAIN), concatenations
included.
"""

import numpy as np


def class_instance_counts(dataset, num_fg_classes: int) -> np.ndarray:
    """Instances per foreground class (contiguous ids 1..num_fg_classes)
    over a dataset with ``get_raw_target``. Returns (num_fg_classes,) int64."""
    from .datasets.coco import COCODataset
    from .datasets.concat import ConcatDataset

    if isinstance(dataset, ConcatDataset):
        return sum(class_instance_counts(d, num_fg_classes)
                   for d in dataset.datasets)
    counts = np.zeros((num_fg_classes,), np.int64)
    if isinstance(dataset, COCODataset):
        # the annotations are in memory already
        for img_id in dataset.ids:
            for a in dataset.coco.img_to_anns.get(img_id, []):
                c = dataset.json_category_id_to_contiguous_id.get(
                    a["category_id"])
                if c is not None and 1 <= c <= num_fg_classes:
                    counts[c - 1] += 1
        return counts
    for i in range(len(dataset)):
        _, labels = dataset.get_raw_target(i)
        for c in labels:
            if 1 <= c <= num_fg_classes:
                counts[c - 1] += 1
    return counts
