"""Concatenation of several detection datasets into one index space; a
copy of ``scan_tpu/data/datasets/concat.py``, which the port does not import.

Parity target: reference ``fcos_core/data/datasets/concat_dataset.py:7-23``
(a torch.utils.data.ConcatDataset subclass adding get_idxs/get_img_info) and
``fcos_core/data/build.py:32-54`` which builds every name in a DATASETS list
and concatenates when training. Same semantics here: cumulative index
mapping, get_img_info delegated to the owning child.
"""

import bisect
from typing import List


class ConcatDataset:
    def __init__(self, datasets: List):
        assert datasets, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def get_idxs(self, idx: int):
        """(dataset_idx, sample_idx) for a global index
        (reference concat_dataset.py:12-19)."""
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if dataset_idx == 0:
            sample_idx = idx
        else:
            sample_idx = idx - self.cumulative_sizes[dataset_idx - 1]
        return dataset_idx, sample_idx

    def get_img_info(self, idx: int) -> dict:
        di, si = self.get_idxs(idx)
        return self.datasets[di].get_img_info(si)

    def load_image(self, idx: int):
        di, si = self.get_idxs(idx)
        return self.datasets[di].load_image(si)

    def get_raw_target(self, idx: int):
        di, si = self.get_idxs(idx)
        return self.datasets[di].get_raw_target(si)

    def class_names(self) -> List[str]:
        return self.datasets[0].class_names()
