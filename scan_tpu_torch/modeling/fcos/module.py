"""FCOS TEST.MODE mixing (counterpart of ``scan_tpu/modeling/fcos/module.py``).

The three TEST.MODEs (reference ``fcos.py:162-169``):
  common    - raw logits, sigmoid applied inside the postprocessor;
  precision - 0.5*sigmoid(logits) + 0.5*act_maps[..., 1:] (probabilities);
  light     - act_maps[..., 1:] replace the classification maps and the cls
              tower is skipped.
Act maps are NHWC; channel 0 is background when PROTO_WITH_BG.
"""

import torch


def mix_cls_maps(mode: str, box_cls, act_maps):
    """Apply the TEST.MODE ensembling. Returns (cls_maps, apply_sigmoid)."""
    if mode == "light":
        return [a[..., 1:] for a in act_maps], False
    if mode == "precision":
        return (
            [0.5 * torch.sigmoid(c) + 0.5 * a[..., 1:]
             for c, a in zip(box_cls, act_maps)],
            False,
        )
    return list(box_cls), True
