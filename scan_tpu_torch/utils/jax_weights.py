"""Carry ``scan_tpu``'s parameters into the port (counterpart of
``scan_tpu/utils/torch_weights.py``, the other direction).

Input is the JAX parameter dict as ``jax.device_get(params)`` gives it:
``{"backbone": {"params": ...}, "middle_head": {...}, "fcos": {...},
"dis_P3_CON": {...}, ...}``, nested dicts of numpy arrays. The port's
modules carry ``scan_tpu``'s names, the discriminators its top-level keys,
so a path maps to a state-dict key by dropping ``params`` and flax's
wrapper scopes (``Conv_0``, ``GroupNorm_0``) and converting layouts:

  * conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
  * flax ``ConvTranspose`` kernel (kh, kw, I, O) -> weight (I, O, kh, kw),
    flipped in both spatial axes (``layers.ConvTranspose`` says why); the
    rule follows the port module's type, not its name;
  * dense kernel (I, O) -> weight (O, I), the two-stage box head's ``fc6``
    included: it reads the pooled map flattened in NHWC order, as flax's;
  * GroupNorm / LayerNorm ``scale`` -> ``weight`` (``Scale``'s stays ``scale``);
  * ``TorchRNN`` weights are in torch layout already;
  * a ResNet body's FrozenBatchNorm ``weight``, ``bias``, ``running_mean``
    and ``running_var`` (parameters in ``scan_tpu``'s tree) land in the
    port's buffers of those names; the ATSS head sits under ``fcos`` with
    FCOS's names.

The static int8 activation scales of a calibrated tree, the
``act_scales`` collection beside ``params``, go into the port's scale
buffers under the same path: ``.../<conv>/amax`` to ``<conv>.amax`` and the
stem's ``conv0_act``, ``conv1_act``, ``stem_out_act`` to the body's buffers
of those names. A tree calibrated on a backend where ``scan_tpu`` runs the
naive stem holds ``conv0/amax``, ``conv1/amax`` and ``conv2/amax`` instead;
calibration measures the same tensors under both sets of names (stage 1's
input, its ReLU'd conv1_1 and its pooled output, which conv2 reads), so
those fill in the stem's names.

Every top-level key is carried over, the training-only condgraph layers
(``multihead_attn``, ``proto_cls_hidden``, ``proto_cls``, ``gcn_layer1/2``,
``edge_project_u/v``) and the ``dis_*`` discriminators of every family
(``dis_P3``, ``dis_P3_CA``, ``dis_P3_OUT``, ``dis_P3_CON``) included, and
``FasterRCNN``'s ``backbone``, ``rpn``, ``roi_box``, ``roi_mask`` and
``roi_keypoint``: every
parameter of the port must be covered, and every key carried over must
exist in the port, or ``load_jax_params`` raises. A scale buffer with no scale in the tree (an
uncalibrated tree, or the cls tower after a ``light``-mode calibration)
holds no value afterwards, and its conv quantizes dynamically, as
``scan_tpu``'s does. Nothing here imports JAX.
"""

import numpy as np
import torch

from ..modeling.layers import ConvTranspose, NO_SCALE, is_scale_key, read_scales

_WRAPPERS = ("params", "act_scales", "Conv_0", "GroupNorm_0")
# the port's stem scales <- the naive stem's (scan_tpu's name for each)
_STEM_ALIASES = {
    "backbone.body.conv0_act": "backbone.body.conv0.amax",
    "backbone.body.conv1_act": "backbone.body.conv1.amax",
    "backbone.body.stem_out_act": "backbone.body.conv2.amax",
}


def _flatten(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def convert_params(params: dict, transposed=()) -> dict:
    """JAX parameter dict -> the port's state dict (torch float32 tensors).
    ``transposed``: the port's module names (``roi_mask.conv5_mask``) whose
    kernels are flax ``ConvTranspose`` ones."""
    transposed = set(transposed)
    out = {}
    for top in params:
        for path, arr in _flatten(params[top]):
            parts = [p for p in path if p not in _WRAPPERS]
            leaf = parts[-1]
            owner = parts[-2] if len(parts) > 1 else ""
            if leaf == "kernel":
                if ".".join([top] + parts[:-1]) in transposed:
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                else:
                    arr = arr.T
                leaf = "weight"
            elif leaf == "scale" and not owner.startswith("scale"):
                leaf = "weight"
            key = ".".join([top] + parts[:-1] + [leaf])
            out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out


def _alias_stem_scales(sd: dict, own_keys) -> dict:
    """Fill the port's stem scales from the naive stem's names where the
    tree has only those, and drop the naive names the port does not have."""
    sd = dict(sd)
    own_keys = set(own_keys)
    for key, naive in _STEM_ALIASES.items():
        if key in own_keys and key not in sd and naive in sd:
            sd[key] = sd[naive]
    for naive in _STEM_ALIASES.values():
        if naive in sd and naive not in own_keys:
            del sd[naive]
    return sd


@torch.no_grad()
def load_jax_params(detector, params: dict, proto_state=None):
    """Copy ``scan_tpu`` parameters and activation scales (and a numpy
    ``ProtoState`` or (prototype, counter) pair) into ``detector`` in place,
    keeping each tensor's device and dtype. Raises if a port parameter is
    not covered, a key has no place in the port, or a shape differs; scale
    buffers the tree has no value for are set to hold none."""
    own = {k: v for k, v in detector.state_dict().items()
           if k not in ("prototype", "proto_counter")}
    transposed = [n for n, m in detector.named_modules()
                  if isinstance(m, ConvTranspose)]
    sd = _alias_stem_scales(convert_params(params, transposed), own)
    missing = sorted(k for k in set(own) - set(sd) if not is_scale_key(k))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, unexpected {extra}")
    for k, v in own.items():
        if k not in sd:
            v.fill_(NO_SCALE)
            continue
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: port {tuple(v.shape)} vs scan_tpu "
                             f"{tuple(sd[k].shape)}")
        v.copy_(sd[k])
    read_scales(detector)
    if proto_state is not None:
        proto, counter = proto_state[0], proto_state[1]
        detector.prototype.copy_(torch.from_numpy(np.array(proto, np.float32)))
        detector.proto_counter.fill_(int(np.asarray(counter)))
    return detector
