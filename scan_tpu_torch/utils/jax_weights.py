"""Carry ``scan_tpu``'s parameters into the port (counterpart of
``scan_tpu/utils/torch_weights.py``, the other direction).

Input is the JAX parameter dict as ``jax.device_get(params)`` gives it:
``{"backbone": {"params": ...}, "middle_head": {...}, "fcos": {...}, ...}``,
nested dicts of numpy arrays. The port's modules carry ``scan_tpu``'s names,
so a path maps to a state-dict key by dropping ``params`` and flax's
wrapper scopes (``Conv_0``, ``GroupNorm_0``) and converting layouts:

  * conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
  * dense kernel (I, O) -> weight (O, I);
  * GroupNorm / LayerNorm ``scale`` -> ``weight`` (``Scale``'s stays ``scale``);
  * ``TorchRNN`` weights are in torch layout already.

Parameters of parts the port does not have yet (discriminators, the
training-only condgraph layers) are skipped; every parameter of the port
must be covered, or ``load_jax_params`` raises. Nothing here imports JAX.
"""

import numpy as np
import torch

_WRAPPERS = ("params", "Conv_0", "GroupNorm_0")
# scan_tpu modules that only training or other heads use
_NOT_PORTED = {
    "middle_head": ("multihead_attn", "proto_cls_hidden", "proto_cls",
                    "gcn_layer1", "gcn_layer2", "edge_project_u",
                    "edge_project_v"),
}


def _flatten(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def convert_params(params: dict) -> dict:
    """JAX parameter dict -> the port's state dict (torch float32 tensors)."""
    out = {}
    for top in ("backbone", "middle_head", "fcos"):
        if top not in params:
            continue
        for path, arr in _flatten(params[top]):
            parts = [p for p in path if p not in _WRAPPERS]
            if parts and parts[0] in _NOT_PORTED.get(top, ()):
                continue
            leaf = parts[-1]
            owner = parts[-2] if len(parts) > 1 else ""
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                leaf = "weight"
            elif leaf == "scale" and not owner.startswith("scale"):
                leaf = "weight"
            key = ".".join([top] + parts[:-1] + [leaf])
            out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out


@torch.no_grad()
def load_jax_params(detector, params: dict, proto_state=None):
    """Copy ``scan_tpu`` parameters (and a numpy ``ProtoState`` or
    (prototype, counter) pair) into ``detector`` in place, keeping each
    tensor's device and dtype. Raises if a port parameter is not covered or
    a shape differs."""
    sd = convert_params(params)
    own = {k: v for k, v in detector.state_dict().items()
           if k not in ("prototype", "proto_counter")}
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, unexpected {extra}")
    for k, v in own.items():
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: port {tuple(v.shape)} vs scan_tpu "
                             f"{tuple(sd[k].shape)}")
        v.copy_(sd[k])
    if proto_state is not None:
        proto, counter = proto_state[0], proto_state[1]
        detector.prototype.copy_(torch.from_numpy(np.array(proto, np.float32)))
        detector.proto_counter.fill_(int(np.asarray(counter)))
    return detector
