"""Seeded weights for both sides, made on the card in one draw.

The state dict is laid out from the plain reference's modules (built on the
``meta`` device, so nothing is allocated), whose names are the system's.
One ``torch.randn`` of every parameter's numbers from a generator on the
card, split and scaled per tensor:

* backbone body convs: He, std sqrt(2 / fan_in) (the caffe input's ~60 std
  then stays ~60 through the ReLUs, as trained weights keep it);
* FPN convs: std sqrt(1 / fan_in) (``kaiming_uniform(a=1)``'s variance);
* every other conv (heads, towers, condgraph, discriminators): std 0.01,
  the published FCOS init;
* linear layers and the RNN: std sqrt(1 / fan_in);
* biases 0, norms' weights 1; the FCOS cls_logits bias
  -log((1 - 0.01) / 0.01) plus the cell's ``cls_bias_offset``; the FCOS
  bbox_pred bias log(``reg_bias_px``), so that each side of a box starts
  that many pixels from its location (1 by default);
* FrozenBatchNorm: unit scale and variance, zero shift and mean, the last
  BN of each residual branch (``bn3``) at 0.2, so 33 blocks add up without
  overflow, as in a trained ResNet;
* the prototype standard normal, its counter -1.
"""

import math

import torch

from benchmark.reference import model as ref
from benchmark.reference import nn as rnn


def _rule(mod_name, mod, pname, shape):
    """(kind, std or constant) for one tensor."""
    if isinstance(mod, rnn.FrozenBatchNorm):
        if pname == "weight":
            return "const", 0.2 if mod_name.endswith("bn3") else 1.0
        return "const", 1.0 if pname == "running_var" else 0.0
    if isinstance(mod, (rnn.GroupNorm32, torch.nn.LayerNorm, rnn.Scale)):
        return "const", 0.0 if pname == "bias" else 1.0
    if pname.startswith("bias"):
        if mod_name == "fcos.cls_logits":
            return "cls_bias", None
        if mod_name == "fcos.bbox_pred":
            return "reg_bias", None
        if not isinstance(mod, ref.TorchRNN):
            return "const", 0.0
    if isinstance(mod, ref.TorchRNN):
        return "randn", math.sqrt(1.0 / 512)
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        if mod_name.startswith("backbone.body."):
            return "randn", math.sqrt(2.0 / fan_in)
        if mod_name.startswith("backbone.fpn."):
            return "randn", math.sqrt(1.0 / fan_in)
        return "randn", 0.01
    return "randn", math.sqrt(1.0 / shape[-1])


def layout(cfg):
    """[(name, shape, kind, value)] of the state dict, in module order."""
    with torch.device("meta"):
        model = ref.Detector(cfg)
    out = []
    for mod_name, mod in model.named_modules():
        own = list(mod.named_parameters(recurse=False)) + list(
            mod.named_buffers(recurse=False))
        for pname, t in own:
            name = f"{mod_name}.{pname}" if mod_name else pname
            if name == "prototype":
                out.append((name, tuple(t.shape), "randn", 1.0))
            elif name == "proto_counter":
                out.append((name, (), "const", -1))
            else:
                out.append((name, tuple(t.shape),
                            *_rule(mod_name, mod, pname, tuple(t.shape))))
    return out


def make_weights(cfg, seed, device, cls_bias_offset=0.0, reg_bias_px=1.0):
    """name -> float32 tensor on ``device`` (the counter int32)."""
    spec = layout(cfg)
    total = sum(math.prod(s) for _, s, k, _ in spec if k == "randn")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    prior = cfg["MODEL"]["FCOS"]["PRIOR_PROB"]
    out, off = {}, 0
    for name, shape, kind, value in spec:
        if kind == "randn":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape) * value
            off += n
        elif kind == "cls_bias":
            out[name] = torch.full(shape, -math.log((1 - prior) / prior)
                                   + cls_bias_offset, device=device)
        elif kind == "reg_bias":
            out[name] = torch.full(shape, math.log(reg_bias_px), device=device)
        elif name == "proto_counter":
            out[name] = torch.tensor(value, dtype=torch.int32, device=device)
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out
