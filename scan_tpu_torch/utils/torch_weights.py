"""Reference ``.pth`` weights -> the port's state dict (counterpart of
``scan_tpu/utils/torch_weights.py``).

Two families of files, as in ``scan_tpu``:

  * the ImageNet caffe VGG16 (``vgg16_caffe-292e1171.pth``, mmcv's layout
    ``features.{idx}.*``, bare or under ``state_dict``, keys possibly
    prefixed ``module.``) that every VGG config's ``MODEL.WEIGHT`` names: it
    loads the VGG body only;
  * a full SCAN checkpoint of the reference's ``DetectronCheckpointer``
    (``fcos_core/utils/checkpoint.py:141-301``): one state dict per entry of
    its model dict (``model_backbone``, ``model_fcos``, ``middle_head``,
    ``model_dis_P*_CON``, ...), the prototype buffer inside ``middle_head``.

Both sides are torch NCHW, so, unlike ``scan_tpu``'s HWIO conversion, most
entries are renames into ``scan_tpu``'s names, which the port carries
(``backbone.body.conv0``, ``backbone.fpn.fpn_inner1``,
``dis_P3_CON.classifier_cls_2_0``). The special cases are ``scan_tpu``'s:

  * the 13 convs of VGG16 sit at ``features.{0,2,5,...,28}``;
  * the reference's FPN names its levels by the absolute index into the
    backbone's channel list (``fpn_inner3..5`` for VGG, whose first two
    entries are 0-channel placeholders); the port's are 1-based over the
    levels used;
  * towers are ``nn.Sequential`` of [conv, GN, ReLU] (step 3) or, without
    GN (``head_out``), [conv, ReLU] (step 2);
  * ``cond_nx1`` is a Conv2d(512, 256, (ITER, 1)) whose (256, 512, ITER, 1)
    weight is the port's Linear over 512 * ITER (channel-major);
  * ``cond_2`` is dead in the RNN path and dropped there;
  * the CKA heads ``classifier_cls_{c}.{0,2}`` are ``classifier_cls_{c}_{0,1}``.

It converts what ``scan_tpu`` converts and no more: the backbone of a
detector whose body is not VGG (a ResNet) raises, naming the missing
converter, rather than map a ResNet file with the VGG one; the GA, CA and OUT
discriminators of a reference file, its ``edge_project_*`` layers and its
optimizer states are not read. A component the detector lacks (a
``middle_head`` without the condgraph, a discriminator the config does not
build) is skipped, as ``scan_tpu`` merges only the components its
parameter dict has. Nothing here imports JAX.
"""

from typing import Dict, Optional, Tuple

import torch

# torch Sequential indices of the 13 VGG-16 convs in mmcv's ``features``
VGG16_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
REFERENCE_ENTRIES = ("model_backbone", "model_fcos", "middle_head")


def _strip_prefix(sd: Dict, prefix: str = "module.") -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def _unwrap(state: Dict) -> Dict:
    """A bare state dict: the ``state_dict`` wrapper and ``module.`` gone."""
    inner = state.get("state_dict", state)
    return _strip_prefix(inner if isinstance(inner, dict) else state)


def is_imagenet_vgg(state: Dict) -> bool:
    return any(k.startswith("features.") for k in _unwrap(state))


def is_reference(state: Dict) -> bool:
    """A file in the reference's layout: a SCAN model dict or an ImageNet
    VGG (bare or under ``state_dict``)."""
    return (any(k in state for k in REFERENCE_ENTRIES)
            or any(k.startswith("model_dis_") for k in state)
            or is_imagenet_vgg(state))


def _pair(out: Dict, dst: str, sd: Dict, src: str):
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    out[f"{dst}.bias"] = sd[f"{src}.bias"]


def convert_vgg16_caffe(state: Dict) -> Dict:
    """caffe VGG16 ``features.*`` -> ``conv{i}.{weight,bias}`` of the body."""
    sd = {k.replace("body.", ""): v for k, v in _unwrap(state).items()}
    out = {}
    for my_idx, t_idx in enumerate(VGG16_TORCH_CONV_IDX):
        if f"features.{t_idx}.weight" not in sd:
            raise KeyError(f"missing VGG conv features.{t_idx}.weight")
        _pair(out, f"conv{my_idx}", sd, f"features.{t_idx}")
    return out


def convert_fpn(sd: Dict) -> Dict:
    ref_ids = sorted({int(k.split(".")[0][len("fpn_inner"):])
                      for k in sd if k.startswith("fpn_inner")})
    out = {}
    for my_i, ref_i in enumerate(ref_ids, 1):
        for kind in ("inner", "layer"):
            _pair(out, f"fpn_{kind}{my_i}", sd, f"fpn_{kind}{ref_i}")
    for p in ("p6", "p7"):
        if f"top_blocks.{p}.weight" in sd:
            _pair(out, p, sd, f"top_blocks.{p}")
    return out


def convert_tower(sd: Dict, prefix: str, num_convs: int,
                  with_gn: bool = True) -> Dict:
    """``nn.Sequential`` [conv, GN, ReLU] * n (or [conv, ReLU] * n) ->
    ``conv{i}`` / ``gn{i}``."""
    out = {}
    step = 3 if with_gn else 2
    for i in range(num_convs):
        _pair(out, f"conv{i}", sd, f"{prefix}.{i * step}")
        if with_gn:
            _pair(out, f"gn{i}", sd, f"{prefix}.{i * step + 1}")
    return out


def convert_backbone(state: Dict) -> Dict:
    sd = _strip_prefix(state)
    body = {k[len("body."):]: v for k, v in sd.items() if k.startswith("body.")}
    fpn = {k[len("fpn."):]: v for k, v in sd.items() if k.startswith("fpn.")}
    out = {f"body.{k}": v for k, v in convert_vgg16_caffe(body).items()}
    out.update({f"fpn.{k}": v for k, v in convert_fpn(fpn).items()})
    return out


def convert_fcos_head(state: Dict, num_convs_cls=4, num_convs_reg=4,
                      num_levels=5) -> Dict:
    sd = _strip_prefix(state)
    sd = {k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")}
    out = {}
    for tower, n in (("cls_tower", num_convs_cls), ("bbox_tower", num_convs_reg)):
        out.update({f"{tower}.{k}": v
                    for k, v in convert_tower(sd, tower, n).items()})
    for name in ("cls_logits", "bbox_pred", "centerness"):
        _pair(out, name, sd, name)
    for l in range(num_levels):
        out[f"scale{l}.scale"] = sd[f"scales.{l}.scale"]
    return out


def _cond_nx1(w):
    """(256, 512, ITER, 1) -> the Linear's (256, 512 * ITER)."""
    o, i, t, _ = w.shape
    return w[:, :, :, 0].reshape(o, i * t)


def convert_middle_head(state: Dict, cg_cfg) -> Tuple[Dict, torch.Tensor]:
    """GRAPHModule state dict -> the CondGraph's entries and the
    prototype."""
    sd = _strip_prefix(state)
    out = {f"head_in.{k}": v for k, v in convert_tower(
        sd, "head_in.middle_tower", cg_cfg.num_convs_in).items()}
    if cg_cfg.cat_act_map:
        out.update({f"head_out.{k}": v for k, v in convert_tower(
            sd, "head_out.middle_tower", cg_cfg.num_convs_out,
            with_gn=False).items()})
    names = ["proto_cls_hidden", "proto_cls"]
    if cg_cfg.global_gcn:
        names += [f"multihead_attn.{n}" for n in (
            "linear_q", "linear_k", "linear_v", "linear_final", "layer_norm")]
    else:
        names += ["gcn_layer1", "gcn_layer2"]
    if cg_cfg.use_rnn:
        for layer in range(2):
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = f"cond_rnn.{kind}_l{layer}"
                out[key] = sd[key]
        out["cond_nx1.weight"] = _cond_nx1(sd["cond_nx1.weight"])
        out["cond_nx1.bias"] = sd["cond_nx1.bias"]
    elif cg_cfg.proto_iter > 1:
        out["cond_nx1.weight"] = _cond_nx1(sd["cond_nx1.weight"])
        out["cond_nx1.bias"] = sd["cond_nx1.bias"]
        names.append("cond_nx1_norm")
    else:
        names.append("cond_1")
    # cond_2 is in every reference checkpoint but dead in the RNN path
    # (get_conded_weight never calls it, condgraph.py:313-319)
    if "cond_2.weight" in sd and not cg_cfg.use_rnn:
        names.append("cond_2")
    for name in names:
        _pair(out, name, sd, name)
    return out, sd["prototype"]


def convert_con_discriminator(state: Dict, num_convs=4, num_fg=8) -> Dict:
    sd = _strip_prefix(state)
    out = {f"dis_tower.{k}": v
           for k, v in convert_tower(sd, "dis_tower", num_convs).items()}
    for c in range(num_fg):
        _pair(out, f"classifier_cls_{c}_0", sd, f"classifier_cls_{c}.0")
        _pair(out, f"classifier_cls_{c}_1", sd, f"classifier_cls_{c}.2")
    return out


def convert_reference(state: Dict, detector) -> Tuple[
        Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """A reference-layout file (as ``torch.load`` gives it) -> (the port's
    state-dict entries it carries, the prototype or None). Components the
    detector lacks are skipped (``scan_tpu/utils/checkpoint.py:155-177``)."""
    cfg = detector.cfg
    out, prototype = {}, None
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if not body.startswith("VGG") and (
            "model_backbone" in state or is_imagenet_vgg(state)):
        raise NotImplementedError(
            f"a reference-layout backbone for the {body} body: only the "
            "VGG16 converter is ported (as in scan_tpu, whose "
            "torch_weights.py converts VGG bodies alone); a reference "
            "(fcos_core) ResNet .pth needs a ResNet converter, which "
            "neither package has. Start a ResNet from a Detectron .pkl or a "
            "port checkpoint")

    def add(prefix, entries):
        out.update({f"{prefix}.{k}": v for k, v in entries.items()})

    if "model_backbone" in state:
        add("backbone", convert_backbone(state["model_backbone"]))
    if "model_fcos" in state:
        add("fcos", convert_fcos_head(state["model_fcos"],
                                      cfg.MODEL.FCOS.NUM_CONVS_CLS,
                                      cfg.MODEL.FCOS.NUM_CONVS_REG))
    if "middle_head" in state and detector.condgraph_on:
        mh, prototype = convert_middle_head(state["middle_head"],
                                            detector.cg_cfg)
        add("middle_head", mh)
    for k in state:
        name = k[len("model_"):]
        if (k.startswith("model_dis_") and k.endswith("_CON")
                and name in detector.dis_names):
            add(name, convert_con_discriminator(
                state[k], num_fg=cfg.MODEL.FCOS.NUM_CLASSES - 1))
    if not out and is_imagenet_vgg(state):
        add("backbone.body", convert_vgg16_caffe(state))
    return out, prototype
