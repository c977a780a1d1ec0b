"""The port's optimizer, LR schedule and DA weight bridge against ``scan_tpu``'s.

* WarmupMultiStep: the port's ``LambdaLR`` gives each param group, at
  optimizer step k, ``scan_tpu``'s schedule value at ``count`` = k, within
  rtol 1e-6 (float32 there), at iterations 0, warmup - 1, warmup and around
  each step, for constant and linear warmup and for bias groups.
* The parameter grouping: every parameter of the port lands in the group
  ``scan_tpu``'s ``label_fn`` gives it (``solver/build.py:124-136``):
  the frozen VGG stages 1-2 ("frozen", then out of the optimizer with
  ``requires_grad`` False), GroupNorm's ``bias`` a bias, ``TorchRNN``'s
  ``bias_ih_l0`` not, the ``dis_*`` trees in "discriminator".
* The R-101 body's parameters (narrow widths) against ``label_fn`` at
  FREEZE_CONV_BODY_AT 0, 2 and 5: every FrozenBatchNorm tensor frozen (a
  buffer in the port), the frozen stem and stages out of the optimizer
  with ``requires_grad`` False, the rest in ``backbone`` / ``backbone/bias``.
* ``load_jax_params`` carries the whole DA tree (``dis_P*_CON``, the MHA,
  the node classifier) strictly: a key removed or added raises.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.solver import build as jsolver
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")


def tiny_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 32
    cfg.TPU.MAX_TARGET_POINTS = 32
    cfg.TPU.MAX_BOXES = 4
    cfg.TPU.VGG_WIDTH_DIV = 8
    return cfg


@pytest.fixture(scope="module")
def models():
    jdet = jax_build_detector(tiny_cfg(jax_default_cfg()))
    params, proto = jdet.init_params(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 96, 3), jnp.float32))
    params = jax.device_get(params)
    tdet = build_detector(tiny_cfg(get_default_cfg()), device="cpu")
    load_jax_params(tdet, params, jax.device_get(proto))
    return params, tdet


@pytest.mark.parametrize("method", ["constant", "linear"])
def test_warmup_multistep_schedule(method):
    cfg = tiny_cfg(get_default_cfg())
    jcfg = tiny_cfg(jax_default_cfg())
    for c in (cfg, jcfg):
        for key in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
            s = c.SOLVER[key]
            s.WARMUP_ITERS, s.STEPS, s.WARMUP_METHOD = 5, (8, 12), method
            s.BIAS_LR_FACTOR, s.GAMMA, s.WARMUP_FACTOR = 2.0, 0.1, 1.0 / 3
    groups = [{"params": [torch.nn.Parameter(torch.zeros(1))],
               "solver_key": k, "lr": cfg.SOLVER[k].BASE_LR * f}
              for k in ("BACKBONE", "DIS") for f in (1.0, 2.0)]
    opt = torch.optim.SGD(groups, lr=1.0, momentum=0.9)
    sched = make_lr_scheduler(cfg, opt)
    checked = {0, 4, 5, 7, 8, 9, 11, 12, 13}
    for it in range(14):
        for g in opt.param_groups:
            s = jcfg.SOLVER[g["solver_key"]]
            bias = g["initial_lr"] > s.BASE_LR * 1.5
            want = jsolver.warmup_multistep(
                s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS,
                s.WARMUP_METHOD, s.BIAS_LR_FACTOR if bias else 1.0)(
                    jnp.asarray(it))
            if it in checked:
                assert g["lr"] == pytest.approx(float(want), rel=1e-6), (it, g)
        opt.step()
        sched.step()


def _jax_labels(cfg, params):
    """scan_tpu's ``label_fn`` (``solver/build.py:124-136``)."""
    is_frozen = jsolver._frozen_checker(cfg)

    def walk(tree, top, path):
        if isinstance(tree, dict):
            return {k: walk(v, top, path + (k,)) for k, v in tree.items()}
        if is_frozen(top, path):
            return "frozen"
        g = jsolver._module_group(top)
        return f"{g}/bias" if path and path[-1] == "bias" else g

    return {k: walk(v, k, ()) for k, v in params.items()}


def test_param_groups_follow_scan_tpu(models):
    params, tdet = models
    labels = _jax_labels(tiny_cfg(jax_default_cfg()), params)
    codes = {}

    def code_tree(lab, arr):
        if isinstance(lab, dict):
            return {k: code_tree(lab[k], arr[k]) for k in lab}
        return np.full(np.shape(arr), codes.setdefault(lab, len(codes)),
                       np.float32)

    want = {k: int(v.flatten()[0]) for k, v in
            convert_params(code_tree(labels, params)).items()}
    names = {v: k for k, v in codes.items()}
    opt = make_optimizer(tiny_cfg(get_default_cfg()), tdet)
    got = {}
    by_id = {id(p): n for n, p in tdet.named_parameters()}
    for g in opt.param_groups:
        for p in g["params"]:
            got[by_id[id(p)]] = g["label"]
    for name, p in tdet.named_parameters():
        label = names[want[name]]
        if label == "frozen":
            assert name not in got and not p.requires_grad, name
        else:
            assert got[name] == label, name
    assert names[want["middle_head.cond_rnn.bias_ih_l0"]] == "middle_head"
    assert got["middle_head.head_in.gn0.bias"] == "middle_head/bias"
    assert got["dis_P3_CON.classifier_cls_0_0.bias"] == "discriminator/bias"
    frozen = [n for n in want if names[want[n]] == "frozen"]
    assert sorted(frozen) == sorted(f"backbone.body.conv{i}.{t}"
                                    for i in range(4) for t in ("weight", "bias"))
    wd = {g["label"]: g["weight_decay"] for g in opt.param_groups}
    assert wd["fcos"] == 0.0001 and wd["fcos/bias"] == 0.0


def test_weight_bridge_carries_the_da_tree(models):
    params, tdet = models
    sd = convert_params(params)
    assert set(sd) == set(tdet.state_dict()) - {"prototype", "proto_counter"}
    assert any(k.startswith("dis_P7_CON.classifier_cls_7_1") for k in sd)
    assert "middle_head.multihead_attn.layer_norm.weight" in sd
    w = params["dis_P3_CON"]["params"]["classifier_cls_2_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        tdet.dis_P3_CON.classifier_cls_2_0.weight.detach().numpy(),
        np.asarray(w).transpose(3, 2, 0, 1))
    short = dict(params)
    short["dis_P5_CON"] = {"params": {k: v for k, v in
                                      params["dis_P5_CON"]["params"].items()
                                      if k != "classifier_cls_4_1"}}
    with pytest.raises(KeyError, match="classifier_cls_4_1"):
        load_jax_params(tdet, short)
    extra = dict(params, dis_P9_CON=params["dis_P3_CON"])
    with pytest.raises(KeyError, match="dis_P9_CON"):
        load_jax_params(tdet, extra)


@pytest.fixture(scope="module")
def r101_backbone_params():
    from scan_tpu.modeling.backbone.build import build_backbone as jbuild
    from test_torch_resnet import narrow_cfg

    jbb = jbuild(narrow_cfg(jax_default_cfg(), depth=101))
    return jax.device_get(jbb.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 96, 3), jnp.float32)))


@pytest.mark.parametrize("freeze_at", [0, 2, 5])
def test_resnet_param_groups_follow_scan_tpu(r101_backbone_params, freeze_at):
    """The R-101 body's parameters against ``label_fn``: FrozenBatchNorm is
    always frozen (the port holds it in buffers), ``stem_*`` from
    FREEZE_CONV_BODY_AT 1, ``layer{k}`` from k + 1; the rest train in
    ``backbone`` / ``backbone/bias``."""
    from test_torch_resnet import narrow_cfg

    params = {"backbone": r101_backbone_params}
    labels = _jax_labels(narrow_cfg(jax_default_cfg(), 101, freeze_at=freeze_at),
                         params)
    codes = {}

    def code_tree(lab, arr):
        if isinstance(lab, dict):
            return {k: code_tree(lab[k], arr[k]) for k in lab}
        return np.full(np.shape(arr), codes.setdefault(lab, len(codes)),
                       np.float32)

    coded = convert_params(code_tree(labels, params))
    names = {v: k for k, v in codes.items()}
    want = {k: names[int(t.flatten()[0])] for k, t in coded.items()}
    cfg = narrow_cfg(get_default_cfg(), 101, freeze_at=freeze_at)
    tdet = build_detector(cfg, device="cpu")
    opt = make_optimizer(cfg, tdet)
    by_id = {id(p): n for n, p in tdet.named_parameters()}
    got = {by_id[id(p)]: g["label"] for g in opt.param_groups
           for p in g["params"]}
    params_ = dict(tdet.named_parameters())
    buffers = {n for n, _ in tdet.named_buffers()}
    assert set(want) == {k for k in set(params_) | buffers
                         if k.startswith("backbone.")}
    n_frozen = 0
    for name, label in want.items():
        if label == "frozen":
            n_frozen += 1
            assert name in buffers or not params_[name].requires_grad, name
            assert name not in got, name
        else:
            assert params_[name].requires_grad and got[name] == label, name
    body_trained = {n for n in got if n.startswith("backbone.body.")}
    assert bool(body_trained) == (freeze_at < 5)
    assert any(n.startswith("backbone.body.stem_") for n in got) == (
        freeze_at == 0)
    assert any(n.startswith("backbone.body.layer1_") for n in got) == (
        freeze_at < 2)
    assert n_frozen >= 4 * 104  # R-101's 104 FrozenBatchNorms, 4 tensors each
