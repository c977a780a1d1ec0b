"""The port's bfloat16 training step against ``scan_tpu``'s, on the CPU.

``scan_tpu`` trains in bf16 with ``TPU.COMPUTE_DTYPE bfloat16``: its flax
modules compute in bf16 over float32 parameters. The port's detector built
with ``train=True`` keeps float32 masters and casts at use. The C2F config
at VGG width / 8 with stages 2-5 cut to one conv each, 1-conv FCOS and CKA
towers and the pyramid cut to P3-P5, 64x96 images, batch 2 + 2, every
BASE_LR 0.1 (the inputs of ``test_torch_train_step.py``); ``scan_tpu``'s
seeded parameters are carried into the port. ``scan_tpu``'s step is the
jitted one its users run: under ``jax.jit`` XLA keeps the float32 result of
a conv whose output is cast to float32 (the prediction convs), and the
port's ``float_output`` convs do the same (without them ``loss_cls`` lay
4x outside the bound: its bf16 logits round at 0.031 near the prior bias).

``scan_tpu`` has no bf16 training test of its own, so the bound is
measured, not guessed: for every metric, and for the update of every
parameter group (the solver's labels, ``backbone``, ``fcos/bias``, ...) as
a relative L2 norm, the port's distance from ``scan_tpu``'s bf16 step must
be at most 2x the distance between ``scan_tpu``'s own bf16 and float32
steps on the same inputs (both printed). This holds the port to bf16's
rounding, which a missed cast or a float32 path where ``scan_tpu`` runs
bf16 (or the reverse) exceeds. The node and DBSCAN masks are not compared
one by one: bf16 features can move a candidate across DBSCAN's threshold
in either package, and that case shows in the metrics and updates, which
are compared.

Checked besides: one DA step in each ``forward_target`` variant and one
source-only step (on the ``MODEL.DA_ON`` False config ``train_net`` runs:
with discriminators that take no gradient, optax would decay them and
torch's SGD skips them); every parameter and momentum buffer stays
float32; stage 1 runs K2's plain version in bf16 (counted through the backbone's
``fused_stem``, as ``test_torch_vgg_int8.py`` counts the int8 kernels); a
detector built for evaluation (bf16 parameters) and an int8 detector
refuse to train; a bf16 detector for evaluation keeps the non-RNN
condgraph's ``cond_nx1_norm`` float32, as ``scan_tpu`` does (it used to be
cast, and the forward raised).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.engine.train_step import make_da_train_step as jax_da_step
from scan_tpu.engine.train_step import \
    make_source_only_train_step as jax_source_step
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.solver.build import make_optimizer as jax_make_optimizer
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.train_step import (make_da_train_step,
                                              make_source_only_train_step)
from scan_tpu_torch.modeling.backbone import vgg as tvgg
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params
from tests.test_torch_train_step import make_batches, tiny_cfg

# the pyramid cut to P3-P5, stages 2-5 to one conv each, 1-conv FCOS and
# CKA towers: six step compiles in scan_tpu
CUT = ("TPU.VGG_STAGE_BLOCKS", (2, 1, 1, 1, 1), "TPU.FPN_TOP_BLOCK", "none",
       "MODEL.FCOS.FPN_STRIDES", (8, 16, 32), "MODEL.FCOS.NUM_CONVS_CLS", 1,
       "MODEL.FCOS.NUM_CONVS_REG", 1) + tuple(
    x for p in ("P3", "P4", "P5")
    for x in (f"MODEL.ADV.CON_NUM_SHARED_CONV_{p}", 1)) + tuple(
    x for p in ("P6", "P7")
    for x in (f"MODEL.ADV.USE_DIS_{p}", False,
              f"MODEL.ADV.USE_DIS_{p}_CON", False))
KINDS = ("da_ft0", "da_ft1", "source")


def cfg_for(dtype, default=get_default_cfg, da=True):
    """The test's config; ``da`` False is the source-only config of
    ``train_net`` (no discriminators)."""
    return tiny_cfg(default(), opts=CUT + ("TPU.COMPUTE_DTYPE", dtype,
                                           "MODEL.DA_ON", da))


def source_params(params):
    return {k: v for k, v in params.items() if not k.startswith("dis_")}


def _jax_run(dtype, params, proto, batches):
    """scan_tpu's three steps from (params, proto) in ``dtype``: (new
    params, metrics) per kind, on the host; the source-only step on the
    DA_ON False config, without the discriminators."""
    bs, bt = batches
    js = {k: jnp.asarray(v) for k, v in bs.items()}
    jt = {"images": jnp.asarray(bt["images"])}
    out = {}
    cfg = cfg_for(dtype, jax_default_cfg)
    opt = jax_make_optimizer(cfg, params)
    da = jax_da_step(jax_build_detector(cfg), opt)
    for ft in (False, True):
        p, _, _, m = da(params, opt.init(params), proto, js, jt,
                        forward_target=ft)
        out[f"da_ft{int(ft)}"] = jax.device_get((p, m))
    cfg = cfg_for(dtype, jax_default_cfg, da=False)
    src = source_params(params)
    opt = jax_make_optimizer(cfg, src)
    p, _, _, m = jax_source_step(jax_build_detector(cfg), opt)(
        src, opt.init(src), proto, js)
    out["source"] = jax.device_get((p, m))
    return out


@pytest.fixture(scope="module")
def reference():
    batches = make_batches(0)
    jdet = jax_build_detector(cfg_for("float32", jax_default_cfg))
    params, proto = jdet.init_params(jax.random.PRNGKey(0),
                                     jnp.asarray(batches[0]["images"]))
    runs = {dt: _jax_run(dt, params, proto, batches)
            for dt in ("float32", "bfloat16")}
    return jax.device_get((params, proto)), batches, runs


def _port_run(params, proto, batches, kind, monkeypatch):
    cfg = cfg_for("bfloat16", da=kind != "source")
    det = build_detector(cfg, device="cpu", train=True)
    if kind == "source":
        params = source_params(params)
    load_jax_params(det, params, proto)
    opt = make_optimizer(cfg, det)
    sched = make_lr_scheduler(cfg, opt)
    calls = []
    real = tvgg.fused_stem

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw["out_dtype"], out.dtype))
        return out

    monkeypatch.setattr(tvgg, "fused_stem", counted)
    bs, bt = batches
    if kind == "source":
        step = make_source_only_train_step(det, opt, sched)
        _, metrics = step(det.proto_state(), bs)
    else:
        step = make_da_train_step(det, opt, sched)
        _, metrics = step(det.proto_state(), bs, bt,
                          forward_target=kind == "da_ft1")
    return det, opt, metrics, calls


def _groups(opt, det):
    """Parameter name -> the solver label of its group."""
    label = {id(p): g["label"] for g in opt.param_groups for p in g["params"]}
    return {k: label[id(p)] for k, p in det.named_parameters()
            if id(p) in label}


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_step_within_twice_scan_tpus_own_bf16_distance(
        reference, kind, monkeypatch):
    (params, proto), batches, runs = reference
    (p32, m32), (p16, m16) = runs["float32"][kind], runs["bfloat16"][kind]
    det, opt, got, calls = _port_run(params, proto, batches, kind,
                                     monkeypatch)

    # K2's plain version in bf16, once a source pass and once a target pass
    assert calls == [(torch.bfloat16, torch.bfloat16)] * (
        1 if kind == "source" else 2)
    assert all(p.dtype == torch.float32 for p in det.parameters())
    mom = [s["momentum_buffer"] for s in opt.state.values()]
    assert mom and all(m.dtype == torch.float32 for m in mom)

    assert set(got) == set(m16) == set(m32)
    for k in m16:
        a, b, c = float(got[k]), float(m16[k]), float(m32[k])
        print(f"{kind} {k}: port-bf16 {abs(a - b):.3g}  "
              f"scan_tpu bf16-f32 {abs(c - b):.3g}")
        assert abs(a - b) <= 2 * abs(c - b), k

    p0 = convert_params(source_params(params) if kind == "source" else params)
    d16 = {k: v - p0[k] for k, v in convert_params(p16).items()}
    d32 = {k: v - p0[k] for k, v in convert_params(p32).items()}
    after = det.state_dict()
    dport = {k: after[k] - p0[k] for k in p0}
    by_group = {}
    for k, g in _groups(opt, det).items():
        by_group.setdefault(g, []).append(k)
    assert len(by_group) == (6 if kind == "source" else 8)
    for g, keys in sorted(by_group.items()):
        def dist(d):
            num = sum(float(((d[k] - d16[k]) ** 2).sum()) for k in keys)
            den = sum(float((d16[k] ** 2).sum()) for k in keys)
            return (num / den) ** 0.5
        port, own = dist(dport), dist(d32)
        print(f"{kind} update {g}: port-bf16 {port:.3g}  "
              f"scan_tpu bf16-f32 {own:.3g}")
        assert port <= 2 * own, g


def test_eval_and_int8_detectors_refuse_to_train():
    cfg = cfg_for("bfloat16")
    det = build_detector(cfg, device="cpu")  # evaluation only: bf16 params
    assert det.backbone.fpn.fpn_inner1.weight.dtype == torch.bfloat16
    opt = make_optimizer(cfg, det)
    with pytest.raises(ValueError, match="train=True"):
        make_da_train_step(det, opt)
    cfg = cfg_for("bfloat16")
    cfg.TPU.INT8_INFERENCE = True
    det = build_detector(cfg, device="cpu", train=True)
    with pytest.raises(NotImplementedError, match="int8"):
        make_source_only_train_step(det, make_optimizer(cfg, det))


def test_bf16_eval_keeps_the_cond_nx1_branch_float32():
    """The non-RNN manifestation branch (``cond_nx1``, its plain GroupNorm
    ``cond_nx1_norm``, ``cond_2``) is float32 in ``scan_tpu``'s bf16
    detector (flax Dense and GroupNorm without ``dtype``). A bf16 detector
    for evaluation used to cast every GroupNorm's parameters, this one's
    too, and then raised on its float32 input; it now keeps it float32 and
    its kernels equal ``scan_tpu``'s within float32 rounding."""
    from scan_tpu.modeling.condgraph.module import CondGraph as JaxCondGraph
    from scan_tpu.modeling.condgraph.module import \
        CondGraphConfig as JaxCondGraphConfig

    cfg = cfg_for("bfloat16")
    cfg.MODEL.MIDDLE_HEAD.USE_RNN = None
    det = build_detector(cfg, device="cpu")
    mh = det.middle_head
    assert not mh.cfg.use_rnn and mh.cfg.proto_iter == 3
    assert mh.cond_nx1_norm.weight.dtype == torch.float32
    jcfg = cfg_for("bfloat16", jax_default_cfg)
    jcfg.MODEL.MIDDLE_HEAD.USE_RNN = None
    jmh = JaxCondGraph(JaxCondGraphConfig.from_cfg(jcfg), dtype=jnp.bfloat16)
    proto = jax.random.normal(jax.random.PRNGKey(2), (9, 256, 3))
    p = jmh.init(jax.random.PRNGKey(3), proto,
                 method=JaxCondGraph.get_conded_weight)
    sd = {k.split(".", 1)[1]: v
          for k, v in convert_params({"m": jax.device_get(p)}).items()}
    assert set(sd) == {f"{m}.{t}" for m in ("cond_nx1", "cond_nx1_norm",
                                            "cond_2")
                       for t in ("weight", "bias")}
    with torch.no_grad():
        for k, v in sd.items():
            mh.get_parameter(k).copy_(v)
        got = mh.get_conded_weight(torch.from_numpy(np.array(proto)))
        images = torch.from_numpy(make_batches(0)[0]["images"])
        out = det.forward_inference(images, torch.tensor([[64, 96]] * 2))
    want = jmh.apply(p, proto, method=JaxCondGraph.get_conded_weight)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert out["boxes"].shape == (2, cfg.TEST.DETECTIONS_PER_IMG, 4)
