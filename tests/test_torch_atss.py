"""The port's ATSS (``scan_tpu_torch/modeling/atss/atss.py``, ``anchors.py``,
``retinanet.matcher_assign``, ``data/stats.py``) against ``scan_tpu``'s, on
the CPU.

* Cell and grid anchors and the octave sizes: equal.
* The BOX and POINT coders: encode and decode within rtol 1e-6.
* Every positive type (ATSS, ADAPT_ATSS, SSC, IoU, TOPK) on planted gts
  at 128x192 (512 anchors): labels and matched boxes equal. ``scan_tpu``
  runs op by op, as a ``vmap`` outside ``jax.jit``, so both sides round
  each operation once. Two of the gts are centred between anchor centres,
  where 5 of the 8 anchors of the next distance ring enter the top 9: the
  tie test holds the port's pick to ``lax.top_k``'s (lower index first),
  and checks that breaking the ties toward the higher index changes the
  labels, so the case is sensitive.
* ADAPT_ATSS's table from a synthetic COCO set on disk, through each
  package's ``adapt_topk_from_cfg``: equal.
* The losses (both coders; ATSS and the IoU type, whose ignored anchors
  are masked) and their gradients with respect to the head's maps within
  rtol 1e-5 (float32 sums in another order), and finite where a row that
  is not positive predicts inf (``giou_loss`` zeroes such rows before the
  decode; checked by mutation: without that the POINT loss is NaN).
* The postprocess: the valid mask equal, and boxes, scores and labels
  equal within float32 rounding in the valid slots (the invalid ones hold
  NEG_INF ties, which ``torch.topk`` orders otherwise).
* The ATSS config as a whole (``configs/epm/da_ga_sim10k_VGG_16_FPN_4x_atss.yaml``
  at VGG width / 8, 64x96, the head's towers cut to 2 convs and the
  discriminators' to 1, the center-aware family turned on as well): the eval forward's valid
  detections, and one GA + CA DA step, metrics within rtol 1e-5 and every
  parameter update within ``tests/test_torch_train_step.py``'s bound.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from scan_tpu.engine.train_step import make_da_train_step as jax_make_step
from scan_tpu.modeling import anchors as janchors
from scan_tpu.modeling.atss import atss as jatss
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.modeling.fcos.postprocess import PostProcessConfig as JaxPP
from scan_tpu.solver.build import make_optimizer as jax_make_optimizer
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import DatasetCatalog
from scan_tpu_torch.modeling import anchors
from scan_tpu_torch.modeling.atss import atss
from scan_tpu_torch.modeling.fcos.postprocess import PostProcessConfig

from test_torch_train_step import _check_metrics, _check_updates, make_batches
from test_torch_train_step import _port as port_step

ATSS_CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "epm",
                        "da_ga_sim10k_VGG_16_FPN_4x_atss.yaml")
STRIDES = (8, 16, 32, 64, 128)
IMG_H, IMG_W = 128, 192
SHAPES = [((IMG_H + s - 1) // s, (IMG_W + s - 1) // s) for s in STRIDES]


def _cfg(**kw):
    return atss.ATSSConfig(num_classes=4, **kw)


def _jcfg(cfg):
    return jatss.ATSSConfig(**{f: getattr(cfg, f) for f in (
        "num_classes", "regression_type", "topk", "positive_type",
        "adapt_topk", "fg_iou_thresh", "bg_iou_thresh", "loss_gamma",
        "loss_alpha", "reg_loss_weight")})


def _anchor_levels(cfg):
    sizes = anchors.atss_level_sizes(cfg.anchor_sizes, cfg.octave,
                                     cfg.scales_per_octave)
    return anchors.grid_anchors(SHAPES, STRIDES, sizes, cfg.aspect_ratios)


# ---------------------------------------------------------------------- #
def test_anchors_equal():
    for stride, sizes, ratios in ((8, (64,), (1.0,)), (16, (32, 40.3), (0.5, 1.0, 2.0)),
                                  (128, (1024,), (1.0, 2.0))):
        np.testing.assert_array_equal(
            anchors.generate_cell_anchors(stride, sizes, ratios),
            janchors.generate_cell_anchors(stride, sizes, ratios))
    for octave, n in ((2.0, 1), (2.0, 3)):
        assert anchors.atss_level_sizes((32, 64), octave, n) == \
            janchors.atss_level_sizes((32, 64), octave, n)
    sizes = janchors.atss_level_sizes((64, 128, 256, 512, 1024), 2.0, 3)
    got = anchors.grid_anchors(SHAPES, STRIDES, sizes, (0.5, 1.0))
    want = janchors.grid_anchors(SHAPES, STRIDES, sizes, (0.5, 1.0))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("regression", ["BOX", "POINT"])
def test_coder_matches(regression):
    cfg = _cfg(regression_type=regression)
    rng = np.random.RandomState(0)
    anc = np.array(janchors.grid_anchors(SHAPES[:1], STRIDES[:1], [(64,)],
                                          (1.0,))[0])
    xy = rng.rand(len(anc), 2).astype(np.float32) * 150
    boxes = np.concatenate([xy, xy + rng.rand(len(anc), 2) * 80 + 4],
                           1).astype(np.float32)
    preds = (rng.randn(len(anc), 4) * 2).astype(np.float32)
    if regression == "POINT":
        preds = np.abs(preds)
    for name, x in (("encode", boxes), ("decode", preds)):
        got = getattr(atss, f"atss_{name}")(cfg, torch.from_numpy(x),
                                            torch.from_numpy(anc))
        want = getattr(jatss, f"atss_{name}")(_jcfg(cfg), jnp.asarray(x),
                                              jnp.asarray(anc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------- #
def planted_gts():
    """Two images, 5 slots. The first gt of each image is centred between
    anchor centres (31.5 and 95.5 px lie half-way between P3's 27.5/35.5
    and 91.5/99.5 and between P4's), wide or tall, so the top 9 of P3 and
    P4 end in a tie; the others are seeded; a masked slot holds garbage."""
    rng = np.random.RandomState(3)
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[0, 0] = [9.5, 23.5, 53.5, 39.5]  # centre (31.5, 31.5), wide
    boxes[1, 0] = [87.5, 67.5, 103.5, 123.5]  # centre (95.5, 95.5), tall
    for b in range(2):
        for j in range(1, 4):
            x0, y0 = rng.rand(2) * [150, 90]
            w, h = rng.rand(2) * [60, 50] + 10
            boxes[b, j] = [x0, y0, min(x0 + w, IMG_W - 1), min(y0 + h, IMG_H - 1)]
    boxes[0, 4] = [5, 5, 600, 7]
    labels = np.asarray([[1, 2, 3, 1, 2], [3, 1, 2, 3, 1]], np.int32)
    mask = np.asarray([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    return boxes, labels, mask


def _assign_both(cfg):
    levels = _anchor_levels(cfg)
    counts = [a.shape[0] for a in levels]
    anc = torch.cat(levels)
    boxes, labels, mask = planted_gts()
    fn = jatss.__dict__[{"ATSS": "atss_assign_single",
                         "ADAPT_ATSS": "atss_assign_single",
                         "SSC": "ssc_assign_single", "IoU": "iou_assign_single",
                         "TOPK": "topk_assign_single"}[cfg.positive_type]]
    janc = jnp.asarray(anc.numpy())
    wl, wm = jax.vmap(lambda b, l, m: fn(_jcfg(cfg), janc, counts, b, l, m))(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    gl, gm = atss.ASSIGN[cfg.positive_type](
        cfg, anc, counts, torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask))
    return (gl.numpy(), gm.numpy()), (np.asarray(wl), np.asarray(wm))


POSITIVE_TYPES = {
    "ATSS": {}, "ADAPT_ATSS": {"adapt_topk": (9, 13, 17)}, "SSC": {},
    "IoU": {}, "TOPK": {"topk": 9},
}


@pytest.mark.parametrize("ptype", sorted(POSITIVE_TYPES))
def test_assignment_matches(ptype):
    cfg = _cfg(positive_type=ptype, **POSITIVE_TYPES[ptype])
    (gl, gm), (wl, wm) = _assign_both(cfg)
    assert gl.dtype == np.int32
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gm, wm)
    assert (wl > 0).sum() >= 8, "the planted gts must give positives"
    if ptype == "IoU":
        assert (wl == -1).any(), "the IoU type ignores some anchors"


def _higher_index_first(values, k, descending=False):
    """Ties broken toward the higher index: the stable sort of the reversed
    row, its indices mapped back."""
    n = values.shape[-1]
    idx = torch.sort(values.flip(-1), dim=-1, descending=descending,
                     stable=True).indices[..., :k]
    return n - 1 - idx


@pytest.mark.parametrize("ptype", ["ATSS", "ADAPT_ATSS"])
def test_distance_ties_break_as_lax_top_k(ptype, monkeypatch):
    """The planted gts tie at the 9th candidate; the port picks as
    ``lax.top_k`` does, and the other pick changes the positives."""
    cfg = _cfg(positive_type=ptype, **POSITIVE_TYPES[ptype])
    (gl, _), (wl, _) = _assign_both(cfg)
    np.testing.assert_array_equal(gl, wl)
    monkeypatch.setattr(atss, "_first_k", _higher_index_first)
    (flipped, _), _ = _assign_both(cfg)
    changed = (flipped != wl).sum()
    assert changed > 0, "the planted ties do not reach the positives"


def test_adapt_topk_table_from_a_coco_set(tmp_path, monkeypatch):
    ann = {"images": [], "annotations": [],
           "categories": [{"id": i, "name": f"c{i}"} for i in (1, 2, 3)]}
    rng = np.random.RandomState(0)
    for i in range(6):
        ann["images"].append({"id": i, "file_name": f"{i}.png",
                              "height": 64, "width": 96})
        for j in range(rng.randint(1, 6)):
            cat = int(rng.choice([1, 1, 1, 1, 2, 2, 3]))
            ann["annotations"].append({
                "id": len(ann["annotations"]) + 1, "image_id": i,
                "category_id": cat, "bbox": [4, 4, 20, 20], "area": 400,
                "iscrowd": 0})
    root = tmp_path / "sim"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "ann.json").write_text(json.dumps(ann))
    for cat in (DatasetCatalog, JaxCatalog):
        monkeypatch.setitem(cat.DATASETS, "synthetic_cocostyle", {
            "img_dir": "sim/JPEGImages", "ann_file": "sim/ann.json"})
        monkeypatch.setattr(cat, "DATA_DIR", str(tmp_path))
    tables = []
    for default_cfg, mod in ((get_default_cfg, atss), (jax_default_cfg, jatss)):
        cfg = default_cfg()
        cfg.merge_from_file(ATSS_CFG)
        cfg.MODEL.ATSS.NUM_CLASSES = 4
        cfg.MODEL.ATSS.POSITIVE_TYPE = "ADAPT_ATSS"
        cfg.DATASETS.TRAIN_SOURCE = ("synthetic_cocostyle",)
        tables.append(mod.ATSSConfig.from_cfg(cfg).adapt_topk)
    assert tables[0] == tables[1] and tables[0] is not None
    assert tables[0][0] == 9 and max(tables[0]) > 9, tables[0]


# ---------------------------------------------------------------------- #
def _head_maps(cfg, seed, b=2, cls_mean=-2.0):
    rng = np.random.RandomState(seed)
    na, nc = cfg.num_anchors, cfg.num_classes - 1
    cls = [rng.randn(b, h, w, na * nc).astype(np.float32) + cls_mean
           for h, w in SHAPES]
    reg = [(rng.randn(b, h, w, na * 4) * 0.5).astype(np.float32)
           for h, w in SHAPES]
    if cfg.regression_type == "POINT":
        reg = [np.abs(r) + 3 for r in reg]
    ctr = [rng.randn(b, h, w, na).astype(np.float32) for h, w in SHAPES]
    return cls, reg, ctr


@pytest.mark.parametrize("ptype,regression", [("ATSS", "BOX"),
                                              ("ATSS", "POINT"),
                                              ("IoU", "BOX")])
def test_losses_and_gradients_match(ptype, regression):
    cfg = _cfg(positive_type=ptype, regression_type=regression)
    levels = _anchor_levels(cfg)
    cls, reg, ctr = _head_maps(cfg, 1)
    # an infinite prediction on rows that are not positive: decoded, it
    # would give inf - inf in the GIoU, a NaN that ``* valid`` keeps
    reg[0][:, 0, 0, :] = np.inf
    boxes, labels, mask = planted_gts()

    def jloss(c, r, t):
        out = jatss.atss_losses(
            _jcfg(cfg), [jnp.asarray(a.numpy()) for a in levels], c, r, t,
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
        return sum(out.values()), out

    jin = [[jnp.asarray(x) for x in m] for m in (cls, reg, ctr)]
    (_, want), wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(*jin)
    tin = [[torch.tensor(x, requires_grad=True) for x in m]
           for m in (cls, reg, ctr)]
    got = atss.atss_losses(cfg, levels, *tin, torch.from_numpy(boxes),
                           torch.from_numpy(labels), torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-5), k
    sum(got.values()).backward()
    for name, gs, ws in zip(("cls", "reg", "ctr"), tin, wgrads):
        for lvl, (g, w) in enumerate(zip(gs, ws)):
            assert torch.isfinite(g.grad).all(), (name, lvl)
            w = np.asarray(w)
            np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max() + 1e-12,
                                       err_msg=f"{name} level {lvl}")


def test_postprocess_valid_slots_match():
    cfg = _cfg()
    levels = _anchor_levels(cfg)
    cls, reg, ctr = _head_maps(cfg, 2, cls_mean=-5.0)
    sizes = np.asarray([[IMG_H, IMG_W], [100, 150]], np.int32)
    kw = dict(pre_nms_thresh=0.05, pre_nms_top_n=100, nms_thresh=0.6,
              fpn_post_nms_top_n=50, num_classes=4, nms_cap=128)
    want = jax.device_get(jatss.atss_postprocess(
        _jcfg(cfg), JaxPP(**kw), [jnp.asarray(a.numpy()) for a in levels],
        *[[jnp.asarray(x) for x in m] for m in (cls, reg, ctr)],
        jnp.asarray(sizes)))
    got = atss.atss_postprocess(
        cfg, PostProcessConfig(**kw), levels,
        *[[torch.from_numpy(x) for x in m] for m in (cls, reg, ctr)],
        torch.from_numpy(sizes))
    got = {k: v.numpy() for k, v in got.items()}
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert 20 < v.sum() < v.size, "the test needs valid and invalid slots"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-6)


# ---------------------------------------------------------------------- #
# the ATSS config as a whole
# ---------------------------------------------------------------------- #
ATSS_OPTS = ("MODEL.ADV.USE_DIS_CENTER_AWARE", True,
             "MODEL.ATSS.NUM_CONVS", 2) + tuple(
    x for p in ("P3", "P4", "P5", "P6", "P7")
    for x in (f"MODEL.ADV.DIS_{p}_NUM_CONVS", 1,
              f"MODEL.ADV.CA_DIS_{p}_NUM_CONVS", 1))


@pytest.fixture(scope="module")
def atss_reference():
    """scan_tpu's ATSS detector: its initial parameters (the head's
    predictors rescaled so the eval forward has detections), its eval
    forward and its one-step GA + CA results."""
    from test_torch_train_step import tiny_cfg

    cfg = tiny_cfg(jax_default_cfg(), ATSS_CFG, ATSS_OPTS)
    assert cfg.MODEL.ATSS_ON and not cfg.MODEL.MIDDLE_HEAD.CONDGRAPH_ON
    jdet = jax_build_detector(cfg)
    bs, bt = make_batches(4)
    bs["labels"] = np.minimum(bs["labels"], 1)  # one class: car
    params, _ = jdet.init_params(jax.random.PRNGKey(3),
                                 jnp.asarray(bs["images"]))
    params = jax.device_get(params)
    fc = params["fcos"]["params"]
    for name, gain, bias in (("cls_logits", 8.0, -1.0), ("bbox_pred", 8.0, 0.0)):
        c = fc[name]["Conv_0"]
        c["kernel"] = np.asarray(c["kernel"]) * gain
        c["bias"] = np.full_like(np.asarray(c["bias"]), bias)
    sizes = np.asarray([[64, 96], [56, 80]], np.int32)
    preds = jax.device_get(jax.jit(jdet.forward_inference)(
        params, None, jnp.asarray(bs["images"]), jnp.asarray(sizes)))
    opt = jax_make_optimizer(cfg, params)
    new_params, _, _, metrics = jax_make_step(jdet, opt)(
        params, opt.init(params), None,
        {k: jnp.asarray(v) for k, v in bs.items()},
        {"images": jnp.asarray(bt["images"])}, forward_target=False)
    return (params, (bs, bt), sizes, preds,
            jax.device_get((new_params, metrics)))


def test_atss_detector_forward_matches(atss_reference):
    params, (bs, _), sizes, want, _ = atss_reference
    det, _ = port_step(params, None, ATSS_CFG, ATSS_OPTS)
    got = {k: v.numpy() for k, v in det.forward_inference(
        torch.from_numpy(bs["images"]), torch.from_numpy(sizes)).items()}
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.sum() > 10, "the test needs detections to compare"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-4,
                               atol=1e-6)


def test_atss_da_step_matches(atss_reference):
    params, (bs, bt), _, _, (new_params, want_metrics) = atss_reference
    families = {k.split("_")[3] for k in want_metrics if k.startswith("loss_adv")}
    assert families == {"GA", "CA"}
    assert {"loss_cls_gs", "loss_reg_gs", "loss_centerness_gs"} <= set(
        want_metrics)
    det, step = port_step(params, None, ATSS_CFG, ATSS_OPTS)
    assert det.atss_on and det.need_score_maps
    before = {k: v.clone() for k, v in det.state_dict().items()}
    _, metrics = step(None, bs, bt)
    _check_metrics(metrics, want_metrics, 1e-5)
    _check_updates(params, new_params, before, det)
