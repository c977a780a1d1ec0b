"""The two-stage detector's modules against ``scan_tpu``'s, one by one, on the
CPU: the Faster R-CNN box coder, ROIAlign / ROIPool, the level mapper and
FPN pooler, the RPN, box, mask and keypoint heads (with ``scan_tpu``'s
parameters carried across by ``utils/jax_weights.py``), the proposal and
box postprocess, the second-stage matcher, the five losses, the keypoint
heatmap targets and decode, the RetinaNet head and losses, and the FPN's
``maxpool`` top block. Inputs are seeded numpy arrays given to both.

Tolerances: values within 1e-5 of the largest |value| (float32 sums in
another order); levels, labels, indices, heatmap targets and ``valid``
masks equal; proposal boxes within 1e-4 px, detection boxes within 1e-3
px and scores 1e-6; keypoints within 1e-4 px; losses within rtol 1e-5.
ROIAlign's gradient with respect to the features within 1e-5 of the
largest. The RPN, mask and keypoint heads in bf16 equal ``scan_tpu``'s
jitted bf16 heads but for fewer than 0.1% of values, each within one bf16
ulp of itself or of the largest (a float32 sum in another order rounds to
the other neighbour; measured 2-3 values of 131,712; the
keypoint head's 2x resize rounds after each axis, as ``jax.image.resize``
does, or 30% of its values would differ).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling import anchors as janchors
from scan_tpu.modeling import retinanet as jret
from scan_tpu.modeling import roi_heads as jroi
from scan_tpu.modeling import rpn_anchor as jrpn
from scan_tpu.modeling.backbone.fpn import FPN as JaxFPN
from scan_tpu.ops import roi_align as jalign
from scan_tpu.structures import boxes as jboxes
from scan_tpu_torch.modeling import anchors, retinanet, roi_heads, rpn_anchor
from scan_tpu_torch.modeling.backbone.fpn import FPN
from scan_tpu_torch.modeling.layers import Conv, ConvTranspose
from scan_tpu_torch.ops import roi_align
from scan_tpu_torch.structures import boxes as tboxes
from scan_tpu_torch.utils.jax_weights import convert_params

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]  # P2..P6 of 64x96
STRIDES = (4, 8, 16, 32, 64)


def T(a):
    return torch.from_numpy(np.array(a))


def jit(fn, *static):
    """``scan_tpu``'s function jitted over its array arguments, as its own
    tests run it (op by op its vmaps take tens of seconds on the CPU)."""
    return jax.jit(functools.partial(fn, *static))


def close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def bf16_equal(got, want):
    """A bf16 head's float32 output against the jitted flax head's: equal
    but on fewer than 0.1% of the values, each within one bf16 ulp of
    itself or of the largest value (a float32 sum in another order can
    round a value, or an intermediate the value interpolates, to the other
    bf16 neighbour)."""
    got, want = got.detach().numpy(), np.asarray(want)
    diff = got != want
    assert diff.mean() < 1e-3, diff.mean()
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())


def rand_boxes(rng, n, w=96, h=64, lo=2, hi=60):
    xy = rng.uniform(-4, [w, h], (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def load(module, jparams, transposed=()):
    sd = convert_params({"m": jax.device_get(jparams)},
                        ["m." + t for t in transposed])
    module.load_state_dict({k[2:]: v for k, v in sd.items()})
    return module


def set_dtype(module, dtype):
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.compute_dtype = dtype
    return module


def test_box_coder_matches_scan_tpu():
    rng = np.random.RandomState(0)
    gt, props = rand_boxes(rng, 300), rand_boxes(rng, 300)
    codes = (rng.randn(300, 4) * 3).astype(np.float32)  # dw, dh past the clip
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        close(tboxes.encode_boxes(T(gt), T(props), w),
              jboxes.encode_boxes(gt, props, w))
        close(tboxes.decode_boxes(T(codes), T(props), w),
              jboxes.decode_boxes(codes, props, w))
    np.testing.assert_array_equal(tboxes.box_area(T(gt)).numpy(),
                                  np.asarray(jboxes.box_area(gt)))


@pytest.mark.parametrize("s,sr,scale", [(7, 2, 0.25), (14, 2, 0.125),
                                        (5, 1, 0.5), (4, 3, 1.0)])
def test_roi_align_and_pool_match_scan_tpu(s, sr, scale):
    rng = np.random.RandomState(s + sr)
    feats = rng.randn(2, 20, 30, 6).astype(np.float32)
    rois = rand_boxes(rng, 40, w=30 / scale, h=20 / scale, lo=0.5, hi=50)
    bidx = rng.randint(0, 2, 40).astype(np.int32)
    align = jit(lambda f: jalign.roi_align(f, jnp.asarray(rois),
                                           jnp.asarray(bidx), s, scale, sr))
    want = align(jnp.asarray(feats))
    x = T(feats).requires_grad_(True)
    got = roi_align.roi_align(x, T(rois), T(bidx), s, scale, sr)
    close(got, want)
    # the gradient with respect to the features (embedding_bag's backward)
    cot = rng.randn(*got.shape).astype(np.float32)
    (got * T(cot)).sum().backward()
    jgrad = jax.jit(jax.grad(lambda f: jnp.sum(align(f) * cot)))(
        jnp.asarray(feats))
    close(x.grad, jgrad)
    close(roi_align.roi_pool(T(feats), T(rois), T(bidx), s, scale),
          jit(lambda f: jalign.roi_pool(f, jnp.asarray(rois),
                                        jnp.asarray(bidx), s, scale))(
              jnp.asarray(feats)))


def _pyramid(rng, c=8, b=2):
    return [rng.randn(b, h, w, c).astype(np.float32) for h, w in SHAPES]


def test_level_map_and_fpn_pooler_match_scan_tpu():
    rng = np.random.RandomState(1)
    feats = _pyramid(rng)
    rois = np.concatenate([rand_boxes(rng, 60, lo=1, hi=40),
                           rand_boxes(rng, 30, lo=40, hi=800)])
    bidx = rng.randint(0, 2, len(rois)).astype(np.int32)
    lv = roi_heads.level_map(T(rois), 4).numpy()
    np.testing.assert_array_equal(lv, np.asarray(jroi.level_map(rois, 4)))
    assert len(set(lv.tolist())) == 4, "every level must be used"
    for cfg in (jroi.RoIBoxConfig(), jroi.RoIMaskConfig(sampling_ratio=1),
                jroi.RoIBoxConfig(pooler_scales=(1.0 / 16,),
                                  pooler_resolution=14)):
        close(roi_heads.fpn_pooler(cfg, [T(f) for f in feats[:4]], T(rois),
                                   T(bidx)),
              jit(jroi.fpn_pooler, cfg)([jnp.asarray(f) for f in feats[:4]],
                                        jnp.asarray(rois), jnp.asarray(bidx)))


def test_fpn_maxpool_level_matches_scan_tpu():
    rng = np.random.RandomState(2)
    ins = [rng.randn(1, h, w, c).astype(np.float32)
           for (h, w), c in zip(SHAPES[:4], (8, 16, 32, 64))]
    jfpn = JaxFPN(in_features=(0, 1, 2, 3), out_channels=16,
                  top_block="maxpool")
    p = jfpn.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in ins])
    want = jfpn.apply(p, [jnp.asarray(x) for x in ins])
    fpn = load(FPN((8, 16, 32, 64), (0, 1, 2, 3), 16, top_block="maxpool"),
               p["params"])
    got = fpn([T(x) for x in ins])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g, w)
    assert got[4].shape[1:3] == (1, 2)  # P5 is 2x3
    assert torch.equal(got[4], got[3][:, ::2, ::2])


@pytest.fixture(scope="module")
def rpn_case():
    """scan_tpu's RPN head on a seeded pyramid, and its parameters."""
    rng = np.random.RandomState(3)
    feats = _pyramid(rng, c=16)
    head = jrpn.RPNHead(num_anchors=3)
    params = head.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats])
    params = jax.tree_util.tree_map(lambda a: a * 20.0, params)  # spread
    obj, reg = head.apply(params, [jnp.asarray(f) for f in feats])
    return feats, params, [np.asarray(o) for o in obj], [np.asarray(r)
                                                        for r in reg]


def test_rpn_head_matches_scan_tpu(rpn_case):
    feats, params, obj, reg = rpn_case
    head = load(rpn_anchor.RPNHead(3, input_channels=16), params["params"])
    got_obj, got_reg = head([T(f) for f in feats])
    for g, w in zip(got_obj + got_reg, obj + reg):
        close(g, w)
    # bf16: the 1x1 convs round, as the jitted flax head does
    jhead = jrpn.RPNHead(num_anchors=3, dtype=jnp.bfloat16)
    want = jax.jit(jhead.apply)(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = set_dtype(head, torch.bfloat16)([T(f) for f in feats])
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        bf16_equal(g, w)


def _rpn_cfgs():
    jc = jrpn.RPNConfig(pre_nms_top_n=300, post_nms_top_n=600, min_size=2.0)
    tc = rpn_anchor.RPNConfig(pre_nms_top_n=300, post_nms_top_n=600,
                              min_size=2.0)
    sizes = [(s,) for s in jc.anchor_sizes]
    ja = janchors.grid_anchors(SHAPES, STRIDES, sizes, jc.aspect_ratios)
    ta = anchors.grid_anchors(SHAPES, STRIDES, sizes, tc.aspect_ratios)
    return jc, tc, ja, ta


def test_rpn_proposals_match_scan_tpu(rpn_case):
    _, _, obj, reg = rpn_case
    jc, tc, ja, ta = _rpn_cfgs()
    sizes = np.asarray([[64, 96], [50, 70]], np.int32)
    want = jax.device_get(jit(jrpn.rpn_proposals, jc, ja)(
        [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg],
        jnp.asarray(sizes)))
    got = rpn_anchor.rpn_proposals(tc, ta, [T(o) for o in obj],
                                   [T(r) for r in reg], T(sizes))
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert 20 < v.sum() < v.size, "NMS must keep some and drop some"
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"][v],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v],
                               rtol=0, atol=1e-6)


def _gt(rng, b=2, g=5):
    boxes = np.stack([rand_boxes(rng, g, lo=10, hi=50) for _ in range(b)])
    labels = rng.randint(1, 5, (b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[1, 3:] = False
    return boxes, labels, mask


def test_rpn_and_retinanet_losses_match_scan_tpu(rpn_case):
    _, _, obj, reg = rpn_case
    jc, tc, ja, ta = _rpn_cfgs()
    boxes, labels, mask = _gt(np.random.RandomState(4))
    want = jit(jrpn.rpn_losses, jc, ja)(
        [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg],
        jnp.asarray(boxes), jnp.asarray(mask))
    got = rpn_anchor.rpn_losses(tc, ta, [T(o) for o in obj],
                                [T(r) for r in reg], T(boxes), T(mask))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    # the RetinaNet head and losses on the same pyramid
    rng = np.random.RandomState(5)
    feats = _pyramid(rng, c=16)
    rcfg = jret.RetinaNetConfig(num_classes=4, num_convs=2)
    jhead = jret.RetinaNetHead(rcfg, in_channels=32)
    params = jhead.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats])
    wl, wr = jhead.apply(params, [jnp.asarray(f) for f in feats])
    head = load(retinanet.RetinaNetHead(
        retinanet.RetinaNetConfig(num_classes=4, num_convs=2), 32, 16),
        params["params"])
    gl, gr = head([T(f) for f in feats])
    for g, w in zip(gl + gr, list(wl) + list(wr)):
        close(g, w)
    sizes = janchors.atss_level_sizes(rcfg.anchor_sizes, rcfg.octave,
                                      rcfg.scales_per_octave)
    strides = (8, 16, 32, 64, 128)
    ra = janchors.grid_anchors(SHAPES, strides, sizes, rcfg.aspect_ratios)
    want = jit(jret.retinanet_losses, rcfg, ra)(
        wl, wr, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    got = retinanet.retinanet_losses(
        retinanet.RetinaNetConfig(num_classes=4, num_convs=2),
        anchors.grid_anchors(SHAPES, strides, sizes, rcfg.aspect_ratios),
        [T(np.asarray(x)) for x in wl], [T(np.asarray(x)) for x in wr],
        T(boxes), T(labels), T(mask))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
        assert float(want[k]) > 0, k


def _box_case(rng, b=2, n=64, nc=5):
    props = np.stack([rand_boxes(rng, n, lo=4, hi=50) for _ in range(b)])
    valid = rng.rand(b, n) > 0.2
    logits = (rng.randn(b, n, nc) * 2).astype(np.float32)
    deltas = (rng.randn(b, n, nc * 4) * 0.3).astype(np.float32)
    return props, valid, logits, deltas


def test_box_head_and_postprocess_match_scan_tpu():
    rng = np.random.RandomState(6)
    cfg = jroi.RoIBoxConfig(num_classes=5, mlp_dim=32, score_thresh=0.2,
                            detections_per_img=200)
    tcfg = roi_heads.RoIBoxConfig(num_classes=5, mlp_dim=32, score_thresh=0.2,
                                  detections_per_img=200)
    pooled = rng.randn(6, 7, 7, 8).astype(np.float32)
    jhead = jroi.RoIBoxHead(cfg)
    params = jhead.init(jax.random.PRNGKey(3), jnp.asarray(pooled))
    params = jax.tree_util.tree_map(lambda a: a * 5.0, params)
    wc, wb = jhead.apply(params, jnp.asarray(pooled))
    head = load(roi_heads.RoIBoxHead(tcfg, 8), params["params"])
    gc, gb = head(T(pooled))
    close(gc, wc)
    close(gb, wb)
    props, valid, logits, deltas = _box_case(rng)
    sizes = np.asarray([[64, 96], [50, 70]], np.int32)
    want = jax.device_get(jit(jroi.roi_box_postprocess, cfg)(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(props),
        jnp.asarray(valid), jnp.asarray(sizes)))
    got = roi_heads.roi_box_postprocess(tcfg, T(logits), T(deltas), T(props),
                                        T(valid), T(sizes))
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert 10 < v.sum() < v.size
    np.testing.assert_array_equal(got["labels"].numpy()[v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"][v],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v],
                               rtol=0, atol=1e-6)


def test_matcher_and_box_losses_match_scan_tpu():
    rng = np.random.RandomState(7)
    boxes, labels, mask = _gt(rng)
    # proposals jittered around the gt boxes, and some anywhere
    near = boxes[:, rng.randint(0, 5, 40)] + rng.randn(2, 40, 4) * 4
    props = np.concatenate([near, np.stack([rand_boxes(rng, 24)
                                            for _ in range(2)])], 1)
    props = props.astype(np.float32)
    pv = rng.rand(2, 64) > 0.1
    # bg below fg, so that some proposals are ignored (-1)
    cfg = jroi.RoIBoxConfig(num_classes=5, bg_iou=0.3)
    tcfg = roi_heads.RoIBoxConfig(num_classes=5, bg_iou=0.3)
    wl, wr, wi = jit(jroi.match_proposals, cfg)(
        jnp.asarray(props), jnp.asarray(pv), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(mask))
    gl, gr, gi = roi_heads.match_proposals(tcfg, T(props), T(pv), T(boxes),
                                           T(labels), T(mask))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    wl = np.asarray(wl)
    assert (wl > 0).sum() > 10 and (wl == 0).sum() > 5 and (wl == -1).any()
    close(gr.numpy()[wl > 0], np.asarray(wr)[wl > 0])
    _, _, logits, deltas = _box_case(rng, n=64)
    args = (logits.reshape(-1, 5), deltas.reshape(-1, 20),
            props.reshape(-1, 4), pv.reshape(-1), wl.reshape(-1),
            np.asarray(wr).reshape(-1, 4))
    want = jroi.roi_box_losses(cfg, *[jnp.asarray(a) for a in args])
    got = roi_heads.roi_box_losses(tcfg, *[T(a) for a in args])
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


def test_mask_head_and_loss_match_scan_tpu():
    rng = np.random.RandomState(8)
    pooled = rng.randn(6, 14, 14, 16).astype(np.float32)
    cfg = jroi.RoIMaskConfig(num_classes=5, conv_layers=(32, 32))
    jhead = jroi.RoIMaskHead(cfg)
    params = jhead.init(jax.random.PRNGKey(4), jnp.asarray(pooled))
    want = jhead.apply(params, jnp.asarray(pooled))
    head = load(roi_heads.RoIMaskHead(
        roi_heads.RoIMaskConfig(num_classes=5, conv_layers=(32, 32)), 16),
        params["params"], ["conv5_mask"])
    got = head(T(pooled))
    assert got.shape == (6, 28, 28, 5)
    close(got, want)
    want16 = jax.jit(jroi.RoIMaskHead(cfg, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(pooled))
    got16 = set_dtype(head, torch.bfloat16)(T(pooled))
    bf16_equal(got16, want16)
    labels = np.asarray([1, 2, 0, 4, 3, -1])
    targets = (rng.rand(6, 28, 28) > 0.5).astype(np.float32)
    pos = labels > 0
    w = jroi.roi_mask_loss(want, jnp.asarray(labels), jnp.asarray(targets),
                           jnp.asarray(pos))
    g = roi_heads.roi_mask_loss(T(np.asarray(want)), T(labels), T(targets),
                                T(pos))
    assert float(g) == pytest.approx(float(w), rel=1e-5)


def test_keypoint_head_targets_decode_and_loss_match_scan_tpu():
    rng = np.random.RandomState(9)
    pooled = rng.randn(6, 14, 14, 16).astype(np.float32)
    cfg = jroi.RoIKeypointConfig(num_keypoints=7, conv_layers=(32, 32))
    jhead = jroi.RoIKeypointHead(cfg)
    params = jhead.init(jax.random.PRNGKey(5), jnp.asarray(pooled))
    want = jhead.apply(params, jnp.asarray(pooled))
    head = load(roi_heads.RoIKeypointHead(
        roi_heads.RoIKeypointConfig(num_keypoints=7, conv_layers=(32, 32)),
        16), params["params"], ["kps_score_lowres"])
    got = head(T(pooled))
    assert got.shape == (6, 56, 56, 7)
    close(got, want)
    want16 = jax.jit(jroi.RoIKeypointHead(cfg, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(pooled))
    got16 = set_dtype(head, torch.bfloat16)(T(pooled))
    bf16_equal(got16, want16)

    rois = rand_boxes(rng, 6, lo=10, hi=50)
    kp = np.concatenate([rng.uniform(-5, 100, (6, 7, 2)),
                         rng.randint(0, 3, (6, 7, 1))], -1).astype(np.float32)
    kp[0, 0, :2] = rois[0, 2:]  # on the max boundary: the last cell
    wt, wv = jroi.keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(rois), 56)
    gt_, gv = roi_heads.keypoints_to_heatmap(T(kp), T(rois), 56)
    np.testing.assert_array_equal(gt_.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < np.asarray(wv).sum() < wv.size
    hm = np.asarray(want)
    wxy, ws = jroi.roi_keypoint_decode(jnp.asarray(hm), jnp.asarray(rois))
    gxy, gs = roi_heads.roi_keypoint_decode(T(hm), T(rois))
    np.testing.assert_allclose(gxy.numpy(), np.asarray(wxy), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    w = jroi.roi_keypoint_loss(jnp.asarray(hm), wt, wv)
    g = roi_heads.roi_keypoint_loss(T(hm), gt_, gv)
    assert float(g) == pytest.approx(float(w), rel=1e-5)
