"""Reference ``.pth`` weights in the port (``utils/torch_weights.py``,
``utils/model_zoo.py``, ``Checkpointer.load``), on the CPU, against
``scan_tpu``'s ``torch_weights`` and ``Checkpointer``.

The files are built here in the reference's key layout at the test's
widths (C2F at VGG width / 8, 1-conv FCOS towers), with seeded tensors: an
ImageNet caffe VGG16 (``features.{idx}.*`` and mmcv's classifier), bare or
under ``state_dict`` with a ``module.`` prefix, and a full SCAN checkpoint
(``model_backbone``, ``model_fcos``, ``middle_head`` with the prototype,
``model_dis_P*_CON`` and a GA entry ``model_dis_P3`` that neither package
converts), in the RNN condgraph (``cond_nx1`` as a (256, 512, 3, 1) conv,
the dead ``cond_2``) and the non-RNN one (``cond_nx1`` + ``cond_nx1_norm``,
``cond_2``).

* A full checkpoint loaded by both packages: every tensor the port loads
  equals ``scan_tpu``'s loaded parameter, exactly, and the two detectors'
  ``forward_inference`` agree within ``tests/test_torch_detector.py``'s
  tolerance (labels and valid slots equal, boxes within 1e-3 px, scores
  within rtol 1e-4). Iteration 0; the prototype is the file's, its counter
  kept.
* An ImageNet file, bare or wrapped: only the VGG body changes, to the
  file's tensors, equal to ``scan_tpu``'s ``convert_vgg16_caffe``.
* ``load_dis`` False keeps the discriminators; True loads the CKA heads.
* A shape mismatch and a key the port lacks raise.
* A port checkpoint still loads with its optimizer state; the
  ``last_checkpoint`` pointer comes before the file given.
* An ``http(s)`` URL resolves through ``SCAN_TPU_CACHE_DIR`` (and the other
  cache variables, in ``scan_tpu``'s order) to a cached file; a missing one
  raises naming the path to put it at, and nothing touches the network;
  a ``catalog://`` name resolves to the same cache (the missing file's
  path named; present, the Detectron pickle loads into a ResNet body and a
  VGG detector refuses it).
* A reference-layout backbone for a ResNet body raises, naming the missing
  converter.
"""

import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.utils import torch_weights as jtw
from scan_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils import model_zoo
from scan_tpu_torch.utils import torch_weights
from scan_tpu_torch.utils.checkpoint import Checkpointer
from scan_tpu_torch.utils.jax_weights import convert_params

from test_torch_c2_loading import detectron_blobs, write_pickle
from test_torch_resnet import narrow_cfg

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
URL = ("https://s3.ap-northeast-2.amazonaws.com/open-mmlab/pretrain/"
       "third_party/vgg16_caffe-292e1171.pth")
H, W = 64, 96
WIDTH_DIV = 8
VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_CH = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
LAYERS = ("P3", "P4", "P5", "P6", "P7")


def small_cfg(default=get_default_cfg, rnn=True, *opts):
    cfg = default()
    cfg.merge_from_file(C2F)
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "TPU.VGG_WIDTH_DIV", WIDTH_DIV,
        "TPU.MAX_NODES", 16, "TPU.MAX_TARGET_POINTS", 16,
        "MODEL.FCOS.NUM_CONVS_CLS", 1, "MODEL.FCOS.NUM_CONVS_REG", 1,
        "MODEL.MIDDLE_HEAD.USE_RNN", "RNN" if rnn else None, *opts])
    return cfg


def imagenet_vgg(seed=0, width_div=WIDTH_DIV):
    """mmcv's caffe VGG16 layout: the 13 convs at ``features.{idx}`` and
    the classifier, which nothing converts."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for idx, c in zip(VGG_IDX, VGG_CH):
        ch = max(8, c // width_div)
        sd[f"features.{idx}.weight"] = (torch.randn(ch, cin, 3, 3, generator=g)
                                        * (2.0 / (9 * ch)) ** 0.5)
        sd[f"features.{idx}.bias"] = torch.randn(ch, generator=g) * 0.1
        cin = ch
    sd["classifier.0.weight"] = torch.randn(16, 8, generator=g)
    sd["classifier.0.bias"] = torch.randn(16, generator=g)
    return sd


def reference_ckpt(cfg, seed=1, rnn=True):
    """A full reference SCAN checkpoint at ``cfg``'s widths (the layout of
    ``tests/test_checkpoint_roundtrip.py::_make_reference_ckpt``)."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, std=0.01):
        return torch.randn(*shape, generator=g) * std

    def tower(prefix, n, ch, gn=True):
        out = {}
        step = 3 if gn else 2
        for i in range(n):
            out[f"{prefix}.{i * step}.weight"] = t(ch, ch, 3, 3)
            out[f"{prefix}.{i * step}.bias"] = t(ch)
            if gn:
                out[f"{prefix}.{i * step + 1}.weight"] = 1 + t(ch, std=0.1)
                out[f"{prefix}.{i * step + 1}.bias"] = t(ch, std=0.1)
        return out

    backbone = {f"body.{k}": v for k, v in imagenet_vgg(seed).items()
                if k.startswith("features.")}
    stage_out = [max(8, c // WIDTH_DIV) for c in (128, 256, 512, 512)]
    for ref_i, cin in zip((3, 4, 5), stage_out[1:]):
        backbone[f"fpn.fpn_inner{ref_i}.weight"] = t(256, cin, 1, 1, std=0.1)
        backbone[f"fpn.fpn_inner{ref_i}.bias"] = t(256)
        backbone[f"fpn.fpn_layer{ref_i}.weight"] = t(256, 256, 3, 3, std=0.03)
        backbone[f"fpn.fpn_layer{ref_i}.bias"] = t(256)
    for p in ("p6", "p7"):
        backbone[f"fpn.top_blocks.{p}.weight"] = t(256, 256, 3, 3, std=0.03)
        backbone[f"fpn.top_blocks.{p}.bias"] = t(256)

    nc = cfg.MODEL.FCOS.NUM_CLASSES
    fcos = {}
    for name, n in (("cls_tower", cfg.MODEL.FCOS.NUM_CONVS_CLS),
                    ("bbox_tower", cfg.MODEL.FCOS.NUM_CONVS_REG)):
        fcos.update({f"head.{k}": v for k, v in tower(name, n, 256).items()})
    # predictors spread as in test_torch_detector.py: distinct scores and
    # ~40 px boxes, so the detections have something to check
    fcos["head.cls_logits.weight"] = t(nc - 1, 256, 3, 3, std=0.05)
    fcos["head.cls_logits.bias"] = torch.zeros(nc - 1)
    fcos["head.bbox_pred.weight"] = t(4, 256, 3, 3, std=0.05)
    fcos["head.bbox_pred.bias"] = torch.full((4,), 3.0)
    fcos["head.centerness.weight"] = t(1, 256, 3, 3)
    fcos["head.centerness.bias"] = t(1)
    for l in range(5):
        fcos[f"head.scales.{l}.scale"] = 1 + t(1, std=0.1)

    mh_cfg = cfg.MODEL.MIDDLE_HEAD
    used = nc  # with the background prototype
    it = mh_cfg.PROTO_ITER
    mh = tower("head_in.middle_tower", mh_cfg.NUM_CONVS_IN, 256)
    mh["head_out.middle_tower.0.weight"] = t(256, 256 + used, 3, 3)
    mh["head_out.middle_tower.0.bias"] = t(256)
    mh["prototype"] = t(used, 256, it, std=1.0)
    mh["proto_cls_hidden.weight"] = t(512, 256)
    mh["proto_cls_hidden.bias"] = t(512)
    mh["proto_cls.weight"] = t(used, 512)
    mh["proto_cls.bias"] = t(used)
    for lin in ("linear_q", "linear_k", "linear_v", "linear_final"):
        mh[f"multihead_attn.{lin}.weight"] = t(256, 256, std=0.06)
        mh[f"multihead_attn.{lin}.bias"] = t(256)
    mh["multihead_attn.layer_norm.weight"] = 1 + t(256, std=0.1)
    mh["multihead_attn.layer_norm.bias"] = t(256, std=0.1)
    hidden = mh_cfg.COND_HIDDEN_CHANNEL
    if rnn:
        for layer in range(2):
            in_sz = 256 if layer == 0 else 512
            mh[f"cond_rnn.weight_ih_l{layer}"] = t(512, in_sz, std=0.05)
            mh[f"cond_rnn.weight_hh_l{layer}"] = t(512, 512, std=0.05)
            mh[f"cond_rnn.bias_ih_l{layer}"] = t(512)
            mh[f"cond_rnn.bias_hh_l{layer}"] = t(512)
        mh["cond_nx1.weight"] = t(256, 512, it, 1, std=0.03)
        mh["cond_nx1.bias"] = t(256)
        mh["cond_2.weight"] = t(256, 512)  # dead in the RNN path
        mh["cond_2.bias"] = t(256)
    else:
        mh["cond_nx1.weight"] = t(hidden, 256, it, 1, std=1.0)
        mh["cond_nx1.bias"] = t(hidden)
        mh["cond_nx1_norm.weight"] = 1 + t(hidden, std=0.1)
        mh["cond_nx1_norm.bias"] = t(hidden, std=0.1)
        mh["cond_2.weight"] = t(256, hidden, std=0.05)
        mh["cond_2.bias"] = t(256)

    ckpt = {"model_backbone": backbone, "model_fcos": fcos,
            "middle_head": mh, "iteration": 20000}
    extra = 1 if cfg.MODEL.ADV.CON_FUSUIN_CFG == "concat" else 0
    for layer in LAYERS:
        dis = tower("dis_tower", 4, 256)
        for c in range(nc - 1):
            dis[f"classifier_cls_{c}.0.weight"] = t(128, 256 + extra, 3, 3)
            dis[f"classifier_cls_{c}.0.bias"] = t(128)
            dis[f"classifier_cls_{c}.2.weight"] = t(1, 128, 3, 3)
            dis[f"classifier_cls_{c}.2.bias"] = t(1)
        ckpt[f"model_dis_{layer}_CON"] = dis
    # a GA discriminator entry: scan_tpu converts none, nor does the port
    ckpt["model_dis_P3"] = tower("dis_tower", 4, 256)
    return ckpt


def images():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8),
            np.asarray([[H, W], [56, 80]], np.int32))


@pytest.fixture(scope="module", params=[True, False], ids=["rnn", "no_rnn"])
def loaded(request, tmp_path_factory):
    """One full checkpoint loaded by both packages."""
    rnn = request.param
    root = tmp_path_factory.mktemp("ref_rnn" if rnn else "ref_cond_nx1")
    cfg = small_cfg(rnn=rnn)
    path = str(root / "scan_c2f.pth")
    ref = reference_ckpt(cfg, rnn=rnn)
    torch.save(ref, path)

    jcfg = small_cfg(jax_default_cfg, rnn)
    jdet = jax_build_detector(jcfg)
    params, proto = jdet.init_params(jax.random.PRNGKey(0),
                                     jnp.zeros((1, H, W, 3), jnp.float32))
    params, proto, _, it = JaxCheckpointer(str(root / "jax"), jdet).load(
        path, params, proto, None)
    assert it == 0
    det = build_detector(cfg, device="cpu", seed=5)
    assert Checkpointer(str(root / "port"), det).load(path) == 0
    return dict(rnn=rnn, ref=ref, path=path, cfg=cfg, jdet=jdet,
                params=jax.device_get(params), proto=jax.device_get(proto),
                det=det, root=root)


def test_full_checkpoint_equals_scan_tpus_and_forward_agrees(loaded):
    det, ref = loaded["det"], loaded["ref"]
    converted, prototype = torch_weights.convert_reference(ref, det)
    own = det.state_dict()
    want = convert_params(loaded["params"])
    assert len(converted) > 100
    for k, v in converted.items():
        assert torch.equal(own[k], v), k
        assert torch.equal(own[k], want[k]), k  # scan_tpu's, exactly
    assert not any(k.startswith("dis_P3.") for k in converted)
    assert ("middle_head.cond_2.weight" in converted) != loaded["rnn"]
    # the prototype is the file's; the counter kept
    np.testing.assert_array_equal(det.prototype.numpy(),
                                  ref["middle_head"]["prototype"].numpy())
    np.testing.assert_array_equal(np.asarray(loaded["proto"].prototype),
                                  det.prototype.numpy())
    assert int(det.proto_counter) == int(loaded["proto"].counter) == -1
    # spot checks of the special cases
    assert torch.equal(own["backbone.body.conv12.weight"],
                       ref["model_backbone"]["body.features.28.weight"])
    assert torch.equal(own["backbone.fpn.fpn_inner1.weight"],
                       ref["model_backbone"]["fpn.fpn_inner3.weight"])
    assert torch.equal(own["middle_head.head_in.gn1.weight"],
                       ref["middle_head"]["head_in.middle_tower.4.weight"])
    assert torch.equal(own["dis_P4_CON.classifier_cls_2_1.weight"],
                       ref["model_dis_P4_CON"]["classifier_cls_2.2.weight"])
    w = ref["middle_head"]["cond_nx1.weight"]
    assert torch.equal(own["middle_head.cond_nx1.weight"],
                       w[..., 0].reshape(w.shape[0], -1))

    im, sizes = images()
    jdet = loaded["jdet"]
    jdet.test_mode = det.test_mode = "common"
    want = jax.device_get(jax.jit(jdet.forward_inference)(
        loaded["params"], loaded["proto"], jnp.asarray(im),
        jnp.asarray(sizes)))
    got = {k: v.numpy() for k, v in det.forward_inference(
        torch.from_numpy(im), torch.from_numpy(sizes)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 10, "the test needs detections"
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "state_dict"])
def test_imagenet_file_loads_the_vgg_body_only(tmp_path, wrapped):
    sd = imagenet_vgg(seed=3)
    state = {"state_dict": {f"module.{k}": v for k, v in sd.items()},
             "meta": {"epoch": 90}} if wrapped else sd
    path = str(tmp_path / "vgg16_caffe.pth")
    torch.save(state, path)
    det = build_detector(small_cfg(), device="cpu", seed=2)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    assert Checkpointer(str(tmp_path / "out"), det).load(path) == 0
    after = det.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed == {f"backbone.body.conv{i}.{t}" for i in range(13)
                       for t in ("weight", "bias")}
    body = jtw.convert_vgg16_caffe(sd)  # scan_tpu's HWIO conversion
    for i, idx in enumerate(VGG_IDX):
        w = after[f"backbone.body.conv{i}.weight"]
        assert torch.equal(w, sd[f"features.{idx}.weight"])
        np.testing.assert_array_equal(
            w.numpy(), body[f"conv{i}"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
        assert torch.equal(after[f"backbone.body.conv{i}.bias"],
                           sd[f"features.{idx}.bias"])


@pytest.mark.parametrize("load_dis", [False, True])
def test_load_dis(loaded, load_dis):
    cfg, ref = loaded["cfg"], loaded["ref"]
    det = build_detector(cfg, device="cpu", seed=7)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    Checkpointer(str(loaded["root"] / f"dis{load_dis}"), det).load(
        loaded["path"], load_dis=load_dis)
    after = det.state_dict()
    dis = [k for k in before if k.startswith("dis_")]
    assert dis
    for k in dis:
        assert torch.equal(after[k], before[k]) != load_dis, k
    if load_dis:
        assert torch.equal(after["dis_P7_CON.dis_tower.conv3.weight"],
                           ref["model_dis_P7_CON"]["dis_tower.9.weight"])


def test_mismatches_raise(tmp_path):
    cfg = small_cfg()
    det = build_detector(cfg, device="cpu")
    wide = str(tmp_path / "wide.pth")  # the full-width VGG into width / 8
    torch.save(imagenet_vgg(width_div=1), wide)
    with pytest.raises(ValueError, match="shape mismatch"):
        Checkpointer(str(tmp_path / "a"), det).load(wide)
    short = build_detector(small_cfg(get_default_cfg, True,
                                     "TPU.VGG_STAGE_BLOCKS", (2, 2, 3, 3, 2)),
                           device="cpu")
    path = str(tmp_path / "vgg.pth")
    torch.save(imagenet_vgg(), path)
    with pytest.raises(KeyError, match="conv12"):
        Checkpointer(str(tmp_path / "b"), short).load(path)
    torch.save({"weights": torch.zeros(3)}, str(tmp_path / "other.pth"))
    with pytest.raises(ValueError, match="no 'model'"):
        Checkpointer(str(tmp_path / "c"), det).load(str(tmp_path / "other.pth"))


def test_port_checkpoint_and_pointer_still_first(loaded, tmp_path):
    cfg = loaded["cfg"]
    det = build_detector(cfg, device="cpu", seed=4, train=True)
    opt = make_optimizer(cfg, det)
    sched = make_lr_scheduler(cfg, opt)
    for p in det.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    ck = Checkpointer(str(tmp_path / "run"), det, opt, sched)
    ck.save("model_0000007", iteration=7)

    fresh = build_detector(cfg, device="cpu", seed=9, train=True)
    opt2 = make_optimizer(cfg, fresh)
    sched2 = make_lr_scheduler(cfg, opt2)
    # the pointer in the run's directory wins over the reference file
    assert Checkpointer(str(tmp_path / "run"), fresh, opt2, sched2).load(
        loaded["path"]) == 7
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    assert sched2.last_epoch == 1
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the weight loader touched the network")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)


def test_url_resolves_to_the_cache_only(tmp_path, monkeypatch, no_network):
    cache = tmp_path / "cache"
    monkeypatch.setenv("SCAN_TPU_CACHE_DIR", str(cache))
    det = build_detector(small_cfg(), device="cpu")
    ck = Checkpointer(str(tmp_path / "out"), det)
    want = str(cache / "vgg16_caffe-292e1171.pth")
    with pytest.raises(ValueError, match="fetches nothing") as e:
        ck.load(URL)
    assert want in str(e.value) and not cache.exists()
    cache.mkdir()
    sd = imagenet_vgg(seed=11)
    torch.save(sd, want)
    assert model_zoo.resolve_weight_uri(URL) == want
    assert ck.load(URL) == 0
    assert torch.equal(det.state_dict()["backbone.body.conv5.weight"],
                       sd["features.12.weight"])
    # a catalog:// name resolves through ModelCatalog to the same cache:
    # missing, the error names the path; present, the pickle loads (into a
    # ResNet body: a VGG detector refuses it)
    catalog = "catalog://ImageNetPretrained/MSRA/R-101"
    pkl = str(cache / "R-101.pkl")
    with pytest.raises(ValueError, match="fetches nothing") as e:
        ck.load(catalog)
    assert pkl in str(e.value)
    r101 = build_detector(narrow_cfg(get_default_cfg(), depth=101),
                          device="cpu")
    blobs = detectron_blobs(r101.backbone.body, seed=3)
    write_pickle(pkl, blobs)
    with pytest.raises(ValueError, match="Detectron ResNet pickle"):
        ck.load(catalog)
    assert Checkpointer(str(tmp_path / "r101"), r101).load(catalog) == 0
    assert torch.equal(r101.state_dict()["backbone.body.stem_conv1.weight"],
                       torch.from_numpy(blobs["conv1_w"]))
    assert model_zoo.url_to_filename(
        "https://dl.fbaipublicfiles.com/detectron/36/model_final.pkl") == \
        "_detectron_36_model_final.pkl"


def test_reference_file_for_a_resnet_body_raises(tmp_path):
    """A reference-layout file's backbone (an ImageNet VGG16 or a SCAN
    checkpoint's ``model_backbone``) given to a detector whose body is not
    VGG raises, naming the missing converter, rather than being mapped by
    the VGG converter."""
    det = build_detector(narrow_cfg(get_default_cfg(), depth=50),
                         device="cpu")
    ck = Checkpointer(str(tmp_path / "out"), det)
    vgg = str(tmp_path / "vgg.pth")
    torch.save(imagenet_vgg(seed=2), vgg)
    full = str(tmp_path / "full.pth")
    torch.save({"model_backbone": {f"body.{k}": v for k, v in
                                   imagenet_vgg(seed=3).items()}}, full)
    for f in (vgg, full):
        with pytest.raises(NotImplementedError, match="ResNet converter"):
            ck.load(f)


def test_cache_dir_order(monkeypatch, tmp_path):
    for var in ("SCAN_TPU_CACHE_DIR", "TORCH_MODEL_ZOO", "TORCH_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert model_zoo.default_cache_dir() == str(tmp_path / ".torch" / "models")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    assert model_zoo.default_cache_dir() == str(tmp_path / "th" / "models")
    monkeypatch.setenv("TORCH_MODEL_ZOO", str(tmp_path / "zoo"))
    assert model_zoo.default_cache_dir() == str(tmp_path / "zoo")
    monkeypatch.setenv("SCAN_TPU_CACHE_DIR", str(tmp_path / "scan"))
    assert model_zoo.default_cache_dir() == str(tmp_path / "scan")
