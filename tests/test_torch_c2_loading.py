"""Detectron ``.pkl`` weights in the port (``scan_tpu_torch/utils/c2_loading.py``,
``utils/model_zoo.py``, ``config/paths_catalog.py::ModelCatalog``,
``Checkpointer.load``) against ``scan_tpu``'s converter and catalog.

* A seeded pickle in Detectron's blob layout, with the names
  ``scan_tpu/utils/c2_loading.py:3-12`` lists (plus the classifier, ``lr``
  and ``_momentum`` blobs a real file carries), under ``blobs`` or bare and
  in pickle protocols 2 and 4, loads into the port's R-101 body (narrow
  widths) through ``Checkpointer.load``: every body entry equals what
  ``scan_tpu``'s ``convert_c2_resnet`` (called directly: nothing in
  ``scan_tpu`` reaches it, ROADMAP queue C) maps it to, the FPN and heads
  keep their values, and the iteration is 0 with no optimizer state read.
* ``catalog://`` names resolve to ``scan_tpu``'s URLs; a catalog file
  missing from the cache raises with its path; present, it loads.
* The restricted unpickler refuses a pickle that names any other global
  (and runs nothing), and leaves torch's own files to ``torch.load``.
* The size of ``scan_tpu``'s FrozenBatchNorm eps (which maskrcnn-benchmark
  does not add) on a Detectron pickle (ROADMAP queue C).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from scan_tpu.config.paths_catalog import ModelCatalog as JaxCatalog
from scan_tpu.utils.c2_loading import convert_c2_resnet as jax_convert
from scan_tpu.utils.c2_loading import load_c2_pickle as jax_load_pickle
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.config.paths_catalog import ModelCatalog
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_optimizer
from scan_tpu_torch.utils import c2_loading, model_zoo
from scan_tpu_torch.utils.checkpoint import Checkpointer
from scan_tpu_torch.utils.jax_weights import convert_params

from test_torch_resnet import narrow_cfg

CATALOG = "catalog://ImageNetPretrained/MSRA/R-101"


def r101(cfg=None):
    cfg = cfg or narrow_cfg(get_default_cfg(), depth=101)
    return build_detector(cfg, device="cpu")


def detectron_blobs(body, seed=0):
    """A seeded Detectron blob dict shaped like ``body`` (a port ResNet):
    ``conv1_w``, ``res_conv1_bn_{s,b}``, ``res{S}_{B}_branch2{a,b,c}_*`` and
    ``res{S}_0_branch1_*``, with the extra blobs a model-zoo file has; the
    convs at He scale and the folded BNs near identity, so a forward stays
    finite through 101 layers."""
    rng = np.random.RandomState(seed)
    sd = body.state_dict()

    def put(blobs, name, key):
        shape = sd[key].shape
        if name.endswith("_w"):  # He scale, as a trained body's convs
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("_s"):
            v = 1 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        blobs[name] = v.astype(np.float32)

    blobs = {}
    put(blobs, "conv1_w", "stem_conv1.weight")
    put(blobs, "res_conv1_bn_s", "stem_bn1.weight")
    put(blobs, "res_conv1_bn_b", "stem_bn1.bias")
    for s, n in enumerate(body.stage_blocks, 1):
        for b in range(n):
            prefix, blk = f"res{s + 1}_{b}_branch", f"layer{s}_block{b}"
            for br, (conv, bn) in zip("abc", (("conv1", "bn1"), ("conv2", "bn2"),
                                              ("conv3", "bn3"))):
                put(blobs, f"{prefix}2{br}_w", f"{blk}.{conv}.weight")
                put(blobs, f"{prefix}2{br}_bn_s", f"{blk}.{bn}.weight")
                put(blobs, f"{prefix}2{br}_bn_b", f"{blk}.{bn}.bias")
            if b == 0:
                put(blobs, f"{prefix}1_w", f"{blk}.downsample_conv.weight")
                put(blobs, f"{prefix}1_bn_s", f"{blk}.downsample_bn.weight")
                put(blobs, f"{prefix}1_bn_b", f"{blk}.downsample_bn.bias")
    blobs["fc1000_w"] = rng.randn(10, 4).astype(np.float32)
    blobs["fc1000_b"] = rng.randn(10).astype(np.float32)
    return blobs


def write_pickle(path, blobs, layout="blobs", protocol=2):
    data = dict(blobs)
    if layout == "momentum":
        data.update({k + "_momentum": np.zeros_like(v) for k, v in
                     list(blobs.items())[:6]})
    if layout in ("blobs", "momentum"):
        data = {"blobs": data, "lr": np.float32(0.1), "model_iter": 90000}
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=protocol)
    return str(path)


@pytest.mark.parametrize("layout,protocol", [("blobs", 2), ("bare", 4),
                                             ("momentum", 2)])
def test_pickle_loads_as_scan_tpu_maps_it(tmp_path, layout, protocol):
    det = r101()
    blobs = detectron_blobs(det.backbone.body)
    path = write_pickle(tmp_path / "R-101.pkl", blobs, layout, protocol)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    opt = make_optimizer(det.cfg, det)
    ck = Checkpointer(str(tmp_path / "out"), det, opt)
    assert ck.load(path) == 0
    assert opt.state_dict()["state"] == {}

    jblobs = jax_load_pickle(path)
    assert not any(k.endswith("_momentum") for k in jblobs)
    want = convert_params({"backbone": {"params": {"body": jax_convert(jblobs)}}})
    after = det.state_dict()
    body = {k for k in after if k.startswith("backbone.body.")}
    assert set(want) == body, sorted(set(want) ^ body)[:5]
    for k, v in want.items():
        assert torch.equal(after[k], v), k
    assert torch.equal(after["backbone.body.layer3_block22.conv3.weight"],
                       torch.from_numpy(blobs["res4_22_branch2c_w"]))
    for k in after:
        if k not in body:
            assert torch.equal(after[k], before[k]), k


def test_catalog_names_resolve_as_scan_tpus():
    names = ["ImageNetPretrained/" + k for k in JaxCatalog.C2_IMAGENET_MODELS]
    names.append("Caffe2Detectron/COCO/35857345/e2e_faster_rcnn_R-50-FPN_1x")
    for name in names:
        assert ModelCatalog.get(name) == JaxCatalog.get(name), name
    with pytest.raises(RuntimeError, match="not present"):
        ModelCatalog.get("NoSuch/model")


def test_catalog_weight_from_the_cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("SCAN_TPU_CACHE_DIR", str(cache))
    det = r101()
    ck = Checkpointer(str(tmp_path / "out"), det)
    want = str(cache / "R-101.pkl")
    with pytest.raises(ValueError, match="fetches nothing") as e:
        ck.load(CATALOG)
    assert want in str(e.value) and CATALOG in str(e.value)
    assert not cache.exists()
    cache.mkdir()
    blobs = detectron_blobs(det.backbone.body, seed=5)
    write_pickle(want, blobs)
    assert model_zoo.resolve_weight_uri(CATALOG) == want
    assert ck.load(CATALOG) == 0
    assert torch.equal(det.state_dict()["backbone.body.stem_conv1.weight"],
                       torch.from_numpy(blobs["conv1_w"]))


class _Runs:
    def __reduce__(self):
        return (os.system, ("echo pwned > /dev/null",))


def test_restricted_unpickler_refuses_other_globals(tmp_path):
    det = r101()
    blobs = detectron_blobs(det.backbone.body)
    bad = dict(blobs, conv1_w=_Runs())
    path = write_pickle(tmp_path / "bad.pkl", bad)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        c2_loading.load_c2_pickle(path)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        Checkpointer(str(tmp_path / "out"), det).load(path)
    odd = tmp_path / "odd.pkl"
    with open(odd, "wb") as f:
        pickle.dump({"blobs": {"conv1_w": blobs["conv1_w"]},
                     "meta": __import__("collections").OrderedDict()}, f)
    with pytest.raises(pickle.UnpicklingError, match="OrderedDict"):
        c2_loading.load_c2_pickle(str(odd))
    # torch's own files, zip or legacy, are not taken for Detectron pickles
    for legacy in (False, True):
        p = tmp_path / f"t{int(legacy)}.pth"
        torch.save({"model": {}}, p, _use_new_zipfile_serialization=not legacy)
        assert c2_loading.load_c2_pickle(str(p)) is None


def test_pickle_for_a_vgg_body_raises(tmp_path):
    det = r101()
    path = write_pickle(tmp_path / "R-101.pkl", detectron_blobs(det.backbone.body))
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "epm", "da_ga_ca_cityscapes_VGG_16_FPN_4x.yaml"))
    cfg.TPU.VGG_WIDTH_DIV = 8
    vgg = build_detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="Detectron ResNet pickle"):
        Checkpointer(str(tmp_path / "out"), vgg).load(path)
    r50 = build_detector(narrow_cfg(get_default_cfg(), depth=50), device="cpu")
    with pytest.raises(KeyError, match="layer3_block6"):
        Checkpointer(str(tmp_path / "out50"), r50).load(path)


def test_frozen_bn_eps_on_a_detectron_pickle(tmp_path):
    """The port adds ``scan_tpu``'s eps 1e-5 under the FrozenBatchNorm's
    rsqrt; maskrcnn-benchmark's ``FrozenBatchNorm2d`` adds none. On a
    Detectron pickle (variance 1 everywhere) each BN's scale is then
    1 - 5e-6 of the reference's; over R-101 the features move by less than
    1e-3 of each level's largest value (measured here, at narrow widths:
    3.4e-5 at C2 to 2.3e-4 at C5), and by more than float32 rounding."""
    from scan_tpu_torch.modeling.layers import FrozenBatchNorm

    det = r101()
    Checkpointer(str(tmp_path / "out"), det).load(write_pickle(
        tmp_path / "R-101.pkl", detectron_blobs(det.backbone.body, seed=4)))
    bns = [m for m in det.modules() if isinstance(m, FrozenBatchNorm)]
    assert all(bool((m.running_var == 1).all()) for m in bns)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 128, 192, 3).astype(np.float32))
    with torch.no_grad():
        ours = det.backbone.body(x)
        for m in bns:
            m.eps = 0.0
        reference = det.backbone.body(x)
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(ours, reference)]
    print("FrozenBN eps 1e-5 vs 0, relative change of C2..C5:", rel)
    assert all(1e-6 < r < 1e-3 for r in rel), rel
