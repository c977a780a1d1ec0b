"""The port's package surface against ``scan_tpu``'s, on the CPU.

* ``scan_tpu_torch.{ops,engine,structures}.__all__`` equal ``scan_tpu``'s,
  every name resolves, and importing them builds no kernel and (for
  ``engine``) pulls in neither the trainer nor the detector.
* ``structures.boxes.Boxes``, ``ops.locations.level_sizes_from_image`` and
  ``structures.image_batch.batch_images`` equal ``scan_tpu``'s on seeded
  numpy inputs, exactly (the arithmetic is the same, in float32).
* ``utils/vis_tools.py::VisTools`` writes its files from tensors, and
  ``tools/webcam.py`` imports without ``cv2``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scan_tpu.ops.locations import level_sizes_from_image as jax_level_sizes
from scan_tpu.structures.boxes import Boxes as JaxBoxes
from scan_tpu.structures.image_batch import batch_images as jax_batch_images
from scan_tpu.structures.image_batch import round_up as jax_round_up
from scan_tpu_torch.ops.locations import level_sizes_from_image
from scan_tpu_torch.structures.boxes import Boxes
from scan_tpu_torch.structures.image_batch import batch_images, round_up

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, sys
import scan_tpu_torch.ops, scan_tpu_torch.engine, scan_tpu_torch.structures
from scan_tpu_torch.ops.cuda import build
loaded = sorted(m for m in sys.modules if m.endswith((".trainer", ".detector",
                                                      ".train_step")))
print(json.dumps({"loaded": loaded, "built": sorted(build._libs)}))
"""


@pytest.mark.parametrize("name", ["ops", "engine", "structures"])
def test_all_equals_scan_tpu(name):
    import importlib

    ours = importlib.import_module(f"scan_tpu_torch.{name}")
    theirs = importlib.import_module(f"scan_tpu.{name}")
    assert ours.__all__ == theirs.__all__
    for n in ours.__all__:
        assert callable(getattr(ours, n)), n


def test_engine_aliases_and_lazy_imports():
    import json

    import scan_tpu_torch.engine as engine

    assert engine.validation is engine.inference is engine.validataion
    assert callable(engine.inference)
    from scan_tpu_torch.engine.trainer import do_train_da

    assert engine.do_train_da is do_train_da
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"loaded": [], "built": []}


def _jax_boxes(b):
    return JaxBoxes(jnp.asarray(b.boxes.numpy()), jnp.asarray(b.mask.numpy()),
                    jnp.asarray(b.labels.numpy()), None, b.size)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boxes_equal_scan_tpu():
    rng = np.random.RandomState(0)
    xy = rng.uniform(-20, 120, (7, 2))
    wh = rng.uniform(0, 60, (7, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    labels = rng.randint(1, 9, 7).astype(np.int32)
    for capacity in (10, 5):
        ours = Boxes.from_numpy(boxes, labels, capacity, (96, 64))
        theirs = JaxBoxes.from_numpy(boxes, labels, capacity, (96, 64))
        for f in ("boxes", "mask", "labels"):
            _equal(getattr(ours, f), getattr(theirs, f))
        assert ours.size == theirs.size and ours.scores is None
        assert ours.capacity == theirs.capacity == capacity
        _equal(ours.num_valid(), theirs.num_valid())
        _equal(ours.area(), theirs.area())
        for got, want in ((ours.clip_to_image(), theirs.clip_to_image()),
                          (ours.remove_small(12.0), theirs.remove_small(12.0))):
            _equal(got.boxes, want.boxes)
            _equal(got.mask, want.mask)
    batched = Boxes(torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
                    torch.from_numpy(rng.rand(2, 7) > 0.3),
                    torch.from_numpy(np.stack([labels, labels])), None,
                    (96, 64))
    want = _jax_boxes(batched)
    _equal(batched.num_valid(), want.num_valid())
    _equal(batched.remove_small(20.0).mask, want.remove_small(20.0).mask)
    _equal(batched.clip_to_image().boxes, want.clip_to_image().boxes)


@pytest.mark.parametrize("hw", [(800, 1344), (96, 128), (672, 1344),
                                (224, 320), (32, 32)])
def test_level_sizes_equal_scan_tpu(hw):
    strides = [8, 16, 32, 64, 128]
    assert level_sizes_from_image(*hw, strides) == jax_level_sizes(*hw,
                                                                  strides)
    assert level_sizes_from_image(*hw, [4, 8]) == jax_level_sizes(*hw, [4, 8])


@pytest.mark.parametrize("bucket", [None, (128, 160)])
def test_batch_images_equal_scan_tpu(bucket):
    rng = np.random.RandomState(1)
    images = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
              for h, w in ((70, 100), (96, 127), (33, 64))]
    ours = batch_images(images, 32, bucket)
    theirs = jax_batch_images(images, 32, bucket)
    _equal(ours.tensors, theirs.tensors)
    _equal(ours.sizes, theirs.sizes)
    assert ours.tensors.dtype == torch.float32
    assert ours.sizes.dtype == torch.int32
    assert ours.padded_hw == theirs.padded_hw
    assert [round_up(x, 32) for x in (1, 32, 33, 95)] == [
        jax_round_up(x, 32) for x in (1, 32, 33, 95)]


def test_vis_tools_write_files(tmp_path):
    from scan_tpu_torch.utils.vis_tools import VisTools

    vis = VisTools(str(tmp_path / "vis"))
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(1, 8, 12, 4, generator=g),
             torch.randn(2, 3, generator=g).numpy()]
    vis.save_feat(feats, tag="p")
    np.testing.assert_array_equal(np.load(tmp_path / "vis" / "p_0.npy"),
                                  feats[0].numpy())
    path = vis.draw_maps(torch.rand(1, 6, 8, 3, generator=g), level=1)
    assert path.endswith("activation_P4.png") and os.path.getsize(path) > 0
    proto = torch.randn(9, 16, 2, generator=g)
    path = vis.tsne_prototypes(proto, labels=[f"c{i}" for i in range(18)])
    assert os.path.getsize(path) > 0


def test_webcam_imports_without_cv2():
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import scan_tpu_torch.tools.webcam as w\n"
            "try:\n"
            "    w.main(['--config-file', 'x.yaml'])\n"
            "except ImportError:\n"
            "    print('needs cv2 at run time')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "needs cv2 at run time" in proc.stdout
