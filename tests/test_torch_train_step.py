"""The port's DA training step against ``scan_tpu``'s, on the CPU, float32.

The C2F config at VGG width / 8, 64x96 images, batch 2 + 2, small node and
box capacities, every BASE_LR 0.1 (so an update is readable: 0.033 a step
under the constant 1/3 warmup, 0.067 for biases). ``scan_tpu``'s detector is
initialised, its parameters and prototype state are carried into the port,
and both packages take the same seeded uint8 batches with GT boxes, without
dropout.

* One step in each ``forward_target`` variant: the metrics (names equal,
  values within rtol 1e-5), the prototype state (counter equal, values
  within 1e-5), and for every parameter the update Δp within
  1e-4 · max|Δp| of that tensor + 1e-4 · max|Δp| of the whole update. The
  second term is there because a ReLU whose input lies within float32
  rounding of 0 can fall on either side in the two frameworks (seen in a
  CKA tower on a 64x96 input), which moves the update of the layers above
  it by a share of their own scale; a missed ``.detach()`` or a wrong group
  moves a tensor's update by far more. Frozen tensors (VGG stages 1-2) move
  in neither package, and a tensor moves in one package exactly when it
  moves in the other.
* A trajectory of three steps, ``forward_target`` False, False, True, in the
  pattern of ``docs/parity/trajectory_ab.md``: every step's metrics within
  rtol 1e-4 and its prototype state within 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.engine.train_step import make_da_train_step as jax_make_step
from scan_tpu.modeling.detector import build_detector as jax_build_detector
from scan_tpu.solver.build import make_optimizer as jax_make_optimizer
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.engine.train_step import make_da_train_step
from scan_tpu_torch.modeling.detector import build_detector
from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer
from scan_tpu_torch.utils.jax_weights import convert_params, load_jax_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
B, H, W = 2, 64, 96
VARIANTS = (False, False, True)  # the trajectory's forward_target per step


def tiny_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.TPU.MAX_NODES = 64
    cfg.TPU.MAX_TARGET_POINTS = 64
    cfg.TPU.MAX_BOXES = 8
    cfg.TPU.VGG_WIDTH_DIV = 8
    for key in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS"):
        cfg.SOLVER[key].BASE_LR = 0.1
    return cfg


def make_batches(seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (2, B, H, W, 3)).astype(np.uint8)
    boxes = np.zeros((B, 8, 4), np.float32)
    labels = np.zeros((B, 8), np.int32)
    mask = np.zeros((B, 8), bool)
    for b in range(B):
        for j in range(3):
            x0, y0 = rng.rand(2) * [60, 30]
            w, h = rng.rand(2) * [40, 30] + 8
            boxes[b, j] = [x0, y0, x0 + w, y0 + h]
            labels[b, j] = rng.randint(1, 9)
            mask[b, j] = True
    batch_s = dict(images=images[0], sizes=np.asarray([[H, W]] * B, np.int32),
                   boxes=boxes, labels=labels, mask=mask)
    return batch_s, dict(images=images[1])


def _port(params, proto):
    cfg = tiny_cfg(get_default_cfg())
    det = build_detector(cfg, device="cpu")
    load_jax_params(det, params, proto)
    opt = make_optimizer(cfg, det)
    return det, make_da_train_step(det, opt, make_lr_scheduler(cfg, opt))


@pytest.fixture(scope="module")
def reference():
    """scan_tpu's initial state, its one-step results in each variant and
    its three-step trajectory."""
    cfg = tiny_cfg(jax_default_cfg())
    jdet = jax_build_detector(cfg)
    batches = [make_batches(i) for i in range(len(VARIANTS))]
    params, proto = jdet.init_params(jax.random.PRNGKey(0),
                                     jnp.asarray(batches[0][0]["images"]))
    opt = jax_make_optimizer(cfg, params)
    step = jax_make_step(jdet, opt)
    init = jax.device_get((params, proto))

    def run(p, s, st, bs, bt, ft):
        out = step(p, s, st, {k: jnp.asarray(v) for k, v in bs.items()},
                   {"images": jnp.asarray(bt["images"])}, forward_target=ft)
        return out, jax.device_get((out[0], out[2], out[3]))

    one = {ft: run(params, opt.init(params), proto, *batches[0], ft)[1]
           for ft in (False, True)}
    traj, state = [], (params, opt.init(params), proto)
    for ft, (bs, bt) in zip(VARIANTS, batches):
        out, host = run(*state, bs, bt, ft)
        state = out[:3]
        traj.append(host[1:])
    return init, batches, one, traj


def _check_metrics(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=rtol), k


def _check_proto(got, want, atol):
    assert int(got.counter) == int(want.counter)
    np.testing.assert_allclose(got.prototype.numpy(),
                               np.asarray(want.prototype), rtol=0, atol=atol)


@pytest.mark.parametrize("forward_target", [False, True])
def test_one_step_updates_match(reference, forward_target):
    (params, proto), batches, one, _ = reference
    want_params, want_proto, want_metrics = one[forward_target]
    det, step = _port(params, proto)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    got_proto, metrics = step(det.proto_state(), *batches[0],
                              forward_target=forward_target)
    _check_metrics(metrics, want_metrics, 1e-5)
    assert ("transfer_loss_gt" in metrics) == forward_target
    _check_proto(got_proto, want_proto, 1e-5)

    p0, p1 = convert_params(params), convert_params(want_params)
    want = {k: (p1[k] - p0[k]).numpy() for k in p0}
    after = det.state_dict()
    got = {k: (after[k] - before[k]).numpy() for k in p0}
    scale = max(float(np.abs(d).max()) for d in want.values())
    assert scale > 1e-3
    frozen = {f"backbone.body.conv{i}.{t}" for i in range(4)
              for t in ("weight", "bias")}
    for k in want:
        moved = np.abs(want[k]).max() > 0
        assert moved == (np.abs(got[k]).max() > 0), k
        assert moved != (k in frozen), k
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=1e-4 * np.abs(want[k]).max() + 1e-4 * scale, err_msg=k)


def test_three_step_trajectory(reference):
    (params, proto), batches, _, traj = reference
    det, step = _port(params, proto)
    state = det.proto_state()
    for i, (ft, (bs, bt), (want_proto, want_metrics)) in enumerate(
            zip(VARIANTS, batches, traj)):
        state, metrics = step(state, bs, bt, forward_target=ft)
        _check_metrics(metrics, want_metrics, 1e-4)
        _check_proto(state, want_proto, 1e-4)
        np.testing.assert_array_equal(det.prototype.numpy(),
                                      state.prototype.numpy())
    assert int(state.counter) == 2
