"""The port's condgraph training modes against ``scan_tpu``'s, on the CPU.

``scan_tpu``'s ``CondGraph`` is initialised in source mode, its parameters
and a seeded prototype state are carried across, and both modules run on
the same features, float32:

* ``source`` mode (C2F's config: the MHA, the RNN manifestation, softmax
  act loss): losses within rtol 1e-5, the new prototype state (counter
  equal, values within 1e-5), act maps and features within 1e-5 of the
  largest, and the gradient of the losses for every parameter within 1e-4
  of the largest parameter gradient (the biases in front of a GroupNorm
  and ``cond_nx1.bias``, whose kernels feed a softmax over the classes,
  have a gradient of 0 in exact arithmetic: rounding noise in both);
* ``target`` mode (DBSCAN sampling, NODES + ADJ transfer): the same, with
  the transfer loss non-zero;
* the local GCN of ``GLOBAL_GCN`` False in its four ``GCN_EDGE_NORM``s
  through ``forward_gcns``, with the gradients of the parameters and of the
  nodes, and the PROTOTYPE and ADJ_COMPLETE transfers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.condgraph.module import CondGraph as JCondGraph
from scan_tpu.modeling.condgraph.module import CondGraphConfig as JConfig
from scan_tpu.modeling.condgraph.prototype import ProtoState as JState
from scan_tpu_torch.modeling.condgraph.module import CondGraph, CondGraphConfig
from scan_tpu_torch.modeling.condgraph.prototype import ProtoState
from scan_tpu_torch.utils.jax_weights import convert_params

SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
SMALL = dict(max_nodes=48, max_target_candidates=48)


def _targets():
    boxes = np.zeros((2, 3, 4), np.float32)
    labels = np.zeros((2, 3), np.int32)
    mask = np.zeros((2, 3), bool)
    boxes[0, :2] = [[4, 4, 40, 44], [30, 10, 90, 60]]
    boxes[1, :1] = [[10, 6, 70, 60]]
    labels[0, :2], labels[1, :1] = [2, 7], [5]
    mask[0, :2] = mask[1, :1] = True
    return boxes, labels, mask


def _pair(**changes):
    jcfg = dataclasses.replace(JConfig(), **SMALL, **changes)
    tcfg = dataclasses.replace(CondGraphConfig(), **SMALL, **changes)
    rng = np.random.RandomState(0)
    feats = [np.maximum(rng.randn(2, h, w, 256), 0).astype(np.float32)
             for h, w in SHAPES]
    proto = rng.randn(jcfg.used_classes, 256, jcfg.proto_iter).astype(np.float32)
    boxes, labels, mask = _targets()
    jt = {"boxes": jnp.asarray(boxes), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    jstate = JState(jnp.asarray(proto), jnp.asarray(-1, jnp.int32))
    jmod = JCondGraph(jcfg)
    params = jmod.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats],
                       jstate, "source", jt)
    tmod = CondGraph(tcfg)
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in convert_params(
        {"m": jax.device_get(params)}).items()}, strict=True)
    tt = {k: torch.from_numpy(v) for k, v in
          (("boxes", boxes), ("labels", labels), ("mask", mask))}
    tstate = ProtoState(torch.from_numpy(proto), torch.tensor(-1, dtype=torch.int32))
    return jmod, params, jstate, jt, tmod, tstate, tt, feats


def _grads_close(tmod, jgrads):
    want = {k.split(".", 1)[1]: v.numpy() for k, v in convert_params(
        {"m": jax.device_get(jgrads)}).items()}
    got = {k: (np.zeros_like(want[k]) if p.grad is None else p.grad.numpy())
           for k, p in tmod.named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["source", "target"])
def test_condgraph_training_mode_matches_scan_tpu(mode):
    jmod, params, jstate, jt, tmod, tstate, tt, feats = _pair()

    def f(p):
        out, losses, maps, state = jmod.apply(
            p, [jnp.asarray(x) for x in feats], jstate, mode,
            jt if mode == "source" else None)
        return sum(losses.values()), (out, losses, maps, state)

    (_, (w_out, w_losses, w_maps, w_state)), jg = jax.value_and_grad(
        f, has_aux=True)(params)
    out, losses, maps, state = tmod([torch.from_numpy(x) for x in feats],
                                    tstate, mode,
                                    tt if mode == "source" else None)
    sum(losses.values()).backward()

    assert set(losses) == set(w_losses)
    for k in w_losses:
        assert losses[k].item() == pytest.approx(float(w_losses[k]), rel=1e-5), k
        assert float(w_losses[k]) > 0, k
    assert int(state.counter) == int(w_state.counter)
    np.testing.assert_allclose(state.prototype.numpy(),
                               np.asarray(w_state.prototype), rtol=0, atol=1e-5)
    for got, want in list(zip(out, w_out)) + list(zip(maps, w_maps)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    _grads_close(tmod, jg)


@pytest.mark.parametrize("edge", ["cosine_detached", "NO", "softmax", "cosine"])
def test_local_gcn_matches_scan_tpu(edge):
    jmod, params, _, _, tmod, _, _, _ = _pair(global_gcn=False,
                                                 gcn_edge_norm=edge)
    rng = np.random.RandomState(3)
    nodes = np.maximum(rng.randn(40, 256), 0).astype(np.float32)
    labels = rng.randint(0, 9, 40).astype(np.int32)
    valid = rng.rand(40) > 0.25

    def f(p, x):
        loss, proto = jmod.apply(p, x, jnp.asarray(labels),
                                 jnp.asarray(valid),
                                 method=JCondGraph.forward_gcns)
        return loss + jnp.sum(proto * proto), (loss, proto)

    (_, (w_loss, w_proto)), (jg, jx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(nodes))
    x = torch.from_numpy(nodes).requires_grad_(True)
    loss, proto = tmod.forward_gcns(x, torch.from_numpy(labels),
                                    torch.from_numpy(valid))
    (loss + (proto * proto).sum()).backward()
    assert loss.item() == pytest.approx(float(w_loss), rel=1e-5)
    np.testing.assert_allclose(proto.detach().numpy(), np.asarray(w_proto),
                               rtol=0, atol=1e-5)
    _grads_close(tmod, jg)
    # the node gradient: the detached edge softmax of cosine_detached and
    # NO shows here only (it holds no parameter)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.grad.numpy(), jx, rtol=0,
                               atol=1e-4 * np.abs(jx).max())


@pytest.mark.parametrize("transfer", [("PROTOTYPE",), ("NODES", "ADJ_COMPLETE")])
def test_transfer_losses(transfer):
    jmod, params, _, _, tmod, _, _, _ = _pair(transfer_cfg=transfer)
    rng = np.random.RandomState(4)
    sr = rng.randn(9, 256).astype(np.float32)
    tg = rng.randn(9, 256).astype(np.float32)
    tg[3] = 0.0
    nodes = rng.randn(30, 256).astype(np.float32)
    labels = rng.randint(0, 9, 30).astype(np.int32)
    valid = rng.rand(30) > 0.3
    exist = np.arange(9) != 3
    want = jmod.apply(params, *map(jnp.asarray, (sr, tg, nodes, labels, valid,
                                                  exist)),
                      method=JCondGraph.get_transfer_loss)
    got = tmod.get_transfer_loss(*map(torch.from_numpy,
                                      (sr, tg, nodes, labels, valid, exist)))
    assert got.item() == pytest.approx(float(want), rel=1e-5)
