"""The port's condgraph inference against ``scan_tpu``'s on the CPU, float32.

``scan_tpu``'s ``CondGraph`` is initialised in source mode, so its tree holds
the training layers too (the MHA, the node classifier), and its
parameters and prototype state are carried across by
``scan_tpu_torch/utils/jax_weights.py``. The manifested kernels, the act
maps and the features out of head_out must agree within rtol 1e-4, atol
1e-5 (float32 convolutions and matmuls summed in another order), for the
three kernel-manifestation paths: the RNN that C2F uses, the (ITER,1) conv
with GroupNorm, and the linear one for PROTO_ITER 1. Training modes are
held against ``scan_tpu`` in ``tests/test_torch_condgraph_train.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.config import get_default_cfg as jax_default_cfg
from scan_tpu.modeling.condgraph.module import CondGraph as JaxCondGraph
from scan_tpu.modeling.condgraph.module import CondGraphConfig as JaxCondGraphConfig
from scan_tpu.modeling.condgraph.prototype import ProtoState as JaxProtoState
from scan_tpu_torch.config import get_default_cfg
from scan_tpu_torch.modeling.condgraph.module import CondGraph, CondGraphConfig
from scan_tpu_torch.modeling.condgraph.prototype import ProtoState
from scan_tpu_torch.utils.jax_weights import convert_params

C2F = os.path.join(os.path.dirname(__file__), "..", "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]


def _cfg(base, use_rnn, proto_iter):
    base.merge_from_file(C2F)
    base.MODEL.MIDDLE_HEAD.USE_RNN = use_rnn
    base.MODEL.MIDDLE_HEAD.PROTO_ITER = proto_iter
    return base


@pytest.mark.parametrize("use_rnn,proto_iter", [("RNN", 3), ("", 3), ("", 1)])
def test_condgraph_inference_matches_scan_tpu(use_rnn, proto_iter):
    jcfg = JaxCondGraphConfig.from_cfg(_cfg(jax_default_cfg(), use_rnn, proto_iter))
    tcfg = CondGraphConfig.from_cfg(_cfg(get_default_cfg(), use_rnn, proto_iter))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)

    rng = np.random.RandomState(proto_iter + len(use_rnn))
    feats = [rng.randn(2, h, w, 256).astype(np.float32) for h, w in SHAPES]
    shape = (jcfg.used_classes, jcfg.proto_channel) + (
        (proto_iter,) if proto_iter > 1 else ())
    proto = rng.randn(*shape).astype(np.float32)
    jstate = JaxProtoState(jnp.asarray(proto), jnp.asarray(-1, jnp.int32))

    jmod = JaxCondGraph(jcfg)
    jfeats = [jnp.asarray(f) for f in feats]
    targets = {"boxes": jnp.asarray([[[8.0, 8.0, 48.0, 40.0]]] * 2),
               "labels": jnp.ones((2, 1), jnp.int32),
               "mask": jnp.ones((2, 1), bool)}
    params = jmod.init(jax.random.PRNGKey(3), jfeats, jstate, "source",
                       targets)
    want_feats, _, want_maps, _ = jax.device_get(
        jmod.apply(params, jfeats, jstate, "inference"))
    want_w = jax.device_get(jmod.apply(
        params, jnp.asarray(proto), method=JaxCondGraph.get_conded_weight))

    mod = CondGraph(tcfg)
    sd = {k[len("middle_head."):]: v for k, v in
          convert_params({"middle_head": jax.device_get(params)}).items()}
    mod.load_state_dict(sd, strict=True)
    tstate = ProtoState(torch.from_numpy(proto), torch.tensor(-1))
    with torch.no_grad():
        got_feats, losses, got_maps, _ = mod(
            [torch.from_numpy(f) for f in feats], tstate, "inference")
        got_w = mod.get_conded_weight(torch.from_numpy(proto))
    assert losses == {}
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-4, atol=1e-5)
    for lvl in range(len(SHAPES)):
        np.testing.assert_allclose(got_maps[lvl].numpy(), want_maps[lvl],
                                   rtol=1e-4, atol=1e-5, err_msg=f"act {lvl}")
        np.testing.assert_allclose(got_feats[lvl].numpy(), want_feats[lvl],
                                   rtol=1e-4, atol=1e-5, err_msg=f"feat {lvl}")


def test_training_modes_are_refused():
    """The int8 condgraph is for inference: ``scan_tpu`` trains the fp
    modules only (``detector.py:82-84``)."""
    mod = CondGraph(CondGraphConfig(), quant=True)
    state = ProtoState(torch.zeros(9, 256, 3), torch.tensor(-1))
    for mode in ("source", "target"):
        with pytest.raises(NotImplementedError):
            mod([torch.zeros(1, 2, 2, 256)], state, mode)
