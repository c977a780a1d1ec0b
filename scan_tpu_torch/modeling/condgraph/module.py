"""The condgraph middle head, inference half (counterpart of
``scan_tpu/modeling/condgraph/module.py``).

Parity target: reference ``fcos_core/modeling/rpn/fcos/condgraph.py``
(``GRAPHModule``) in eval: head_in tower -> prototype kernel manifestation
(RNN / (ITER,1)-conv / linear) -> per-class dynamic 1x1 conv -> activation
maps -> concat onto the features -> head_out tower. Node sampling, the graph
layers, the prototype EMA and the losses of training belong to a later
slice, as do their submodules (``multihead_attn``, ``proto_cls*``,
``gcn_layer*``, ``edge_project_*``).

Features are NHWC lists, one tensor per FPN level. With ``quant`` the
``head_in`` and ``head_out`` towers run the int8 branch; the dynamic conv
of the act maps stays fp (``scan_tpu/modeling/condgraph/module.py:144-161,
207-219``).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dynamic_conv import dynamic_conv
from ..layers import ConvTower, Linear
from .prototype import ProtoState


@dataclasses.dataclass(frozen=True)
class CondGraphConfig:
    num_classes: int = 9  # includes background
    in_channels: int = 256
    num_convs_in: int = 2
    num_convs_out: int = 1
    in_norm: str = "GN"
    cat_act_map: bool = True
    with_bg_proto: bool = True
    with_bias_dc: bool = False
    with_shortcut: bool = False
    global_gcn: bool = True
    gcn_edge_norm: str = "cosine_detached"
    gcn_out_activation: str = "relu"
    gcn1_out: int = 256
    gcn2_out: int = 256
    proto_channel: int = 256
    proto_iter: int = 3
    use_rnn: bool = True
    cosine_update: bool = True
    proto_momentum: float = 0.95
    cond_hidden: int = 512
    act_loss: Optional[str] = "softmaxFL"
    act_loss_weight: float = 1.0
    gcn_loss_weight: float = 1.0
    con_loss_weight: float = 1.0
    gcn_loss_weight_tg: float = 1.0
    transfer_cfg: tuple = ("NODES", "ADJ")
    self_training: bool = False
    target_sampling: str = "dbscan"
    plabel_th: float = 0.5
    dbscan_eps: float = 3.0
    dbscan_thr: float = 0.05
    max_nodes: int = 1024
    max_target_candidates: int = 512
    fpn_strides: tuple = (8, 16, 32, 64, 128)
    mha_dropout: float = 0.1

    @property
    def used_classes(self) -> int:
        return self.num_classes - 1 + int(self.with_bg_proto)

    @staticmethod
    def from_cfg(cfg):
        mh = cfg.MODEL.MIDDLE_HEAD
        transfer = mh.TRANSFER_CFG
        if not isinstance(transfer, (tuple, list)):
            transfer = (transfer,)
        return CondGraphConfig(
            num_classes=cfg.MODEL.FCOS.NUM_CLASSES,
            num_convs_in=mh.NUM_CONVS_IN,
            num_convs_out=mh.NUM_CONVS_OUT,
            in_norm=mh.IN_NORM,
            cat_act_map=mh.CAT_ACT_MAP,
            with_bg_proto=mh.PROTO_WITH_BG,
            with_bias_dc=mh.COND_WITH_BIAS,
            with_shortcut=mh.GCN_SHORTCUT,
            global_gcn=mh.GLOBAL_GCN,
            gcn_edge_norm=mh.GCN_EDGE_NORM,
            gcn_out_activation=mh.GCN_OUT_ACTIVATION,
            gcn1_out=mh.GCN1_OUT_CHANNEL,
            gcn2_out=mh.GCN2_OUT_CHANNEL,
            proto_channel=mh.PROTO_CHANNEL,
            proto_iter=mh.PROTO_ITER,
            use_rnn=bool(mh.USE_RNN),
            cosine_update=mh.COSINE_UPDATE_ON,
            proto_momentum=mh.PROTO_MOMENTUM,
            cond_hidden=mh.COND_HIDDEN_CHANNEL,
            act_loss=mh.ACT_LOSS,
            act_loss_weight=mh.ACT_LOSS_WEIGHT,
            gcn_loss_weight=mh.GCN_LOSS_WEIGHT,
            con_loss_weight=mh.CON_LOSS_WEIGHT,
            gcn_loss_weight_tg=mh.GCN_LOSS_WEIGHT_TG,
            transfer_cfg=tuple(transfer),
            self_training=mh.GCN_SELF_TRAINING,
            target_sampling=mh.TARGET_SAMPLING_CFG,
            plabel_th=cfg.SOLVER.MIDDLE_HEAD.PLABEL_TH[0],
            dbscan_eps=float(mh.DBSCAN_EPS),
            dbscan_thr=float(mh.DBSCAN_THR),
            max_nodes=cfg.TPU.MAX_NODES,
            max_target_candidates=cfg.TPU.MAX_TARGET_POINTS,
            fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            mha_dropout=float(mh.ATT_DROPOUT),
        )


class GraphTower(ConvTower):
    """Projection tower (reference GRAPHHead, ``condgraph.py:68-119``):
    num_convs x [conv3x3 -> (GN) -> ReLU]."""

    def __init__(self, num_convs, in_channels, out_channels, norm=None,
                 quant=False):
        super().__init__(num_convs, in_channels, out_channels,
                         norm="GN" if norm == "GN" else "NONE", quant=quant)


class TorchRNN(nn.Module):
    """Multi-layer Elman RNN with tanh, ``torch.nn.RNN(256, 512, 2)``'s
    parameters and ``scan_tpu``'s arithmetic order. xs: (T, B, input_size)."""

    def __init__(self, input_size=256, hidden_size=512, num_layers=2):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        h = hidden_size
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else h
            self.register_parameter(f"weight_ih_l{layer}", nn.Parameter(torch.empty(h, in_sz)))
            self.register_parameter(f"weight_hh_l{layer}", nn.Parameter(torch.empty(h, h)))
            self.register_parameter(f"bias_ih_l{layer}", nn.Parameter(torch.empty(h)))
            self.register_parameter(f"bias_hh_l{layer}", nn.Parameter(torch.empty(h)))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)

    def forward(self, xs):
        outs = xs
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{layer}")
            w_hh = getattr(self, f"weight_hh_l{layer}")
            b_ih = getattr(self, f"bias_ih_l{layer}")
            b_hh = getattr(self, f"bias_hh_l{layer}")
            hidden = xs.new_zeros((xs.shape[1], self.hidden_size))
            layer_outs = []
            for t in range(xs.shape[0]):
                hidden = torch.tanh(
                    outs[t] @ w_ih.t() + b_ih + hidden @ w_hh.t() + b_hh
                )
                layer_outs.append(hidden)
            outs = torch.stack(layer_outs, dim=0)
        return outs


class CondGraph(nn.Module):
    """The SCAN middle head in inference mode."""

    def __init__(self, cfg: CondGraphConfig, quant: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.head_in = GraphTower(c.num_convs_in, c.in_channels, c.in_channels,
                                  norm=c.in_norm, quant=quant)
        if c.cat_act_map:
            self.head_out = GraphTower(
                c.num_convs_out, c.in_channels + c.used_classes, c.in_channels,
                quant=quant)
        if c.use_rnn:
            self.cond_rnn = TorchRNN(c.proto_channel, 512, 2)
            self.cond_nx1 = Linear(512 * c.proto_iter, 256)
        elif c.proto_iter > 1:
            self.cond_nx1 = Linear(c.proto_channel * c.proto_iter,
                                   c.cond_hidden, kernel_init="normal", std=1.0)
            self.cond_nx1_norm = nn.GroupNorm(32, c.cond_hidden, eps=1e-5)
        else:
            self.cond_1 = Linear(c.proto_channel, c.cond_hidden,
                                 kernel_init="normal", std=0.01)
        if not c.use_rnn:
            self.cond_2 = Linear(c.cond_hidden, 256 + int(c.with_bias_dc),
                                 kernel_init="normal", std=0.01)

    def get_conded_weight(self, prototype):
        """Manifest prototypes into per-class 1x1 kernels
        (reference ``condgraph.py:313-336``)."""
        c = self.cfg
        if c.use_rnn:
            seq = prototype.permute(2, 0, 1)  # (ITER, C_used, ch)
            rnn_out = self.cond_rnn(seq)  # (ITER, C_used, 512)
            # Conv2d(512, 256, (ITER, 1)) == dense over (512*ITER), iter-minor
            flat = rnn_out.permute(1, 2, 0).reshape(prototype.shape[0], -1)
            return self.cond_nx1(flat)
        if c.proto_iter > 1:
            hidden = self.cond_nx1(prototype.reshape(prototype.shape[0], -1))
            return self.cond_2(F.relu(self.cond_nx1_norm(hidden)))
        return self.cond_2(F.relu(self.cond_1(prototype)))

    def _act_maps(self, features, conded_weight):
        c = self.cfg
        maps_logits = [dynamic_conv(f, conded_weight, with_bias=c.with_bias_dc)
                       for f in features]
        if c.act_loss == "softmaxFL":
            maps = [torch.softmax(m, dim=-1) for m in maps_logits]
        else:
            maps = [torch.sigmoid(m) for m in maps_logits]
        return maps_logits, maps

    def post_process(self, features, act_maps):
        """Concat act maps onto the features + head_out (``condgraph.py:379-384``)."""
        if not self.cfg.cat_act_map:
            return list(features)
        return [self.head_out(torch.cat([f, a.to(f.dtype)], dim=-1))
                for f, a in zip(features, act_maps)]

    def forward(self, features, proto_state: ProtoState, mode: str = "inference"):
        """Returns (features_out, losses, act_maps, proto_state), as
        ``scan_tpu``'s ``CondGraph.__call__`` does."""
        if mode != "inference":
            raise NotImplementedError(
                f"condgraph mode {mode!r} is not ported yet (inference only)")
        features = [self.head_in(f) for f in features]
        conded_weight = self.get_conded_weight(proto_state.prototype.float())
        _, act_maps = self._act_maps(features, conded_weight)
        features = self.post_process(features, act_maps)
        return features, {}, act_maps, proto_state
