"""The condgraph middle head (counterpart of
``scan_tpu/modeling/condgraph/module.py``; reference
``rpn/fcos/condgraph.py``, ``GRAPHModule``). Per mode:

  source (training): head_in -> FCOS point labelling -> node sampling ->
    graph aggregation (global multi-head attention or per-class GCN) and
    the node-classification loss -> prototype EMA -> kernel manifestation
    (RNN / (ITER,1)-conv / linear) -> per-class dynamic 1x1 conv -> the
    act-map focal loss -> act maps concatenated onto the features ->
    head_out.
  target (training): kernels -> act maps -> density-based node sampling ->
    graph aggregation -> the Graph-based Semantic Transfer losses (NODES KL,
    PROTOTYPE KL, ADJ cosine; ``condgraph.py:457-498``).
  inference: kernels -> act maps -> concat -> head_out.

Node sets are fixed-capacity masked tensors and per-class reductions are
one-hot matmuls built by comparing with an ``arange`` (``F.one_hot`` checks
its input on the host), so a training pass reads nothing back. The
``stop_gradient`` sites of ``scan_tpu`` are ``.detach()`` here: the edge
softmax of ``cosine_detached``/``NO`` (``module.py:294, 298``) and the
prototype update (``prototype.py``).

In bfloat16 the towers compute in bf16 and the rest as JAX's promotion
makes ``scan_tpu``'s: its Dense layers and MHA have no ``dtype`` and so run
in float32 on bf16 nodes (``layers.Linear``), the dynamic conv is float32,
and a product of a bf16 adjacency with float32 nodes runs in float32
(``promoted_matmul``).

Features are NHWC lists, one tensor per FPN level. With ``quant`` the
``head_in`` and ``head_out`` towers run the int8 branch, for inference only;
the dynamic conv of the act maps stays fp (``module.py:144-161, 207-219``).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dynamic_conv import dynamic_conv
from ...ops.focal_loss import bce_focal_loss, softmax_focal_loss
from ...ops.locations import compute_locations
from ..layers import (ConvTower, Linear, MultiHeadSelfAttention,
                      promoted_matmul, safe_l2_norm)
from .prototype import ProtoState, source_prototype_view, update_prototype
from .sampling import sample_source_nodes, sample_target_nodes

EPS = 1e-8


def sim_matrix(a, b, eps=EPS):
    """Cosine similarity matrix (reference ``condgraph.py:35-43``), finite
    in its gradient at exactly-zero rows."""
    a = a / safe_l2_norm(a, dim=1, keepdim=True, eps=eps).clamp_min(eps)
    b = b / safe_l2_norm(b, dim=1, keepdim=True, eps=eps).clamp_min(eps)
    return a @ b.t()


def one_hot(index, num_classes: int, dtype):
    """(N,) int -> (N, num_classes); rows of out-of-range indices are 0, as
    ``jax.nn.one_hot`` makes them."""
    classes = torch.arange(num_classes, device=index.device)
    return (index[:, None] == classes[None, :]).to(dtype)


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
    """The SCAN middle head; see the module docstring for its modes.

    Submodules carry ``scan_tpu``'s names, and exactly the ones its
    parameter tree holds for the config: ``multihead_attn`` (GLOBAL_GCN) or
    ``gcn_layer1/2`` with ``edge_project_u`` (``softmax`` edges) and
    ``edge_project_v`` (``softmax`` and ``cosine``), the node classifier
    ``proto_cls_hidden``/``proto_cls``, and the manifestation branch."""

    def __init__(self, cfg: CondGraphConfig, quant: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.quant = quant
        self.head_in = GraphTower(c.num_convs_in, c.in_channels, c.in_channels,
                                  norm=c.in_norm, quant=quant)
        if c.cat_act_map:
            self.head_out = GraphTower(
                c.num_convs_out, c.in_channels + c.used_classes, c.in_channels,
                quant=quant)
        if c.global_gcn:
            self.multihead_attn = MultiHeadSelfAttention(
                model_dim=256, num_heads=4, dropout=c.mha_dropout)
            node_dim = 256
        else:
            self.gcn_layer1 = Linear(c.in_channels, c.gcn1_out,
                                     kernel_init="normal", std=0.01)
            self.gcn_layer2 = Linear(c.gcn1_out, c.gcn2_out,
                                     kernel_init="normal", std=0.01)
            if c.gcn_edge_norm == "softmax":
                self.edge_project_u = Linear(c.in_channels, 256)
            if c.gcn_edge_norm in ("softmax", "cosine"):
                self.edge_project_v = Linear(c.in_channels, 256)
            node_dim = c.gcn2_out
        self.proto_cls_hidden = Linear(node_dim, 512, kernel_init="normal",
                                       std=0.01)
        self.proto_cls = Linear(512, c.used_classes, kernel_init="normal",
                                std=0.01)
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

    # ------------------------------------------------------------------ #
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

    def _edge(self, nodes, pair_mask):
        """Adjacency restricted to ``pair_mask``, per GCN_EDGE_NORM
        (reference ``get_edge``, ``condgraph.py:284-302``)."""
        c = self.cfg
        neg = torch.full((), -1e30, device=nodes.device)
        if c.gcn_edge_norm == "cosine_detached":
            sim = torch.where(pair_mask, sim_matrix(nodes, nodes), neg)
            return torch.softmax(sim, dim=-1).detach()
        if c.gcn_edge_norm == "NO":
            sim = torch.where(pair_mask, nodes @ nodes.t(), neg)
            return torch.softmax(sim, dim=-1).detach()
        if c.gcn_edge_norm == "softmax":
            sim = self.edge_project_u(nodes) @ self.edge_project_v(nodes).t()
            return torch.softmax(torch.where(pair_mask, sim, neg), dim=-1)
        if c.gcn_edge_norm == "cosine":
            proj = F.relu(self.edge_project_v(nodes))
            sim = sim_matrix(proj, proj)
            sim = torch.where(pair_mask, sim, torch.zeros_like(sim))
            return sim / sim.sum(dim=-1, keepdim=True).clamp_min(EPS)
        raise KeyError(c.gcn_edge_norm)

    def _gcn_local(self, nodes, adj):
        c = self.cfg
        h = F.relu(self.gcn_layer1(promoted_matmul(adj, nodes)))
        y = self.gcn_layer2(promoted_matmul(adj, h))
        act = c.gcn_out_activation
        if act == "relu":
            y = F.relu(y)
        elif act == "softmax":
            y = torch.softmax(y, dim=-1)
        elif act == "sigmoid":
            y = torch.sigmoid(y)
        elif act == "tanh":
            y = torch.tanh(y)
        elif act != "NO":
            raise KeyError(act)
        return y + nodes if c.with_shortcut else y

    def _cls_index(self, node_labels):
        return node_labels if self.cfg.with_bg_proto else node_labels - 1

    def forward_gcns(self, nodes, node_labels, node_valid, generator=None):
        """Graph aggregation, the node-classification loss and the per-class
        means (reference ``_forward_gcns``, ``condgraph.py:386-421``).
        Returns (node_loss, prototype_batch (C_used, ch))."""
        c = self.cfg
        if c.global_gcn:
            nodes_out = self.multihead_attn(nodes, mask=node_valid,
                                            generator=generator)
            if c.with_shortcut:
                nodes_out = nodes_out + nodes
        else:
            same_class = node_labels[:, None] == node_labels[None, :]
            valid_pair = node_valid[:, None] & node_valid[None, :] & same_class
            nodes_out = self._gcn_local(nodes, self._edge(nodes, valid_pair))
            nodes_out = torch.where(node_valid[:, None], nodes_out, nodes)

        cls_index = self._cls_index(node_labels)
        oh = one_hot(cls_index, c.used_classes, nodes_out.dtype)
        oh = oh * node_valid[:, None].to(nodes_out.dtype)
        counts = oh.sum(dim=0)
        proto_batch = (oh.t() @ nodes_out) / counts[:, None].clamp_min(1.0)
        proto_batch = proto_batch * (counts[:, None] > 0)

        logits = self.proto_cls(F.relu(self.proto_cls_hidden(nodes_out)))
        logp = torch.log_softmax(logits, dim=-1)
        # rows of an out-of-range index are masked out below
        target = cls_index.clamp(0, c.used_classes - 1).long()
        ce = -torch.gather(logp, 1, target[:, None])[:, 0]
        valid = node_valid.to(ce.dtype)
        node_loss = c.gcn_loss_weight * (ce * valid).sum() / valid.sum().clamp_min(1.0)
        return node_loss, proto_batch

    def _act_maps(self, features, conded_weight):
        c = self.cfg
        maps_logits = [dynamic_conv(f, conded_weight, with_bias=c.with_bias_dc)
                       for f in features]
        if c.act_loss == "softmaxFL":
            maps = [torch.softmax(m, dim=-1) for m in maps_logits]
        else:
            maps = [torch.sigmoid(m) for m in maps_logits]
        return maps_logits, maps

    def get_act_loss(self, maps_logits, act_labels):
        """Activation-map loss (reference ``condgraph.py:338-370``)."""
        c = self.cfg
        logits = torch.cat([m.reshape(-1, c.used_classes) for m in maps_logits])
        labels = torch.cat([l.reshape(-1) for l in act_labels])
        if c.act_loss == "softmaxFL":
            return c.act_loss_weight * softmax_focal_loss(logits, labels)
        if c.act_loss == "sigmoidFL":
            onehot = one_hot(labels.clamp(0, 1), 2, logits.dtype)
            return c.act_loss_weight * bce_focal_loss(logits, onehot)
        return None

    def post_process(self, features, act_maps):
        """Concat act maps onto the features + head_out (``condgraph.py:379-384``)."""
        if not self.cfg.cat_act_map:
            return list(features)
        return [self.head_out(torch.cat([f, a.to(f.dtype)], dim=-1))
                for f, a in zip(features, act_maps)]

    def _class_exist(self, node_labels, node_valid):
        """Classes with at least one valid node this step, from counts
        (``module.py:408-416``)."""
        oh = one_hot(self._cls_index(node_labels), self.cfg.used_classes,
                     torch.float32)
        return (oh * node_valid[:, None]).sum(dim=0) > 0

    def get_transfer_loss(self, sr_prototype, tg_prototype, tg_nodes,
                          tg_labels, tg_valid, exist=None):
        """Graph-based Semantic Transfer (reference ``condgraph.py:457-498``)."""
        c = self.cfg
        losses = []
        cfg_str = [t for t in c.transfer_cfg if t]

        def masked_kl(target_logits, logits, row_mask):
            tgt = torch.softmax(target_logits, dim=-1)
            kl = tgt * (torch.log(tgt.clamp_min(1e-12))
                        - torch.log_softmax(logits, dim=-1))
            m = row_mask[:, None].to(kl.dtype)
            return (kl * m).sum() / (m.sum() * kl.shape[1]).clamp_min(1.0)

        if any(t in ("NODES", "NODE") for t in cfg_str):
            # KLDiv(log softmax(nodes), softmax(proto[label])), the mean over
            # N * ch (torch KLDivLoss 'mean'); masked rows excluded. An index
            # past the prototypes is clamped, as a JAX gather clamps it.
            idx = tg_labels.clamp(0, sr_prototype.shape[0] - 1).long()
            losses.append(masked_kl(sr_prototype[idx], tg_nodes, tg_valid))
        if exist is None:
            exist = tg_prototype.sum(dim=-1) != 0
        if "PROTOTYPE" in cfg_str:
            losses.append(masked_kl(sr_prototype, tg_prototype, exist))
        if "ADJ" in cfg_str or "ADJ_COMPLETE" in cfg_str:
            if "ADJ_COMPLETE" in cfg_str:
                tg_c = torch.where(exist[:, None], tg_prototype, sr_prototype)
                pair_mask = None
            else:
                tg_c = tg_prototype
                pair_mask = exist[:, None] & exist[None, :]
            adj_sr = sim_matrix(sr_prototype, sr_prototype)
            adj_tg = sim_matrix(tg_c, tg_c)
            if pair_mask is not None:
                adj_sr = torch.where(pair_mask, adj_sr, torch.zeros_like(adj_sr))
                adj_tg = torch.where(pair_mask, adj_tg, torch.zeros_like(adj_tg))
            a, b = adj_sr.reshape(-1), adj_tg.reshape(-1)
            cos = torch.dot(a, b) / (safe_l2_norm(a) * safe_l2_norm(b)).clamp_min(1e-8)
            losses.append(1.0 - cos)
        if not losses:
            return None
        return sum(losses)

    # ------------------------------------------------------------------ #
    def forward(self, features, proto_state: ProtoState, mode: str = "inference",
                targets=None, generator=None):
        """Returns (features_out, losses, act_maps, proto_state), as
        ``scan_tpu``'s ``CondGraph.__call__`` does. ``targets`` (source mode)
        holds ``boxes``, ``labels`` and ``mask``; ``generator`` draws the
        MHA's dropout (none: deterministic). The int8 towers are for
        inference: training modes raise on a ``quant`` module."""
        if mode in ("source", "target") and self.quant:
            raise NotImplementedError(
                "the int8 condgraph runs inference only; training runs the "
                "fp modules")
        features = [self.head_in(f) for f in features]
        if mode == "source":
            return self._forward_source(features, proto_state, targets,
                                        generator)
        if mode == "target":
            return self._forward_target(features, proto_state, generator)
        conded_weight = self.get_conded_weight(proto_state.prototype.float())
        _, act_maps = self._act_maps(features, conded_weight)
        return self.post_process(features, act_maps), {}, act_maps, proto_state

    def _forward_source(self, features, proto_state, targets, generator):
        c = self.cfg
        shapes = [(f.shape[1], f.shape[2]) for f in features]
        locations = compute_locations(shapes, c.fpn_strides,
                                      device=features[0].device)
        nodes, node_labels, node_valid, act_labels = sample_source_nodes(
            locations, features, targets["boxes"], targets["labels"],
            targets["mask"], max_nodes=c.max_nodes, with_bg=c.with_bg_proto)
        node_loss, proto_batch = self.forward_gcns(nodes, node_labels,
                                                   node_valid, generator)
        new_state = update_prototype(
            proto_state, proto_batch, c.proto_iter, c.use_rnn,
            c.cosine_update, c.proto_momentum,
            exist=self._class_exist(node_labels, node_valid))
        maps_logits, act_maps = self._act_maps(
            features, self.get_conded_weight(new_state.prototype))
        losses = {"node_loss": node_loss}
        if c.act_loss:
            losses["act_loss"] = self.get_act_loss(maps_logits, act_labels)
        return self.post_process(features, act_maps), losses, act_maps, new_state

    def _forward_target(self, features, proto_state, generator):
        c = self.cfg
        _, act_maps = self._act_maps(
            features, self.get_conded_weight(proto_state.prototype))
        nodes, node_labels, node_valid, any_nodes = sample_target_nodes(
            features, act_maps, max_nodes=c.max_nodes,
            sampling_cfg=c.target_sampling, score_threshold=c.plabel_th,
            dbscan_eps=c.dbscan_eps, dbscan_thr=c.dbscan_thr,
            max_candidates_per_level=c.max_target_candidates)
        features_out = self.post_process(features, act_maps)
        losses = {}
        if [t for t in c.transfer_cfg if t] or c.self_training:
            node_loss, tg_proto = self.forward_gcns(nodes, node_labels,
                                                    node_valid, generator)
            transfer = self.get_transfer_loss(
                source_prototype_view(proto_state, c.proto_iter), tg_proto,
                nodes, node_labels, node_valid,
                exist=self._class_exist(node_labels, node_valid))
            gate = any_nodes.to(torch.float32)
            if transfer is not None:
                losses["transfer_loss"] = c.con_loss_weight * transfer * gate
            if c.self_training:
                losses["node_loss_tg"] = c.gcn_loss_weight_tg * node_loss * gate
        return features_out, losses, act_maps, proto_state
