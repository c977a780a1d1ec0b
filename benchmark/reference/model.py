"""The plain reference of the SCAN and EPM detectors: float32, plain
PyTorch, no kernel, no cache, no batching trick.

It follows the published models (SCAN, ``CityU-AIM-Group/SCAN``'s
``fcos_core``; EPM's GA and CA discriminators) in the fixed-shape form the
system under test computes them: node sets of ``TPU.MAX_NODES`` rows with a
validity mask, DBSCAN as a fixed-iteration density clustering, the top
``TPU.MAX_TARGET_POINTS`` candidates a level, ``TPU.NMS_CAP`` candidates
into NMS. Departures from the loops of the original that change no value:
batched image dimensions, one-hot matmuls for per-class means. Stage 1 of
VGG16 is conv / ReLU / conv / ReLU / max-pool, CKA's per-class heads are
separate convs over ``cat(feature, act_map_c)``, NMS is the greedy loop.

``cfg`` is the ``cfg`` object of a file in ``benchmark/configs/``, nested
dicts as loaded from JSON. Parameters carry the names of the system's, so
one state dict of seeded weights loads into both.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nn import (Conv, ConvTower, FrozenBatchNorm, Linear,
                 MultiHeadSelfAttention, Scale, bce_with_logits, grl,
                 iou_loss, safe_l2_norm, sigmoid_focal_loss,
                 softmax_focal_loss, to_nchw, to_nhwc)

LEVELS = ("P3", "P4", "P5", "P6", "P7")
INF = 100000000.0
SOI = ((-1.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, 512.0),
       (512.0, INF))
NEG_INF = -1e10


# ---------------------------------------------------------------- backbones
class VGG16(nn.Module):
    """conv0..conv12, stages (2, 2, 3, 3, 3), 2x2 max-pool after each;
    stages 1-2 frozen. Returns C1..C5."""

    BLOCKS, CH = (2, 2, 3, 3, 3), (64, 128, 256, 512, 512)

    def __init__(self):
        super().__init__()
        idx, cin = 0, 3
        for blocks, ch in zip(self.BLOCKS, self.CH):
            for _ in range(blocks):
                self.add_module(f"conv{idx}", Conv(cin, ch))
                cin, idx = ch, idx + 1
        for i in range(4):
            getattr(self, f"conv{i}").requires_grad_(False)
        self.channels = self.CH

    def forward(self, x):
        outs, idx = [], 0
        for blocks in self.BLOCKS:
            for _ in range(blocks):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            x = to_nhwc(F.max_pool2d(to_nchw(x), 2, 2))
            outs.append(x)
        return outs


class Bottleneck(nn.Module):
    def __init__(self, cin, cb, cout, stride):
        super().__init__()
        self.down = cin != cout or stride != 1
        if self.down:
            self.downsample_conv = Conv(cin, cout, 1, stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(cout)
        self.conv1 = Conv(cin, cb, 1, stride, bias=False)  # stride in 1x1
        self.bn1 = FrozenBatchNorm(cb)
        self.conv2 = Conv(cb, cb, 3, bias=False)
        self.bn2 = FrozenBatchNorm(cb)
        self.conv3 = Conv(cb, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)

    def forward(self, x):
        idt = self.downsample_bn(self.downsample_conv(x)) if self.down else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + idt)


class ResNet(nn.Module):
    """ResNet-101 with FrozenBatchNorm; the stem and stage 1 frozen
    (FREEZE_CONV_BODY_AT 2). Returns C2..C5."""

    STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

    def __init__(self, depth, res2=256, stem=64, freeze_at=2):
        super().__init__()
        self.freeze_at = freeze_at
        self.blocks = self.STAGES[depth]
        self.stem_conv1 = Conv(3, stem, 7, 2, bias=False)
        self.stem_bn1 = FrozenBatchNorm(stem)
        self.stem_conv1.requires_grad_(False)
        cin, cout, cb, ch = stem, res2, res2 // 4, []
        for s, n in enumerate(self.blocks, 1):
            for b in range(n):
                blk = Bottleneck(cin, cb, cout, (1 if s == 1 else 2) if b == 0
                                 else 1)
                if freeze_at >= s + 1:
                    blk.requires_grad_(False)
                self.add_module(f"layer{s}_block{b}", blk)
                cin = cout
            ch.append(cout)
            cout, cb = cout * 2, cb * 2
        self.channels = tuple(ch)

    def forward(self, x):
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = to_nhwc(F.max_pool2d(to_nchw(x), 3, 2, padding=1)).detach()
        outs = []
        for s, n in enumerate(self.blocks, 1):
            for b in range(n):
                x = getattr(self, f"layer{s}_block{b}")(x)
            if self.freeze_at >= s + 1:
                x = x.detach()
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Laterals 1x1, outputs 3x3, nearest 2x top-down, P6 from P5 and P7
    from relu(P6), both 3x3 stride 2."""

    def __init__(self, in_channels, in_features, ch=256):
        super().__init__()
        self.in_features = in_features
        for i, f in enumerate(in_features):
            self.add_module(f"fpn_inner{i + 1}", Conv(in_channels[f], ch, 1))
            self.add_module(f"fpn_layer{i + 1}", Conv(ch, ch, 3))
        self.p6 = Conv(ch, ch, 3, 2)
        self.p7 = Conv(ch, ch, 3, 2)

    def forward(self, body_outs):
        feats = [body_outs[i] for i in self.in_features]
        n = len(feats)
        lat = [getattr(self, f"fpn_inner{i + 1}")(f)
               for i, f in enumerate(feats)]
        res = [None] * n
        inner = lat[-1]
        res[-1] = getattr(self, f"fpn_layer{n}")(inner)
        for i in range(n - 2, -1, -1):
            up = inner.repeat_interleave(2, 1).repeat_interleave(2, 2)
            inner = lat[i] + up
            res[i] = getattr(self, f"fpn_layer{i + 1}")(inner)
        p6 = self.p6(res[-1])
        return res + [p6, self.p7(F.relu(p6))]


class Backbone(nn.Module):
    def __init__(self, body, fpn):
        super().__init__()
        self.body, self.fpn = body, fpn

    def forward(self, x):
        return self.fpn(self.body(x))


# -------------------------------------------------------------------- FCOS
def locations(shapes, strides, device):
    out = []
    for (h, w), s in zip(shapes, strides):
        ys, xs = torch.meshgrid(
            torch.arange(0, h * s, s, dtype=torch.float32, device=device),
            torch.arange(0, w * s, s, dtype=torch.float32, device=device),
            indexing="ij")
        out.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], 1) + s // 2)
    return out


def fcos_targets(locs, gt_boxes, gt_labels, gt_mask):
    """Per location: the label of the smallest-area GT box that holds it
    within the level's size range, and its ltrb distances."""
    n_pts = [l.shape[0] for l in locs]
    soi = torch.cat([torch.tensor(SOI[i], device=locs[0].device).expand(n, 2)
                     for i, n in enumerate(n_pts)])
    loc = torch.cat(locs)
    xs, ys = loc[None, :, None, 0], loc[None, :, None, 1]
    bx = gt_boxes[:, None]
    reg = torch.stack([xs - bx[..., 0], ys - bx[..., 1], bx[..., 2] - xs,
                       bx[..., 3] - ys], 3)
    inside = reg.amin(3) > 0
    mx = reg.amax(3)
    cared = (mx >= soi[None, :, 0:1]) & (mx <= soi[None, :, 1:2])
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1)
            * (gt_boxes[..., 3] - gt_boxes[..., 1] + 1))
    ok = inside & cared & gt_mask[:, None, :]
    a = torch.where(ok, area[:, None, :].expand_as(ok),
                    torch.full_like(reg[..., 0], INF))
    amin, gi = a.amin(2), a.argmin(2)
    labels = torch.gather(gt_labels.to(torch.int32), 1, gi)
    labels = torch.where(amin == INF, torch.zeros_like(labels), labels)
    regt = torch.gather(reg, 2, gi[:, :, None, None].expand(-1, -1, 1, 4))
    return labels, regt[:, :, 0], n_pts


class FCOSHead(nn.Module):
    def __init__(self, num_classes, cin, n_cls=4, n_reg=4, prior=0.01,
                 reg_ctr=True):
        super().__init__()
        self.reg_ctr = reg_ctr
        self.cls_tower = ConvTower(n_cls, cin, 256)
        self.bbox_tower = ConvTower(n_reg, cin, 256)
        self.cls_logits = Conv(256, num_classes - 1)
        self.bbox_pred = Conv(256, 4)
        self.centerness = Conv(256, 1)
        for l in range(5):
            self.add_module(f"scale{l}", Scale())

    def forward(self, feats):
        cls, reg, ctr = [], [], []
        for l, f in enumerate(feats):
            c = self.cls_tower(f)
            cls.append(self.cls_logits(c))
            r = self.bbox_tower(f)
            ctr.append(self.centerness(r if self.reg_ctr else c))
            s = getattr(self, f"scale{l}")(self.bbox_pred(r))
            reg.append(torch.exp(torch.clamp(s, max=25.0)))
        return cls, reg, ctr


def fcos_losses(locs, cls, reg, ctr, boxes, labels, mask, gamma, alpha):
    b, nc = cls[0].shape[0], cls[0].shape[-1]
    lab, regt, _ = fcos_targets(locs, boxes, labels, mask)
    lab, regt = lab.reshape(-1), regt.reshape(-1, 4)

    def flat(maps, c):
        return torch.cat([m.reshape(b, -1, c) for m in maps], 1).reshape(-1, c)

    cls_f, reg_f, ctr_f = flat(cls, nc), flat(reg, 4), flat(ctr, 1)[:, 0]
    pos = lab > 0
    npos = pos.float().sum()
    l, t, r, bt = regt.unbind(-1)
    ctr_t = torch.sqrt(((torch.minimum(l, r) / torch.maximum(l, r).clamp_min(
        1e-12)) * (torch.minimum(t, bt) / torch.maximum(t, bt).clamp_min(
            1e-12))).clamp_min(0.0))
    has = npos > 0
    reg_l = iou_loss(reg_f, regt, ctr_t, pos)
    ctr_l = (bce_with_logits(ctr_f, ctr_t) * pos).sum() / npos.clamp_min(1.0)
    zero = torch.zeros_like(reg_l)
    return {"loss_cls": sigmoid_focal_loss(cls_f, lab, gamma, alpha)
            / (npos + b),
            "loss_reg": torch.where(has, reg_l, zero),
            "loss_centerness": torch.where(has, ctr_l, zero)}


# --------------------------------------------------------------- condgraph
def one_hot(index, n, dtype):
    return (index[:, None] == torch.arange(n, device=index.device)).to(dtype)


def sim_matrix(a, b, eps=1e-8):
    a = a / safe_l2_norm(a, 1, True, eps).clamp_min(eps)
    b = b / safe_l2_norm(b, 1, True, eps).clamp_min(eps)
    return a @ b.t()


def even_subset(select_from, want):
    """The reference's balanced background choice,
    ``floor(linspace(0, n - 2, want))`` over the True entries."""
    sel = select_from.long()
    n = sel.sum()
    rank = torch.cumsum(sel, 0) - 1
    want = want.long()
    m = torch.clamp_min(n - 2, 1)
    km1 = torch.clamp_min(want - 1, 1)
    r = torch.clamp_min(rank, 0)
    lo = torch.div(r * km1 + m - 1, m, rounding_mode="floor")
    hi = torch.div((r + 1) * km1 - 1, m, rounding_mode="floor")
    hit = (lo <= hi) & (lo <= km1)
    hit = torch.where((n > 2) & (want >= 2), hit, rank == 0)
    hit = (hit | (want >= n)) & (want >= 1)
    return select_from & hit & (rank >= 0)


def gather_nodes(feats, labels, select, max_nodes):
    """Background rows first, then foreground, each in flat order, into
    ``max_nodes`` rows with a validity mask."""
    n = select.shape[0]
    i = torch.arange(n, device=select.device)
    key = torch.where(select, (labels > 0).long() * n + i, 2 * n + i)
    idx = torch.argsort(key, stable=True)[:max_nodes]
    valid = select[idx]
    nodes = feats[idx] * valid[:, None].float()
    lab = torch.where(valid, labels[idx], torch.zeros_like(labels[idx]))
    return nodes, lab, valid


def dbscan_keep(pts, valid, eps, min_samples=5, iters=16):
    """Density clustering over the eps-graph through core points; keeps
    noise and every component but the one of the lowest core point."""
    k = pts.shape[0]
    sq = (pts * pts).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.t())
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    core = valid & (adj.sum(1) >= min_samples)
    prop = adj & core[None, :]
    idx = torch.arange(k, device=pts.device)
    fill = torch.full_like(idx, k)
    comp = torch.where(valid, idx, fill)
    for _ in range(iters):
        best = torch.where(prop, comp[None, :], fill[None, :]).amin(1)
        comp = torch.where(valid, torch.minimum(comp, best), fill)
    first = torch.where(core, comp, fill).amin()
    noise = valid & ~core & ~(adj & core[None, :]).any(1)
    keep = valid & (noise | ~((comp == first) & ~noise))
    return torch.where(core.any(), keep, valid)


class TorchRNN(nn.Module):
    def __init__(self, cin=256, hidden=512, layers=2):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for l in range(layers):
            i = cin if l == 0 else hidden
            setattr(self, f"weight_ih_l{l}", nn.Parameter(torch.empty(hidden, i)))
            setattr(self, f"weight_hh_l{l}", nn.Parameter(torch.empty(hidden, hidden)))
            setattr(self, f"bias_ih_l{l}", nn.Parameter(torch.empty(hidden)))
            setattr(self, f"bias_hh_l{l}", nn.Parameter(torch.empty(hidden)))

    def forward(self, xs):
        outs = xs
        for l in range(self.layers):
            h = xs.new_zeros((xs.shape[1], self.hidden))
            seq = []
            for t in range(xs.shape[0]):
                h = torch.tanh(outs[t] @ getattr(self, f"weight_ih_l{l}").t()
                               + getattr(self, f"bias_ih_l{l}")
                               + h @ getattr(self, f"weight_hh_l{l}").t()
                               + getattr(self, f"bias_hh_l{l}"))
                seq.append(h)
            outs = torch.stack(seq)
        return outs


class CondGraph(nn.Module):
    """SCAN's middle head for its C2F settings: GN head_in of 2 convs, a
    1-conv head_out over the concatenated act maps, global MHA over the
    nodes, an RNN over 3 prototype slots, softmax focal act loss, cosine
    EMA of the prototypes, NODES + ADJ transfer with DBSCAN sampling."""

    def __init__(self, cfg):
        super().__init__()
        mh = cfg["MODEL"]["MIDDLE_HEAD"]
        for key, want in (("GLOBAL_GCN", True), ("USE_RNN", "RNN"),
                          ("CAT_ACT_MAP", True), ("PROTO_WITH_BG", True),
                          ("COND_WITH_BIAS", False), ("ACT_LOSS", "softmaxFL"),
                          ("COSINE_UPDATE_ON", True), ("IN_NORM", "GN"),
                          ("GCN_SHORTCUT", False), ("GCN_SELF_TRAINING", False),
                          ("TARGET_SAMPLING_CFG", "dbscan")):
            if mh[key] != want:
                raise NotImplementedError(f"reference: MIDDLE_HEAD.{key}")
        self.nc = cfg["MODEL"]["FCOS"]["NUM_CLASSES"]
        self.iters = mh["PROTO_ITER"]
        self.strides = cfg["MODEL"]["FCOS"]["FPN_STRIDES"]
        self.max_nodes = cfg["TPU"]["MAX_NODES"]
        self.max_cand = cfg["TPU"]["MAX_TARGET_POINTS"]
        self.plabel_th = cfg["SOLVER"]["MIDDLE_HEAD"]["PLABEL_TH"][0]
        self.eps, self.thr = float(mh["DBSCAN_EPS"]), float(mh["DBSCAN_THR"])
        self.transfer = [t for t in mh["TRANSFER_CFG"] if t]
        self.w = {k: mh[k] for k in ("ACT_LOSS_WEIGHT", "GCN_LOSS_WEIGHT",
                                     "CON_LOSS_WEIGHT")}
        self.head_in = ConvTower(mh["NUM_CONVS_IN"], 256, 256)
        self.head_out = ConvTower(mh["NUM_CONVS_OUT"], 256 + self.nc, 256,
                                  norm=False)
        self.multihead_attn = MultiHeadSelfAttention(256, 4,
                                                     mh["ATT_DROPOUT"])
        self.proto_cls_hidden = Linear(256, 512)
        self.proto_cls = Linear(512, self.nc)
        self.cond_rnn = TorchRNN(mh["PROTO_CHANNEL"], 512, 2)
        self.cond_nx1 = Linear(512 * self.iters, 256)

    def kernels(self, proto):
        out = self.cond_rnn(proto.permute(2, 0, 1))
        return self.cond_nx1(out.permute(1, 2, 0).reshape(proto.shape[0], -1))

    def act_maps(self, feats, kernels):
        logits = [f.float() @ kernels.float().t() for f in feats]
        return logits, [torch.softmax(m, -1) for m in logits]

    def gcns(self, nodes, labels, valid, generator):
        out = self.multihead_attn(nodes, valid, generator)
        oh = one_hot(labels, self.nc, out.dtype) * valid[:, None].float()
        cnt = oh.sum(0)
        proto = (oh.t() @ out) / cnt[:, None].clamp_min(1.0)
        proto = proto * (cnt[:, None] > 0)
        logp = torch.log_softmax(
            self.proto_cls(F.relu(self.proto_cls_hidden(out))), -1)
        ce = -torch.gather(logp, 1, labels.clamp(0, self.nc - 1).long()[:, None])[:, 0]
        v = valid.float()
        loss = self.w["GCN_LOSS_WEIGHT"] * (ce * v).sum() / v.sum().clamp_min(1.0)
        return loss, proto

    def exist(self, labels, valid):
        return (one_hot(labels, self.nc, torch.float32) * valid[:, None]).sum(0) > 0

    def update(self, proto, counter, batch, exist):
        """Cosine EMA of one of the ITER slots, shifting the history once
        all slots are filled."""
        batch = batch.detach()
        counter = torch.clamp_max(counter + 1, self.iters)
        shifted = torch.cat([proto[:, :, 1:], proto[:, :, -1:]], 2)
        base = torch.where(counter >= self.iters, shifted, proto)
        slot = torch.clamp_max(counter, self.iters - 1)
        old = torch.gather(proto, 2, slot.long().reshape(1, 1, 1).expand(
            proto.shape[0], proto.shape[1], 1))[:, :, 0]
        m = ((old * batch).sum(1) / (safe_l2_norm(old, 1) * safe_l2_norm(
            batch, 1)).clamp_min(1e-8))[:, None]
        new = torch.where(exist[:, None], old * m + batch * (1 - m), old)
        at = torch.arange(self.iters, device=proto.device) == slot
        return torch.where(at, new[:, :, None], base), counter

    def post(self, feats, maps):
        return [self.head_out(torch.cat([f, a], -1)) for f, a in zip(feats, maps)]

    def forward(self, feats, proto, counter, mode, targets=None,
                generator=None):
        feats = [self.head_in(f) for f in feats]
        if mode == "source":
            return self._source(feats, proto, counter, targets, generator)
        if mode == "target":
            return self._target(feats, proto, counter, generator)
        _, maps = self.act_maps(feats, self.kernels(proto.float()))
        return self.post(feats, maps), {}, maps, (proto, counter)

    def _source(self, feats, proto, counter, t, generator):
        locs = locations([(f.shape[1], f.shape[2]) for f in feats],
                         self.strides, feats[0].device)
        labels, _, n_pts = fcos_targets(locs, t["boxes"], t["labels"], t["mask"])
        act_labels = list(torch.split(labels, n_pts, 1))
        sel, ff, lf = [], [], []
        for f, lab in zip(feats, act_labels):
            ll = lab.reshape(-1)
            pos = ll > 0
            sel.append(pos | even_subset(~pos, pos.sum()))
            ff.append(f.reshape(-1, f.shape[-1]))
            lf.append(ll)
        nodes, nl, nv = gather_nodes(torch.cat(ff), torch.cat(lf),
                                     torch.cat(sel), self.max_nodes)
        node_loss, batch = self.gcns(nodes, nl, nv, generator)
        proto, counter = self.update(proto, counter, batch, self.exist(nl, nv))
        logits, maps = self.act_maps(feats, self.kernels(proto))
        act = softmax_focal_loss(
            torch.cat([m.reshape(-1, self.nc) for m in logits]),
            torch.cat([l.reshape(-1) for l in act_labels]))
        losses = {"node_loss": node_loss,
                  "act_loss": self.w["ACT_LOSS_WEIGHT"] * act}
        return self.post(feats, maps), losses, maps, (proto, counter)

    def _target(self, feats, proto, counter, generator):
        _, maps = self.act_maps(feats, self.kernels(proto))
        sel, ff, pf = [], [], []
        for f, a in zip(feats, maps):
            fl = f.reshape(-1, f.shape[-1])
            fg = a.reshape(-1, a.shape[-1])[:, 1:]
            n_loc = fl.shape[0]
            cand = fg.t().reshape(-1)
            k = min(self.max_cand, cand.shape[0])
            top, ti = torch.topk(torch.where(cand > self.thr, cand,
                                             torch.full_like(cand, -1.0)), k)
            cv = top > 0
            li = ti % n_loc
            pts = fl[li] * top[:, None] * cv[:, None].float()
            keep = dbscan_keep(pts, cv, self.eps)
            conf = torch.zeros(n_loc, dtype=torch.int32, device=f.device
                               ).index_add_(0, li, keep.to(torch.int32)) > 0
            sel.append(conf | even_subset(~conf, conf.sum()))
            ff.append(fl)
            pl = torch.argmax(fg, -1).to(torch.int32) + 1
            pf.append(torch.where(conf, pl, torch.zeros_like(pl)))
        nodes, nl, nv = gather_nodes(torch.cat(ff), torch.cat(pf),
                                     torch.cat(sel), self.max_nodes)
        out = self.post(feats, maps)
        _, tg = self.gcns(nodes, nl, nv, generator)
        sr = proto.detach().mean(-1)
        exist = self.exist(nl, nv)
        parts = []
        if "NODES" in self.transfer:
            tgt = torch.softmax(sr[nl.clamp(0, sr.shape[0] - 1).long()], -1)
            kl = tgt * (torch.log(tgt.clamp_min(1e-12))
                        - torch.log_softmax(nodes, -1))
            m = nv[:, None].float()
            parts.append((kl * m).sum() / (m.sum() * kl.shape[1]).clamp_min(1.0))
        if "ADJ" in self.transfer:
            pm = exist[:, None] & exist[None, :]
            a, b = sim_matrix(sr, sr), sim_matrix(tg, tg)
            a = torch.where(pm, a, torch.zeros_like(a))
            b = torch.where(pm, b, torch.zeros_like(b))
            a, b = a.reshape(-1), b.reshape(-1)
            parts.append(1.0 - torch.dot(a, b) / (
                safe_l2_norm(a) * safe_l2_norm(b)).clamp_min(1e-8))
        gate = nv.any().float()
        losses = {"transfer_loss": self.w["CON_LOSS_WEIGHT"] * sum(parts) * gate}
        return out, losses, maps, (proto, counter)


# ---------------------------------------------------------- discriminators
class DisGA(nn.Module):
    def __init__(self, n, cin, lambd):
        super().__init__()
        self.lambd = lambd
        self.dis_tower = ConvTower(n, cin, 256)
        self.cls_logits = Conv(256, 1)

    def forward(self, f, target, sm, act):
        return bce_with_logits(self.cls_logits(self.dis_tower(
            grl(f, self.lambd))), target).mean()


class DisCA(DisGA):
    """Center-aware: the feature weighted by sigmoid(w * max_c p_cls * p_ctr)
    before the GRL (``ca_feature``)."""

    def __init__(self, n, cin, lambd, weight):
        super().__init__(n, cin, lambd)
        self.weight = weight

    def forward(self, f, target, sm, act):
        att = torch.sigmoid(self.weight * torch.sigmoid(sm[0].detach()).amax(
            -1, keepdim=True) * torch.sigmoid(sm[2].detach()))
        return super().forward(att * f, target, sm, act)


class DisCon(nn.Module):
    """CKA: a shared 4-conv tower, then per foreground class a 3x3 conv over
    cat(tower, act_map_c), ReLU and a 3x3 conv to one logit; the BCE
    weighted by the detached act map and normalised by its mass."""

    def __init__(self, n, nc, lambd):
        super().__init__()
        self.lambd, self.nfg = lambd, nc - 1
        self.dis_tower = ConvTower(n, 256, 256)
        for c in range(self.nfg):
            self.add_module(f"classifier_cls_{c}_0", Conv(257, 128))
            self.add_module(f"classifier_cls_{c}_1", Conv(128, 1))

    def forward(self, f, target, sm, act):
        x = self.dis_tower(grl(f, self.lambd))
        act = grl(act, self.lambd)
        total = 0.0
        for c in range(self.nfg):
            a = act[..., c + 1:c + 2]
            h = F.relu(getattr(self, f"classifier_cls_{c}_0")(
                torch.cat([x, a], -1)))
            logit = getattr(self, f"classifier_cls_{c}_1")(h)
            w = a.detach()
            total = total + (bce_with_logits(logit, target) * w).sum() / (
                w.sum().clamp_min(1e-6))
        return total / self.nfg


# ---------------------------------------------------------------- detector
class Detector(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        m, adv = cfg["MODEL"], cfg["MODEL"]["ADV"]
        self.cfg = cfg
        body_name = m["BACKBONE"]["CONV_BODY"]
        if body_name.startswith("VGG-16"):
            body, feats = VGG16(), (2, 3, 4)
        else:
            r = m["RESNETS"]
            body = ResNet(101 if "101" in body_name else 50,
                          r["RES2_OUT_CHANNELS"], r["STEM_OUT_CHANNELS"],
                          m["BACKBONE"]["FREEZE_CONV_BODY_AT"])
            feats = (1, 2, 3)
        ch = m["RESNETS"]["BACKBONE_OUT_CHANNELS"] if body_name.startswith(
            "R-") else 256
        self.backbone = Backbone(body, FPN(body.channels, feats, ch))
        self.nc = m["FCOS"]["NUM_CLASSES"]
        self.strides = m["FCOS"]["FPN_STRIDES"]
        self.condgraph_on = m["MIDDLE_HEAD"]["CONDGRAPH_ON"]
        if self.condgraph_on:
            self.middle_head = CondGraph(cfg)
            self.register_buffer("prototype", torch.zeros(
                self.nc, m["MIDDLE_HEAD"]["PROTO_CHANNEL"],
                m["MIDDLE_HEAD"]["PROTO_ITER"]))
            self.register_buffer("proto_counter",
                                 torch.tensor(-1, dtype=torch.int32))
        f = m["FCOS"]
        self.fcos = FCOSHead(self.nc, ch, f["NUM_CONVS_CLS"],
                             f["NUM_CONVS_REG"], f["PRIOR_PROB"],
                             f["REG_CTR_ON"])
        self.gamma, self.alpha = f["LOSS_GAMMA"], f["LOSS_ALPHA"]
        self.mean = torch.tensor(cfg["INPUT"]["PIXEL_MEAN"])
        self.std = torch.tensor(cfg["INPUT"]["PIXEL_STD"])
        self.need_maps = adv["USE_DIS_CENTER_AWARE"] or adv["USE_DIS_OUT"]
        if adv["USE_DIS_OUT"] or adv["GRL_APPLIED_DOMAIN"] != "both":
            raise NotImplementedError("reference: OUT or one-domain GRL")
        if adv["USE_DIS_CENTER_AWARE"] and adv["CENTER_AWARE_TYPE"] != "ca_feature":
            raise NotImplementedError("reference: CENTER_AWARE_TYPE")
        if adv["USE_DIS_CON"] and adv["CON_FUSUIN_CFG"] != "concat":
            raise NotImplementedError("reference: CON_FUSUIN_CFG")
        self.dis = []  # (name, level, family, lambda)
        for lvl, p in enumerate(LEVELS):
            if not adv[f"USE_DIS_{p}"]:
                continue
            if adv["USE_DIS_GLOBAL"]:
                self._dis(f"dis_{p}", lvl, adv["GA_DIS_LAMBDA"], DisGA(
                    adv[f"DIS_{p}_NUM_CONVS"], ch, adv[f"GRL_WEIGHT_{p}"]))
            if adv["USE_DIS_CENTER_AWARE"]:
                self._dis(f"dis_{p}_CA", lvl, adv["CA_DIS_LAMBDA"], DisCA(
                    adv[f"CA_DIS_{p}_NUM_CONVS"], ch,
                    adv[f"CA_GRL_WEIGHT_{p}"], adv["CENTER_AWARE_WEIGHT"]))
            if adv["USE_DIS_CON"] and adv[f"USE_DIS_{p}_CON"]:
                self._dis(f"dis_{p}_CON", lvl, adv["CON_DIS_LAMBDA"], DisCon(
                    adv[f"CON_NUM_SHARED_CONV_{p}"], self.nc,
                    adv[f"GRL_WEIGHT_{p}"]))

    def _dis(self, name, lvl, lambd, module):
        self.add_module(name, module)
        family = name.split("_")[2] if name.count("_") > 1 else "GA"
        self.dis.append((name, lvl, family, lambd))

    def prep(self, images):
        """uint8 RGB NHWC -> BGR * 255 - mean, / std."""
        x = images.float().flip(-1)
        return (x - self.mean.to(x.device)) / self.std.to(x.device)

    def forward_train(self, proto, counter, images, targets, mode,
                      forward_target=False, generator=None):
        feats = self.backbone(self.prep(images))
        losses, maps = {}, None
        if self.condgraph_on:
            mh = mode if (mode == "source" or forward_target) else "inference"
            feats, mhl, maps, (proto, counter) = self.middle_head(
                feats, proto, counter, mh,
                targets if mode == "source" else None, generator)
            losses.update(mhl)
        sm = None
        if mode == "source" or self.need_maps:
            sm = self.fcos(feats)
        if mode == "source":
            locs = locations([(f.shape[1], f.shape[2]) for f in feats],
                             self.strides, images.device)
            losses.update(fcos_losses(locs, *sm, targets["boxes"],
                                      targets["labels"], targets["mask"],
                                      self.gamma, self.alpha))
        return losses, feats, maps, sm, (proto, counter)

    def dis_losses(self, feats, maps, sm, target, suffix):
        out = {}
        for name, lvl, family, lambd in self.dis:
            s = None if sm is None else [m[lvl] for m in sm]
            a = None if maps is None else maps[lvl]
            out[f"loss_adv_{LEVELS[lvl]}_{family}_{suffix}"] = lambd * getattr(
                self, name)(feats[lvl], target, s, a)
        return out

    @torch.no_grad()
    def forward_inference(self, images, sizes, pp):
        feats = self.backbone(self.prep(images))
        feats, _, maps, _ = self.middle_head(
            feats, self.prototype, self.proto_counter, "inference")
        cls, reg, ctr = self.fcos(feats)
        mixed = [0.5 * torch.sigmoid(c) + 0.5 * a[..., 1:]
                 for c, a in zip(cls, maps)]
        locs = locations([(f.shape[1], f.shape[2]) for f in feats],
                         self.strides, images.device)
        return postprocess(pp, locs, mixed, reg, ctr, sizes)


# ------------------------------------------------------------- postprocess
def _rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def postprocess(pp, locs, cls, reg, ctr, sizes):
    """Per level: candidates above INFERENCE_TH, the top PRE_NMS_TOP_N by
    cls * ctr, boxes decoded and clipped; then the top NMS_CAP, per-class
    greedy NMS at NMS_TH, the top DETECTIONS_PER_IMG, score sqrt(cls * ctr).
    ``pp``: thresh, top_n, nms, cap, per_img."""
    b, nc = cls[0].shape[0], cls[0].shape[-1]
    sizes = sizes.float()
    all_b, all_s, all_l, all_v = [], [], [], []
    for loc, c, r, t in zip(locs, cls, reg, ctr):
        c, r, t = c.reshape(b, -1, nc), r.reshape(b, -1, 4), t.reshape(b, -1)
        ranked = torch.where(c > pp["thresh"], c * torch.sigmoid(t)[..., None],
                             torch.full_like(c, NEG_INF)).reshape(b, -1)
        k = min(pp["top_n"], ranked.shape[1])
        top, ti = torch.topk(ranked, k, -1)
        li, cl = ti // nc, ti % nc + 1
        xy, rr = loc[li], _rows(r, li)
        bx = torch.stack([xy[..., 0] - rr[..., 0], xy[..., 1] - rr[..., 1],
                          xy[..., 0] + rr[..., 2], xy[..., 1] + rr[..., 3]], -1)
        w, h = (sizes[:, 1] - 1)[:, None], (sizes[:, 0] - 1)[:, None]
        zero = torch.zeros((), device=bx.device)
        bx = torch.stack([torch.minimum(torch.maximum(bx[..., 0], zero), w),
                          torch.minimum(torch.maximum(bx[..., 1], zero), h),
                          torch.minimum(torch.maximum(bx[..., 2], zero), w),
                          torch.minimum(torch.maximum(bx[..., 3], zero), h)], -1)
        all_b.append(bx)
        all_s.append(top.clamp(min=0.0))
        all_l.append(cl)
        all_v.append(top > NEG_INF / 2)
    boxes, scores = torch.cat(all_b, 1), torch.cat(all_s, 1)
    labels, valid = torch.cat(all_l, 1), torch.cat(all_v, 1)
    cap = min(pp["cap"], boxes.shape[1])
    ki = torch.topk(torch.where(valid, scores, torch.full_like(scores, NEG_INF)),
                    cap, -1).indices
    boxes, scores = _rows(boxes, ki), torch.gather(scores, 1, ki)
    labels, valid = torch.gather(labels, 1, ki), torch.gather(valid, 1, ki)
    keep = greedy_nms(boxes, scores, labels, valid, pp["nms"])
    n = min(pp["per_img"], keep.shape[1])
    top, ti = torch.topk(torch.where(keep, scores, torch.full_like(
        scores, NEG_INF)), n, -1)
    ok = top > NEG_INF / 2
    lab = torch.gather(labels, 1, ti)
    return {"boxes": _rows(boxes, ti), "scores": torch.sqrt(top.clamp(min=0.0)),
            "labels": torch.where(ok, lab, torch.zeros_like(lab)), "valid": ok}


def greedy_nms(boxes, scores, labels, valid, thr):
    """Per image, in descending score order (stable): keep a box unless a
    kept box of its label overlaps it by IoU > thr ('+1' areas)."""
    bx, sc = boxes.cpu().numpy(), scores.cpu().numpy()
    lb, vd = labels.cpu().numpy(), valid.cpu().numpy()
    keep = np.zeros_like(vd)
    thr = np.float32(thr)
    for i in range(bx.shape[0]):
        order = np.argsort(-np.where(vd[i], sc[i], NEG_INF), kind="stable")
        b = bx[i][order]
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        kept = []
        for j in range(len(order)):
            if not vd[i][order[j]]:
                continue
            if kept:
                kb = np.asarray(kept)
                iw = np.clip(np.minimum(b[kb, 2], b[j, 2]) - np.maximum(
                    b[kb, 0], b[j, 0]) + 1, 0, None)
                ih = np.clip(np.minimum(b[kb, 3], b[j, 3]) - np.maximum(
                    b[kb, 1], b[j, 1]) + 1, 0, None)
                inter = iw * ih
                iou = inter / (area[kb] + area[j] - inter)
                same = lb[i][order[kb]] == lb[i][order[j]]
                if np.any(same & (iou > thr)):
                    continue
            kept.append(j)
        keep[i, order[kept]] = True
    return torch.from_numpy(keep).to(boxes.device)
