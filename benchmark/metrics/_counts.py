"""Operations and bytes from shapes, and the card's published peaks.

Nothing here reads the system: the layer list is worked out from the
configuration file's settings at the cell's padded input size. A conv of
k x k over cin -> cout at stride s with 'same' padding, on an h x w input,
does 2 * ceil(h / s) * ceil(w / s) * cout * cin * k * k operations; a
linear layer 2 * rows * in * out. The backward of a layer that trains
counts twice its forward (the input's and the weight's gradients), once
where its input needs no gradient (the first layer above a frozen part),
and a frozen layer below every trained one counts nothing. Left out, as
they depend on the data: the graph nodes' attention and classifier, DBSCAN,
top-k and NMS; and every elementwise operation and norm.
"""

import math

# NVIDIA H100 SXM data sheet, dense: the fastest unit that holds a cell's
# stated precision (float32 cells: TF32 tensor cores)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12


def _up(n, s):
    return -(-n // s)


class Counter:
    """Accumulates (forward, backward) operations of one image's pass."""

    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0

    def conv(self, h, w, cin, cout, k=3, s=1, train=True, dgrad=True):
        f = 2.0 * _up(h, s) * _up(w, s) * cout * cin * k * k
        self.fwd += f
        if train:
            self.bwd += f * (2 if dgrad else 1)
        return _up(h, s), _up(w, s)

    def linear(self, rows, cin, cout, train=True):
        f = 2.0 * rows * cin * cout
        self.fwd += f
        if train:
            self.bwd += 2 * f


def levels(h, w):
    """(h, w) of P3..P7 for a /32-padded input."""
    out = [(h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32)]
    for _ in range(2):
        out.append((_up(out[-1][0], 2), _up(out[-1][1], 2)))
    return out


def vgg16(c, h, w, train):
    """C3..C5 channels; stages 1-2 frozen."""
    cin, idx = 3, 0
    for blocks, ch in zip((2, 2, 3, 3, 3), (64, 128, 256, 512, 512)):
        for _ in range(blocks):
            c.conv(h, w, cin, ch, train=train and idx >= 4,
                   dgrad=idx > 4)
            cin, idx = ch, idx + 1
        h, w = h // 2, w // 2
    return (256, 512, 512)


def resnet(c, h, w, train, depth=101, res2=256, stem=64):
    """C3..C5 channels; the stem and stage 1 frozen."""
    h, w = c.conv(h, w, 3, stem, 7, 2, train=False)
    h, w = _up(h, 2), _up(w, 2)  # max-pool 3, stride 2
    cin, cout, cb = stem, res2, res2 // 4
    for s, n in enumerate({50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth], 1):
        tr = train and s >= 2
        for b in range(n):
            stride = (1 if s == 1 else 2) if b == 0 else 1
            first = s == 2 and b == 0  # reads the frozen stage's output
            if cin != cout or stride != 1:
                c.conv(h, w, cin, cout, 1, stride, tr, dgrad=not first)
            h2, w2 = c.conv(h, w, cin, cb, 1, stride, tr, dgrad=not first)
            c.conv(h2, w2, cb, cb, 3, 1, tr)
            c.conv(h2, w2, cb, cout, 1, 1, tr)
            h, w, cin = h2, w2, cout
        cout, cb = cout * 2, cb * 2
    return (512, 1024, 2048)


def fpn(c, lv, chans, train, ch=256):
    for (h, w), cin in zip(lv[:3], chans):
        c.conv(h, w, cin, ch, 1, train=train)
        c.conv(h, w, ch, ch, 3, train=train)
    c.conv(*lv[2], ch, ch, 3, 2, train)
    c.conv(*lv[3], ch, ch, 3, 2, train)


def backbone(c, cfg, h, w, train):
    body = cfg["MODEL"]["BACKBONE"]["CONV_BODY"]
    if body.startswith("VGG-16"):
        chans = vgg16(c, h, w, train)
    else:
        r = cfg["MODEL"]["RESNETS"]
        chans = resnet(c, h, w, train, 101 if "101" in body else 50,
                       r["RES2_OUT_CHANNELS"], r["STEM_OUT_CHANNELS"])
    fpn(c, levels(h, w), chans, train)


def condgraph(c, cfg, lv, train):
    """head_in, the act maps' dynamic 1x1 conv, head_out; the prototype
    RNN and its 1x(ITER) projection."""
    mh = cfg["MODEL"]["MIDDLE_HEAD"]
    nc = cfg["MODEL"]["FCOS"]["NUM_CLASSES"]
    for h, w in lv:
        for i in range(mh["NUM_CONVS_IN"]):
            c.conv(h, w, 256, 256, train=train)
        c.linear(h * w, 256, nc, train)
        for i in range(mh["NUM_CONVS_OUT"]):
            c.conv(h, w, 256 + nc if i == 0 else 256, 256, train=train)
    it = mh["PROTO_ITER"]
    c.linear(nc * it, mh["PROTO_CHANNEL"], 512, train)
    c.linear(nc * it * 3, 512, 512, train)
    c.linear(nc, 512 * it, 256, train)


def fcos_head(c, cfg, lv, train):
    f = cfg["MODEL"]["FCOS"]
    for h, w in lv:
        for _ in range(f["NUM_CONVS_CLS"]):
            c.conv(h, w, 256, 256, train=train)
        for _ in range(f["NUM_CONVS_REG"]):
            c.conv(h, w, 256, 256, train=train)
        c.conv(h, w, 256, f["NUM_CLASSES"] - 1, train=train)
        c.conv(h, w, 256, 4, train=train)
        c.conv(h, w, 256, 1, train=train)


def discriminators(c, cfg, lv):
    adv = cfg["MODEL"]["ADV"]
    nc = cfg["MODEL"]["FCOS"]["NUM_CLASSES"]
    for (h, w), p in zip(lv, ("P3", "P4", "P5", "P6", "P7")):
        if not adv[f"USE_DIS_{p}"]:
            continue
        towers = []
        if adv["USE_DIS_GLOBAL"]:
            towers.append(adv[f"DIS_{p}_NUM_CONVS"])
        if adv["USE_DIS_CENTER_AWARE"]:
            towers.append(adv[f"CA_DIS_{p}_NUM_CONVS"])
        for n in towers:
            for _ in range(n):
                c.conv(h, w, 256, 256)
            c.conv(h, w, 256, 1)
        if adv["USE_DIS_CON"] and adv[f"USE_DIS_{p}_CON"]:
            for _ in range(adv[f"CON_NUM_SHARED_CONV_{p}"]):
                c.conv(h, w, 256, 256)
            for _ in range(nc - 1):
                c.conv(h, w, 257, 128)
                c.conv(h, w, 128, 1)


def da_step_flops(cfg, batch, h, w, forward_target=True):
    """Operations of one DA step of ``batch`` + ``batch`` images padded to
    h x w: both domains' passes, both domains' discriminators, their
    backward."""
    lv = levels(h, w)
    c = Counter()
    for domain in ("source", "target"):
        backbone(c, cfg, h, w, True)
        if cfg["MODEL"]["MIDDLE_HEAD"]["CONDGRAPH_ON"]:
            condgraph(c, cfg, lv, True)
        adv = cfg["MODEL"]["ADV"]
        if domain == "source" or adv["USE_DIS_CENTER_AWARE"] or adv["USE_DIS_OUT"]:
            fcos_head(c, cfg, lv, True)
        discriminators(c, cfg, lv)
    return batch * (c.fwd + c.bwd)


def eval_flops(cfg, batch, h, w):
    """Operations of one evaluation forward of ``batch`` images."""
    lv = levels(h, w)
    c = Counter()
    backbone(c, cfg, h, w, False)
    if cfg["MODEL"]["MIDDLE_HEAD"]["CONDGRAPH_ON"]:
        condgraph(c, cfg, lv, False)
    fcos_head(c, cfg, lv, False)
    return batch * c.fwd


def stem_bound_s(batch, h, w, dtype):
    """The least time of one K2 launch (VGG16's stage 1: conv 3->64, ReLU,
    conv 64->64, ReLU, 2x2 max-pool) on ``batch`` images of h x w: its
    operations over the dtype's peak, or its bytes (the float32 input read
    once, the weights, the pooled output written once) over the HBM's."""
    ops = 2.0 * batch * h * w * 64 * (27 + 576)
    out_bytes = 4 if dtype == "float32" else 2
    nbytes = (batch * h * w * 3 * 4 + (27 + 576 + 2) * 64 * 4
              + batch * (h // 2) * (w // 2) * 64 * out_bytes)
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def share(bound_s, measured_s):
    """A roofline or peak share in %, None where nothing was measured."""
    if not measured_s or not math.isfinite(measured_s):
        return None
    return 100.0 * bound_s / measured_s
