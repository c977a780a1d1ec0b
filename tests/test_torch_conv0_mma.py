"""The arithmetic of the redesigned kernels K3 (``csrc/conv0.cu``) and K1
(``csrc/nms.cu``), on the CPU.

K3's epilogue has no division and no conversion instruction. Each of its
steps is written here in plain PyTorch float32 exactly as the kernel
computes it, and proved exhaustively against what it replaces:
- the s32 -> f32 conversion by the magic number 1.5 * 2**23, over every
  |acc| <= 27 * 128 * 127 (the largest sum of the 3x3x3 conv);
- the round to bf16, against ``.to(torch.bfloat16)``: on the bits (the exact
  path) and by Veltkamp's split (the common path), for every exponent and
  upper 7 mantissa bits with the lower halves that decide the rounding;
- the guarded requant: p = sat(y * r / 128) * 128 with r = 1 / s1 computed
  once in float32, the IEEE division taken only where p is within 2**-14 of
  a half-integer, rint by the magic add of 2**23, against
  ``clip(round(y / s1))`` for every non-negative finite bf16 y and ~200
  seeded scales s1 in [1e-8, 100], among them 1/127 and powers of two (whose
  products land on exact half-integers);
- the whole epilogue from any float y (negatives and denormals too) below
  the common path's bound, against the plain epilogue;
- the per-launch check: where the unguarded path agrees with the division
  on the 1,280 bf16 values the kernel tries, it agrees on all of them.
K3's GEMM: the new weight pack reads back to the quantized weights, and an
im2col in the kernel's K order (3 rows x 4 pixel words of 4 bytes)
contracted with it is ``conv_s32`` exactly; with the emulated epilogue it
gives ``conv0_s8_plain``'s bytes.

K1's chunked greedy scan is emulated in numpy on the plain suppression
bitmask, both scans: the one for K <= 2048 (a word of "removed" a lane) and
the pieced one for any K (chunk rows staged in pieces of 64 rows x 64
words); each must equal ``nms_sorted_plain`` and, up to K = 1000,
``scan_tpu``'s ``nms_pallas_sorted`` in interpret mode; K = 2049 and 4200
(33 and 66 words: past the small scan's 32, and two pieces for the first
chunks) run the pieced scan only.

The kernels themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.ops.pallas.nms_kernel import nms_pallas_sorted
from scan_tpu_torch.ops.cuda import conv0_kernel, nms_kernel
from scan_tpu_torch.ops.quant import conv_s32, prepare_weight, quantize_weight
from scan_tpu_torch.structures.boxes import box_iou

F32 = torch.float32
MAGIC22 = torch.tensor(12582912.0, dtype=F32)  # 1.5 * 2**23
MAGIC23 = torch.tensor(8388608.0, dtype=F32)   # 2**23
GUARD = torch.tensor(0.5 - 2.0 ** -14, dtype=F32)
SIGMA = torch.tensor(65537.0, dtype=F32)       # Veltkamp's 2**16 + 1
ACC_MAX = 27 * 128 * 127


# ---- K3's epilogue, step by step as csrc/conv0.cu computes it ----------
# float32 ops in torch round like the card's __fmul_rn/__fadd_rn; where the
# kernel writes an FMA (128 ps + c) the product is exact, so one rounding
# of a separate multiply and add is the same.

def s32_to_f32(acc):
    """The accumulators start at 0x4B400000: ``bits - 12582912.f``."""
    return (acc.to(torch.int32) + 0x4B400000).view(F32) - MAGIC22


def bf16_round_bits(y):
    """The exact path: ``u += 0x7FFF + ((u >> 16) & 1); u &= 0xFFFF0000``."""
    u = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(F32)


def bf16_round_veltkamp(y):
    """The common path: g = (2**16 + 1) y; g + (y - g)."""
    g = y * SIGMA
    return g + (y - g)


def quant_fast(y, s1):
    """The common path's byte of y and its distance from a half-integer
    test: ps = sat(y * r / 128), t = 2**23 + rint(128 ps)."""
    r128 = torch.reciprocal(s1) * torch.tensor(1 / 128, dtype=F32)
    ps = torch.clamp(y * r128, 0.0, 1.0)
    t = ps * 128.0 + MAGIC23
    d = ps * 128.0 - (t - MAGIC23)
    q = torch.clamp_max(t.view(torch.int32), 0x4B00007F) - 0x4B000000
    return q, d.abs() >= GUARD


def quant_exact(y, s1):
    """The exact path's quantize of y = relu(bf16(.)): IEEE division."""
    t = torch.clamp_max(y / s1, 128.0) + MAGIC23
    return torch.clamp_max(t.view(torch.int32), 0x4B00007F) - 0x4B000000


def requant(y, s1, guard=True):
    """y >= 0 float32 (bf16 values) and s1 float32 -> the output byte."""
    q, near = quant_fast(y, s1)
    return torch.where(near, quant_exact(y, s1), q) if guard else q


def epilogue(acc, scale, bias, s1):
    """The kernel's byte of an s32 sum (the common path where it is valid,
    else the exact one)."""
    y = s32_to_f32(acc) * scale + bias
    q, near = quant_fast(bf16_round_veltkamp(y), s1)
    exact = quant_exact(torch.clamp_min(bf16_round_bits(y), 0.0), s1)
    return torch.where(near, exact, q).to(torch.int8)


def plain_byte(y, s1):
    """``conv0_s8_plain``'s epilogue from y = acc * scale + bias."""
    y = torch.clamp_min(y.to(torch.bfloat16).to(F32), 0.0)
    return torch.clamp(torch.round(y / s1), -127, 127).to(torch.int8)


def _float_classes(sign=False):
    """Every exponent x every upper 7 mantissa bits x the lower halves that
    decide a round to bf16 (round bit, sticky bits): each bf16 value and
    each rounding case once, denormals included."""
    e = torch.arange(0, 255, dtype=torch.int64)
    mh = torch.arange(0, 128, dtype=torch.int64)
    lows = torch.tensor([0x0000, 0x0001, 0x4000, 0x7FFF, 0x8000, 0x8001,
                         0xC000, 0xFFFF], dtype=torch.int64)
    bits = (e[:, None, None] << 23 | mh[None, :, None] << 16
            | lows[None, None]).reshape(-1)
    if sign:
        bits = torch.cat([bits, bits | 1 << 31])
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(F32)


def _all_nonneg_bf16():
    """Every non-negative finite bf16 value, as float32."""
    return torch.arange(0, 0x7F80, dtype=torch.int16).view(
        torch.bfloat16).to(F32)


def _scales():
    rng = np.random.RandomState(0)
    seeded = 10.0 ** rng.uniform(-8, 2, 200)
    special = [1 / 127, 1e-8, 100.0, 1.0, 3.0, 5.0, 6.0, 7.0, 10.0, 0.1,
               1 / 3, 2 / 3, 0.37, 0.9, 0.8, 0.31]
    powers = [2.0 ** e for e in range(-26, 7)]
    return torch.tensor(np.concatenate([seeded, special, powers]), dtype=F32)


def test_magic_s32_to_f32_is_exact_over_the_conv_range():
    acc = torch.arange(-ACC_MAX, ACC_MAX + 1, dtype=torch.int32)
    assert ACC_MAX < 2 ** 22
    assert torch.equal(s32_to_f32(acc), acc.to(F32))


def test_bf16_round_on_bits_equals_torch():
    y = _float_classes(sign=True)
    y = y[torch.isfinite(y)]
    want = y.to(torch.bfloat16).to(F32)
    got = bf16_round_bits(y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the lower halves cover every (round bit, sticky bits) case at each
    # upper half, and bit 16 comes from the upper half: the whole float32
    # range rounds as torch does
    assert bool(torch.isinf(got).any())  # overflow past bf16's max as well


def test_bf16_round_by_veltkamp_equals_torch():
    """Veltkamp's split rounds to nearest on 8 bits (Dekker's theorem, for
    binary floats without overflow); where that leaves a choice, on exact
    ties, every tie of a normal float is in the classes (its lower 16 bits
    are 0x8000) and must round to even. Normal |y| < 2**110, the kernel's
    common path; a seeded sample of random floats besides."""
    y = _float_classes(sign=True)
    gen = torch.Generator().manual_seed(0)
    rand = torch.randint(-2 ** 31, 2 ** 31, (1 << 22,), generator=gen,
                         dtype=torch.int64).to(torch.int32).view(F32)
    y = torch.cat([y, rand])
    normal = (y.abs() >= 2.0 ** -126) & (y.abs() < 2.0 ** 110)
    y = y[normal]
    want = y.to(torch.bfloat16).to(F32)
    got = bf16_round_veltkamp(y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ties = (y.view(torch.int32) & 0xFFFF) == 0x8000
    assert int(ties.sum()) >= 2 * 236 * 128  # exponents 1..236, both signs


def test_epilogue_from_any_float_equals_plain():
    """From y = acc * scale + bias to the byte, the common path with its
    guard equals the plain epilogue for every float class below the
    common path's bound 2**110, negatives and denormals included, at
    scales across the range."""
    y = _float_classes(sign=True)
    y = y[y.abs() < 2.0 ** 110]
    for s in (1e-8, 1 / 127, 0.03, 1.0, 3.0, 7.0, 1e3, 1e20, 2.0 ** 90):
        s1 = torch.tensor(s, dtype=F32)
        q, near = quant_fast(bf16_round_veltkamp(y), s1)
        exact = quant_exact(torch.clamp_min(bf16_round_bits(y), 0.0), s1)
        got = torch.where(near, exact, q).to(torch.int8)
        assert torch.equal(got, plain_byte(y, s1)), s


def test_guarded_requant_is_exact_for_every_bf16_and_scale():
    y = _all_nonneg_bf16()
    scales = _scales()
    n_guarded = n_unguarded_miss = 0
    for s in scales:
        s1 = torch.clamp_min(s, 1e-8).reshape(())
        want = torch.clamp(torch.round(y / s1), -127, 127).to(torch.int32)
        got = requant(y, s1)
        assert torch.equal(got, want), float(s1)
        n_guarded += int(quant_fast(y, s1)[1].sum())
        n_unguarded_miss += int((requant(y, s1, guard=False) != want).sum())
    total = len(scales) * y.numel()
    # the guard band is needed, and it is narrow
    assert n_unguarded_miss > 0
    assert 0 < n_guarded < 1e-3 * total


# a scale at which the division-free path without its guard gives one byte
# other than the division's (y = 0.10400390625): the kernel keeps the guard
GUARDED_S1 = 0.0099051333963871


def _window(s1):
    """The bf16 values the kernel tries for s1: the 10 binades from s1's
    exponent - 2 to + 7."""
    e1 = int(s1.view(torch.int32)) >> 23 & 0xFF
    i = torch.arange(10 * 128)
    e = e1 - 2 + i // 128
    bits = (e << 7 | i % 128) << 16
    return bits[(e >= 0) & (e < 255)].to(torch.int32).view(F32)


def test_scale_check_decides_the_guard():
    """The kernel leaves the guard out when the unguarded path agrees with
    the division on the window of 1,280 bf16 values: then it agrees on
    every non-negative finite bf16 value. Of 2,000 seeded scales in
    [1e-8, 100], 1 needs the guard; of the chosen ones, 7.0, 0.9 (whose
    products land on half-integers more often) and the one chosen for it."""
    y = _all_nonneg_bf16()
    rng = np.random.RandomState(1)
    seeded = torch.tensor(10.0 ** rng.uniform(-8, 2, 2000), dtype=F32)
    chosen = torch.cat([_scales()[200:], torch.tensor([GUARDED_S1],
                                                      dtype=F32)])
    needs_guard = {"seeded": [], "chosen": []}
    for kind, scales in (("seeded", seeded), ("chosen", chosen)):
        for s in scales:
            s1 = torch.clamp_min(s, 1e-8).reshape(())
            yw = _window(s1)
            window_ok = torch.equal(requant(yw, s1, guard=False),
                                    quant_exact(yw, s1))
            all_ok = torch.equal(requant(y, s1, guard=False),
                                 quant_exact(y, s1))
            assert window_ok == all_ok, float(s1)
            if not window_ok:
                needs_guard[kind].append(float(s1))
    assert len(needs_guard["seeded"]) == 1, needs_guard
    f32 = lambda v: torch.tensor(v, dtype=F32).item()  # noqa: E731
    assert needs_guard["chosen"] == [f32(7.0), f32(0.9), f32(GUARDED_S1)]


# ---- K3's GEMM: the pack and the K order --------------------------------

def _conv0_data(b, h, w, seed):
    rng = np.random.RandomState(seed)
    x_q = torch.from_numpy(rng.randint(-128, 128, (b, h, w, 3)).astype(np.int8))
    w0 = torch.from_numpy((rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32))
    b0 = torch.from_numpy((rng.randn(64) * 0.5).astype(np.float32))
    return x_q, w0, b0


def _im2col_k3(x_q):
    """(B, H, W, 3) s8 -> (B*H*W, 64) in the kernel's K order: word 4 ky +
    kx is input pixel (y + ky - 1, x + kx - 1) as bytes (c0, c1, c2, 0),
    kx = 0..3 (the kernel reads a real pixel at kx = 3; its weight is 0),
    ky = 3 is zero."""
    b, h, w, _ = x_q.shape
    xp = np.zeros((b, h + 2, w + 3, 4), np.int64)
    xp[:, 1:h + 1, 1:w + 1, :3] = x_q.numpy()
    cols = np.zeros((b, h, w, 4, 4, 4), np.int64)
    for ky in range(3):
        for kx in range(4):
            cols[:, :, :, ky, kx] = xp[:, ky:ky + h, kx:kx + w]
    return cols.reshape(b * h * w, 64)


def test_k3_pack_reads_back():
    _, w0, _ = _conv0_data(1, 1, 1, 3)
    wk, w_scale = conv0_kernel.pack_weight(w0)
    w_q, w_scale_want = quantize_weight(w0)
    assert wk.dtype == torch.int32 and wk.shape == (64, 16)
    assert wk.is_contiguous()
    assert torch.equal(w_scale, w_scale_want)
    by = wk.view(torch.int8).reshape(64, 4, 4, 4)  # [co][ky][kx][byte]
    assert torch.equal(by[:, :3, :3, :3].permute(1, 2, 3, 0), w_q)
    assert not by[:, 3].any() and not by[:, :, 3].any()
    assert not by[..., 3].any()


@pytest.mark.parametrize("b,h,w", [(1, 5, 7), (2, 9, 20)])
def test_k3_pack_contracts_to_conv_s32(b, h, w):
    x_q, w0, _ = _conv0_data(b, h, w, b * h + w)
    wk, _ = conv0_kernel.pack_weight(w0)
    got = _im2col_k3(x_q) @ wk.view(torch.int8).reshape(64, 64).numpy(
    ).astype(np.int64).T
    want = conv_s32(x_q, prepare_weight(*quantize_weight(w0)), (1, 1),
                    ((1, 1), (1, 1)))
    assert np.array_equal(got.reshape(b, h, w, 64), want.numpy())
    assert np.abs(got).max() <= ACC_MAX


@pytest.mark.parametrize("s1", [0.9 * 0.1, 1 / 127, 1e-3, 2.0 ** -5])
def test_k3_emulated_kernel_equals_plain(s1):
    """The kernel's K order and its epilogue, step by step, give the plain
    version's bytes (small s1 saturates at 127; 2**-5 puts many products
    on exact half-integers)."""
    b, h, w = 2, 11, 19
    x_q, w0, b0 = _conv0_data(b, h, w, 11)
    s0, s1 = torch.tensor(0.31), torch.tensor(s1, dtype=F32)
    wk, w_scale = conv0_kernel.pack_weight(w0)
    acc = torch.from_numpy(_im2col_k3(x_q) @ wk.view(torch.int8).reshape(
        64, 64).numpy().astype(np.int64).T).to(torch.int32)
    got = epilogue(acc, w_scale * s0, b0, s1).reshape(b, h, w, 64)
    want = conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1)
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < want.numel()


# ---- K1's chunked greedy scan --------------------------------------------

def _suppression_bits(boxes, valid, labels, thr):
    """The mask pass's bitmask, from the plain suppression matrix: row i
    has bit j when i would suppress j (IoU > thr, same label, both valid,
    j > i); (K, words) Python ints of 64 bits."""
    k = boxes.shape[0]
    sup = box_iou(boxes, boxes, plus_one=True) > torch.tensor(thr, dtype=F32)
    if labels is not None:
        sup &= labels[:, None] == labels[None, :]
    sup &= torch.ones((k, k), dtype=torch.bool).triu(1)
    sup &= valid[:, None] & valid[None, :]
    words = (k + 63) // 64
    padded = np.zeros((k, words * 64), bool)
    padded[:, :k] = sup.numpy()
    weights = 1 << np.arange(64, dtype=np.uint64)
    packed = (padded.reshape(k, words, 64) * weights).sum(-1, dtype=np.uint64)
    return [[int(v) for v in row] for row in packed]


def _small_scan(mask, valid):
    """csrc/nms.cu::nms_scan_small_kernel (K <= 2048): lane w holds word w
    of "removed"."""
    k = len(valid)
    words = (k + 63) // 64
    full = (1 << 64) - 1
    removed = [0] * words
    keep = np.zeros(k, bool)
    for c in range(words):
        rows = range(64 * c, min(64 * c + 64, k))
        vword = sum(1 << (i - 64 * c) for i in rows if valid[i])
        cur = removed[c] | (~vword & full)
        for r, i in enumerate(rows):  # every lane, redundantly
            if not (cur >> r) & 1:
                cur |= mask[i][c]
        kept = ~cur & full
        for w in range(c + 1, words):  # lanes w > c, in parallel
            for r, i in enumerate(rows):
                if (kept >> r) & 1:
                    removed[w] |= mask[i][w]
        for r, i in enumerate(rows):
            keep[i] = (kept >> r) & 1
    return keep


def _chunked_scan(mask, valid):
    """csrc/nms.cu::nms_scan_kernel (any K): "removed" is one word a chunk,
    starting as the invalid rows and the rows past K; chunk c's rows are
    staged in pieces of 64 words from word c, the first holding the
    diagonal word the walk reads; every piece's words right of the chunk
    are ORed into "removed" over the kept rows, by 4 row groups of 16."""
    k = len(valid)
    words = (k + 63) // 64
    full = (1 << 64) - 1
    removed = []
    for c in range(words):
        rows = range(64 * c, min(64 * c + 64, k))
        vword = sum(1 << (i - 64 * c) for i in rows if valid[i])
        removed.append(~vword & full)
    keep = np.zeros(k, bool)
    for c in range(words):
        rows = list(range(64 * c, min(64 * c + 64, k)))
        pieces = (words - c + 63) // 64
        for p in range(pieces):
            w0 = c + 64 * p
            piece = [[mask[i][w] for w in range(w0, min(w0 + 64, words))]
                     for i in rows]
            if p == 0:  # warp 0's walk on the diagonal words (column 0)
                cur = removed[c]
                for r in range(len(rows)):
                    if not (cur >> r) & 1:
                        cur |= piece[r][0]
                kept = ~cur & full
                for r, i in enumerate(rows):
                    keep[i] = (kept >> r) & 1
            groups = [range(16 * g, 16 * g + 16) for g in range(4)]
            for j in range(len(piece[0])):  # thread (g, j)
                w = w0 + j
                if w <= c:
                    continue
                for group in groups:
                    acc = 0
                    for r in group:
                        if r < len(rows) and (kept >> r) & 1:
                            acc |= piece[r][j]
                    removed[w] |= acc
    return keep


def _sorted_set(seed, k, n_labels):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, min(300, 20 + 2 * k), (k, 2))  # overlaps at any K
    wh = rng.uniform(10, 90, (k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    valid = rng.uniform(0, 1, k) >= 0.2
    labels = rng.randint(1, n_labels + 1, k).astype(np.int32)
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    return boxes[order], valid[order], labels[order]


@pytest.mark.parametrize("k", [1, 63, 64, 65, 512, 1000, 2049, 4200])
@pytest.mark.parametrize("use_labels", [False, True])
def test_chunked_scan_equals_plain_and_pallas(k, use_labels):
    boxes, valid, labels = _sorted_set(k + use_labels, k, 4)
    labels = labels if use_labels else None
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    tl = None if labels is None else torch.from_numpy(labels)
    bits = _suppression_bits(tb, tv, tl, 0.5)
    got = _chunked_scan(bits, valid)
    plain = nms_kernel.nms_sorted_plain(
        tb[None], tv[None], None if tl is None else tl[None], 0.5)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    if k <= 2048:  # the scan the kernel runs there
        np.testing.assert_array_equal(_small_scan(bits, valid), plain)
    if k <= 1000:  # the interpreted Pallas scan is slow past that
        pallas = np.asarray(nms_pallas_sorted(
            jnp.asarray(boxes), jnp.asarray(valid),
            None if labels is None else jnp.asarray(labels), 0.5,
            interpret=True))
        np.testing.assert_array_equal(got, pallas)
    if k >= 64:
        assert 0 < got.sum() < valid.sum(), "the set must suppress something"
