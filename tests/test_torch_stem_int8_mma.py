"""The arithmetic of kernel K5's conv1_1 (``csrc/stem_int8.cu``) on the CPU.

conv1_1 runs on the tensor cores (mma.sync m16n8k32 s8 -> s32) in K3's
fragment layout, and its requant, clip(rint(max(acc a0 + b0, 0) / s1), 0,
127), has no division per value: p = y * r with r = 1 / s1 rounded once,
rint by the magic add of 2**23, and the IEEE division only where p lies
within 2**-14 of a half-integer below 127 (or for every value where r is
not a normal float). Each step is written here in plain float32 exactly as
the kernel computes it, and proved against the plain version's division:
- over every float32 y in [s1 / 4, 128 s1] (below, both give 0; above,
  both 127: checked on samples) for round scales (0.9, 7, 1/127, 2**-5),
  the floor 1e-8, seeded ones and extreme ones (r near and below the
  smallest normal float);
- for 200 seeded scales, on every y whose quotient lies within 16 ulp of a
  half-integer, where a division-free rint could differ;
- without the guard, some scales give other bytes: the guard is needed.
The GEMM: K3's w0 pack with B's columns permuted (column n of n8 tile nt is
channel 16 (n >> 1) + 2 nt + (n & 1)) puts a lane's 16 channels of a pixel
in one 16-byte chunk, and an im2col of the halo in the kernel's K order
contracted with it is ``conv_s32`` exactly; with the emulated requant it
gives the plain version's conv1_1 bytes.

The kernel itself runs only on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from scan_tpu_torch.ops.cuda import stem_int8_kernel
from scan_tpu_torch.ops.quant import (clamp_scale, conv_s32, prepare_weight,
                                      quantize_weight)

F32 = torch.float32
MAGIC22 = torch.tensor(12582912.0, dtype=F32)  # 1.5 * 2**23
MAGIC23 = torch.tensor(8388608.0, dtype=F32)   # 2**23
GUARD = torch.tensor(0.5 - 2.0 ** -14, dtype=F32)
R_MIN = 2.0 ** -125  # below it the kernel divides every value
CH = 64


def requant1(y, s1, guard=True):
    """The kernel's byte of y = max(acc a0 + b0, 0), float32 y >= 0, s1 a
    float32 scalar: ``requant1`` in csrc/stem_int8.cu step by step. Float32
    ops in torch round as the card's __fmul_rn / __fadd_rn / __fdiv_rn, and
    torch.reciprocal gives __frcp_rn's value."""
    r = torch.reciprocal(s1)
    p = torch.clamp_max(y * r, 128.0)
    t = p + MAGIC23
    near = (p < 127.0) & ((p - (t - MAGIC23)).abs() >= GUARD)
    if not bool(r >= R_MIN):
        near = torch.ones_like(near)
    if guard:
        t = torch.where(near, torch.clamp_max(y / s1, 128.0) + MAGIC23, t)
    return torch.clamp_max(t.view(torch.int32), 0x4B00007F) - 0x4B000000


def plain_byte(y, s1):
    """``fused_stem_int8_plain``'s conv1_1 requant of y >= 0."""
    return torch.clamp(torch.round(y / s1), 0, 127).to(torch.int32)


def _bits(lo, hi):
    """Every float32 in [lo, hi] (both >= 0), in chunks of 2**22."""
    a = int(torch.tensor(lo, dtype=F32).view(torch.int32))
    b = int(torch.tensor(hi, dtype=F32).view(torch.int32))
    for start in range(a, b + 1, 1 << 22):
        yield torch.arange(start, min(start + (1 << 22), b + 1),
                           dtype=torch.int32).view(F32)


def _sweep(s1, guard=True):
    """Mismatches and guarded values over every float32 y in [s1 / 4,
    128 s1] (capped at the largest finite float)."""
    lo = float(s1) / 4
    hi = min(128 * float(s1), float(torch.finfo(F32).max))
    miss = guarded = total = 0
    for y in _bits(lo, hi):
        got = requant1(y, s1, guard)
        miss += int((got != plain_byte(y, s1)).sum())
        if guard:
            r = torch.reciprocal(s1)
            p = torch.clamp_max(y * r, 128.0)
            guarded += int(((p < 127.0) & ((p - ((p + MAGIC23) - MAGIC23))
                                           .abs() >= GUARD)).sum())
        total += y.numel()
    return miss, guarded, total


EXHAUSTIVE = {"round_0.9": 0.9, "round_7": 7.0, "1/127": 1 / 127,
              "2**-5": 2.0 ** -5, "floor_1e-8": 1e-8, "seeded_a": 0.0731,
              "seeded_b": 23.7, "r_near_min_normal": 3e37,
              "r_subnormal": 1e38}


@pytest.mark.parametrize("name", list(EXHAUSTIVE))
def test_requant_equals_division_for_every_float_that_matters(name):
    s1 = torch.tensor(EXHAUSTIVE[name], dtype=F32)
    miss, guarded, total = _sweep(s1)
    assert miss == 0, (name, miss)
    assert total > 1 << 23  # at least a whole binade
    if bool(torch.reciprocal(s1) >= R_MIN):
        assert guarded < 1e-3 * total  # the guard band is narrow
    # below s1 / 4 both give 0, above 128 s1 both 127: samples, 0 and inf
    gen = torch.Generator().manual_seed(len(name))
    low = torch.rand(1 << 16, generator=gen) * (float(s1) / 4)
    high = torch.tensor([128 * float(s1), 1e30, 3e38, float("inf")],
                        dtype=F32)
    high = high[high >= 128 * float(s1)]
    for y in (low, torch.zeros(4), high):
        assert torch.equal(requant1(y, s1), plain_byte(y, s1))


def _seeded_scales(n=200):
    rng = np.random.RandomState(0)
    return torch.tensor(10.0 ** rng.uniform(-8, 2, n), dtype=F32)


def test_requant_near_every_half_integer_for_seeded_scales():
    """For each seeded s1 and half-integer h = 0.5 .. 127.5, every float32
    y within 40 ulp of h s1 (so every y whose quotient lies within 16 ulp
    of h): the guarded path equals the division; the unguarded one does
    not everywhere."""
    h = torch.arange(0.5, 128.0, 1.0, dtype=torch.float64)
    offs = torch.arange(-40, 41, dtype=torch.int32)
    n_unguarded_miss = n_near = 0
    for s1 in _seeded_scales():
        y0 = (h * float(s1)).to(F32).view(torch.int32)
        y = (y0[:, None] + offs[None]).reshape(-1).view(F32)
        q = y.double() / float(s1)
        ulp = torch.tensor(2.0 ** -23, dtype=torch.float64) * \
            torch.exp2(torch.floor(torch.log2(q)))
        n_near += int(((q - h.repeat_interleave(81)).abs() <= 16 * ulp).sum())
        want = plain_byte(y, s1)
        assert torch.equal(requant1(y, s1), want), float(s1)
        n_unguarded_miss += int((requant1(y, s1, guard=False) != want).sum())
    assert n_near > 200 * 128 * 16  # the neighbourhoods are covered
    assert n_unguarded_miss > 0  # the guard band is needed


def test_requant_needs_its_guard():
    """Without the guard the division-free rint differs from the division
    on some float32 y at a round scale: the kernel keeps the band."""
    misses = {name: _sweep(torch.tensor(EXHAUSTIVE[name], dtype=F32),
                           guard=False)[0] for name in ("round_0.9", "round_7")}
    assert sum(misses.values()) > 0, misses


# ---- the GEMM: K3's w0 pack, B's columns permuted, K3's K order ----------

def _data(b, h, w, seed):
    rng = np.random.RandomState(seed)
    x_q = torch.from_numpy(rng.randint(-128, 128, (b, h, w, 3)).astype(np.int8))
    w0 = torch.from_numpy((rng.randn(3, 3, 3, CH) * 0.2).astype(np.float32))
    b0 = torch.from_numpy((rng.randn(CH) * 0.5).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(3, 3, CH, CH) * 0.05).astype(np.float32))
    return x_q, w0, b0, w1


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


def _column_channel():
    """(8 n8 tiles, 8 columns) -> the channel B's column holds."""
    nt, n = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    return 16 * (n >> 1) + 2 * nt + (n & 1)


def test_k5_b_permutation_puts_a_lanes_channels_in_one_chunk():
    chan = _column_channel()
    assert sorted(chan.reshape(-1).tolist()) == list(range(CH))
    for t in range(4):  # lane (g, t) holds columns 2t, 2t + 1 of each tile
        lane = [int(chan[nt, 2 * t + j]) for nt in range(8) for j in range(2)]
        assert lane == list(range(16 * t, 16 * t + 16))


@pytest.mark.parametrize("b,h,w", [(1, 18, 34), (2, 9, 20)])
def test_k5_conv1_1_gemm_equals_conv_s32(b, h, w):
    x_q, w0, _, w1 = _data(b, h, w, b * h + w)
    w0k = stem_int8_kernel.pack_weights(w0, w1)[0]
    assert w0k.dtype == torch.int32 and w0k.shape == (CH, 16)
    wb = w0k.view(torch.int8).reshape(CH, 64).numpy().astype(np.int64)
    chan = _column_channel().reshape(-1)
    tiles = _im2col_k3(x_q) @ wb[chan].T  # the GEMM's columns, permuted
    got = np.empty_like(tiles)
    got[:, chan] = tiles
    want = conv_s32(x_q, prepare_weight(*quantize_weight(w0)), (1, 1),
                    ((1, 1), (1, 1)))
    assert np.array_equal(got.reshape(b, h, w, CH), want.numpy())
    assert np.abs(got).max() <= 27 * 128 * 127 < 2 ** 22


@pytest.mark.parametrize("s1", [0.9, 7.0, 0.31, 2.0 ** -5])
def test_k5_emulated_conv1_1_equals_plain(s1):
    """The magic-number s32 -> f32, acc a0 + b0 in scan_tpu's order, the
    ReLU and the guarded requant give the plain version's conv1_1 bytes."""
    x_q, w0, b0, w1 = _data(2, 11, 19, 4)
    s0 = torch.tensor(0.31)
    s1 = torch.tensor(s1, dtype=F32)
    w0k, w0_s, _, _ = stem_int8_kernel.pack_weights(w0, w1)
    acc = torch.from_numpy(_im2col_k3(x_q) @ w0k.view(torch.int8).reshape(
        CH, 64).numpy().astype(np.int64).T).to(torch.int32)
    a0 = clamp_scale(s0, x_q) * w0_s
    y = (acc + 0x4B400000).view(F32) - MAGIC22
    y = torch.clamp_min(y * a0 + b0, 0.0)
    got = requant1(y, clamp_scale(s1, x_q))
    # the plain version's conv1_1 (fused_stem_int8_plain's first half)
    w0_q, _ = quantize_weight(w0)
    acc0 = conv_s32(x_q, prepare_weight(w0_q, w0_s), (1, 1),
                    ((1, 1), (1, 1)))
    yp = torch.clamp_min(acc0.float() * a0 + b0.float(), 0.0)
    want = torch.clamp(torch.round(yp / clamp_scale(s1, x_q)), 0, 127)
    assert torch.equal(got.reshape(want.shape), want.to(torch.int32))
    assert 0 < int((want != 0).sum()) < want.numel()
