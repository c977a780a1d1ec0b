#!/usr/bin/env python3
"""Time kernels K1 (NMS) and K3 (conv1_1 + requant) of two checkouts of the
port on one CUDA card, in turns.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a gitignored directory, e.g.
``build/parent``). The trees are run one after another, each in its own
process that imports that tree's ``scan_tpu_torch`` and builds its kernels
into that tree's ``build/``; give them in turns (parent, change, change,
parent) so that drift on the card shows. For each tree, on the same seeded
inputs:
  * K1 at (4, 512), 8 labels (int64, as the postprocess makes them): the
    wrapper ``nms_sorted`` timed with CUDA events over back-to-back calls,
    and the raw launch on prepared buffers captured in a CUDA graph (the
    device's time, without the host's); keep masks equal to the plain
    version's; the same at (2, 1000) and (2, 2000) without labels at IoU
    0.7, the two-stage detector's proposal NMS;
  * K3 at (4, 800, 1344): the wrapper ``conv0_s8`` on a packed weight, timed
    with CUDA events, at an s1 set from the conv's range and at one that
    needs K3's guard band; bytes equal to the plain version's.
The card's name and power limit are printed first; one JSON line per tree
follows, and the results go to ``chiprun_out/kernel_ab.json``.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# an s1 at which K3's division-free products disagree with the division on
# one bf16 value, so that its guarded kernel does the work
GUARDED_S1 = 0.0099051333963871


def measure(tree):
    """Run in a child process: the numbers of one tree."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import scan_tpu_torch
    from scan_tpu_torch.ops import quant
    from scan_tpu_torch.ops.cuda import conv0_kernel, nms_kernel

    assert Path(scan_tpu_torch.__file__).resolve().parents[1] == \
        Path(tree).resolve(), scan_tpu_torch.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # this checkout's timers, for every tree
    cuda_time, graph_ms = smoke.cuda_time, smoke.graph_ms

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    res = {"tree": tree}

    # ---- K1 ----
    bsz, k = 4, 512
    xy = torch.rand(bsz, k, 2, generator=g) * 600
    wh = torch.rand(bsz, k, 2, generator=g) * 120 + 8
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(bsz, k, generator=g)
    valid = torch.rand(bsz, k, generator=g) > 0.2
    labels = torch.randint(1, 9, (bsz, k), generator=g)
    order = torch.sort(-torch.where(valid, scores, torch.tensor(-1e10)),
                       stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).to(dev)
    valid = torch.gather(valid, 1, order).to(dev)
    labels = torch.gather(labels, 1, order).to(dev)
    want = nms_kernel.nms_sorted_plain(boxes, valid, labels, 0.6)
    got = nms_kernel.nms_sorted(boxes, valid, labels, 0.6)
    assert torch.equal(got, want), "K1 disagrees with its plain version"
    res["k1_wrapper_ms"] = cuda_time(
        lambda: nms_kernel.nms_sorted(boxes, valid, labels, 0.6), 200)

    lib = nms_kernel._lib()
    words = (k + 63) // 64
    mask = torch.empty((bsz, k, words), dtype=torch.int64, device=dev)
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    if len(lib.argtypes) == 11:  # labels read as they are, with their width
        lab = labels.contiguous()
        head = (lab.data_ptr(), lab.element_size())
    else:  # the earlier interface: int32 labels, cast once here
        lab = labels.to(torch.int32).contiguous()
        head = (lab.data_ptr(),)

    def k1_raw():
        err = lib(boxes.data_ptr(), valid.data_ptr(), *head, bsz, k, 0.6, 1,
                  mask.data_ptr(), keep.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"nms: CUDA error {err}"
    res["k1_graph_ms"] = graph_ms(k1_raw)
    assert torch.equal(keep, want), "K1's raw launch disagrees"

    # K1 at the RPN's K, B = 2, no labels, IoU 0.7 (the two-stage detector's
    # proposal NMS at its published PRE_NMS_TOP_N_TEST / _TRAIN)
    for kk in (1000, 2000):
        xy = torch.rand(2, kk, 2, generator=g) * 600 * (kk / 512) ** 0.5
        wh = torch.rand(2, kk, 2, generator=g) * 120 + 8
        bx = torch.cat([xy, xy + wh], -1)
        vd = torch.rand(2, kk, generator=g) > 0.2
        order = torch.sort(-torch.where(vd, torch.rand(2, kk, generator=g),
                                        torch.tensor(-1e10)),
                           stable=True).indices
        bx = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4)).to(dev)
        vd = torch.gather(vd, 1, order).to(dev)
        w_ = (kk + 63) // 64
        mk = torch.empty((2, kk, w_), dtype=torch.int64, device=dev)
        kp = torch.empty((2, kk), dtype=torch.bool, device=dev)
        nolab = (None, 0) if len(lib.argtypes) == 11 else (None,)

        def raw_k(bx=bx, vd=vd, kk=kk, mk=mk, kp=kp):
            err = lib(bx.data_ptr(), vd.data_ptr(), *nolab, 2, kk, 0.7, 1,
                      mk.data_ptr(), kp.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"nms: CUDA error {err}"
        res[f"k1_graph_ms_B2_K{kk}"] = graph_ms(raw_k)
        assert torch.equal(kp, nms_kernel.nms_sorted_plain(bx, vd, None, 0.7))
        res[f"k1_wrapper_ms_B2_K{kk}"] = cuda_time(
            lambda: nms_kernel.nms_sorted(bx, vd, None, 0.7), 100)

    # ---- K3 ----
    b, h, w = 4, 800, 1344
    x_q = torch.randint(-127, 128, (b, h, w, 3), generator=g).to(
        torch.int8).to(dev)
    w0 = (torch.randn(3, 3, 3, 64, generator=g) * 0.2).to(dev)
    b0 = (torch.randn(64, generator=g) * 0.5).to(dev)
    s0 = torch.tensor(0.02, device=dev)
    # s1 from the conv's own range, as calibration would set it
    acc = quant.conv_s32(x_q[:1], quant.prepare_weight(
        *quant.quantize_weight(w0)), (1, 1), ((1, 1), (1, 1)))
    y = acc.float() * (quant.quantize_weight(w0)[1] * s0) + b0
    s1 = torch.clamp_min(y.amax(), 1e-8) / 127
    del acc, y
    packed = conv0_kernel.pack_weight(w0)
    got = conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1, packed=packed)
    want = conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1)
    res["k3_mismatches"] = int((got != want).sum())
    res["k3_nonzero_share"] = float((want != 0).float().mean())
    assert res["k3_mismatches"] == 0, "K3 disagrees with its plain version"
    del got, want
    res["k3_ms"] = cuda_time(
        lambda: conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1, packed=packed), 20)
    # a scale at which the division-free path needs its guard band
    s1g = torch.tensor(GUARDED_S1, device=dev)
    got = conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1g, packed=packed)
    want = conv0_kernel.conv0_s8_plain(x_q, w0, b0, s0, s1g)
    res["k3_guarded_mismatches"] = int((got != want).sum())
    assert res["k3_guarded_mismatches"] == 0, "K3 disagrees at the guarded s1"
    del got, want
    res["k3_guarded_ms"] = cuda_time(
        lambda: conv0_kernel.conv0_s8(x_q, w0, b0, s0, s1g, packed=packed), 20)
    return res


def main(argv):
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_ab.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
