"""Greedy (ML-)NMS over score-sorted boxes: kernel K1 and its plain version.

Counterpart of ``scan_tpu/ops/pallas/nms_kernel.py::nms_pallas_sorted``.
``nms_sorted`` launches ``csrc/nms.cu`` for CUDA tensors and runs
``nms_sorted_plain`` for CPU tensors; it never falls back from one to the
other. The source note in ``csrc/nms.cu`` says what bounds the kernel and
how its bitmask design answers it.
"""

import contextlib
import ctypes

import torch

from ...structures.boxes import box_iou
from . import build

# The scan's shared memory holds 64 KB of staged mask pieces and the
# "removed" bitset, 8 bytes a 64 rows: K <= 64 * ((232448 - 65536) // 8 - 1)
# (``scan_nms_max_k`` in ``csrc/nms.cu``). The (B, K, ceil(K / 64)) bitmask
# in device memory, 8 B K^2 / 64 bytes, runs out long before.
MAX_K = 1_335_232


def nms_sorted_plain(boxes, valid, labels, iou_threshold: float,
                     plus_one: bool = True):
    """Plain PyTorch greedy NMS: the suppression matrix, then a for loop over
    the rows in score order (``scan_tpu/ops/nms.py:64-73``), batched over
    the leading dimension.

    boxes (B, K, 4) f32, valid (B, K) bool, labels (B, K) int or None.
    Returns keep (B, K) bool in the sorted order.
    """
    k = boxes.shape[-2]
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    sup = box_iou(boxes, boxes, plus_one=plus_one) > thr
    if labels is not None:
        sup = sup & (labels[..., :, None] == labels[..., None, :])
    later = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    sup = sup & later
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        keep_i = valid[:, i] & ~suppressed[:, i]
        suppressed = suppressed | (keep_i[:, None] & sup[:, i])
    return valid & ~suppressed


def _lib():
    lib = build.load("nms")
    fn = lib.scan_nms_sorted
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _on(device):
    """The device's context, or none when it is already the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def nms_sorted(boxes, valid, labels, iou_threshold: float,
               plus_one: bool = True):
    """Greedy NMS over boxes already sorted by descending score.

    boxes (B, K, 4) f32; valid (B, K) bool; labels (B, K) int or None.
    Returns keep (B, K) bool in the sorted order. CPU tensors take the plain
    version; CUDA tensors launch kernel K1 or raise. Labels of int32 or
    int64 go to the kernel as they are.
    """
    if boxes.device.type == "cpu":
        return nms_sorted_plain(boxes, valid, labels, iou_threshold, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_sorted: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"nms_sorted: boxes must be (B, K, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    b, k = boxes.shape[:2]
    if valid.shape != (b, k) or valid.dtype != torch.bool:
        raise ValueError("nms_sorted: valid must be (B, K) bool")
    if k > MAX_K:
        raise ValueError(f"nms_sorted: K={k} exceeds {MAX_K}, the most the "
                         "scan's shared memory holds")
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    label_bytes = 0
    if labels is not None:
        if labels.shape != (b, k):
            raise ValueError("nms_sorted: labels must be (B, K)")
        if labels.dtype not in (torch.int32, torch.int64):
            labels = labels.to(torch.int32)
        labels = labels.contiguous()
        label_bytes = labels.element_size()
    # one allocation: the (B, K, words) bitmask, then the (B, K) keep flags
    words = (k + 63) // 64
    buf = torch.empty(b * k * (8 * words + 1), dtype=torch.uint8,
                      device=boxes.device)
    keep = buf[b * k * 8 * words:].view(torch.bool).view(b, k)
    if b == 0 or k == 0:
        return keep
    with _on(boxes.device):
        err = _lib()(
            boxes.data_ptr(), valid.data_ptr(),
            labels.data_ptr() if labels is not None else None, label_bytes,
            b, k, float(iou_threshold), int(plus_one), buf.data_ptr(),
            keep.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    nms_sorted.launches += 1
    return keep


nms_sorted.launches = 0
