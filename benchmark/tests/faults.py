"""Faults planted under the timed path, for the tests that show the
comparison catches them. A DA fault wraps the step (``faults(det, opt,
step) -> step``), an evaluation fault alters the detector in place."""

import dataclasses
import sys
import types

import torch


def state_unchanged(det, opt, step):
    """A step that computes everything and returns the parameters and the
    prototype state as they were."""
    def faulty(state, batch_s, batch_t, **kw):
        params = [p.detach().clone() for p in det.parameters()]
        _, metrics = step(state, batch_s, batch_t, **kw)
        with torch.no_grad():
            for p, q in zip(det.parameters(), params):
                p.copy_(q)
            if state is not None:
                det.load_proto_state(state)
        return state, metrics
    return faulty


def half_batch(det, opt, step):
    """A step on the first half of each domain's batch alone, its losses
    the means over that half."""
    def faulty(state, batch_s, batch_t, **kw):
        half = batch_s["images"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch_s.items()},
                    {k: v[:half] for k, v in batch_t.items()}, **kw)
    return faulty


def altered_answers(det):
    """The forward's first ten detections an image come out moved right
    by their own width."""
    inner = det.forward_inference

    def faulty(images, sizes):
        out = inner(images, sizes)
        b = out["boxes"][:, :10]
        b[..., 0::2] += (b[..., 2] - b[..., 0])[..., None]
        return out

    det.forward_inference = faulty


def half_answers(det):
    """The forward runs on the first half of each batch alone; the other
    half's images come back with no detection."""
    inner = det.forward_inference

    def faulty(images, sizes):
        half = images.shape[0] // 2
        out = inner(images[:half], sizes[:half])
        rest = images.shape[0] - half
        return {k: torch.cat([v, v.new_zeros((rest, *v.shape[1:]))])
                for k, v in out.items()}

    det.forward_inference = faulty


def no_nms(det):
    """K1 suppresses nothing: the postprocess's NMS threshold at IoU 1."""
    det.pp_cfg = dataclasses.replace(det.pp_cfg, nms_thresh=1.0)


class _NoExchange:
    """``torch.distributed`` as ``engine/dp`` sees it, its all-reduce a
    no-op."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    @staticmethod
    def all_reduce(*args, **kw):
        return None


def no_exchange(det, opt, step):
    """The data-parallel step with its all-reduce left out: each rank
    steps on its own slice's gradient (divided by the world size)."""
    import scan_tpu_torch.engine.dp as dp
    dp.dist = _NoExchange(dp.dist)
    return step


def loads_jax_off_rank0(det, opt, step):
    """Every rank but rank 0 loads a module named ``jax``."""
    import torch.distributed as dist
    if dist.get_rank() != 0:
        sys.modules["jax"] = types.ModuleType("jax")
    return step


DA_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
DP_FAULTS = dict(DA_FAULTS, no_exchange=no_exchange)
EVAL_FAULTS = {"altered_answers": altered_answers,
               "half_answers": half_answers, "no_nms": no_nms}
