"""The DA training step (counterpart of ``scan_tpu/engine/train_step.py``).

Parity target: reference ``fcos_core/engine/trainer.py:241-424``, which runs
three ``backward()`` calls (G-source with retain_graph, D-source,
D-target + GST) and then steps every optimizer once. Each optimizer steps
once per iteration, so the gradient is that of the sum of the loss terms,
and the step is one ``backward()`` over

    L = L_G(source) + sum_l L_D(source, l)
        + sum_l L_D(target, l) + [forward_target] (L_GST + L_node_tg)

with the gradient-reversal layers giving the adversarial sign, then one
optimizer step and one scheduler step. ``forward_target`` (the AP50 gate,
reference trainer.py:350) selects which subgraphs exist, a Python bool per
call. The step has no host round trip on the card: the prototype state and
the metrics stay device tensors.

In bfloat16 (``TPU.COMPUTE_DTYPE``) the step computes in bf16 over float32
master weights, as ``scan_tpu``'s does: the detector is built with
``build_detector(..., train=True)``, which keeps every parameter float32,
so the gradients, the SGD update and its momentum are float32.

Data parallelism (``scan_tpu``'s ``axis_name`` and ``_fused_pmean``) lives in
``engine/dp.py``: its steps are these with a ``reduce`` hook, which
averages the gradients, the metrics and the batch prototype over the
processes between the backward and the optimizer step.
"""

import numpy as np
import torch

from ..modeling.condgraph.prototype import ProtoState


def _check_trainable(detector):
    if detector.int8_inference:
        raise NotImplementedError("an int8 detector does not train")
    low = sorted(k for k, p in detector.named_parameters()
                 if p.dtype != torch.float32)
    if low:
        raise ValueError(
            f"{len(low)} parameters are not float32 (e.g. {low[0]}): a "
            "detector built for evaluation holds bf16 parameters; build it "
            "with build_detector(..., train=True) to train on float32 "
            "masters")


def _on(batch, device):
    """A batch dict's arrays as tensors on ``device`` (tensors already
    there pass unchanged)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, non_blocking=True)
        for k, v in batch.items()}


def _targets(batch):
    return {k: batch[k] for k in ("boxes", "labels", "mask")}


def _apply(detector, optimizer, scheduler, total, metrics, new_proto,
           reduce):
    """One backward, the ``reduce`` hook (data parallelism), one optimizer
    and scheduler step; the new prototype state goes into the detector's
    buffers. Returns the (detached) prototype state and metrics, as
    ``reduce`` left them."""
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    if new_proto is not None:  # None without the condgraph
        new_proto = ProtoState(new_proto.prototype.detach(), new_proto.counter)
    if reduce is not None:
        metrics, new_proto = reduce(optimizer, metrics, new_proto)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    if new_proto is not None:
        detector.load_proto_state(new_proto)
    return new_proto, metrics


def make_da_train_step(detector, optimizer, scheduler=None, reduce=None):
    """Returns ``train_step(proto_state, batch_s, batch_t,
    forward_target=False, generator=None) -> (proto_state, metrics)``.

    batch_s: ``images`` (B, H, W, 3) uint8 or normalised float, ``sizes``,
    ``boxes`` (B, G, 4), ``labels`` (B, G), ``mask`` (B, G); batch_t:
    ``images``. Numpy arrays or tensors. ``generator`` (a ``torch.Generator``
    on the detector's device) draws the condgraph MHA's dropout; without
    one the step is deterministic. The metrics are device scalars named as
    ``scan_tpu``'s: ``*_gs``, ``loss_adv_{P}_{FAMILY}_{ds|dt}``, ``*_gt``,
    ``loss_total``. The new prototype state is returned and also stored in
    the detector's buffers, which inference reads. ``reduce(optimizer,
    metrics, proto_state) -> (metrics, proto_state)`` runs between the
    backward and the optimizer step (``engine/dp.py``)."""
    _check_trainable(detector)
    device = next(detector.parameters()).device

    def loss_fn(proto_state, batch_s, batch_t, forward_target, generator):
        metrics = {}
        # ---- (1) G on source ----
        losses_s, feats_s, act_s, score_maps_s, new_proto = \
            detector.forward_train(proto_state, batch_s["images"],
                                   _targets(batch_s), "source",
                                   generator=generator)
        metrics.update({k + "_gs": v for k, v in losses_s.items()})
        # ---- (2) D on source ----
        d_src = detector.discriminator_losses(feats_s, act_s, score_maps_s,
                                              1.0, "source")
        metrics.update(d_src)
        # ---- (3) target: GST (gated) + D ----
        d_tgt, losses_t = {}, {}
        if detector.cfg.MODEL.DA_ON:
            losses_t, feats_t, act_t, score_maps_t, _ = detector.forward_train(
                new_proto, batch_t["images"], None, "target",
                forward_target=forward_target, generator=generator)
            metrics.update({k + "_gt": v for k, v in losses_t.items()})
            d_tgt = detector.discriminator_losses(feats_t, act_t,
                                                  score_maps_t, 0.0, "target")
            metrics.update(d_tgt)
        total = sum(losses_s.values())
        total = total + sum(d_src.values()) + sum(d_tgt.values())
        total = total + sum(losses_t.values())
        metrics["loss_total"] = total
        return total, metrics, new_proto

    def train_step(proto_state, batch_s, batch_t, forward_target=False,
                   generator=None):
        total, metrics, new_proto = loss_fn(
            proto_state, _on(batch_s, device), _on(batch_t, device),
            bool(forward_target), generator)
        return _apply(detector, optimizer, scheduler, total, metrics,
                      new_proto, reduce)

    return train_step


def make_source_only_train_step(detector, optimizer, scheduler=None,
                                reduce=None):
    """The plain (non-DA) step (reference trainer.py:153-240,
    ``tools/train_net.py``): ``train_step(proto_state, batch,
    generator=None) -> (proto_state, metrics)``."""
    _check_trainable(detector)
    device = next(detector.parameters()).device

    def train_step(proto_state, batch, generator=None):
        batch = _on(batch, device)
        losses, _, _, _, new_proto = detector.forward_train(
            proto_state, batch["images"], _targets(batch), "source",
            generator=generator)
        total = sum(losses.values())
        losses["loss_total"] = total
        return _apply(detector, optimizer, scheduler, total, losses,
                      new_proto, reduce)

    return train_step
