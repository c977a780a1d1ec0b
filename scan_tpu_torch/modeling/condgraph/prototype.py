"""Semantic prototype state (counterpart of ``scan_tpu/modeling/condgraph/prototype.py``).

The buffer of shape (C_used, channel[, PROTO_ITER]) and its step counter
(reference ``condgraph.py:180-184, 558-617``), updated once per source
pass with a fixed or a cosine-similarity momentum:

  * PROTO_ITER == 1: a plain EMA on the classes present;
  * PROTO_ITER > 1 without the RNN: a cycling counter 0..ITER-1 selects the
    slice;
  * with the RNN: the counter saturates at ITER (0, 1, ..., ITER-1, ITER,
    ITER, ...); once saturated the buffer shifts left and the last slice is
    updated.

The state is passed in and returned, as in ``scan_tpu``; the counter stays
on the device, so the saturating branch is a ``torch.where`` on a device
scalar, not a host ``if``. The batch means enter detached, as
``stop_gradient`` makes them there.
"""

from typing import NamedTuple

import torch

from ..layers import safe_l2_norm


class ProtoState(NamedTuple):
    prototype: torch.Tensor  # (C_used, ch) or (C_used, ch, ITER)
    counter: torch.Tensor  # () int32


def init_proto_state(gen: torch.Generator, num_classes_used: int,
                     channels: int, proto_iter: int) -> ProtoState:
    """Standard-normal prototypes and counter -1, as ``scan_tpu`` starts."""
    shape = (num_classes_used, channels) if proto_iter == 1 else (
        num_classes_used, channels, proto_iter)
    return ProtoState(torch.randn(shape, generator=gen),
                      torch.tensor(-1, dtype=torch.int32))


def _blend(old_slice, batch, exist, cosine: bool, momentum: float):
    if cosine:
        dot = (old_slice * batch).sum(dim=1)
        denom = safe_l2_norm(old_slice, dim=1) * safe_l2_norm(batch, dim=1)
        m = (dot / denom.clamp_min(1e-8))[:, None]
    else:
        m = momentum
    new = old_slice * m + batch * (1 - m)
    return torch.where(exist[:, None], new, old_slice)


def update_prototype(state: ProtoState, prototype_batch, proto_iter: int,
                     use_rnn: bool, cosine: bool, momentum: float = 0.95,
                     exist=None) -> ProtoState:
    """``scan_tpu``'s ``update_prototype`` (``prototype.py:55-109``).
    ``exist`` marks the classes to update; by default the reference's
    ``prototype_batch.sum(-1) != 0``."""
    batch = prototype_batch.detach()
    if exist is None:
        exist = batch.sum(dim=-1) != 0
    proto = state.prototype
    if proto_iter == 1:
        return ProtoState(_blend(proto, batch, exist, cosine, momentum),
                          state.counter)
    if not use_rnn:
        counter = torch.remainder(state.counter + 1, proto_iter)
        return ProtoState(_update_slot(proto, proto, counter, batch, exist,
                                       cosine, momentum), counter)
    counter = torch.clamp_max(state.counter + 1, proto_iter)
    # saturated: shift the history left and update the last slice (whose
    # old value is the unshifted last slice); filling: update slice
    # ``counter`` in place
    shifted = torch.cat([proto[:, :, 1:], proto[:, :, -1:]], dim=2)
    base = torch.where(counter >= proto_iter, shifted, proto)
    slot = torch.clamp_max(counter, proto_iter - 1)
    return ProtoState(_update_slot(proto, base, slot, batch, exist, cosine,
                                   momentum), counter)


def _update_slot(proto, base, slot, batch, exist, cosine, momentum):
    """``base`` with slice ``slot`` (a device scalar) replaced by the blend
    of ``proto``'s slice ``slot`` and the batch means."""
    c, ch, iters = proto.shape
    idx = slot.long().reshape(1, 1, 1).expand(c, ch, 1)
    old_slice = torch.gather(proto, 2, idx)[:, :, 0]
    new_slice = _blend(old_slice, batch, exist, cosine, momentum)
    at = torch.arange(iters, device=proto.device) == slot
    return torch.where(at, new_slice[:, :, None], base)


def source_prototype_view(state: ProtoState, proto_iter: int):
    """The detached source prototype of the transfer losses (reference
    ``condgraph.py:459-460``): the mean over the ITER axis when 3-D."""
    p = state.prototype.detach()
    return p.mean(dim=-1) if proto_iter > 1 else p
