"""Semantic prototype state (counterpart of ``scan_tpu/modeling/condgraph/prototype.py``).

The buffer of shape (C_used, channel[, PROTO_ITER]) and its step counter
(reference ``condgraph.py:180-184``). Inference reads it only; the EMA
updates of training belong to a later slice.
"""

from typing import NamedTuple

import torch


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
