"""Data-parallel train steps over a process group (counterpart of
``scan_tpu/engine/dp.py`` and the data-parallel branch of
``scan_tpu/engine/train_step.py``).

Parity target: the reference wires per-module DDP into its entry point
(reference ``tools/train_net_da.py:421-515,698-703``); its DA path is in
practice single-GPU because the prototype buffer never syncs. ``scan_tpu``
shards one jitted step over a device mesh and pmeans the gradients and the
batch prototypes. Here each process (one per card, ``torch.distributed.run``)
takes its contiguous slice of the global batch (the loaders of
``data/build.py`` decode only that slice and mark the batch
``RANK_SLICE``, which passes as it is), runs the forward and the
backward on it, and then **one** all-reduce averages a flat float32
vector holding every gradient, the float metrics and the batch prototype
(``scan_tpu``'s ``_fused_pmean``), before the optimizer steps. So the
gradient is per-replica-normalised then averaged, as under DDP, and the
prototype stays in sync, which the reference's does not.

``DistributedDataParallel`` is not used: it all-reduces the gradients
bucket by bucket and cannot carry the metrics and the prototype in the
same collective, and the ``forward_target=False`` variant leaves
parameters without a gradient, which DDP would have to find by an extra
traversal (``find_unused_parameters``).
"""

import torch
import torch.distributed as dist

from ..modeling.condgraph.prototype import ProtoState
from ..parallel.mesh import get_world_size, rank_part
# the plain steps are looked up on their module at call time, so a wrapper
# set there (a caller's instrumentation) wraps these steps too
from . import train_step as plain


class FusedMean:
    """The ``reduce`` hook of the steps: average every gradient of the
    optimizer's parameters, every float metric and the batch prototype over
    the group in one all-reduce of a flat float32 vector. The prototype's
    counter is not averaged. A parameter without a gradient on this rank
    (unused in a ``forward_target`` variant; which ones depends only on the
    variant and the config, so on no rank's data) counts as 0, as in
    ``scan_tpu``'s gradient tree, and keeps no gradient here.
    ``numel`` is the vector's length in the last call."""

    def __init__(self, group=None):
        self.group = group
        self.numel = 0

    def __call__(self, optimizer, metrics, proto):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        names = sorted(k for k, v in metrics.items()
                       if torch.is_floating_point(v))
        parts = [p.grad.reshape(-1).float() if p.grad is not None
                 else p.new_zeros(p.numel(), dtype=torch.float32)
                 for p in params]
        parts += [metrics[k].reshape(1).float() for k in names]
        if proto is not None:
            parts.append(proto.prototype.reshape(-1).float())
        flat = torch.cat(parts)
        self.numel = flat.numel()
        dist.all_reduce(flat, group=self.group)
        flat /= dist.get_world_size(self.group)
        off = 0
        for p in params:
            n = p.numel()
            if p.grad is not None:
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n
        metrics = dict(metrics)
        for k in names:
            metrics[k] = flat[off].to(metrics[k].dtype)
            off += 1
        if proto is not None:
            n = proto.prototype.numel()
            proto = ProtoState(flat[off:off + n].view_as(proto.prototype).to(
                proto.prototype.dtype), proto.counter)
        return metrics, proto


def _rank_generator(generator, rank: int):
    """The iteration's dropout generator with this rank folded into its
    seed (``scan_tpu``'s ``fold_in(rng, axis_index)``,
    ``train_step.py:119-121``): independent draws per replica."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    return g.manual_seed((generator.initial_seed() * 1_000_003 + rank + 1)
                         % (1 << 63))


def make_dp_da_train_step(detector, optimizer, scheduler=None, group=None):
    """The DA step over the process group, with the signature of
    ``make_da_train_step``'s: ``train_step(proto_state, batch_s, batch_t,
    forward_target=False, generator=None) -> (proto_state, metrics)``.
    A batch is either the global one, the same on every rank, of which
    each rank takes its slice, or one marked ``RANK_SLICE`` that a loader
    made for this rank alone, taken as it is (``rank_part``). The metrics
    and the prototype returned are the averages over the ranks. ``train_step.reduce`` is the all-reduce hook
    (its ``numel``, the flat vector's length)."""
    reduce = FusedMean(group)
    step = plain.make_da_train_step(detector, optimizer, scheduler,
                                   reduce=reduce)
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def train_step(proto_state, batch_s, batch_t, forward_target=False,
                   generator=None):
        return step(proto_state, rank_part(batch_s, rank, world),
                    rank_part(batch_t, rank, world),
                    forward_target=forward_target,
                    generator=_rank_generator(generator, rank))

    train_step.reduce = reduce
    return train_step


def make_dp_source_only_train_step(detector, optimizer, scheduler=None,
                                   group=None):
    """The source-only step over the process group: ``train_step(
    proto_state, batch, generator=None) -> (proto_state, metrics)``, each
    rank on its part of the batch (``rank_part``)."""
    reduce = FusedMean(group)
    step = plain.make_source_only_train_step(detector, optimizer, scheduler,
                                             reduce=reduce)
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def train_step(proto_state, batch, generator=None):
        return step(proto_state, rank_part(batch, rank, world),
                    generator=_rank_generator(generator, rank))

    train_step.reduce = reduce
    return train_step


def build_da_train_step(detector, optimizer, scheduler=None):
    """The data-parallel step when a process group of more than one rank
    is up, else the plain step unchanged."""
    if get_world_size() == 1:
        return plain.make_da_train_step(detector, optimizer, scheduler)
    return make_dp_da_train_step(detector, optimizer, scheduler)


def build_source_only_train_step(detector, optimizer, scheduler=None):
    if get_world_size() == 1:
        return plain.make_source_only_train_step(detector, optimizer,
                                                 scheduler)
    return make_dp_source_only_train_step(detector, optimizer, scheduler)
