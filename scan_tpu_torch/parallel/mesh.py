"""Process-group setup and comm helpers (counterpart of
``scan_tpu/parallel/mesh.py``).

The reference scales with per-module DDP over NCCL (reference
``tools/train_net_da.py:421-515``, ``utils/comm.py``). ``scan_tpu`` shards one
jitted step over a 1-D device mesh inside a process. The port runs one
process per card (``torch.distributed.run``), each with its own device, and
averages gradients, metrics and batch prototypes in one all-reduce a step
(``engine/dp.py``). In place of the mesh helpers: ``shard_batch`` takes a
rank's contiguous slice of the global batch, ``rank_part`` takes a batch
the loader made for the rank alone (marked ``RANK_SLICE``) as it is, and
``broadcast_module`` copies rank 0's parameters and buffers to every rank.
"""

import contextlib
import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("scan_tpu_torch.mesh")


def maybe_init_distributed(enable: bool = False, device="cuda",
                           init_method=None, rank=None, world_size=None,
                           timeout_s: float = 1800.0) -> bool:
    """Start the default process group (reference
    ``tools/train_net_da.py:698-703``) when ``enable`` (``--distributed``) or
    ``SCAN_TPU_DISTRIBUTED=1`` asks for it. Returns whether a group is up.

    Rank, world size and local rank come from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or from the caller's ``init_method``, ``rank`` and
    ``world_size``. The backend is NCCL for a ``cuda`` device and gloo for
    the CPU; on the card each rank binds ``cuda:LOCAL_RANK`` first.

    When the caller asked for distributed mode, a failed init raises:
    training on one process after a failed init would be a wrong run, not
    a fallback. A group that is already up is left as it is.
    """
    if not (enable or os.environ.get("SCAN_TPU_DISTRIBUTED") == "1"):
        return False
    if dist.is_initialized():
        logger.warning("torch.distributed is already initialised")
        return True
    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method,
                      rank=int(os.environ["RANK"] if rank is None else rank),
                      world_size=int(os.environ["WORLD_SIZE"]
                                     if world_size is None else world_size))
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    logger.info("process group: %s, rank %d of %d", backend, dist.get_rank(),
                dist.get_world_size())
    return True


@contextlib.contextmanager
def process_group(enable: bool = False, device="cuda"):
    """``maybe_init_distributed`` for the block; a group started here is
    destroyed at its end."""
    was_up = dist.is_available() and dist.is_initialized()
    up = maybe_init_distributed(enable, device)
    try:
        yield up
    finally:
        if up and not was_up:
            dist.destroy_process_group()


def check_split(world: int, **batch_sizes):
    """Raise unless every named batch size splits evenly over ``world``
    processes (``SOLVER.IMS_PER_BATCH=8``)."""
    for name, n in batch_sizes.items():
        if n % world:
            raise ValueError(f"{name}={n} does not split over {world} "
                             "processes")


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous slice of a global batch dict (arrays or
    tensors with the batch first). The batch must split evenly."""
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % world:
            raise ValueError(f"batch entry {k!r} of {n} does not split over "
                             f"{world} processes")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out


# The key that marks a batch a loader made for one rank alone (its value:
# (rank, world)): the rank's slots of the global batch, already sliced.
RANK_SLICE = "rank_slice"


def rank_part(batch: dict, rank: int, world: int) -> dict:
    """This rank's part of a batch: a batch marked ``RANK_SLICE`` (the
    loader made only this rank's slots) as it is, without the mark; an
    unmarked global batch sliced by ``shard_batch``. A batch marked for
    another rank or world raises."""
    mark = batch.get(RANK_SLICE)
    if mark is None:
        return shard_batch(batch, rank, world)
    if tuple(mark) != (rank, world):
        raise ValueError(f"a batch made for rank {mark[0]} of {mark[1]} "
                         f"reached rank {rank} of {world}")
    return {k: v for k, v in batch.items() if k != RANK_SLICE}


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Copy rank ``src``'s parameters and buffers to every rank."""
    if get_world_size() == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        data = t.data.view(torch.uint8) if t.dtype == torch.bool else t.data
        dist.broadcast(data, src=src)
    return module


# --------------------------------------------------------------------- #
# comm-style helpers (reference fcos_core/utils/comm.py:13-60)
# --------------------------------------------------------------------- #
def get_world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def get_rank() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank()


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize():
    """Barrier across processes (reference comm.synchronize)."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather(data):
    """Every rank's picklable ``data``, in rank order (reference
    comm.all_gather); ``[data]`` on one process."""
    world = get_world_size()
    if world == 1:
        return [data]
    out = [None] * world
    dist.all_gather_object(out, data)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def reduce_loss_dict(loss_dict):
    """The mean of each scalar loss over the ranks, for logging (reference
    engine/trainer.py:76-98). The DP step already averages its metrics in
    its one all-reduce, so the loop does not call this; on one process the
    values pass through."""
    world = get_world_size()
    if world == 1:
        return loss_dict
    names = sorted(loss_dict)
    vals = torch.stack([torch.as_tensor(loss_dict[k], dtype=torch.float32)
                        for k in names])
    if dist.get_backend() == "nccl":
        vals = vals.cuda()
    dist.all_reduce(vals)
    return dict(zip(names, vals / world))
