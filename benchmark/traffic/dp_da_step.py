"""Traffic ``dp_da_step``: the DA step of ``engine/dp.make_dp_da_train_step``
over one process a card (NCCL; gloo on the CPU), the published global
batch split over the ranks, in a closed loop.

This process is rank 0; it starts the other ranks (``spawn``), each on
its own card. Every rank makes the same weights and the same pool of
global batches from the seed; the step takes the rank's contiguous slice,
and one all-reduce averages the gradients and the metrics. Before the
window rank 0 fixes its number of steps, ``--seconds`` over the time of
set-up's last step, and broadcasts it once, so the window runs the
trainer's loop alone. With ``--trace 1`` every rank profiles the same
slice of steps and rank 0 averages what they read. After the window every
rank frees its program and checks that it loaded nothing of JAX (a rank
that did exits non-zero, and rank 0 then prints no result), and rank 0
works out the global batch's first steps with the plain reference: each
slice's gradient, averaged, then SGD.
"""

import gc
import math
import multiprocessing
import socket
import sys
import time

import torch
import torch.distributed as dist

from benchmark.harness import compare, core, scenes, trace, weights
from benchmark.reference import model as ref_model
from benchmark.reference import step as ref_step
from benchmark.traffic.da_step import (_generator, _norms, _set_tf32, build,
                                       first_steps, window)

ALLREDUCE = "AllReduce"  # NCCL's all-reduce kernels (ncclDevKernel_AllReduce_...)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_program(cell, rank, world, device, faults=None):
    """One rank's set-up, window and traced slice; rank 0's readings."""
    from scan_tpu_torch.engine.dp import make_dp_da_train_step

    work, t = cell.work, cell.work["traffic"]
    pool = [scenes.batch_pair(scenes.item_seed(cell.seed, i), t, device)
            for i in range(t["pool"])]
    det, opt, sched, _ = build(cell, device)
    step = make_dp_da_train_step(det, opt, sched)
    if faults:
        step = faults(det, opt, step)
    prog, state = first_steps(cell, device, det, opt, step, pool)
    steps = torch.tensor([float(math.ceil(cell.seconds / prog["step_s"][-1]))],
                         device=device)
    dist.broadcast(steps, 0)  # rank 0's count sets every rank's window
    steps = max(1, int(steps.item()))
    dist.barrier()
    core.sync(device)
    out = {"prog": prog, "setup_s": time.time() - cell.start}

    def one(i):
        nonlocal state
        state, m = step(state, *pool[i % len(pool)],
                        forward_target=work["forward_target"],
                        generator=_generator(cell, device, i))
        return float(m["loss_total"])

    n, failed, elapsed, i = window(cell, one, work["check_steps"], steps)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated())
                         if device.type == "cuda" else 0.0], device=device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    images = 2 * t["batch"]  # the global batch, both domains
    out.update(attempted=n, failed=failed, train_img_s=n * images / elapsed,
               unit_s=elapsed / n, peak=int(peak.item()))
    if cell.trace:
        k, start = work["trace_steps"], i

        def slice_():
            for j in range(start, start + k):
                one(j)

        s, tw = trace.profile(slice_, k)
        ar, _ = trace.kernel_seconds(s, ALLREDUCE)
        mine = {"busy_s": s["busy_s"], "window_s": tw, "allreduce_s": ar}
        every = [None] * world
        dist.all_gather_object(every, mine)
        out["summary"], out["trace_window_s"] = s, tw
        out["ranks"] = every
    del det, opt, sched, step, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, pool


def _worker(rank, world, port, args):
    """Ranks 1..world-1, started by rank 0."""
    name, seed, seconds, tr, overrides, device_type, faults = args
    cell = core.Cell(name, seed, seconds, tr, overrides)
    cell.device = device_type
    _init(rank, world, port, device_type)
    try:
        _rank_program(cell, rank, world, _device(device_type, rank), faults)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    found = core.forbidden_modules()
    if found:
        print(f"rank {rank}: forbidden modules loaded: {found}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def _device(device_type, rank):
    return torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")


def _init(rank, world, port, device_type):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def reference(cell, device, pool, world):
    """The global batch's first steps: each rank's slice through the plain
    detector, the gradients and metrics averaged over the slices, then
    SGD."""
    work = cell.work
    _set_tf32(False)
    w = weights.make_weights(cell.cfg, cell.seed, device)
    with torch.device(device):
        det = ref_model.Detector(cell.cfg)
    det.load_state_dict(w)
    del w
    if det.condgraph_on:
        raise NotImplementedError("reference: a data-parallel condgraph")
    opt = ref_step.SGD(cell.cfg, det)
    params = [p for _, p, _, _ in opt.params]
    init = {n: p.detach().clone() for n, p, _, _ in opt.params}
    ref = {"metrics": []}
    for i in range(work["check_steps"]):
        bs, bt = pool[i]
        per = bs["images"].shape[0] // world
        grads, metrics = None, {}
        for r in range(world):
            part = slice(r * per, (r + 1) * per)
            m, total, _ = ref_step.losses(
                det, (None, None), {k: v[part] for k, v in bs.items()},
                {k: v[part] for k, v in bt.items()}, work["forward_target"],
                None)
            g = torch.autograd.grad(total, params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(params, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + float(v.detach()) / world
        opt.step([g / world for g in grads], work["start_iter"] + i)
        ref["metrics"].append(metrics)
        if i == 0:
            ref["grad"] = _norms(opt.buf)
    ref["change"] = _norms({n: p.detach() - init[n]
                            for n, p, _, _ in opt.params})
    ref["prototype"] = None
    return ref


def run(cell, faults=None):
    """The whole run; ``faults`` (tests only, a module-level function so
    that it reaches every rank) wraps each rank's step."""
    world = cell.work["chips"]
    port = _free_port()
    args = (cell.name, cell.seed, cell.seconds, cell.trace,
            {k: cell.work[k] for k in cell.overrides}, cell.device, faults)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, port, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        _init(0, world, port, cell.device)
        device = _device(cell.device, 0)
        out, pool = _rank_program(cell, 0, world, device, faults)
        dist.barrier()
        dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank failed: {[p.exitcode for p in procs]}")
    dev = core.device_info(torch, world)
    dev["memory_peak_bytes"] = out["peak"]
    metrics = {"train_img_s": {"value": out["train_img_s"], "unit": "img/s"},
               "setup_s": {"value": out["setup_s"], "unit": "s"}}
    breakdown = None
    if cell.trace:
        ranks = out["ranks"]
        mean = {k: sum(r[k] for r in ranks) / world for k in ranks[0]}
        summary = dict(out["summary"], busy_s=mean["busy_s"],
                       allreduce_s=mean["allreduce_s"])
        ctx_ = type("Ctx", (), dict(
            summary=summary, window_s=mean["window_s"], unit_s=out["unit_s"],
            cfg=cell.cfg, work=cell.work))
        metrics = core.read_layers(cell, ctx_)
        dev.update(busy_s=mean["busy_s"], window_s=mean["window_s"])
        breakdown = trace.breakdown(out["summary"])
    else:
        names = {m["name"] for m in cell.end_to_end()}
        metrics = {k: v for k, v in metrics.items() if k in names}
    ref = reference(cell, _device(cell.device, 0), pool, world)
    readings = compare.da_readings(out["prog"], ref)
    ok, checks = compare.judge(readings, cell.work["limits"])
    return dict(correct=ok and out["failed"] == 0, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=dev,
                checks=checks, breakdown=breakdown, readings=readings)
