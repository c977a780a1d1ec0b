"""Traffic ``da_step``: consecutive DA steps of ``make_da_train_step`` in a
closed loop, each starting when the last one's metrics are back on the
host, as the trainer's loop runs them.

Set-up makes the weights and a pool of ``traffic.pool`` seeded batch pairs
on the card, builds the detector, its SGD and schedule (advanced to
``start_iter``), and runs the first ``check_steps`` steps on pool items
that all differ: they warm up every shape, and their losses, the first
gradient (the momentum buffer after step 1) and the change of every
parameter over them are what the reference is held to. The same detector
and step then run the window on the pool, round robin, each step with a
dropout generator of its own. After the window (and its traced slice with
``--trace 1``) the program is freed and the plain reference follows the
first steps from the same weights, batches and generators.
"""

import gc
import math
import time

import torch

from benchmark.harness import compare, core, program, scenes, trace, weights
from benchmark.reference import model as ref_model
from benchmark.reference import step as ref_step


def _set_tf32(on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _generator(cell, device, i):
    """The MHA dropout's generator of step ``i``, or None where the config
    trains without dropout."""
    mh = cell.cfg["MODEL"]["MIDDLE_HEAD"]
    if not (mh["CONDGRAPH_ON"] and mh["GLOBAL_GCN"] and mh["ATT_DROPOUT"] > 0):
        return None
    gen = torch.Generator(device=device)
    return gen.manual_seed(scenes.item_seed(cell.seed, 10 ** 6 + i))


def _norms(tensors):
    return {k: float(v.norm()) for k, v in tensors.items()}


def build(cell, device):
    """The system under test: the detector with the seeded weights, its
    SGD and schedule, and ``make_da_train_step``."""
    work = cell.work
    _set_tf32(work["tf32"])
    pcfg = program.port_cfg(cell.cfg, work)
    w = weights.make_weights(cell.cfg, cell.seed, device)
    det = program.build_detector(pcfg, w, device, train=True)
    del w
    return (det, *program.build_da_step(pcfg, det, work["start_iter"]))


def first_steps(cell, device, det, opt, step, pool):
    """The first ``check_steps`` steps on different pool items: they warm
    up every shape, and give the program's readings and the seconds of
    each step. Returns (readings, the prototype state)."""
    work = cell.work
    names = {p: n for n, p in det.named_parameters() if p.requires_grad}
    init = {n: p.detach().clone() for p, n in names.items()}
    state = det.proto_state()
    prog = {"metrics": [], "step_s": []}
    for i in range(work["check_steps"]):
        t0 = time.perf_counter()
        state, m = step(state, *pool[i], forward_target=work["forward_target"],
                        generator=_generator(cell, device, i))
        prog["metrics"].append({k: float(v) for k, v in m.items()})
        prog["step_s"].append(time.perf_counter() - t0)
        if i == 0:
            prog["grad"] = _norms({n: opt.state[p]["momentum_buffer"]
                                   for p, n in names.items()
                                   if p in opt.state})
    prog["change"] = _norms({n: p.detach() - init[n]
                             for p, n in names.items()})
    prog["prototype"] = (det.prototype.cpu().numpy().copy()
                         if det.condgraph_on else None)
    return prog, state


def window(cell, one, start, steps=None):
    """Steps ``one(i)`` from ``start`` until the first that completes past
    ``--seconds``, or ``steps`` steps. Returns (steps, failed steps,
    elapsed s, the next step's index)."""
    n, failed, i = 0, 0, start
    t0 = time.perf_counter()
    while True:
        failed += not math.isfinite(one(i))
        n, i = n + 1, i + 1
        elapsed = time.perf_counter() - t0
        done = n >= steps if steps else elapsed >= cell.seconds
        if done:
            return n, failed, elapsed, i


def run_program(cell, device, pool, faults=None):
    """Set-up, the window and the traced slice. Returns a dict of what the
    run measured and the program's readings for the comparison."""
    work, t = cell.work, cell.work["traffic"]
    det, opt, _, step = build(cell, device)
    if faults:
        step = faults(det, opt, step)
    prog, state = first_steps(cell, device, det, opt, step, pool)
    core.sync(device)
    out = {"prog": prog, "setup_s": time.time() - cell.start}

    def one(i):
        nonlocal state
        state, m = step(state, *pool[i % len(pool)],
                        forward_target=work["forward_target"],
                        generator=_generator(cell, device, i))
        return float(m["loss_total"])  # closed loop: the metrics are back

    n, failed, elapsed, i = window(cell, one, work["check_steps"])
    images = 2 * t["batch"] * cell.work["chips"]
    out.update(attempted=n, failed=failed, window_s=elapsed,
               train_img_s=n * images / elapsed, unit_s=elapsed / n,
               device=core.device_info(torch, cell.work["chips"]))
    if cell.trace:
        for name in ("backbone", "middle_head", "fcos"):
            if hasattr(det, name):
                trace.wrap_forward(getattr(det, name), name)
        for name in det.dis_names:
            trace.wrap_forward(getattr(det, name), "discriminator")
        k = work["trace_steps"]
        start = i

        def slice_():
            for j in range(start, start + k):
                one(j)

        out["summary"], out["trace_window_s"] = trace.profile(slice_, k)
    del det, opt, step, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_reference(cell, device, pool):
    """The plain reference over the first ``check_steps`` steps, float32
    with TF32 off."""
    work = cell.work
    _set_tf32(False)
    w = weights.make_weights(cell.cfg, cell.seed, device)
    with torch.device(device):
        det = ref_model.Detector(cell.cfg)
    det.load_state_dict(w)
    del w
    opt = ref_step.SGD(cell.cfg, det)
    init = {n: p.detach().clone() for n, p, _, _ in opt.params}
    state = ((det.prototype.clone(), det.proto_counter.clone())
             if det.condgraph_on else (None, None))
    ref = {"metrics": []}
    for i in range(work["check_steps"]):
        state, m = ref_step.da_step(det, opt, state, *pool[i],
                                    work["forward_target"],
                                    _generator(cell, device, i),
                                    work["start_iter"] + i)
        ref["metrics"].append(m)
        if i == 0:
            ref["grad"] = _norms(opt.buf)
    ref["change"] = _norms({n: p.detach() - init[n]
                            for n, p, _, _ in opt.params})
    ref["prototype"] = (det.prototype.cpu().numpy()
                        if det.condgraph_on else None)
    return ref


def run(cell, faults=None):
    """The whole run: program, readings, reference, judgement. ``faults``
    (tests only) wraps the step: ``faults(det, opt, step) -> step``."""
    device = torch.device(cell.device)
    t = cell.work["traffic"]
    pool = [scenes.batch_pair(scenes.item_seed(cell.seed, i), t, device)
            for i in range(t["pool"])]
    out = run_program(cell, device, pool, faults)
    metrics = {"train_img_s": {"value": out["train_img_s"], "unit": "img/s"},
               "setup_s": {"value": out["setup_s"], "unit": "s"}}
    breakdown = None
    if cell.trace:
        s = out["summary"]
        ctx = type("Ctx", (), dict(
            summary=s, window_s=out["trace_window_s"], unit_s=out["unit_s"],
            cfg=cell.cfg, work=cell.work))
        metrics = core.read_layers(cell, ctx)
        out["device"].update(busy_s=s["busy_s"],
                             window_s=out["trace_window_s"])
        breakdown = trace.breakdown(s)
    else:
        names = {m["name"] for m in cell.end_to_end()}
        metrics = {k: v for k, v in metrics.items() if k in names}
    ref = run_reference(cell, device, pool)
    readings = compare.da_readings(out["prog"], ref)
    ok, checks = compare.judge(readings, cell.work["limits"])
    return dict(correct=ok and out["failed"] == 0, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=out["device"],
                checks=checks, breakdown=breakdown, readings=readings)
