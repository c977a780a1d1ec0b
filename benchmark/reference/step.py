"""The reference DA step: the G pass on the source, the discriminators on
both domains, the target pass with GST, one gradient of the sum of every
loss term, and SGD with momentum, weight decay inside the update and the
config's per-group learning rates (``BIAS_LR_FACTOR``, ``WEIGHT_DECAY_BIAS``
on biases; WarmupMultiStep at the step's iteration)."""

import torch

GROUPS = {"backbone": "BACKBONE", "middle_head": "MIDDLE_HEAD",
          "fcos": "FCOS"}


def lr_factor(s, it):
    """WarmupMultiStep at iteration ``it`` of the SOLVER node ``s``."""
    if it >= s["WARMUP_ITERS"]:
        wf = 1.0
    elif s["WARMUP_METHOD"] == "constant":
        wf = s["WARMUP_FACTOR"]
    else:
        a = it / max(s["WARMUP_ITERS"], 1)
        wf = s["WARMUP_FACTOR"] * (1 - a) + a
    return wf * s["GAMMA"] ** sum(it >= x for x in s["STEPS"])


class SGD:
    """Plain momentum SGD over the parameters that require grad."""

    def __init__(self, cfg, model):
        sol = cfg["SOLVER"]
        self.momentum = sol["MOMENTUM"]
        self.params = []  # (name, tensor, SOLVER node, is_bias)
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            top = name.split(".")[0]
            node = sol["DIS"] if top.startswith("dis_") else sol[GROUPS[top]]
            self.params.append((name, p, node, name.endswith(".bias")))
        self.buf = {}
        self.wd = (sol["WEIGHT_DECAY"], sol["WEIGHT_DECAY_BIAS"])

    @torch.no_grad()
    def step(self, grads, it):
        for (name, p, node, bias), g in zip(self.params, grads):
            if g is None:  # no gradient: no update, as torch's SGD
                continue
            d = g + self.wd[bias] * p
            b = self.buf.get(name)
            self.buf[name] = d.clone() if b is None else b.mul_(
                self.momentum).add_(d)
            lr = node["BASE_LR"] * (node["BIAS_LR_FACTOR"] if bias else 1.0)
            p.sub_(lr * lr_factor(node, it) * self.buf[name])


def losses(det, state, batch_s, batch_t, forward_target, generator):
    """Every loss term of the step, under the names of the system's
    metrics, their sum, and the new (prototype, counter)."""
    proto, counter = state
    targets = {k: batch_s[k] for k in ("boxes", "labels", "mask")}
    ls, fs, ms, ss, (proto, counter) = det.forward_train(
        proto, counter, batch_s["images"], targets, "source",
        generator=generator)
    metrics = {k + "_gs": v for k, v in ls.items()}
    ds = det.dis_losses(fs, ms, ss, 1.0, "ds")
    lt, ft, mt, st, _ = det.forward_train(
        proto, counter, batch_t["images"], None, "target", forward_target,
        generator)
    dt = det.dis_losses(ft, mt, st, 0.0, "dt")
    metrics.update(ds)
    metrics.update({k + "_gt": v for k, v in lt.items()})
    metrics.update(dt)
    total = (sum(ls.values()) + sum(ds.values()) + sum(dt.values())
             + sum(lt.values()))
    metrics["loss_total"] = total
    return metrics, total, (proto, counter)


def da_step(det, opt, state, batch_s, batch_t, forward_target, generator,
            it):
    """One step; returns the new (prototype, counter) and the metrics
    (floats) under the names of the system's."""
    metrics, total, (proto, counter) = losses(
        det, state, batch_s, batch_t, forward_target, generator)
    grads = torch.autograd.grad(total, [p for _, p, _, _ in opt.params],
                                allow_unused=True)
    opt.step(grads, it)
    if proto is not None:
        proto = proto.detach()
        det.prototype.copy_(proto)
        det.proto_counter.copy_(counter)
    return (proto, counter), {k: float(v.detach()) for k, v in metrics.items()}
