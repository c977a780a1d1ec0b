"""Optimizer and LR schedule (counterpart of ``scan_tpu/solver/build.py``;
reference ``solver/build.py:7-84``, ``lr_scheduler.py:10-60``).

One ``torch.optim.SGD`` with a param group per (module group, is-bias):
momentum ``SOLVER.MOMENTUM``, the weight decay inside the update (so it
enters the momentum trace, as ``optax.add_decayed_weights`` before
``optax.sgd`` does), ``WEIGHT_DECAY_BIAS`` and ``BIAS_LR_FACTOR`` on the bias
groups. A parameter is a bias when the last component of its name is
``bias``, as ``scan_tpu``'s ``path[-1] == "bias"``: GroupNorm's and
LayerNorm's ``bias`` are biases, ``TorchRNN``'s ``bias_ih_l0`` is not. The
parameters that do not require grad stay out of the optimizer, so they
take neither an update nor weight decay, as under optax's ``set_to_zero``:
the model decides which are frozen, as ``scan_tpu``'s ``_frozen_checker``
freezes them (``solver/build.py:59-97``): ``VGG16`` builds stages 1-2,
conv0..conv3, frozen; ``ResNet`` builds its stem frozen from
FREEZE_CONV_BODY_AT 1 and stage k from k + 1, and its FrozenBatchNorms hold
buffers, which no optimizer sees.

``make_lr_scheduler`` gives each group WarmupMultiStep as a ``LambdaLR``
factor: the optimizer's step k (k = 0, 1, ...) runs at
``BASE_LR * BIAS_LR_FACTOR * warmup_multistep(k)``, the value optax's
schedule takes at ``count`` = k updates so far.
"""

import torch

# module group -> its SOLVER node
_GROUP_TO_SOLVER_KEY = {
    "backbone": "BACKBONE",
    "middle_head": "MIDDLE_HEAD",
    "fcos": "FCOS",
    "discriminator": "DIS",
}


def warmup_multistep(steps, gamma, warmup_factor, warmup_iters,
                     warmup_method):
    """factor(it): the constant or linear warmup factor below
    ``warmup_iters``, times ``gamma`` for each step in ``steps`` reached."""
    steps = list(steps)

    def factor(it):
        it = float(it)
        if it >= warmup_iters:
            wf = 1.0
        elif warmup_method == "constant":
            wf = warmup_factor
        else:  # linear
            alpha = it / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha
        decay = 1.0
        for s in steps:
            if it >= s:
                decay *= gamma
        return wf * decay

    return factor


def _module_group(top: str) -> str:
    if top.startswith("dis_"):
        return "discriminator"
    if top in ("backbone", "middle_head", "fcos"):
        return top
    raise KeyError(top)


def make_optimizer(cfg, model) -> torch.optim.SGD:
    """One SGD over ``model``'s parameters that require grad, a param
    group per (module group, is-bias) in ``scan_tpu``'s label order. Each
    group carries its ``label`` ("backbone", "backbone/bias", ...)."""
    members = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        top, *path = name.split(".")
        is_bias = path[-1] == "bias"
        members.setdefault((_module_group(top), is_bias), []).append(p)
    groups = []
    for group, key in _GROUP_TO_SOLVER_KEY.items():
        s = cfg.SOLVER[key]
        for is_bias in (False, True):
            params = members.get((group, is_bias))
            if not params:
                continue
            groups.append(dict(
                params=params, label=f"{group}/bias" if is_bias else group,
                solver_key=key,
                lr=s.BASE_LR * (s.BIAS_LR_FACTOR if is_bias else 1.0),
                weight_decay=(cfg.SOLVER.WEIGHT_DECAY_BIAS if is_bias
                              else cfg.SOLVER.WEIGHT_DECAY)))
    return torch.optim.SGD(groups, lr=groups[0]["lr"],
                           momentum=cfg.SOLVER.MOMENTUM)


def make_lr_scheduler(cfg, optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    """WarmupMultiStep per param group, from the group's SOLVER node."""
    factors = []
    for g in optimizer.param_groups:
        s = cfg.SOLVER[g["solver_key"]]
        factors.append(warmup_multistep(s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                        s.WARMUP_ITERS, s.WARMUP_METHOD))
    return torch.optim.lr_scheduler.LambdaLR(optimizer, factors)
