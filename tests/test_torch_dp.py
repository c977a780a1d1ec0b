"""Data parallelism of the port (``engine/dp.py``, ``parallel/mesh.py``) on
the CPU: two gloo ranks (``torch.multiprocessing`` spawn, a ``file://``
store under ``tmp_path``, so no port is opened), against ``scan_tpu``.

The C2F config at VGG width / 8, 64x96 images, the global batch 2 + 2
(one image a rank), ``tests/test_torch_train_step.py``'s seeded batches
and BASE_LR 0.1; the model is cut to keep ``scan_tpu``'s compile short
(one conv in each FCOS tower and in the condgraph's input tower, the CON
discriminator on P7 only, with one shared conv). ``scan_tpu``'s parameters
are carried into the port through ``utils/jax_weights.py``; no dropout.

* (a) Each rank gets a different image. After one DP DA step in each
  ``forward_target`` variant, the port's parameters, prototype and metrics
  equal those of ``scan_tpu``'s ``make_dp_da_train_step`` on a 2-device CPU
  mesh (run in a subprocess with ``--xla_force_host_platform_device_count=2``):
  metrics within rtol 1e-5, the prototype within 1e-5, every update within
  ``tests/test_torch_train_step.py``'s bound (1e-4 of the tensor's largest
  update + 1e-4 of the whole update's). Both ranks end bit-equal.
* (b) Both ranks get the same image: the port's DP DA step equals its
  single-process step on that image exactly, in each variant (the mean of
  two equal gradients is the gradient).
* (c) The source-only step passes (b) too; the discriminators get no
  gradient there, count as 0 in the all-reduce, and stay unchanged.
* (d) ``maybe_init_distributed(True)`` against an unreachable store raises.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2F = os.path.join(REPO, "configs", "scan",
                   "scan_vgg16_cityscapace_to_foggy.yaml")
OPTS = [
    "TPU.MAX_NODES", 64, "TPU.MAX_TARGET_POINTS", 64, "TPU.MAX_BOXES", 8,
    "TPU.VGG_WIDTH_DIV", 8, "MODEL.FCOS.NUM_CONVS_REG", 1,
    "MODEL.FCOS.NUM_CONVS_CLS", 1, "MODEL.MIDDLE_HEAD.NUM_CONVS_IN", 1,
    "MODEL.ADV.CON_NUM_SHARED_CONV_P7", 1,
    *[x for p in ("P3", "P4", "P5", "P6")
      for x in (f"MODEL.ADV.USE_DIS_{p}_CON", False)],
    *[x for k in ("BACKBONE", "MIDDLE_HEAD", "FCOS", "DIS")
      for x in (f"SOLVER.{k}.BASE_LR", 0.1)],
]
WORLD = 2


def cut_cfg(cfg):
    cfg.merge_from_file(C2F)
    cfg.merge_from_list(list(OPTS))
    return cfg


def _jax_main(work, forward_target):
    """scan_tpu's side, in a process of its own on a 2-device CPU mesh: the
    initial state (pickled to ``work/init.pkl`` by the False process) and
    the DP DA step of one ``forward_target`` variant on make_batches(0),
    pickled as numpy."""
    import jax
    import jax.numpy as jnp

    from scan_tpu.config import get_default_cfg
    from scan_tpu.engine.dp import make_dp_da_train_step
    from scan_tpu.modeling.detector import build_detector
    from scan_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from scan_tpu.solver.build import make_optimizer
    from test_torch_train_step import make_batches

    assert len(jax.devices()) == WORLD
    cfg = cut_cfg(get_default_cfg())
    det = build_detector(cfg)
    bs, bt = make_batches(0)
    params, proto = det.init_params(jax.random.PRNGKey(0),
                                    jnp.asarray(bs["images"]))
    if not forward_target:
        init = os.path.join(work, "init.pkl")
        with open(init + ".tmp", "wb") as f:
            pickle.dump(jax.device_get((params, proto)), f)
        os.replace(init + ".tmp", init)
    opt = make_optimizer(cfg, params)
    mesh = make_mesh(WORLD, jax.devices())
    step = make_dp_da_train_step(det, opt, mesh, forward_target=forward_target)
    p, o, pr = (replicate(mesh, t) for t in (params, opt.init(params), proto))
    res = step(p, o, pr, shard_batch(mesh, bs), shard_batch(mesh, bt))
    with open(os.path.join(work, f"jax_{forward_target}.pkl"), "wb") as f:
        pickle.dump(jax.device_get((res[0], res[2], res[3])), f)


def _port(device="cpu"):
    from scan_tpu_torch.config import get_default_cfg
    from scan_tpu_torch.modeling.detector import build_detector
    from scan_tpu_torch.solver.build import make_lr_scheduler, make_optimizer

    cfg = cut_cfg(get_default_cfg())
    det = build_detector(cfg, device=device)

    def fresh_optimizer():
        opt = make_optimizer(cfg, det)
        return opt, make_lr_scheduler(cfg, opt)
    return det, fresh_optimizer


def _snapshot(det, proto, metrics):
    return dict(state={k: v.clone() for k, v in det.state_dict().items()},
                proto=(proto.prototype.clone(), int(proto.counter)),
                metrics={k: v.clone() for k, v in metrics.items()})


def _rank_main(rank, world, store, work):
    """One gloo rank: cases (b) and (c) from the port's seeded init, then
    case (a) from scan_tpu's initial state once ``work/init.pth`` is there.
    Rank 0 also runs each case's single-process step."""
    from scan_tpu_torch.engine.dp import (make_dp_da_train_step,
                                          make_dp_source_only_train_step)
    from scan_tpu_torch.engine.train_step import (make_da_train_step,
                                                  make_source_only_train_step)
    from scan_tpu_torch.parallel.mesh import maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed(True, device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=world, timeout_s=240)
    det, fresh_optimizer = _port()
    cases = torch.load(os.path.join(work, "cases.pth"), weights_only=False)
    out = {"init_bc": {k: v.clone() for k, v in det.state_dict().items()}}
    for name, (kind, ft, bs, bt) in cases.items():
        if name.startswith("a_"):
            path = os.path.join(work, "init.pth")
            while not os.path.exists(path):
                time.sleep(0.1)
            init = torch.load(path, weights_only=True)
        else:
            init = out["init_bc"]
        for dp in (True, False):
            if not dp and rank != 0:
                continue
            det.load_state_dict(init)
            opt, sched = fresh_optimizer()
            one = {k: v[:1] for k, v in bs.items()}
            if kind == "da":
                make = make_dp_da_train_step if dp else make_da_train_step
                step = make(det, opt, sched)
                bt_ = bt if dp else {k: v[:1] for k, v in bt.items()}
                proto, metrics = step(det.proto_state(), bs if dp else one,
                                      bt_, forward_target=ft)
            else:
                make = (make_dp_source_only_train_step if dp
                        else make_source_only_train_step)
                step = make(det, opt, sched)
                proto, metrics = step(det.proto_state(), bs if dp else one)
            if dp and name == "a_False":
                out["numel"] = step.reduce.numel
            out[(name, dp)] = _snapshot(det, proto, metrics)
    torch.save(out, os.path.join(work, f"rank{rank}.pth"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """scan_tpu's DP steps (a process per variant on a 2-device mesh, in
    parallel) and the port's on two gloo ranks; (b) and (c) run while
    scan_tpu initialises, (a) once its initial state is there."""
    from scan_tpu_torch.utils.jax_weights import load_jax_params
    from test_torch_train_step import make_batches

    work = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")

    def jax_part(part):
        code = ("import sys; sys.path.insert(0, 'tests');"
                "import jax; jax.config.update('jax_platforms', 'cpu');"
                "from test_torch_dp import _jax_main;"
                f"_jax_main(r'{work}', {part})")
        return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(proc):
        out, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, out[-4000:]

    jax_procs = [jax_part(ft) for ft in (False, True)]
    bs, bt = make_batches(0)
    twin_s = {k: np.concatenate([v[:1], v[:1]]) for k, v in bs.items()}
    twin_t = {"images": np.concatenate([bt["images"][:1]] * 2)}
    cases = {f"b_{ft}": ("da", ft, twin_s, twin_t) for ft in (False, True)}
    cases["c"] = ("source", False, twin_s, None)
    cases.update({f"a_{ft}": ("da", ft, bs, bt) for ft in (False, True)})
    torch.save(cases, work / "cases.pth")
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(WORLD, str(work / "store"), str(work)),
        nprocs=WORLD, join=False)
    deadline = time.time() + 300
    try:
        while not (work / "init.pkl").exists():
            assert jax_procs[0].poll() is None, jax_procs[0].stdout.read()
            assert time.time() < deadline, "scan_tpu's init timed out"
            time.sleep(0.1)
        with open(work / "init.pkl", "rb") as f:
            params, proto = pickle.load(f)
        det, _ = _port()
        load_jax_params(det, params, proto)
        torch.save(det.state_dict(), work / "init.tmp")
        os.replace(work / "init.tmp", work / "init.pth")
        for proc in jax_procs:
            finish(proc)
        while not ctx.join(timeout=5):
            assert time.time() < deadline, "the gloo ranks timed out"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        for proc in jax_procs:
            if proc.poll() is None:
                proc.kill()
    ref = {"init": (params, proto)}
    for ft in (False, True):
        with open(work / f"jax_{ft}.pkl", "rb") as f:
            ref[ft] = pickle.load(f)
    ranks = [torch.load(work / f"rank{r}.pth", weights_only=False)
             for r in range(WORLD)]
    return ref, ranks


def _assert_same(a, b):
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert torch.equal(a["proto"][0], b["proto"][0])
    assert a["proto"][1] == b["proto"][1]
    assert a["metrics"].keys() == b["metrics"].keys()
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k


@pytest.mark.parametrize("forward_target", [False, True])
def test_a_dp_step_matches_scan_tpu(runs, forward_target):
    from scan_tpu_torch.utils.jax_weights import convert_params
    from test_torch_train_step import _check_metrics

    ref, ranks = runs
    params, _ = ref["init"]
    want_params, want_proto, want_metrics = ref[forward_target]
    got = ranks[0][(f"a_{forward_target}", True)]
    _assert_same(got, ranks[1][(f"a_{forward_target}", True)])
    _check_metrics(got["metrics"], want_metrics, 1e-5)
    assert ("transfer_loss_gt" in got["metrics"]) == forward_target
    assert got["proto"][1] == int(want_proto.counter)
    np.testing.assert_allclose(got["proto"][0].numpy(),
                               np.asarray(want_proto.prototype), rtol=0,
                               atol=1e-5)
    p0, p1 = convert_params(params), convert_params(want_params)
    want = {k: (p1[k] - p0[k]).numpy() for k in p0}
    scale = max(float(np.abs(d).max()) for d in want.values())
    assert scale > 1e-3
    for k, w in want.items():
        d = (got["state"][k] - p0[k]).numpy()
        assert (np.abs(w).max() > 0) == (np.abs(d).max() > 0), k
        np.testing.assert_allclose(
            d, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-4 * scale,
            err_msg=k)
    # one vector: every gradient, the float metrics and the prototype
    det, _ = _port()
    assert ranks[0]["numel"] == (
        sum(p.numel() for p in det.parameters() if p.requires_grad)
        + len(ranks[0][("a_False", True)]["metrics"])
        + got["proto"][0].numel())


@pytest.mark.parametrize("case", ["b_False", "b_True", "c"])
def test_bc_same_image_equals_single_step(runs, case):
    _, ranks = runs
    init = ranks[0]["init_bc"]
    dp, single = ranks[0][(case, True)], ranks[0][(case, False)]
    _assert_same(dp, ranks[1][(case, True)])
    _assert_same(dp, single)
    dis = [k for k in init if k.startswith("dis_")]
    assert dis
    moved = [k for k in dis if not torch.equal(dp["state"][k], init[k])]
    assert (moved == []) == (case == "c"), moved


def test_d_explicit_init_failure_raises():
    code = ("from scan_tpu_torch.parallel.mesh import maybe_init_distributed\n"
            "maybe_init_distributed(True, device='cpu', "
            "init_method='tcp://127.0.0.1:1', rank=1, world_size=2, "
            "timeout_s=1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "Error" in proc.stderr
