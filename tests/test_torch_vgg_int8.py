"""The port's int8 VGG16 (``scan_tpu_torch/modeling/backbone/vgg.py`` with
``quant``) against ``scan_tpu``'s ``VGG16(s2d_stage1=True, quant=True)``,
on the CPU.

``scan_tpu``'s VGG is calibrated with ``mutable=["act_scales"]``; its
parameters and scales are carried into the port by the weight bridge. Both
run op by op (no ``jax.jit``, whose fusions would contract the epilogue's
``acc * scale + bias`` into an FMA). Every switch is passed to both
packages explicitly: their VGG16 field defaults are not the config's.

Tolerances, from what the arithmetic allows: every conv is an exact int32
sum followed by the same float32 steps in the same order, so C1 must be
equal, and so must C2-C5 (a tolerance of 0: any flipped rounding would be a
fault). Calibration must give ``scan_tpu``'s scales within rtol 1e-6.

The kernel branches (``pallas_conv0``, ``pallas_phase_max``,
``pallas_stem_int8``) run only at the full stage-1 width, so they are tested
at width_div=1 with one conv per later stage, 32x64. On the CPU each branch
runs its kernel's plain version; the tests count the wrapper calls to show
the branch was taken, and hold each branch to the ``scan_tpu`` chain it
must equal:

* K3 (``pallas_conv0``): the default chain. K3 rounds conv1_1's result to
  bf16 (``conv0_kernel.py:117-120``) where the float32 chain does not, and
  quantizes the float32 weights where the bf16 chain quantizes bf16 ones
  (``vgg.py:276``), so the two are equal only in bf16 with stem weights and
  biases that bf16 holds exactly. The test uses such weights, and asks for
  equality.
* K4 (``pallas_phase_max`` alone): the default chain. C2-C5 equal (the stem
  output's scale is conv2's, and requant commutes with the max); C1 is K4's
  s8 output dequantized, within half an LSB of the fp C1.
* K5 (``pallas_stem_int8``): the ``stem_s8_epilogue`` chain, by K5's rule
  (no s8 value of C1 off by more than 1, fewer than 0.1% off by 1); C2-C5
  then within 10% of the largest value, as ``tests/test_quant_stem.py``
  bounds the effect of 1-LSB input changes.
* K6 (all three of ``stem_s8_epilogue``, ``stem_pair_conv``,
  ``pallas_phase_max``): the ``stem_s8_epilogue`` + ``stem_pair_conv``
  chain, equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.backbone.vgg import VGG16 as JaxVGG16
from scan_tpu_torch.modeling.backbone import vgg as tvgg
from scan_tpu_torch.modeling.layers import Conv, calibration, stored_scale
from scan_tpu_torch.utils.jax_weights import convert_params

OFF = dict(stem_s8_epilogue=False, stem_pair_conv=False, pallas_conv0=False,
           pallas_phase_max=False, pallas_stem_int8=False)
SWITCHES = {
    "default": {},
    "s8_epilogue": dict(stem_s8_epilogue=True),
    "pair_conv": dict(stem_pair_conv=True),
    "s8_epilogue_pair_conv": dict(stem_s8_epilogue=True, stem_pair_conv=True),
}
KERNELS = ("conv0_s8", "phase_max_requant", "pair_phase_max_s8",
           "fused_stem_int8")


def _x(b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, 3) * 40 + 20).astype(np.float32)


def _jax_vgg(dtype=None, **kw):
    return JaxVGG16(s2d_stage1=True, quant=True, dtype=dtype,
                    **{**OFF, "pallas_stem": False, **kw})


def _calibrated(m, x, params=None):
    v = jax.jit(m.init)(jax.random.PRNGKey(0), x) if params is None \
        else params
    _, ups = m.apply(v, x, mutable=["act_scales"])
    return {"params": v["params"], "act_scales": ups["act_scales"]}


def _port_vgg(jvars, dtype=torch.float32, **kw):
    """The port's int8 VGG16 with ``scan_tpu``'s parameters (and scales, when
    ``jvars`` has them) carried across by the weight bridge."""
    kw = {**OFF, **kw}
    m = tvgg.VGG16(quant=True, **kw)
    tree = {"backbone": {k: {"body": v} for k, v in jvars.items()}}
    sd = {k[len("backbone.body."):]: v
          for k, v in convert_params(jax.device_get(tree)).items()}
    missing, unexpected = m.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith(("amax", "_act")) for k in missing), missing
    for mod in m.modules():
        if getattr(mod, "quant", False):
            mod.dtype = dtype
    return m


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def small():
    """width_div=8 (an 8-channel stem), 32x64, calibrated once."""
    x = _x(2, 32, 64)
    m = _jax_vgg(width_div=8)
    v0 = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return x, v0, _calibrated(m, jnp.asarray(x), v0)


@pytest.mark.parametrize("switches", sorted(SWITCHES))
def test_int8_vgg_matches_scan_tpu(small, switches):
    x, _, v = small
    sw = SWITCHES[switches]
    want = _jax_vgg(width_div=8, **sw).apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port_vgg(v, width_div=8, **sw)(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, lvl
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"C{lvl + 1}")


def test_port_calibration_gives_scan_tpu_scales(small):
    x, v0, v = small
    m = _port_vgg({"params": v0["params"]}, width_div=8)
    with torch.no_grad(), calibration(m):
        m(torch.from_numpy(x))
    want = {k[len("backbone.body."):]: float(t) for k, t in convert_params(
        {"backbone": {"act_scales": {"body": jax.device_get(
            v["act_scales"])}}}).items()}
    got = {k: float(t) for k, t in m.state_dict().items()
           if k.endswith(("amax", "_act"))}
    assert set(got) == set(want)
    assert {"conv0_act", "conv1_act", "stem_out_act"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_scale_state_follows_calibration_and_loads():
    """A static scale exists once a calibration pass or a load stores one,
    and not before; ``load_state_dict`` carries whether it holds one."""
    x = torch.randn(1, 6, 6, 3, generator=torch.Generator().manual_seed(0))
    conv = Conv(3, 8, 3, quant=True)
    assert stored_scale(conv, "amax") is None
    with torch.no_grad(), calibration(conv):
        conv(x)
    want = x.abs().amax() / torch.tensor(127.0)
    assert torch.equal(stored_scale(conv, "amax"), want)
    loaded = Conv(3, 8, 3, quant=True)
    loaded.load_state_dict(conv.state_dict())
    assert torch.equal(stored_scale(loaded, "amax"), want)
    conv.load_state_dict(Conv(3, 8, 3, quant=True).state_dict())
    assert stored_scale(conv, "amax") is None


def test_kernel_branches_stay_off_below_full_width(small, monkeypatch):
    x, _, v = small
    calls = _count_kernels(monkeypatch)
    with torch.no_grad():
        for sw in (dict(pallas_stem_int8=True), dict(pallas_conv0=True),
                   dict(pallas_phase_max=True),
                   dict(pallas_phase_max=True, stem_s8_epilogue=True,
                        stem_pair_conv=True)):
            _port_vgg(v, width_div=8, **sw)(torch.from_numpy(x))
    assert sum(calls.values()) == 0, calls


# ---- the kernel branches, at the full stage-1 width ----------------------

def _count_kernels(monkeypatch):
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        real = getattr(tvgg, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tvgg, name, counted)
    return calls


@pytest.fixture(scope="module")
def full():
    """width_div=1, one conv per later stage, 32x64; stem weights and
    biases rounded to values bf16 holds exactly (see the K3 case)."""
    x = _x(1, 32, 64, seed=1)
    blocks = (2, 1, 1, 1, 1)
    m = _jax_vgg(width_div=1, stage_blocks=blocks)
    v0 = jax.device_get(jax.jit(m.init)(jax.random.PRNGKey(1),
                                        jnp.asarray(x)))
    for conv in ("conv0", "conv1"):
        p = v0["params"][conv]["Conv_0"]
        for k in ("kernel", "bias"):
            p[k] = np.asarray(jnp.asarray(p[k]).astype(jnp.bfloat16)
                              .astype(jnp.float32))
        # the init's zero biases plus 0.25: nonzero, and still exact
        p["bias"] = p["bias"] + np.float32(0.25)
    return x, blocks, _calibrated(m, jnp.asarray(x), v0)


BRANCHES = {
    # name: (port switches, scan_tpu switches, kernel, dtype)
    "k3_conv0": (dict(pallas_conv0=True), {}, "conv0_s8", "bfloat16"),
    "k4_phase_max": (dict(pallas_phase_max=True), {}, "phase_max_requant",
                     "float32"),
    "k5_stem_int8": (dict(pallas_stem_int8=True),
                     dict(stem_s8_epilogue=True), "fused_stem_int8",
                     "float32"),
    "k6_pair_phase_max": (
        dict(stem_s8_epilogue=True, stem_pair_conv=True,
             pallas_phase_max=True),
        dict(stem_s8_epilogue=True, stem_pair_conv=True),
        "pair_phase_max_s8", "float32"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_kernel_branch_matches_its_chain(full, branch, monkeypatch):
    x, blocks, v = full
    port_sw, jax_sw, kernel, dtype = BRANCHES[branch]
    want = _jax_vgg(width_div=1, stage_blocks=blocks,
                    dtype=getattr(jnp, dtype), **jax_sw).apply(
        v, jnp.asarray(x))
    calls = _count_kernels(monkeypatch)
    with torch.no_grad():
        got = _port_vgg(v, getattr(torch, dtype), width_div=1,
                        stage_blocks=blocks, **port_sw)(torch.from_numpy(x))
    assert calls == {k: int(k == kernel) for k in KERNELS}, calls
    got, want = [_np(t) for t in got], [_np(t) for t in want]
    s_out = float(v["act_scales"]["stem_out_act"]) / 127.0
    if branch == "k4_phase_max":
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=s_out / 2 * (1 + 1e-5))
        assert not np.array_equal(got[0], want[0]), "C1 must be requantized"
    elif branch == "k5_stem_int8":
        q_got = np.round(got[0] / s_out).astype(int)
        q_want = np.round(want[0] / s_out).astype(int)
        diff = np.abs(q_got - q_want)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        for lvl in range(1, 5):
            scale = max(np.abs(want[lvl]).max(), 1e-3)
            assert np.abs(got[lvl] - want[lvl]).max() / scale < 0.1, lvl
        return
    else:
        np.testing.assert_array_equal(got[0], want[0], err_msg="C1")
    for lvl in range(1, 5):
        np.testing.assert_array_equal(got[lvl], want[lvl],
                                      err_msg=f"C{lvl + 1}")
