"""The port's VGG stage-1 stem against ``scan_tpu``'s, within atol/rtol 2e-4.

On the CPU ``fused_stem`` runs its plain version
(``scan_tpu_torch/ops/cuda/stem_kernel.py::reference_stem``); it is held
against ``scan_tpu``'s oracle ``reference_stem(dtype=float32)`` and against
the Pallas kernel ``fused_s2d_stem`` under ``force_tpu_interpret_mode``, as
``tests/test_stem_kernel.py`` runs it. The 2e-4 tolerance is that test's:
float32 convolutions summed in another order. Kernel K2 itself is held
against the plain version on the card by ``tests/test_torch_kernels.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scan_tpu.ops.pallas.stem_kernel import fused_s2d_stem
from scan_tpu.ops.pallas.stem_kernel import reference_stem as jax_reference_stem
from scan_tpu_torch.ops.cuda import stem_kernel


def _data(h=32, w=64, b=2, ch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, 3) * 2).astype(np.float32)
    w0 = (rng.randn(3, 3, 3, ch) * 0.1).astype(np.float32)  # HWIO
    b0 = (rng.randn(ch) * 0.1).astype(np.float32)
    w1 = (rng.randn(3, 3, ch, ch) * 0.05).astype(np.float32)
    b1 = (rng.randn(ch) * 0.1).astype(np.float32)
    return x, w0, b0, w1, b1


def _port(x, w0, b0, w1, b1, device="cpu", out_dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    oihw = lambda a: t(a.transpose(3, 2, 0, 1).copy())  # noqa: E731
    return stem_kernel.fused_stem(t(x), oihw(w0), t(b0), oihw(w1), t(b1),
                                  out_dtype=out_dtype)


@pytest.mark.parametrize("h,w", [(32, 64), (31, 45)])
def test_plain_stem_matches_xla_oracle(h, w):
    x, w0, b0, w1, b1 = _data(h, w)
    want = np.asarray(jax_reference_stem(*map(jnp.asarray, (x, w0, b0, w1, b1)),
                                         dtype=jnp.float32))
    got = _port(x, w0, b0, w1, b1).numpy()
    assert got.shape == want.shape == (2, h // 2, w // 2, 16)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_plain_stem_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    x, w0, b0, w1, b1 = _data()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_s2d_stem(
            *map(jnp.asarray, (x, w0, b0, w1, b1)), th=4,
            out_dtype=jnp.float32))
    got = _port(x, w0, b0, w1, b1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_cpu_wrapper_does_not_launch():
    before = stem_kernel.fused_stem.launches
    _port(*_data(8, 8))
    assert stem_kernel.fused_stem.launches == before



def test_fused_stem_refuses_autograd():
    """K2 has no backward, so its wrapper raises on every device when grad
    mode is on and an input requires grad; under no_grad it runs."""
    x, w0, b0, w1, b1 = (torch.from_numpy(a) for a in _data(8, 8))
    w0 = w0.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    w1 = w1.permute(3, 2, 0, 1).contiguous()
    with pytest.raises(RuntimeError, match="no backward"):
        stem_kernel.fused_stem(x, w0, b0, w1, b1)
    with torch.no_grad():
        stem_kernel.fused_stem(x, w0, b0, w1, b1)


def test_vgg_stem_is_frozen_and_unfreezing_it_raises(monkeypatch):
    """VGG16 builds conv0..conv3 frozen, so a training forward runs the
    stem wrapper (K2 on the card) and the layers above it get gradients; a
    caller that unfreezes stage 1 gets the wrapper's refusal, never a
    silent switch to the plain convs."""
    from scan_tpu_torch.modeling.backbone import vgg as vgg_mod

    net = vgg_mod.VGG16(width_div=8)
    frozen = {n.split(".")[0] for n, p in net.named_parameters()
              if not p.requires_grad}
    assert frozen == {"conv0", "conv1", "conv2", "conv3"}
    calls = []
    real = vgg_mod.fused_stem
    monkeypatch.setattr(vgg_mod, "fused_stem",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 32, 32, 3)
    net(x)[-1].sum().backward()
    assert calls == [1] and net.conv4.weight.grad is not None
    net.conv0.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        net(x)
    assert calls == [1, 1] and net.conv0.weight.grad is None
    with torch.no_grad():
        net(x)
    assert calls == [1, 1, 1]
