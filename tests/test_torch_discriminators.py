"""The port's discriminators against ``scan_tpu``'s, on the CPU, float32.

GA (``FCOSDiscriminator``, with and without PATCH_STRIDE) and CKA
(``FCOSDiscriminatorCon``) in each fusion mode (``concat``, ``mul``,
``mul_detached``), both domains, with ``scan_tpu``'s parameters carried
across: the loss within rtol 1e-5, and the
gradients of every parameter and of the inputs (through the GRL) within
1e-4 of the largest gradient of the same kind. The conv biases in front of
a GroupNorm have a gradient of 0 in exact arithmetic, so theirs is
rounding noise in both frameworks and only the shared bound applies to it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.discriminator import discriminators as jd
from scan_tpu_torch.modeling.discriminator import discriminators as td
from scan_tpu_torch.utils.jax_weights import convert_params


def _close(got: dict, want: dict, what):
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert scale > 0, what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{what}: {k}")


def _run(jmod, tmod, inputs, target, domain):
    """Loss and gradients (params, inputs) of both modules."""
    jin = [jnp.asarray(a) for a in inputs]
    params = jmod.init(jax.random.PRNGKey(1), jin[0], target, *jin[1:])
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in convert_params(
        {"m": jax.device_get(params)}).items()}, strict=True)

    def f(p, *xs):
        return jmod.apply(p, xs[0], target, *xs[1:], domain)

    want, jg = jax.value_and_grad(f, argnums=tuple(range(len(jin) + 1)))(
        params, *jin)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = tmod(tin[0], target, *tin[1:], domain)
    got.backward()
    jparams = {k.split(".", 1)[1]: v.numpy() for k, v in convert_params(
        {"m": jax.device_get(jg[0])}).items()}
    tparams = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(tparams, jparams, "params")
    for i, (t, w) in enumerate(zip(tin, jg[1:])):
        w = np.asarray(w)
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        if np.abs(w).max() == 0:
            assert np.abs(g).max() == 0, f"input {i}"
        else:
            _close({"x": g}, {"x": w}, f"input {i}")
    return got.item()


@pytest.mark.parametrize("patch_stride", [None, 2])
@pytest.mark.parametrize("domain,target", [("source", 1.0), ("target", 0.0)])
def test_ga_discriminator(domain, target, patch_stride):
    rng = np.random.RandomState(0)
    f = rng.randn(2, 6, 9, 32).astype(np.float32)
    kw = dict(num_convs=2, in_channels=32, grl_lambda=0.1,
              patch_stride=patch_stride)
    _run(jd.FCOSDiscriminator(**kw), td.FCOSDiscriminator(**kw), [f], target,
         domain)


@pytest.mark.parametrize("fusion", ["concat", "mul", "mul_detached"])
@pytest.mark.parametrize("domain,target", [("source", 1.0), ("target", 0.0)])
def test_cka_discriminator(fusion, domain, target):
    rng = np.random.RandomState(len(fusion) + int(target))
    f = np.maximum(rng.randn(2, 6, 9, 32), 0).astype(np.float32)
    logits = rng.randn(2, 6, 9, 9) * 2
    a = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    kw = dict(num_convs=2, in_channels=32, num_classes=9, fusion_cfg=fusion,
              grl_lambda=0.02)
    _run(jd.FCOSDiscriminatorCon(**kw), td.FCOSDiscriminatorCon(**kw),
         [f, a.astype(np.float32)], target, domain)
