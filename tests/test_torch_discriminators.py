"""The port's discriminators against ``scan_tpu``'s, on the CPU, float32.

GA (``FCOSDiscriminator``, with and without PATCH_STRIDE), CKA
(``FCOSDiscriminatorCon``) in each fusion mode (``concat``, ``mul``,
``mul_detached``), CA (``FCOSDiscriminatorCA``) in each type
(``ca_feature``, ``ca_loss``, ``focal``) and OUT (``FCOSDiscriminatorOut``)
in each ``outmap_op`` and loss with either tower, both domains, with
``scan_tpu``'s parameters carried across: the loss within rtol 1e-5, and
the gradients of every parameter and of the inputs (through the GRL) within
1e-4 of the largest gradient of the same kind. An input ``scan_tpu`` passes
no gradient to (CA's score maps) gets none in the port, and OUT's score
maps get one. The conv biases in front of a GroupNorm have a gradient of 0
in exact arithmetic, so theirs is rounding noise in both frameworks and
only the shared bound applies to it.
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
    """Loss and gradients (params, inputs) of both modules. An input is an
    array or a dict of arrays (the score maps). Returns the loss and, per
    input leaf, whether ``scan_tpu``'s gradient there is nonzero."""
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    params = jmod.init(jax.random.PRNGKey(1), jin[0], target, *jin[1:])
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in convert_params(
        {"m": jax.device_get(params)}).items()}, strict=True)

    def f(p, *xs):
        return jmod.apply(p, xs[0], target, *xs[1:], domain)

    want, jg = jax.value_and_grad(f, argnums=tuple(range(len(jin) + 1)))(
        params, *jin)
    tin = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).requires_grad_(True), inputs)
    got = tmod(tin[0], target, *tin[1:], domain)
    got.backward()
    jparams = {k.split(".", 1)[1]: v.numpy() for k, v in convert_params(
        {"m": jax.device_get(jg[0])}).items()}
    tparams = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(tparams, jparams, "params")
    flows = []
    for i, (t, w) in enumerate(zip(jax.tree_util.tree_leaves(tin),
                                   jax.tree_util.tree_leaves(jg[1:]))):
        w = np.asarray(w)
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        flows.append(bool(np.abs(w).max() > 0))
        if not flows[-1]:
            assert np.abs(g).max() == 0, f"input {i}"
        else:
            _close({"x": g}, {"x": w}, f"input {i}")
    return got.item(), flows


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


def _score_maps(rng, h=6, w=9, num_fg=8):
    """One level's FCOS outputs: cls logits, positive box regressions (the
    head's exp), centerness logits."""
    return {"box_cls": (rng.randn(2, h, w, num_fg) * 2).astype(np.float32),
            "box_regression": np.exp(rng.randn(2, h, w, 4)).astype(np.float32),
            "centerness": rng.randn(2, h, w, 1).astype(np.float32)}


@pytest.mark.parametrize("target", [1.0, 0.0])
@pytest.mark.parametrize("domain", ["source", "target"])
@pytest.mark.parametrize("ca_type", ["ca_feature", "ca_loss", "focal"])
def test_ca_discriminator(ca_type, domain, target):
    rng = np.random.RandomState(len(ca_type) + int(target))
    f = rng.randn(2, 6, 9, 32).astype(np.float32)
    sm = _score_maps(rng)
    sm.pop("box_regression")  # CA reads cls and centerness only
    kw = dict(num_convs=2, in_channels=32, grl_lambda=0.1,
              center_aware_weight=20.0, center_aware_type=ca_type)
    _, flows = _run(jd.FCOSDiscriminatorCA(**kw),
                    td.FCOSDiscriminatorCA(**kw), [f, sm], target, domain)
    assert flows == [True, False, False]  # feature; cls, ctr stop here


# base_dis_tower's GN needs a multiple of 32 channels: 28 classes give
# 4 + 27 + 1 for the concatenated maps; maxpool's 6 and attreg's 5 cannot
@pytest.mark.parametrize("base_dis_tower", [False, True])
@pytest.mark.parametrize("out_loss", ["ce", "focal"])
@pytest.mark.parametrize("outmap_op", ["sigmoid", "maxpool", "attreg", "none"])
def test_out_discriminator(outmap_op, out_loss, base_dis_tower):
    rng = np.random.RandomState(len(outmap_op) + len(out_loss))
    num_classes = 28 if base_dis_tower else 9
    sm = _score_maps(rng, h=8, w=12, num_fg=num_classes - 1)
    kw = dict(num_convs=2, grl_lambda=0.1, out_weight=0.5, out_loss=out_loss,
              outmap_op=outmap_op, num_classes=num_classes,
              base_dis_tower=base_dis_tower)
    domain, target = (("target", 0.0) if out_loss == "ce"
                      else ("source", 1.0))
    if base_dis_tower and outmap_op in ("maxpool", "attreg"):
        with pytest.raises(ValueError):
            td.FCOSDiscriminatorOut(**kw)
        with pytest.raises(ValueError):
            jd.FCOSDiscriminatorOut(**kw).init(
                jax.random.PRNGKey(1), jax.tree_util.tree_map(jnp.asarray, sm),
                target)
        return
    _, flows = _run(jd.FCOSDiscriminatorOut(**kw),
                    td.FCOSDiscriminatorOut(**kw), [sm], target, domain)
    # the maps keep their gradient; maxpool reads one cls channel a place
    assert all(flows), flows


def test_out_discriminator_selected_maps():
    """OUTPUT_{REG,CLS,CENTERNESS}_DA select the maps ``sigmoid`` aligns."""
    rng = np.random.RandomState(3)
    sm = _score_maps(rng, h=8, w=12)
    kw = dict(num_convs=1, out_loss="ce", outmap_op="sigmoid", use_cls=False)
    _, flows = _run(jd.FCOSDiscriminatorOut(**kw),
                    td.FCOSDiscriminatorOut(**kw), [sm], 1.0, "source")
    assert flows == [False, True, True]  # cls unused; reg, ctr aligned
