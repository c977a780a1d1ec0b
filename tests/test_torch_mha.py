"""The port's MHA, dropout, prototype EMA and gradient reversal, on the CPU.

* ``MultiHeadSelfAttention`` against ``scan_tpu``'s with its weights carried
  across, without dropout (no rng there, no generator here), masked and
  unmasked: outputs and input gradients within rtol 1e-5 of the largest
  (float32 matmuls in another order).
* Dropout: one generator seed gives the same masks; the drop rate is 0.1
  within 4 standard deviations over ~2.6e5 draws; a module built with
  dropout and called without a generator is deterministic.
* ``update_prototype`` in its three branches (PROTO_ITER 1; the cycling
  counter; the RNN's saturating counter, stepped past saturation), against
  ``scan_tpu`` over the same batches: counters equal, prototypes within
  1e-6; the batch means enter detached.
* ``gradient_reversal``: the identity forward, ``-lambda * g`` backward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scan_tpu.modeling.condgraph import prototype as jproto
from scan_tpu.modeling.discriminator.grl import gradient_reversal as jgrl
from scan_tpu.modeling.layers import MultiHeadSelfAttention as JaxMHA
from scan_tpu_torch.modeling.condgraph import prototype as tproto
from scan_tpu_torch.modeling.discriminator.grl import gradient_reversal
from scan_tpu_torch.modeling.layers import MultiHeadSelfAttention
from scan_tpu_torch.utils.jax_weights import convert_params


def _mha_pair(dropout=0.0):
    jmod = JaxMHA(model_dim=256, num_heads=4, dropout=dropout)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((6, 256)))
    tmod = MultiHeadSelfAttention(256, 4, dropout)
    sd = {k.split(".", 1)[1]: v for k, v in
          convert_params({"m": jax.device_get(params)}).items()}
    tmod.load_state_dict(sd, strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("n,masked", [(24, True), (24, False), (10, True)])
def test_mha_matches_scan_tpu(n, masked):
    jmod, params, tmod = _mha_pair(dropout=0.1)
    rng = np.random.RandomState(n)
    x = rng.randn(n, 256).astype(np.float32)
    mask = rng.rand(n) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)

    def f(xx):
        out = jmod.apply(params, xx, mask=jm)
        return jnp.sum(out * jnp.arange(out.size).reshape(out.shape) / out.size), out

    (_, want), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt, mask=None if mask is None else torch.from_numpy(mask))
    (got * torch.arange(got.numel()).reshape(got.shape) / got.numel()).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


def test_mha_dropout_draws():
    _, _, tmod = _mha_pair(dropout=0.1)
    x = torch.randn(32, 256)
    a = tmod(x, generator=torch.Generator().manual_seed(7))
    b = tmod(x, generator=torch.Generator().manual_seed(7))
    c = tmod(x, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # without a generator: deterministic, and equal to the rate-0 module
    plain = MultiHeadSelfAttention(256, 4, 0.0)
    plain.load_state_dict(tmod.state_dict())
    torch.testing.assert_close(tmod(x), tmod(x), rtol=0, atol=0)
    torch.testing.assert_close(tmod(x), plain(x), rtol=0, atol=0)
    # the drop rate, on the attention weights' dropout
    from scan_tpu_torch.modeling.layers import dropout

    ones = torch.ones(512, 512)
    kept = dropout(ones, 0.1, torch.Generator().manual_seed(1))
    share = float((kept == 0).float().mean())
    sd = (0.1 * 0.9 / ones.numel()) ** 0.5
    assert abs(share - 0.1) < 4 * sd, share
    assert torch.allclose(kept[kept != 0], torch.tensor(1 / 0.9))


@pytest.mark.parametrize("proto_iter,use_rnn", [(1, False), (3, False), (3, True)])
def test_update_prototype_branches(proto_iter, use_rnn):
    rng = np.random.RandomState(proto_iter + 2 * use_rnn)
    shape = (9, 16) + ((proto_iter,) if proto_iter > 1 else ())
    proto = rng.randn(*shape).astype(np.float32)
    jstate = jproto.ProtoState(jnp.asarray(proto), jnp.asarray(-1, jnp.int32))
    tstate = tproto.ProtoState(torch.from_numpy(proto), torch.tensor(-1, dtype=torch.int32))
    for step in range(5):  # past the RNN's saturation at ITER
        batch = rng.randn(9, 16).astype(np.float32)
        batch[step % 9] = 0.0
        exist = rng.rand(9) > 0.3
        jstate = jproto.update_prototype(jstate, jnp.asarray(batch), proto_iter,
                                         use_rnn, True, 0.95,
                                         exist=jnp.asarray(exist))
        tb = torch.from_numpy(batch).requires_grad_(True)
        tstate = tproto.update_prototype(tstate, tb, proto_iter, use_rnn,
                                         True, 0.95,
                                         exist=torch.from_numpy(exist))
        assert not tstate.prototype.requires_grad  # detached batch
        assert int(tstate.counter) == int(jstate.counter), step
        np.testing.assert_allclose(tstate.prototype.numpy(),
                                   np.asarray(jstate.prototype),
                                   rtol=1e-6, atol=1e-6)
    # fixed momentum and the reference's sum test for ``exist``
    jnext = jproto.update_prototype(jstate, jnp.asarray(batch), proto_iter,
                                    use_rnn, False, 0.9)
    tnext = tproto.update_prototype(tstate, torch.from_numpy(batch),
                                    proto_iter, use_rnn, False, 0.9)
    np.testing.assert_allclose(tnext.prototype.numpy(),
                               np.asarray(jnext.prototype), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tproto.source_prototype_view(tnext, proto_iter).numpy(),
        np.asarray(jproto.source_prototype_view(jnext, proto_iter)),
        rtol=1e-6, atol=1e-6)


def test_gradient_reversal():
    x = torch.randn(3, 5, requires_grad=True)
    g = torch.randn(3, 5)
    y = gradient_reversal(x, 0.02)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    y.backward(g)
    torch.testing.assert_close(x.grad, -0.02 * g)
    _, vjp = jax.vjp(lambda t: jgrl(t, 0.02), jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                               rtol=1e-7)
