"""Gradients and dropout of the port's session attention vs the JAX package.

The JAX layer (``models/layers.py::transformer_conv``) is written out here
with an injected keep mask, because its own dropout draws from ``jax.random``
and the port's from a counter hash: with the same mask both must give the
same output and, through ``jax.grad`` and autograd, the same gradients.
Tolerance rtol 1e-5 / atol 1e-6 in float32 (summation order only). On CPU
tensors the wrapper runs the plain version, which is what is differentiated
here; the CUDA backward is held against it on the card
(``tests/test_torch_kernels_on_card.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import session_attention as sa
from gat_recommendation_tpu.models.layers import transformer_conv
from gat_recommendation_tpu.ops.masked import masked_softmax as jax_masked_softmax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(B=3, N=8, heads=2, d=8, seed=0, density=0.5):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, N, heads * d)).astype(np.float32) for _ in range(4))
    adj = rng.random((B, N, N)) < density
    adj[:, 0, :] = False  # an isolated destination in every session
    return q, k, v, adj, dout


def _jax_attention(q, k, v, adj, heads, keep, rate):
    """The attention core of transformer_conv with the keep mask injected."""
    B, N, HD = q.shape
    d = HD // heads
    qr, kr, vr = (t.reshape(B, N, heads, d) for t in (q, k, v))
    scores = jnp.einsum("bihd,bjhd->bhij", qr, kr) / math.sqrt(d)
    alpha = jax_masked_softmax(scores, adj[:, None, :, :], axis=-1)
    if keep is not None:
        alpha = jnp.where(keep, alpha / (1.0 - rate), 0.0)
    return jnp.einsum("bhij,bjhd->bihd", alpha, vr).reshape(B, N, HD)


def _torch_grads(fn, q, k, v, dout):
    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in (q, k, v)]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(dout))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("B,N,heads,d", [(3, 8, 2, 8), (2, 16, 1, 4), (4, 5, 4, 16)])
def test_attention_gradients_match_jax_grad_with_the_same_keep_mask(B, N, heads, d, rate):
    q, k, v, adj, dout = _inputs(B, N, heads, d, seed=N)
    seed = 0xC0FFEE_0000_0001
    keep = sa.dropout_keep_mask((B, heads, N, N), rate, seed, "cpu").numpy() if rate else None
    out, grads = _torch_grads(
        lambda a, b, c: sa.session_attention(a, b, c, torch.from_numpy(adj), heads, rate, seed),
        q, k, v, dout)

    def scalar(a, b, c):
        return jnp.sum(_jax_attention(a, b, c, jnp.asarray(adj), heads, keep, rate) * dout)

    want_out = _jax_attention(*map(jnp.asarray, (q, k, v, adj)), heads, keep, rate)
    want = jax.grad(scalar, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    for g, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize(
    "B,N,heads,d,density",
    [(2, 64, 2, 32, 0.3),   # the largest N the kernels take
     (2, 7, 2, 32, 0.5),    # ragged N, below one row group and one 4 x 4 tile
     (1, 64, 1, 128, 0.02),  # the widest head, almost no edge: tiles and rows skipped
     (2, 56, 2, 32, 1.1),   # every edge present
     (2, 17, 1, 32, 0.05),  # just past the 2 x 2-tile kernels (N <= 16)
     (2, 16, 2, 128, 0.9)],
)
def test_attention_gradients_match_jax_grad_at_the_shapes_the_kernels_special_case(B, N, heads, d, density, rate):
    """The plain version is the yardstick the CUDA kernels are held to on the
    card; here it is held to jax.grad where the kernels change their tiling
    (N <= 16, N = 64, N off a multiple of 4 or 8), at d = 32 and 128 and at
    densities near 0 and 1."""
    q, k, v, adj, dout = _inputs(B, N, heads, d, seed=N + d, density=density)
    seed = 0xC0FFEE_0000_0002
    keep = sa.dropout_keep_mask((B, heads, N, N), rate, seed, "cpu").numpy() if rate else None
    out, grads = _torch_grads(
        lambda a, b, c: sa.session_attention(a, b, c, torch.from_numpy(adj), heads, rate, seed),
        q, k, v, dout)
    dq, dk, dv = sa.session_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v, adj, dout)), heads, rate, seed)

    def scalar(a, b, c):
        return jnp.sum(_jax_attention(a, b, c, jnp.asarray(adj), heads, keep, rate) * dout)

    want_out = _jax_attention(*map(jnp.asarray, (q, k, v, adj)), heads, keep, rate)
    want = jax.grad(scalar, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    for g, direct, w, name in zip(grads, (dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)
        assert torch.equal(g, direct)  # the function the autograd node calls, on CPU tensors
    assert torch.all(out[:, 0] == 0) and torch.all(grads[0][:, 0] == 0)


def test_written_out_jax_attention_is_the_layers_core():
    """With an identity skip and no dropout the written-out core reproduces
    transformer_conv's attention term, so the comparison above holds the port
    to the layer the JAX package trains."""
    B, N, heads, d = 2, 8, 2, 4
    q, k, v, adj, _ = _inputs(B, N, heads, d, seed=3)
    hd = heads * d
    eye = np.eye(hd, dtype=np.float32)
    zero = np.zeros(hd, np.float32)
    x = q
    params = {
        "query": {"w": eye, "b": zero}, "key": {"w": eye * 0.5, "b": zero},
        "value": {"w": eye * 2.0, "b": zero}, "skip": {"w": eye * 0.0, "b": zero},
        "beta": {"w": np.zeros((3 * hd, 1), np.float32)},
    }
    layer = transformer_conv(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(adj), heads=heads)
    core = _jax_attention(jnp.asarray(x), jnp.asarray(0.5 * x), jnp.asarray(2.0 * x), jnp.asarray(adj),
                          heads, None, 0.0)
    np.testing.assert_allclose(np.asarray(layer), 0.5 * np.asarray(core), **TOL)  # beta = sigmoid(0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_isolated_destinations_give_zero_output_and_zero_gradients(rate):
    q, k, v, adj, dout = _inputs(4, 8, 2, 8, seed=5)
    adj[:, 3, :] = False
    adj[:, :, 6] = False  # a source nobody attends to
    out, (dq, dk, dv) = _torch_grads(
        lambda a, b, c: sa.session_attention(a, b, c, torch.from_numpy(adj), 2, rate, 11), q, k, v, dout)
    assert torch.all(out[:, 0] == 0) and torch.all(out[:, 3] == 0)
    assert torch.all(dq[:, 0] == 0) and torch.all(dq[:, 3] == 0)
    assert torch.all(dk[:, 6] == 0) and torch.all(dv[:, 6] == 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_all_masked_batch_has_zero_gradients_everywhere():
    q, k, v, adj, dout = _inputs(2, 8, 2, 8)
    adj[:] = False
    out, grads = _torch_grads(
        lambda a, b, c: sa.session_attention(a, b, c, torch.from_numpy(adj), 2), q, k, v, dout)
    assert torch.all(out == 0) and all(torch.all(g == 0) for g in grads)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_gradcheck_of_the_plain_version_in_float64(rate):
    rng = np.random.default_rng(1)
    B, N, heads, d = 2, 5, 2, 3
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, heads * d))).requires_grad_(True) for _ in range(3))
    adj = torch.from_numpy(rng.random((B, N, N)) < 0.6)
    adj[:, 0, :] = False
    assert torch.autograd.gradcheck(
        lambda a, b, c: sa.session_attention_reference(a, b, c, adj, heads, rate, 99), (q, k, v),
        eps=1e-6, atol=1e-5)


def test_dropout_keeps_the_stated_share_and_scales_the_kept_weights():
    B, N, heads, rate = 64, 32, 2, 0.25
    keep = sa.dropout_keep_mask((B, heads, N, N), rate, 1234, "cpu")
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * math.sqrt(rate * (1 - rate) / n)
    # per head, row and column the share holds too (no structure along any axis)
    for dim in range(4):
        share = keep.float().mean(dim=[x for x in range(4) if x != dim])
        bound = 5 * math.sqrt(rate * (1 - rate) / (n / keep.shape[dim]))
        assert (share - (1 - rate)).abs().max() < bound
    q, k, v, _, _ = _inputs(B, N, heads, 4, seed=2)
    adj = torch.ones(B, N, N, dtype=torch.bool)
    ones = torch.ones(B, N, heads * 4)
    out = sa.session_attention(torch.from_numpy(q), torch.from_numpy(k), ones, adj, heads, rate, 1234)
    # With v = 1 each output is the sum of the kept weights / (1 - rate): mean 1.
    assert abs(out.mean().item() - 1.0) < 0.01
    # One source per destination: its weight is 1, so the output is 0 or 1 / (1 - rate).
    eye = torch.eye(N, dtype=torch.bool).expand(B, N, N)
    out = sa.session_attention(torch.from_numpy(q), torch.from_numpy(k), ones, eye, heads, rate, 1234)
    assert set(out.unique().tolist()) == {0.0, (torch.tensor(1.0) / (1 - rate)).item()}


def test_dropout_is_a_pure_function_of_the_seed_and_eval_ignores_it():
    q, k, v, adj, _ = _inputs(2, 8, 2, 8, seed=4)
    args = [torch.from_numpy(a) for a in (q, k, v, adj)]
    a = sa.session_attention(*args, 2, 0.3, seed=5)
    b = sa.session_attention(*args, 2, 0.3, seed=5)
    c = sa.session_attention(*args, 2, 0.3, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(sa.session_attention(*args, 2, 0.0, seed=5), sa.session_attention(*args, 2))
    with pytest.raises(ValueError, match="seed"):
        sa.session_attention(*args, 2, 0.3)
    with pytest.raises(ValueError, match="dropout_p"):
        sa.session_attention(*args, 2, 1.0, seed=1)
