"""Session attention in the PyTorch port vs the JAX package.

The port's plain version (what its wrapper runs on CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against the attention
core of the JAX ``transformer_conv``. Tolerance rtol 1e-5 / atol 1e-6: both
sides are float32 and differ only in summation order.

The batch cases stand on both sides of the size from which the card's
wrapper takes its one-block-per-session kernel (1024 blocks of four
destinations, 448 above 32 nodes), at node counts on and off that kernel's tile sizes; ``tests/test_torch_kernels_on_card.py``
runs the same shapes on the card. Here the wrapper runs its plain version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import session_attention as port_attn
from gat_recommendation_tpu.models.layers import init_transformer_conv, transformer_conv
from gat_recommendation_tpu.ops.masked import masked_softmax
from gat_recommendation_tpu.ops.pallas.session_attention import fused_session_attention

torch.set_num_threads(1)


def _inputs(seed, B, N, HD, density=0.35):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, HD)).astype(np.float32) for _ in range(3))
    adj = rng.random((B, N, N)) < density
    return q, k, v, adj


def _jax_core(q, k, v, adj, heads):
    B, N, HD = q.shape
    d = HD // heads
    qr, kr, vr = (t.reshape(B, N, heads, d) for t in (q, k, v))
    scores = jnp.einsum("bihd,bjhd->bhij", qr, kr) / math.sqrt(d)
    alpha = masked_softmax(scores, adj[:, None, :, :], axis=-1)
    return jnp.einsum("bhij,bjhd->bihd", alpha, vr).reshape(B, N, HD)


def _port(q, k, v, adj, heads):
    t = [torch.tensor(a) for a in (q, k, v, adj)]
    return port_attn.session_attention(*t, heads=heads).numpy()


@pytest.mark.parametrize("heads,N,B", [(1, 8, 6), (2, 8, 6), (4, 16, 6), (2, 56, 2)])
def test_matches_pallas_kernel_and_xla_core(heads, N, B):
    q, k, v, adj = _inputs(0, B, N, 16)
    got = _port(q, k, v, adj, heads)
    pallas = fused_session_attention(
        *(jnp.asarray(a) for a in (q, k, v, adj)), heads=heads, interpret=True
    )
    core = _jax_core(*(jnp.asarray(a) for a in (q, k, v, adj)), heads)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(core), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [1, 7, 56, 64])
@pytest.mark.parametrize("B,heads,HD", [(3, 2, 16), (31, 2, 24), (32, 2, 16), (70, 1, 8), (17, 4, 32)])  # 3..1120 row blocks
def test_batches_around_the_staged_size_match_pallas_kernel_and_xla_core(B, heads, HD, N):
    q, k, v, adj = _inputs(N + B, B, N, HD)
    adj[:, 0, :] = False  # an isolated destination in every session
    got = _port(q, k, v, adj, heads)
    pallas = fused_session_attention(
        *(jnp.asarray(a) for a in (q, k, v, adj)), heads=heads, interpret=True
    )
    core = _jax_core(*(jnp.asarray(a) for a in (q, k, v, adj)), heads)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(core), rtol=1e-5, atol=1e-6)
    assert np.all(got[:, 0] == 0.0)


@pytest.mark.parametrize(
    "B,N,heads,HD,density",
    [(1, 5, 2, 64, 0.9),     # one row group of four destinations and one more
     (1, 33, 2, 256, 0.05),  # sources on both halves of a warp, almost no edge
     (8, 4, 2, 64, 1.1),     # exactly one row group, every edge
     (31, 3, 1, 32, 0.5),    # a small batch of sessions shorter than a group
     (1, 64, 2, 256, 1.1)],  # the serving shape at its widest: N = 64, d = 128, dense
)
def test_serving_batches_match_pallas_kernel_and_xla_core_at_row_group_edges(B, N, heads, HD, density):
    """Below the staged size the card's wrapper gives four destinations of a
    session and head to a block; the plain version that kernel is held to on
    the card is held to the JAX kernel here at node counts on and off that
    group, at head widths 32 and 128 and densities near 0 and 1."""
    q, k, v, adj = _inputs(N + HD, B, N, HD, density)
    adj[:, 0, :] = False
    got = _port(q, k, v, adj, heads)
    pallas = fused_session_attention(
        *(jnp.asarray(a) for a in (q, k, v, adj)), heads=heads, interpret=True
    )
    core = _jax_core(*(jnp.asarray(a) for a in (q, k, v, adj)), heads)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(core), rtol=1e-5, atol=1e-6)
    assert np.all(got[:, 0] == 0.0)


def test_variant_entry_point_refuses_cpu_tensors_and_unknown_names():
    """Naming a kernel outright is for CUDA tensors; on the CPU only the
    wrapper's plain version exists, and it counts no launch."""
    t = [torch.from_numpy(a) for a in _inputs(4, 2, 8, 16)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attn.session_attention_variant(*t, 2, 0.0, 0, "staged")
    with pytest.raises(ValueError, match="variant"):
        port_attn.session_attention_variant(*t, 2, 0.0, 0, "tile")
    before = (port_attn.session_attention.launches, port_attn.session_attention.staged_launches)
    port_attn.session_attention(*t, heads=2)
    assert (port_attn.session_attention.launches, port_attn.session_attention.staged_launches) == before


def test_isolated_rows_are_exactly_zero():
    q, k, v, _ = _inputs(1, 2, 8, 8)
    adj = np.zeros((2, 8, 8), bool)
    adj[0, 1, 0] = True
    out = _port(q, k, v, adj, heads=2)
    assert np.all(out[0, 0] == 0.0) and np.all(out[0, 2:] == 0.0)
    assert np.all(out[1] == 0.0)
    assert np.abs(out[0, 1]).sum() > 0


def test_cpu_tensors_take_the_plain_version():
    q, k, v, adj = _inputs(2, 3, 8, 16)
    before = port_attn.session_attention.launches
    t = [torch.from_numpy(a) for a in (q, k, v, adj)]
    out = port_attn.session_attention(*t, heads=2)
    ref = port_attn.session_attention_reference(*t, heads=2)
    assert torch.equal(out, ref)
    assert port_attn.session_attention.launches == before


def test_transformer_conv_core_matches_jax_layer():
    """The core plus the beta-gated skip, written out in JAX, is the JAX layer;
    the port's core dropped into that composition gives the same layer."""
    from gat_recommendation_tpu.models.base import linear

    rng = np.random.default_rng(3)
    B, N, in_dim, hidden, heads = 4, 8, 10, 16, 2
    x = jnp.asarray(rng.standard_normal((B, N, in_dim)).astype(np.float32))
    adj = jnp.asarray(rng.random((B, N, N)) < 0.3)
    params = init_transformer_conv(jax.random.key(3), in_dim, hidden // heads, heads)
    ref = transformer_conv(params, x, adj, heads=heads)

    q, k, v = (np.asarray(linear(params[n], x)) for n in ("query", "key", "value"))
    out = jnp.asarray(_port(q, k, v, np.asarray(adj), heads))
    x_r = linear(params["skip"], x)
    beta = jax.nn.sigmoid(linear(params["beta"], jnp.concatenate([out, x_r, out - x_r], -1)))
    np.testing.assert_allclose(
        np.asarray(beta * x_r + (1.0 - beta) * out), np.asarray(ref), rtol=1e-5, atol=1e-6
    )


def test_wrapper_rejects_other_devices():
    q = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_attn.session_attention(q, q, q, torch.empty((1, 8, 8), dtype=torch.bool), heads=2)
