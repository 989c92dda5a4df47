"""Score plus chunk-max and the exact top-k in the PyTorch port vs the JAX package.

Scores: rtol 1e-5 against the JAX Pallas kernel in interpret mode (float32
on both sides, summation order differs). Selection: indices must be EQUAL to
dense ``lax.top_k`` — ties included, which the integer-valued cases make
exact (every dot product is an exact small integer in any summation order).

The ragged cases (B, V and D off every tile size, ``num_items`` inside a
chunk, a [B, V] exclusion mask) are the shapes the card's tiled kernel masks
or zero-fills at its edges; ``tests/test_torch_kernels_on_card.py`` runs the
same shapes on the card. Here the wrapper runs its plain version, held to
rtol 1e-5 / atol 1e-4 (the card's tolerance: dots of up to 256 terms of size
1, scores up to 30, so a score near zero carries 1e-5 of summation noise)
against the Pallas kernel (interpret mode, inputs padded with zero rows to
its 256 x 512 tiles, the mask applied afterwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import score_chunkmax as port_sc
from gat_recommendation_torch.ops import scoring as port_scoring
from gat_recommendation_tpu.ops import scoring as jax_scoring
from gat_recommendation_tpu.ops.pallas.score_chunkmax import CHUNK, fused_score_chunkmax

torch.set_num_threads(1)


def _normal(seed, B, V, D):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, D)).astype(np.float32),
        rng.standard_normal((V, D)).astype(np.float32),
    )


def _integer(seed, B, V, D):
    """Entries in {-1, 0, 1}: dot products are small exact integers, so
    scores tie massively and identically in every summation order."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(-1, 2, (B, D)).astype(np.float32),
        rng.integers(-1, 2, (V, D)).astype(np.float32),
    )


def test_score_chunkmax_matches_pallas_kernel():
    sess, table = _normal(0, 256, 1024, 32)
    num_items = 1024 - 100  # phantom tail
    scores, maxes = port_sc.score_chunkmax(torch.tensor(sess), torch.tensor(table), num_items)
    want_s, want_mt = fused_score_chunkmax(
        jnp.asarray(sess), jnp.asarray(table), num_items, interpret=True
    )
    assert port_sc.CHUNK == CHUNK
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(maxes.numpy(), np.asarray(want_mt).T, rtol=1e-5, atol=1e-5)
    assert np.all(np.isneginf(scores.numpy()[:, num_items:]))


def test_exclusion_mask_sets_minus_inf_and_feeds_the_maxes():
    sess, table = _normal(1, 3, 512, 16)
    rng = np.random.default_rng(1)
    exclude = rng.random((3, 512)) < 0.2
    exclude[1, 64:96] = True  # one whole chunk excluded
    scores, maxes = port_sc.score_chunkmax(
        torch.tensor(sess), torch.tensor(table), 500, torch.tensor(exclude)
    )
    want = sess @ table.T
    want[:, 500:] = -np.inf
    want[exclude] = -np.inf
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(maxes.numpy(), want.reshape(3, -1, 32).max(-1), rtol=1e-5, atol=1e-5)
    assert np.isneginf(maxes.numpy()[1, 2])
    # A [V] mask is the B == 1 form of the same thing.
    one, _ = port_sc.score_chunkmax(
        torch.tensor(sess[:1]), torch.tensor(table), 500, torch.tensor(exclude[0])
    )
    assert torch.equal(torch.isneginf(one[0]), torch.isneginf(scores[0]))
    torch.testing.assert_close(one[0], scores[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make", [_normal, _integer])
@pytest.mark.parametrize("D", [4, 100, 256])
@pytest.mark.parametrize("B,V,num_items", [(2, 96, 70), (7, 4128, 4101), (130, 96, 70), (130, 4128, 4101)])
def test_ragged_shapes_with_exclusion_match_pallas_kernel(make, D, B, V, num_items):
    sess, table = make(B + D, B, V, D)
    rng = np.random.default_rng(V)
    exclude = rng.random((B, V)) < 0.1
    exclude[B - 1, 32:64] = True  # one whole chunk excluded
    scores, maxes = port_sc.score_chunkmax(
        torch.tensor(sess), torch.tensor(table), num_items, torch.tensor(exclude)
    )
    # The Pallas kernel takes whole 256 x 512 tiles: pad with zero rows, cut back.
    sess_p = np.zeros((256, D), np.float32)
    sess_p[:B] = sess
    table_p = np.zeros((-(-V // 512) * 512, D), np.float32)
    table_p[:V] = table
    want, _ = fused_score_chunkmax(jnp.asarray(sess_p), jnp.asarray(table_p), num_items, interpret=True)
    want = np.where(exclude, -np.inf, np.asarray(want)[:B, :V])
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        maxes.numpy(), want.reshape(B, V // 32, 32).max(-1), rtol=1e-5, atol=1e-4
    )
    assert np.array_equal(np.isneginf(scores.numpy()), exclude | (np.arange(V) >= num_items))
    assert np.isneginf(maxes.numpy()[B - 1, 1])
    if make is _integer:  # exact scores: the selection must EQUAL dense lax.top_k of the same matrix
        k = 20
        want_s, want_i = jax.lax.top_k(jnp.asarray(want), k)
        got_s, got_i = port_scoring.select_topk(scores, maxes, k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_variant_entry_points_refuse_cpu_tensors_and_unknown_names():
    """Naming a kernel outright is for CUDA tensors; on the CPU only the
    wrapper's plain version exists."""
    sess, table = _normal(0, 2, 64, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_sc.score_chunkmax_variant(torch.tensor(sess), torch.tensor(table), None, None, "tile")
    with pytest.raises(ValueError, match="variant"):
        port_sc.score_chunkmax_variant(torch.tensor(sess), torch.tensor(table), None, None, "fast")
    before = (port_sc.score_chunkmax.launches, port_sc.score_chunkmax.tile_launches)
    port_sc.score_chunkmax(torch.tensor(sess), torch.tensor(table))
    assert (port_sc.score_chunkmax.launches, port_sc.score_chunkmax.tile_launches) == before


@pytest.mark.parametrize(
    "make,seed,B,V,k",
    [
        (_normal, 0, 4, 2048, 10),
        (_normal, 3, 4, 1024, 20),
        (_integer, 5, 4, 1024, 10),
        (_integer, 6, 2, 2048, 50),
        (_integer, 7, 3, 256, 20),  # fewer chunks (8) than k: one stable sort
    ],
)
def test_selection_matches_dense_lax_top_k(make, seed, B, V, k):
    sess, table = make(seed, B, V, 16)
    num_items = V - 37
    want_s, want_i = jax_scoring.dense_topk(jnp.asarray(sess), jnp.asarray(table), k, num_items)
    got_s, got_i = port_scoring.full_catalog_topk(
        torch.tensor(sess), torch.tensor(table), k, num_items
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    dense_s, dense_i = port_scoring.full_catalog_topk(
        torch.tensor(sess), torch.tensor(table), k, num_items, method="dense"
    )
    np.testing.assert_array_equal(dense_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("seed,k", [(0, 10), (1, 40)])
def test_two_level_topk_scores_matches_jax(seed, k):
    rng = np.random.default_rng(seed)
    # Coarse integer scores at V = 20,000 (> the JAX two-level threshold and
    # not a chunk multiple): heavy ties across chunks, -inf padding exercised.
    scores = rng.integers(0, 50, (3, 20_000)).astype(np.float32)
    want_s, want_i = jax_scoring.two_level_topk_scores(jnp.asarray(scores), k)
    dense_s, dense_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_s, got_i = port_scoring.two_level_topk_scores(torch.tensor(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(dense_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(dense_s))


def test_cross_chunk_tie_resolves_to_the_lower_index():
    """scores [5, 0, 10, 5], chunk 2, k 2: dense gives [2, 0]; skipping the
    ascending sort of the winning chunks would give [2, 3]."""
    scores = torch.tensor([[5.0, 0.0, 10.0, 5.0]])
    s, i = port_scoring.two_level_topk_scores(scores, 2, chunk=2)
    assert i.tolist() == [[2, 0]] and s.tolist() == [[10.0, 5.0]]
    _, want = jax.lax.top_k(jnp.asarray(scores.numpy()), 2)
    assert np.asarray(want).tolist() == [[2, 0]]


def test_unknown_and_unported_methods_raise():
    """An unknown method raises, and the kernel's wrapper refuses a table
    that is not a multiple of 32 rows; 'approx', once unported, is now the
    JAX package's selector (ids equal to its approx_topk on the CPU)."""
    sess, table = _normal(0, 1, 64, 8)
    got_s, got_i = port_scoring.full_catalog_topk(torch.tensor(sess), torch.tensor(table), 3, method="approx")
    want_s, want_i = jax_scoring.full_catalog_topk(jnp.asarray(sess), jnp.asarray(table), 3, method="approx")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        port_scoring.full_catalog_topk(torch.tensor(sess), torch.tensor(table), 3, method="nope")
    with pytest.raises(ValueError, match="multiple of 32"):
        port_sc.score_chunkmax(torch.tensor(sess), torch.tensor(table[:40]))
