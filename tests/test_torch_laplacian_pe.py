"""The port's Laplacian PE (``models/laplacian_pe.py``, ``GraphTransformer.precompute_pe``)
vs the JAX package's.

Both run numpy and scipy on the host, so on the same edges they must give
the same array: atol 1e-6, on a graph of two components and isolated ids,
through both routes of the eigensolve (the dense ``eigh`` below 64 connected
nodes, Lanczos on the spectral complement from 64 on), and for both
normalizations. ``precompute_pe`` must fill ``cached_pe`` as the JAX
``precompute_pe`` fills ``state["cached_pe"]``, the padded phantom rows zero.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gat_recommendation_torch.models import registry
from gat_recommendation_torch.models.laplacian_pe import compute_laplacian_pe
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.models.laplacian_pe import compute_laplacian_pe as jax_compute_laplacian_pe

torch.set_num_threads(1)

ATOL = 1e-6


def _two_components(n_a: int, n_b: int, num_nodes: int, seed: int = 0):
    """Random edges inside ids 1..n_a and inside n_a+1..n_a+n_b (a path through
    each keeps it connected), a self-loop and duplicates; ids above stay isolated."""
    rng = np.random.default_rng(seed)
    edges = []
    for lo, n in ((1, n_a), (n_a + 1, n_b)):
        ids = np.arange(lo, lo + n)
        edges += list(zip(ids[:-1], ids[1:]))
        extra = rng.integers(lo, lo + n, (3 * n, 2))
        edges += [tuple(e) for e in extra]
    edges += [(2, 2), (1, 2), (2, 1)]
    item_i, item_j = np.array(edges, np.int64).T
    assert item_j.max() < num_nodes
    return item_i, item_j


@pytest.mark.parametrize("n_a,n_b", [(12, 9), (70, 45)], ids=["dense_eigh", "lanczos"])
@pytest.mark.parametrize("normalization", ["sym", "rw"])
def test_compute_laplacian_pe_matches_jax(n_a, n_b, normalization):
    num_nodes = n_a + n_b + 30
    item_i, item_j = _two_components(n_a, n_b, num_nodes)
    want = jax_compute_laplacian_pe(item_i, item_j, num_nodes, k=6, normalization=normalization)
    got = compute_laplacian_pe(item_i, item_j, num_nodes, k=6, normalization=normalization)
    assert got.shape == (num_nodes, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[n_a + n_b + 1:] == 0) and np.all(got[0] == 0)  # isolated ids
    assert np.all(got >= 0) and np.abs(got).sum() > 0


def test_degenerate_graphs_match_jax():
    """No edge at all: zeros. Fewer connected nodes than k + 1: the columns
    past the eigenvectors there are stay zero."""
    empty = np.zeros(0, np.int64)
    assert not compute_laplacian_pe(empty, empty, 10, k=4).any()
    item_i, item_j = np.array([1, 2]), np.array([2, 3])
    np.testing.assert_allclose(compute_laplacian_pe(item_i, item_j, 8, k=4),
                               jax_compute_laplacian_pe(item_i, item_j, 8, k=4), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="normalization"):
        compute_laplacian_pe(item_i, item_j, 8, normalization="none")


@pytest.mark.parametrize("name", ["graph_transformer", "graph_transformer_optimized"])
def test_precompute_pe_fills_cached_pe_as_the_jax_model(name):
    from gat_recommendation_tpu.models import graph_transformer as jax_gt

    num_items = 600  # 1024 padded rows: a phantom tail
    item_i, item_j = _two_components(80, 50, num_items, seed=3)
    model = jax_create_model(name, num_items=num_items, embedding_dim=16, hidden_dim=16, laplacian_k=4)
    _, state = model.init_params(jax.random.key(0))
    want = np.asarray(jax_gt.precompute_pe(state, model.config, item_i, item_j)["cached_pe"])

    cfg = dataclasses.asdict(model.config)
    port = registry.create_model(name, cfg.pop("num_items"), device="cpu", **cfg)
    buffer = port.cached_pe
    with torch.no_grad():
        buffer.fill_(7.0)  # every row is written, the phantom tail to zero
    assert port.uses_laplacian_pe
    port.precompute_pe(item_i, item_j)
    assert port.cached_pe is buffer and buffer.shape == (1024, 4)
    np.testing.assert_allclose(buffer.numpy(), want, rtol=0, atol=ATOL)
    assert not buffer[num_items:].any()


@pytest.mark.parametrize("name,kw", [("gat", {}), ("graphsage", {}),
                                     ("graph_transformer_optimized", {"use_laplacian_pe": False})])
def test_precompute_pe_is_a_no_op_without_encodings(name, kw):
    model = registry.create_model(name, 50, embedding_dim=8, hidden_dim=8, device="cpu", **kw)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not model.uses_laplacian_pe
    assert model.precompute_pe(np.array([1, 2]), np.array([2, 3])) is None
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
