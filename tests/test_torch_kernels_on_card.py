"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them; on the
card run (this file imports neither JAX nor the JAX package, so the test
conftest, which does, is skipped):

    python -m pytest --noconftest -q tests/test_torch_kernels_on_card.py

Tolerances: attention rtol 1e-5 / atol 1e-5 and scores rtol 1e-5 / atol 1e-4
(float32 everywhere, no TF32; only the order of summation differs, and
scores are dots of up to 512 terms of size ~1). Top-k indices must be EQUAL
in the integer-valued cases, where every score is exact in any order.
"""

import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import score_chunkmax as sc
from gat_recommendation_torch.ops import scoring
from gat_recommendation_torch.ops import session_attention as sa

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs these checks on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, B, N, HD, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, HD)).astype(np.float32)).to(dev)
               for _ in range(3))
    adj = torch.from_numpy(rng.random((B, N, N)) < density).to(dev)
    adj[:, 0, :] = False  # an isolated destination in every session
    return q, k, v, adj


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,N,heads,HD",
    [(1, 8, 2, 256), (1, 56, 2, 256), (64, 56, 2, 256), (3, 1, 1, 4), (5, 64, 4, 256), (2, 33, 1, 96)],
)
def test_session_attention_kernel_matches_plain(cuda, B, N, heads, HD):
    q, k, v, adj = _attn_inputs(cuda, B, N, HD)
    before = sa.session_attention.launches
    got = sa.session_attention(q, k, v, adj, heads)
    torch.cuda.synchronize()
    assert sa.session_attention.launches == before + 1
    want = sa.session_attention_reference(q, k, v, adj, heads)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.all(got[:, 0] == 0)


@pytest.mark.cuda
def test_session_attention_rejects_shapes_the_kernel_does_not_take(cuda):
    q, k, v, adj = _attn_inputs(cuda, 1, 65, 256)
    with pytest.raises(ValueError, match="nodes"):
        sa.session_attention(q, k, v, adj, 2)
    q, k, v, adj = _attn_inputs(cuda, 1, 8, 512)
    with pytest.raises(ValueError, match="head_dim"):
        sa.session_attention(q, k, v, adj, 2)
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sa.session_attention(q, strided, v, adj, 4)


def _score_inputs(dev, B, V, D, integer, seed=2):
    rng = np.random.default_rng(seed)
    if integer:
        sess, table = rng.integers(-1, 2, (B, D)), rng.integers(-1, 2, (V, D))
    else:
        sess, table = rng.standard_normal((B, D)), rng.standard_normal((V, D))
    return (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (sess, table))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,D,integer", [(1, 256, False), (1, 256, True), (4, 256, False), (2, 64, True), (3, 512, False)]
)
def test_score_chunkmax_kernel_matches_plain(cuda, B, D, integer):
    V, num_items = 8192, 8000
    sess, table = _score_inputs(cuda, B, V, D, integer)
    exclude = torch.zeros((B, V), dtype=torch.uint8, device=cuda)
    exclude[:, ::7] = 1
    before = sc.score_chunkmax.launches
    got = sc.score_chunkmax(sess, table, num_items, exclude)
    torch.cuda.synchronize()
    assert sc.score_chunkmax.launches == before + 1
    want = sc.score_chunkmax_reference(sess, table, num_items, exclude)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCORE_TOL)
    if integer:
        for k in (10, 100):
            s_got, i_got = scoring.select_topk(*got, k)
            s_want, i_want = scoring.dense_topk(sess, table, k, num_items, exclude)
            assert torch.equal(i_got, i_want) and torch.equal(s_got, s_want)


@pytest.mark.cuda
def test_score_chunkmax_takes_a_one_row_exclusion_mask(cuda):
    sess, table = _score_inputs(cuda, 1, 4096, 256, False)
    exclude = torch.zeros(4096, dtype=torch.bool, device=cuda)
    exclude[[0, 5, 100, 4000]] = True
    got, maxes = sc.score_chunkmax(sess, table, 4000, exclude)
    torch.cuda.synchronize()
    assert torch.isneginf(got[0, [0, 5, 100]]).all() and torch.isneginf(got[0, 4000:]).all()
    want, want_m = sc.score_chunkmax_reference(sess, table, 4000, exclude)
    torch.testing.assert_close(got, want, **SCORE_TOL)
    torch.testing.assert_close(maxes, want_m, **SCORE_TOL)
