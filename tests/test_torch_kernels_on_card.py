"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them; on the
card run (this file imports neither JAX nor the JAX package, so the test
conftest, which does, is skipped):

    python -m pytest --noconftest -q tests/test_torch_kernels_on_card.py

Tolerances: attention rtol 1e-5 / atol 1e-5 forward and rtol 1e-5 / atol 2e-5
backward, scores rtol 1e-5 / atol 1e-4 (float32 everywhere, no TF32; only the
order of summation differs, and scores are dots of up to 512 terms of size
~1). Top-k indices must be EQUAL in the integer-valued cases, where every
score is exact in any order. With attention dropout the kernels and the plain
version draw the same keep bits from the same seed, so the same tolerances
hold. AdamW: table rtol 1e-6 / atol 1e-7; the moments, bf16 with stochastic
rounding included, must be EQUAL bit for bit (the kernel does the plain
version's float32 operations in the same order, without FMA contraction, and
draws the same rounding bits).
"""

import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import embedding_adamw as ea
from gat_recommendation_torch.ops import score_chunkmax as sc
from gat_recommendation_torch.ops import scoring
from gat_recommendation_torch.ops import session_attention as sa
from gat_recommendation_torch.ops import sparse_adamw as sp

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-5, atol=2e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
TABLE_TOL = dict(rtol=1e-6, atol=1e-7)
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize(
    "B,N,heads,HD", [(1, 8, 2, 256), (64, 56, 2, 256), (3, 1, 1, 4), (5, 64, 4, 512), (2, 33, 1, 96)]
)
def test_session_attention_forward_and_backward_match_plain(cuda, B, N, heads, HD, dropout_p):
    q, k, v, adj = _attn_inputs(cuda, B, N, HD)
    dout = torch.from_numpy(
        np.random.default_rng(9).standard_normal((B, N, HD)).astype(np.float32)
    ).to(cuda)
    seed = 0x1234_5678_9ABC_DEF0
    grads = []
    fwd, bwd = sa.session_attention.launches, sa.session_attention.backward_launches
    for fn in (sa.session_attention, sa.session_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, adj, heads, dropout_p, seed)
        grads.append((out, *torch.autograd.grad(out, leaves, dout)))
    torch.cuda.synchronize()
    assert sa.session_attention.launches == fwd + 1
    assert sa.session_attention.backward_launches == bwd + 1
    torch.testing.assert_close(grads[0][0], grads[1][0], **ATTN_TOL)
    for got, want in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(got, want, **ATTN_GRAD_TOL)
    assert torch.all(grads[0][0][:, 0] == 0) and torch.all(grads[0][1][:, 0] == 0)


@pytest.mark.cuda
def test_attention_dropout_keeps_the_stated_share_and_scales(cuda):
    q, k, v, adj = _attn_inputs(cuda, 64, 56, 256, density=1.1)
    adj[:] = True
    ones = torch.ones_like(v)
    out = sa.session_attention(q, k, ones, adj, 2, 0.25, seed=77)
    torch.cuda.synchronize()
    # Every row's weights sum to 1 before dropout, so out = sum of kept weights / 0.75.
    assert abs(out.mean().item() - 1.0) < 0.01
    keep = sa.dropout_keep_mask((64, 2, 56, 56), 0.25, 77, cuda)
    assert abs(keep.float().mean().item() - 0.75) < 0.002


def _adamw_inputs(dev, rows, D, U, n_unique, moment_dtype, seed=4, row_offset=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).to(dev)
    mu = torch.from_numpy((0.01 * rng.standard_normal((rows, D))).astype(np.float32)).to(dev)
    nu = torch.from_numpy((1e-4 * rng.random((rows, D))).astype(np.float32)).to(dev)
    ids = np.sort(rng.choice(np.arange(1, row_offset + rows + 50), n_unique - 1, replace=False))
    uid = np.full(U, 2**31 - 1, np.int32)
    uid[:n_unique] = np.concatenate([[0], ids])
    summed = rng.standard_normal((U, D)).astype(np.float32)
    summed[0] = 0.0
    return (table, mu.to(moment_dtype), nu.to(moment_dtype),
            torch.from_numpy(uid).to(dev), torch.from_numpy(summed).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mu_dtype,nu_dtype,sr",
    [
        (torch.float32, torch.float32, False),
        (torch.bfloat16, torch.bfloat16, False),
        (torch.bfloat16, torch.bfloat16, True),
        (torch.float32, torch.bfloat16, True),
        (torch.bfloat16, torch.float32, True),
    ],
)
@pytest.mark.parametrize("rows,D,U,n_unique,row_offset", [(4096, 256, 1024, 700, 0), (1000, 36, 64, 64, 512), (513, 4, 2048, 3, 0)])
def test_sparse_adamw_kernel_matches_plain(cuda, rows, D, U, n_unique, row_offset, mu_dtype, nu_dtype, sr):
    args = _adamw_inputs(cuda, rows, D, U, n_unique, torch.float32, row_offset=row_offset)
    args = (args[0], args[1].to(mu_dtype), args[2].to(nu_dtype), *args[3:])
    got = [t.clone() for t in args[:3]]
    want = [t.clone() for t in args[:3]]
    before = sp.sparse_adamw.launches
    for count in (1, 2, 7):
        sp.sparse_adamw(*got, *args[3:], count, row_offset=row_offset, stochastic_rounding=sr, **HYPER)
        sp.sparse_adamw_reference(*want, *args[3:], count, row_offset=row_offset, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert sp.sparse_adamw.launches == before + 3
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    assert torch.equal(got[1].view(torch.int16 if mu_dtype == torch.bfloat16 else torch.int32),
                       want[1].view(torch.int16 if mu_dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(got[2].view(torch.int16 if nu_dtype == torch.bfloat16 else torch.int32),
                       want[2].view(torch.int16 if nu_dtype == torch.bfloat16 else torch.int32))
    assert not torch.equal(got[0], args[0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mu_dtype,nu_dtype,sr",
    [(torch.float32, torch.float32, False), (torch.bfloat16, torch.bfloat16, False),
     (torch.bfloat16, torch.bfloat16, True), (torch.float32, torch.bfloat16, True)],
)
@pytest.mark.parametrize("rows,D", [(4096, 256), (777, 36)])
def test_embedding_adamw_kernel_matches_plain(cuda, rows, D, mu_dtype, nu_dtype, sr):
    table, mu, nu, _, _ = _adamw_inputs(cuda, rows, D, 8, 4, torch.float32)
    grad = torch.from_numpy(
        np.random.default_rng(5).standard_normal((rows, D)).astype(np.float32)
    ).to(cuda)
    got = [table.clone(), mu.to(mu_dtype), nu.to(nu_dtype)]
    want = [t.clone() for t in got]
    before = ea.embedding_adamw.launches
    for count in (1, 2, 7):
        ea.embedding_adamw(*got, grad, count, stochastic_rounding=sr, **HYPER)
        ea.embedding_adamw_reference(*want, grad, count, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert ea.embedding_adamw.launches == before + 3
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    for g, w in zip(got[1:], want[1:]):
        bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(g.view(bits), w.view(bits))


@pytest.mark.cuda
def test_adamw_wrappers_reject_what_the_kernel_does_not_take(cuda):
    table, mu, nu, uid, summed = _adamw_inputs(cuda, 256, 8, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        sp.sparse_adamw(table, mu, nu, uid.long(), summed, 1, **HYPER)
    with pytest.raises(ValueError, match="summed"):
        sp.sparse_adamw(table, mu, nu, uid, summed[:, :4].contiguous(), 1, **HYPER)
    with pytest.raises(ValueError, match="bfloat16"):
        sp.sparse_adamw(table, mu, nu, uid, summed, 1, stochastic_rounding=True, **HYPER)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ea.embedding_adamw(table, mu.half(), nu, summed, 1, **HYPER)
