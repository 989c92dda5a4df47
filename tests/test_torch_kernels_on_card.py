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
draws the same rounding bits). The lazy AdamW row kernels are held to their
plain versions the same way: weights TABLE_TOL (the series divides by a
reciprocal, not by the IEEE division), float32 moments and last_step equal
(the moments' decay uses expf on both sides and no division), bf16 moments
with stochastic rounding equal bit for bit, rows outside uid untouched; at
0, 1, 16 and 64 series terms on every row, and a second gather (its row
tickets start over) equal to the first.

Each wrapper holds two kernels and chooses by shape: scoring by B (one warp
per chunk below ``TILE_MIN_BATCH`` sessions, the tiled product from there up),
the attention forward by the blocks its first kernel would need (one warp
per destination, four destinations to a block, below ``STAGED_MIN_ROW_BLOCKS``
blocks, ``STAGED_MIN_ROW_BLOCKS_WIDE`` above 32 nodes; one block per session
and head from there up). The cases below reach both sides by their shapes,
and the second launch counter of each wrapper says which kernel ran. The
attention backward is one kernel (one block per session and head) whose
product passes take 2 x 2 tiles up to N = 16 and 4 x 4 tiles above; its cases
stand on both sides of that, on and off multiples of 4 and 8 nodes.

The kernels that run inside the chained train step's CUDA graphs read the
step count, the bias corrections and the seeds from a row of the step block
in device memory: given a row of a block of several steps they must EQUAL
what they give for the Python int (the one-row block the wrapper builds from
the host functions of the by-value path). Node dropout's kernel EQUALS its
plain version, forward and backward. Replayed graphs, a single step and
groups of four, must EQUAL the eager unchained steps on the same state bit for
bit, with the launch counters counting per step run.
"""

import numpy as np
import pytest
import torch

from gat_recommendation_torch.ops import embedding_adamw as ea
from gat_recommendation_torch.ops import lazy_adamw as la
from gat_recommendation_torch.ops import node_dropout as nd
from gat_recommendation_torch.ops import score_chunkmax as sc
from gat_recommendation_torch.ops import scoring
from gat_recommendation_torch.ops import session_attention as sa
from gat_recommendation_torch.ops import sparse_adamw as sp

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-5, atol=2e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
TABLE_TOL = dict(rtol=1e-6, atol=1e-7)
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
TILE_MIN_BATCH = 6  # kTileMinBatch of csrc/score_chunkmax.cu
# kStagedMinRowBlocks (N <= 32), kStagedMinRowBlocksWide (N > 32) and kRowWarps of csrc/session_attention.cu
STAGED_MIN_ROW_BLOCKS, STAGED_MIN_ROW_BLOCKS_WIDE, ROW_WARPS = 1024, 448, 4


def _takes_staged(B, N, heads):
    blocks = B * heads * -(-N // ROW_WARPS)
    return blocks >= (STAGED_MIN_ROW_BLOCKS if N <= 32 else STAGED_MIN_ROW_BLOCKS_WIDE)


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
    [(1, 8, 2, 256), (1, 56, 2, 256), (64, 56, 2, 256), (3, 1, 1, 4), (5, 64, 4, 256), (2, 33, 1, 96),
     # one block per (b, h) from the stated row blocks up: 16 sessions at N = 56, 256 at N = 8
     (512, 56, 2, 256), (512, 8, 2, 256), (1100, 1, 1, 4), (300, 7, 2, 64), (16, 64, 4, 512),
     (128, 16, 2, 256), (128, 17, 2, 200), (33, 33, 2, 24), (16, 56, 2, 256), (256, 8, 2, 256),
     # four destinations to a block below that, N on and off a multiple of 4
     (15, 56, 2, 256), (255, 8, 2, 256), (70, 1, 1, 4), (40, 7, 2, 64), (32, 16, 2, 256), (31, 56, 1, 128),
     (1, 16, 2, 256), (1, 32, 2, 256), (1, 64, 2, 256), (1, 5, 2, 64), (8, 56, 2, 256), (8, 7, 2, 64),
     (31, 7, 2, 64), (31, 33, 1, 128), (8, 3, 4, 16),
     # the Quickstart: evaluate_local and the gate at batch 256, every bucket
     (256, 56, 2, 256), (256, 16, 2, 256), (256, 32, 2, 256)],
)
def test_session_attention_kernel_matches_plain(cuda, B, N, heads, HD):
    q, k, v, adj = _attn_inputs(cuda, B, N, HD)
    before, staged = sa.session_attention.launches, sa.session_attention.staged_launches
    got = sa.session_attention(q, k, v, adj, heads)
    torch.cuda.synchronize()
    assert sa.session_attention.launches == before + 1
    assert sa.session_attention.staged_launches - staged == int(_takes_staged(B, N, heads))
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
    # the same at a batch that would take the staged kernel
    q, k, v, adj = _attn_inputs(cuda, 64, 65, 64)
    with pytest.raises(ValueError, match="nodes"):
        sa.session_attention(q, k, v, adj, 2)
    q, k, v, adj = _attn_inputs(cuda, 64, 8, 264)
    with pytest.raises(ValueError, match="head_dim"):
        sa.session_attention(q, k, v, adj, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("B,N,heads,HD", [(1, 56, 2, 256), (8, 8, 2, 256), (64, 56, 2, 256), (40, 7, 2, 64)])
def test_both_attention_forward_kernels_agree_at_any_batch(cuda, B, N, heads, HD, dropout_p):
    """The two forward kernels, each named outright, on the same inputs: both
    within ATTN_TOL of the plain version, and of each other."""
    q, k, v, adj = _attn_inputs(cuda, B, N, HD)
    seed = 0x0DDB_A11
    want = sa.session_attention_reference(q, k, v, adj, heads, dropout_p, seed)
    got = {}
    for variant in ("warp", "staged"):
        staged = sa.session_attention.staged_launches
        got[variant] = sa.session_attention_variant(q, k, v, adj, heads, dropout_p, seed, variant)
        torch.cuda.synchronize()
        assert sa.session_attention.staged_launches - staged == int(variant == "staged")
        torch.testing.assert_close(got[variant], want, **ATTN_TOL)
        assert torch.all(got[variant][:, 0] == 0)
    torch.testing.assert_close(got["warp"], got["staged"], **ATTN_TOL)
    with pytest.raises(ValueError, match="variant"):
        sa.session_attention_variant(q, k, v, adj, heads, dropout_p, seed, "tile")


@pytest.mark.cuda
def test_staged_attention_gives_exact_zeros_without_in_edges(cuda):
    """Whole sessions without an edge, and single isolated rows, at a batch
    that takes the staged kernel: exact zeros, no NaN from the empty softmax."""
    q, k, v, adj = _attn_inputs(cuda, 64, 56, 256)
    adj[::2] = False  # every other session has no edge at all
    adj[1, 5, :] = False
    staged = sa.session_attention.staged_launches
    for dropout_p in (0.0, 0.5):
        out = sa.session_attention(q, k, v, adj, 2, dropout_p, seed=3)
        torch.cuda.synchronize()
        assert torch.all(out[::2] == 0) and torch.all(out[1, 5] == 0)
        assert torch.isfinite(out).all() and out[1].abs().sum() > 0
    assert sa.session_attention.staged_launches == staged + 2


def _score_inputs(dev, B, V, D, integer, seed=2):
    rng = np.random.default_rng(seed)
    if integer:
        sess, table = rng.integers(-1, 2, (B, D)), rng.integers(-1, 2, (V, D))
    else:
        sess, table = rng.standard_normal((B, D)), rng.standard_normal((V, D))
    return (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (sess, table))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,D,integer", [(1, 256, False), (1, 256, True), (4, 256, False), (2, 64, True), (3, 512, False),
                    # the Quickstart's evaluation batches: 128 (the Trainer), 256 (evaluate_local), 32 at D = 64
                    (128, 256, False), (256, 256, True), (32, 64, False)]
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
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("D", [4, 100, 256, 512])
@pytest.mark.parametrize("B,V,num_items", [(2, 96, 70), (7, 4128, 4101), (9, 96, 70), (130, 4128, 4101),
                                           (130, 96, 96), (512, 8192, 8000)])
def test_score_chunkmax_ragged_shapes_match_plain(cuda, B, V, num_items, D, integer):
    """B, V and D off the tiled kernel's 128 x 128 x 16 tile, `num_items`
    inside a chunk, a [B, V] exclusion mask with one whole chunk excluded."""
    sess, table = _score_inputs(cuda, B, V, D, integer, seed=B + D)
    rng = np.random.default_rng(V)
    mask = rng.random((B, V)) < 0.1
    mask[B - 1, 32:64] = True
    exclude = torch.from_numpy(mask).to(cuda)
    before, tile = sc.score_chunkmax.launches, sc.score_chunkmax.tile_launches
    got = sc.score_chunkmax(sess, table, num_items, exclude)
    torch.cuda.synchronize()
    assert sc.score_chunkmax.launches == before + 1
    assert sc.score_chunkmax.tile_launches - tile == int(B >= TILE_MIN_BATCH)
    want = sc.score_chunkmax_reference(sess, table, num_items, exclude)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCORE_TOL)
        assert torch.equal(torch.isneginf(g), torch.isneginf(w))
    assert torch.isneginf(got[0][:, num_items:]).all() and torch.isneginf(got[1][B - 1, 1])
    if integer:
        k = min(20, num_items // 2)
        s_got, i_got = scoring.select_topk(*got, k)
        s_want, i_want = scoring.dense_topk(sess, table, k, num_items, exclude)
        assert torch.equal(i_got, i_want) and torch.equal(s_got, s_want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16])
def test_both_score_kernels_agree_at_any_batch(cuda, B):
    """The two kernels, each named outright, on the same inputs."""
    V, num_items = 4128, 4101
    sess, table = _score_inputs(cuda, B, V, 256, False)
    exclude = torch.zeros((B, V), dtype=torch.bool, device=cuda)
    exclude[:, ::5] = True
    want = sc.score_chunkmax_reference(sess, table, num_items, exclude)
    for variant in ("warp", "tile"):
        tile = sc.score_chunkmax.tile_launches
        got = sc.score_chunkmax_variant(sess, table, num_items, exclude, variant)
        torch.cuda.synchronize()
        assert sc.score_chunkmax.tile_launches - tile == int(variant == "tile")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **SCORE_TOL)
    with pytest.raises(ValueError, match="variant"):
        sc.score_chunkmax_variant(sess, table, num_items, exclude, "staged")


@pytest.mark.cuda
def test_score_chunkmax_rejects_shapes_no_kernel_takes(cuda):
    for B in (1, 64):
        sess, table = _score_inputs(cuda, B, 64, 516, False)
        with pytest.raises(ValueError, match="<= 512"):
            sc.score_chunkmax(sess, table)
        sess, table = _score_inputs(cuda, B, 64, 6, False)
        with pytest.raises(ValueError, match="multiple of 4"):
            sc.score_chunkmax(sess, table)
        sess, table = _score_inputs(cuda, B, 40, 8, False)
        with pytest.raises(ValueError, match="multiple of 32"):
            sc.score_chunkmax(sess, table)


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
    "B,N,heads,HD", [(1, 8, 2, 256), (64, 56, 2, 256), (3, 1, 1, 4), (5, 64, 4, 512), (2, 33, 1, 96),
                     (70, 1, 1, 4), (40, 7, 2, 64), (16, 64, 4, 512), (32, 16, 2, 256),
                     # the Quickstart: train_baseline at batch 128 in every node bucket;
                     # run_full_pipeline's batch 32 at width 64, 2 heads of 32 and 4 of 16
                     (128, 56, 2, 256), (128, 8, 2, 256), (128, 16, 2, 256), (128, 32, 2, 256),
                     (32, 8, 2, 64), (32, 8, 4, 64), (32, 16, 4, 64)]
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
    # The backward redraws the keep bits of whichever forward kernel ran.
    torch.testing.assert_close(grads[0][0], grads[1][0], **ATTN_TOL)
    for got, want in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(got, want, **ATTN_GRAD_TOL)
    assert torch.all(grads[0][0][:, 0] == 0) and torch.all(grads[0][1][:, 0] == 0)


def _packed(adj: torch.Tensor) -> torch.Tensor:
    """The bit-packed rows of a bool adjacency (np.packbits, most significant bit first)."""
    return torch.from_numpy(np.packbits(adj.cpu().numpy(), axis=-1)).to(adj.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize(
    "B,N,heads,HD",
    # every node bucket at the train batch (the staged forward), the Quickstart's batch 128 at N = 8 (the
    # row forward), serving's B = 1, and N off a multiple of 8 (a packed row's last byte part-filled)
    [(512, 56, 2, 256), (512, 32, 2, 256), (512, 16, 2, 256), (512, 8, 2, 256), (128, 8, 2, 256),
     (1, 56, 2, 256), (3, 7, 2, 64), (9, 33, 1, 128), (2, 64, 4, 256), (1, 1, 1, 4), (300, 12, 1, 32)],
)
def test_packed_route_equals_the_bool_route_bit_for_bit_and_the_plain_version(cuda, B, N, heads, HD, dropout_p):
    """Forward and backward from the bit-packed rows [B, N, ceil(N / 8)]: the
    same bits as from the bool adjacency (every pass after the unpack is the
    same), and the plain version's values within the tolerances."""
    q, k, v, adj = _attn_inputs(cuda, B, N, HD, seed=N)
    packed = _packed(adj)
    assert packed.shape == (B, N, (N + 7) // 8)
    dout = torch.from_numpy(np.random.default_rng(9).standard_normal((B, N, HD)).astype(np.float32)).to(cuda)
    seed = 0x1234_5678_9ABC_DEF0
    runs = []
    counts = (sa.session_attention.packed_launches, sa.session_attention.packed_backward_launches)
    for a, is_packed in ((adj, False), (packed, True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sa.session_attention(*leaves, a, heads, dropout_p, seed, packed=is_packed)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, dout)))
    torch.cuda.synchronize()
    assert (sa.session_attention.packed_launches, sa.session_attention.packed_backward_launches) == (
        counts[0] + 1, counts[1] + 1)
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sa.session_attention_reference(*leaves, adj, heads, dropout_p, seed)
    plain = (out.detach(), *torch.autograd.grad(out, leaves, dout))
    torch.testing.assert_close(runs[1][0], plain[0], **ATTN_TOL)
    for got, want in zip(runs[1][1:], plain[1:]):
        torch.testing.assert_close(got, want, **ATTN_GRAD_TOL)
    for variant in ("warp", "staged"):  # both forward kernels read the packed rows
        got = sa.session_attention_variant(q, k, v, packed, heads, dropout_p, seed, variant, packed=True)
        want = sa.session_attention_variant(q, k, v, adj, heads, dropout_p, seed, variant)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), variant


@pytest.mark.cuda
def test_the_adjacency_form_is_named_not_guessed(cuda):
    q, k, v, adj = _attn_inputs(cuda, 2, 16, 64)
    dense_bytes = adj.to(torch.uint8)  # a dense uint8 adjacency is still dense
    torch.testing.assert_close(sa.session_attention(q, k, v, dense_bytes, 2), sa.session_attention(q, k, v, adj, 2))
    with pytest.raises(ValueError, match="packed adj"):
        sa.session_attention(q, k, v, dense_bytes, 2, packed=True)
    with pytest.raises(ValueError, match="adj"):
        sa.session_attention(q, k, v, _packed(adj), 2)


def _backward_both(dev, q, k, v, adj, heads, dropout_p, seed):
    dout = torch.from_numpy(
        np.random.default_rng(9).standard_normal(tuple(q.shape)).astype(np.float32)).to(dev)
    got = sa.session_attention_backward(q, k, v, adj, dout, heads, dropout_p, seed)
    again = sa.session_attention_backward(q, k, v, adj, dout, heads, dropout_p, seed)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        sa.session_attention_reference(*leaves, adj, heads, dropout_p, seed), leaves, dout)
    torch.cuda.synchronize()
    return got, again, want


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize(
    "B,N,heads,HD",
    [(512, 56, 2, 256), (512, 8, 2, 256), (3, 7, 2, 64), (3, 7, 2, 256), (2, 56, 4, 128), (2, 64, 2, 64),
     (2, 64, 2, 256), (4, 16, 2, 256), (4, 17, 2, 256), (4, 16, 2, 64), (4, 17, 2, 64), (9, 33, 1, 128),
     (1, 1, 1, 4), (300, 12, 1, 32)],
)
def test_attention_backward_kernel_matches_plain_and_repeats_its_bits(cuda, B, N, heads, HD, dropout_p):
    """Ragged N (7, 33, 56, 64), head widths 32 and 128, both tile sizes of the
    product passes (N <= 16 and above); no atomics, so two runs give equal bits."""
    q, k, v, adj = _attn_inputs(cuda, B, N, HD, seed=N)
    before = sa.session_attention.backward_launches
    got, again, want = _backward_both(cuda, q, k, v, adj, heads, dropout_p, 0x0BAD_5EED_0000_0001)
    assert sa.session_attention.backward_launches == before + 2
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, **ATTN_GRAD_TOL)
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
    assert torch.all(got[0][:, 0] == 0)  # dq of the isolated destination


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("B,N,heads,HD,density", [(6, 56, 2, 256, 0.02), (6, 56, 2, 256, 1.1), (6, 16, 2, 64, 0.02),
                                                  (6, 64, 1, 128, 1.1)])
def test_attention_backward_gives_exact_zeros_where_nothing_attends(cuda, B, N, heads, HD, density, dropout_p):
    """A session without any edge: dq, dk and dv all exactly zero. A destination
    without in-edges: its dq exactly zero. A source nobody attends to: its dk
    and dv exactly zero. At densities near 0 (tiles and rows skipped) and 1."""
    q, k, v, adj = _attn_inputs(cuda, B, N, HD, seed=3, density=density)
    adj[1] = False
    adj[2, N // 2, :] = False
    adj[3, :, N - 1] = False
    got, again, want = _backward_both(cuda, q, k, v, adj, heads, dropout_p, 17)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, **ATTN_GRAD_TOL)
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        assert torch.isfinite(g).all() and torch.all(g[1] == 0)
    dq, dk, dv = got
    assert torch.all(dq[:, 0] == 0) and torch.all(dq[2, N // 2] == 0)
    assert torch.all(dk[3, N - 1] == 0) and torch.all(dv[3, N - 1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("B,N", [(1, 8), (1, 56), (8, 56), (31, 56), (31, 7), (8, 64)])
def test_row_forward_kernel_at_serving_batches(cuda, B, N, dropout_p):
    """The kernel for few sessions, named outright and, where the wrapper
    takes it, through the wrapper: the same bits both ways, within ATTN_TOL of
    the plain version."""
    q, k, v, adj = _attn_inputs(cuda, B, N, 256, seed=B + N)
    staged = sa.session_attention.staged_launches
    named = sa.session_attention_variant(q, k, v, adj, 2, dropout_p, 21, "warp")
    chosen = sa.session_attention(q, k, v, adj, 2, dropout_p, 21)
    torch.cuda.synchronize()
    assert sa.session_attention.staged_launches - staged == int(_takes_staged(B, N, 2))
    if not _takes_staged(B, N, 2):
        assert torch.equal(named, chosen)
    want = sa.session_attention_reference(q, k, v, adj, 2, dropout_p, 21)
    torch.testing.assert_close(named, want, **ATTN_TOL)
    torch.testing.assert_close(chosen, want, **ATTN_TOL)
    assert torch.all(named[:, 0] == 0)
    sa.session_attention_launch_floor(B, N, 2, 128)  # the empty twin launches at the same shape
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["warp", "staged"])
def test_forward_kernels_repeat_their_bits_with_every_sm_busy(cuda, variant):
    """Many more blocks than the card holds at once: a block that read a tile
    before its copy had landed would show as bits that change between runs."""
    q, k, v, adj = _attn_inputs(cuda, 512, 56, 256, seed=6)
    runs = [sa.session_attention_variant(q, k, v, adj, 2, 0.1, 33, variant) for _ in range(4)]
    torch.cuda.synchronize()
    torch.testing.assert_close(runs[0], sa.session_attention_reference(q, k, v, adj, 2, 0.1, 33), **ATTN_TOL)
    assert all(torch.equal(r.view(torch.int32), runs[0].view(torch.int32)) for r in runs[1:])


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
@pytest.mark.parametrize("rows,D,U,n_unique,row_offset", [(4096, 256, 1024, 700, 0), (1000, 36, 64, 64, 512), (513, 4, 2048, 3, 0),
                                                         # a batch of 128's unique rows over the full table
                                                         (467_456, 256, 2048, 1400, 0)])
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
@pytest.mark.parametrize("rows,D", [(4096, 256), (777, 36), (467_456, 64)])  # run_full_pipeline's table
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


def _lazy_inputs(dev, rows, D, U, n_real, count, mu_dtype, nu_dtype, seed=6):
    """Rows last written 0, 1, .., 63, 64 and several hundred steps before
    `count - 1`, some with zero moments, row 0 among the uid rows, a sentinel
    tail."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy((0.05 * rng.standard_normal((rows, D))).astype(np.float32)).to(dev)
    mu = torch.from_numpy((0.01 * rng.standard_normal((rows, D))).astype(np.float32)).to(dev)
    nu = torch.from_numpy(rng.gamma(2.0, 5e-5, (rows, D)).astype(np.float32)).to(dev)
    table[0] = mu[0] = nu[0] = 0.0
    mu[1::5] = 0.0  # never touched: the kernels skip their series
    nu[1::5] = 0.0
    mu[2::7] = -0.0
    gaps = np.concatenate([np.arange(0, 66), [200, 300, 700]])
    last = np.clip(count - 1 - gaps[rng.integers(0, len(gaps), rows)], 0, None).astype(np.int32)
    ids = np.sort(np.concatenate([[0], rng.choice(np.arange(1, rows), n_real - 1, replace=False)]))
    uid = np.full(U, 2**31 - 1, np.int32)
    uid[:n_real] = ids
    summed = rng.standard_normal((U, D)).astype(np.float32) * 0.1
    summed[0] = 0.0
    summed[n_real:] = 0.0
    return (table, mu.to(mu_dtype), nu.to(nu_dtype), torch.from_numpy(last).to(dev),
            torch.from_numpy(uid).to(dev), torch.from_numpy(summed).to(dev))


def _same_bits(a, b):
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.int32: torch.int32}[a.dtype]
    return torch.equal(a.view(bits), b.view(bits))


LAZY_MOMENTS = [(torch.float32, torch.float32, False), (torch.bfloat16, torch.bfloat16, False),
                (torch.bfloat16, torch.bfloat16, True), (torch.float32, torch.bfloat16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,nu_dtype,sr", LAZY_MOMENTS)
@pytest.mark.parametrize("rows,D,U,n_real,count", [(4096, 256, 1024, 700, 900), (999, 36, 64, 64, 70),
                                                    (513, 4, 40, 3, 2),
                                                    # corpus v3's training batch of 512 with the most
                                                    # unique rows
                                                    (467_456, 256, 8192, 6125, 900)])
def test_lazy_gather_and_touched_update_kernels_match_plain(cuda, rows, D, U, n_real, count, mu_dtype,
                                                           nu_dtype, sr):
    table, mu, nu, last, uid, summed = _lazy_inputs(cuda, rows, D, U, n_real, count, mu_dtype, nu_dtype)
    gathers, touched = la.gather_catch_up.launches, la.touched_update_scatter.launches
    got = la.gather_catch_up(table, mu, nu, last, uid, count, **HYPER)
    want = la.gather_catch_up_reference(table, mu, nu, last, uid, count, **HYPER)
    torch.cuda.synchronize()
    assert la.gather_catch_up.launches == gathers + 1
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    assert _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
    assert all(torch.all(g[n_real:] == 0) for g in got)  # sentinel slots
    after = [[t.clone() for t in (table, mu, nu, last)] for _ in range(2)]
    la.touched_update_scatter(*after[0], uid, *got, summed, count, stochastic_rounding=sr, **HYPER)
    la.touched_update_scatter_reference(*after[1], uid, *got, summed, count, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert la.touched_update_scatter.launches == touched + 1
    torch.testing.assert_close(after[0][0], after[1][0], **TABLE_TOL)
    assert all(_same_bits(a, b) for a, b in zip(after[0][1:], after[1][1:]))
    outside = torch.ones(rows, dtype=torch.bool, device=cuda)
    outside[uid[:n_real].long()] = False
    for a, start in zip(after[0], (table, mu, nu, last)):
        assert _same_bits(a[outside], start[outside])
    assert torch.all(after[0][3][uid[:n_real].long()] == count)
    assert torch.all(after[0][0][0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,nu_dtype,sr", LAZY_MOMENTS)
@pytest.mark.parametrize("rows,D,count,terms", [(4096, 256, 900, 64), (999, 36, 70, 64), (100, 4, 5, 64),
                                                (300, 128, 400, 17)])
def test_lazy_materialize_kernel_matches_plain_and_is_idempotent(cuda, rows, D, count, terms, mu_dtype,
                                                                 nu_dtype, sr):
    table, mu, nu, last, _, _ = _lazy_inputs(cuda, rows, D, 8, 4, count, mu_dtype, nu_dtype)
    last[::7] = count  # rows already current
    got = [t.clone() for t in (table, mu, nu, last)]
    want = [t.clone() for t in (table, mu, nu, last)]
    before = la.materialize.launches
    la.materialize(*got, count, tail_terms=terms, stochastic_rounding=sr, **HYPER)
    la.materialize_reference(*want, count, tail_terms=terms, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert la.materialize.launches == before + 1
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    assert all(_same_bits(a, b) for a, b in zip(got[1:], want[1:]))
    assert torch.all(got[3] == count)
    current = last == count
    assert all(_same_bits(a[current], b[current]) for a, b in zip(got[:3], (table, mu, nu)))
    again = [t.clone() for t in got]
    la.materialize(*again, count, tail_terms=terms, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,sr", [(torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
@pytest.mark.parametrize("terms", [0, 1, 16, 64])
def test_lazy_series_kernels_match_plain_at_fixed_series_lengths(cuda, terms, mu_dtype, sr):
    """Every row exactly `terms` steps behind, so the gather and materialize
    run series of that length (0: the rows are current); over 256 columns
    (one item a warp) and over 600 (three items, the last ragged)."""
    for rows, D, U, n_real in ((2048, 256, 1024, 900), (300, 600, 128, 100)):
        count = 5000
        table, mu, nu, last, uid, _ = _lazy_inputs(cuda, rows, D, U, n_real, count, mu_dtype, mu_dtype)
        last.fill_(count - 1 - terms)  # the gather catches up to count - 1
        got = la.gather_catch_up(table, mu, nu, last, uid, count, **HYPER)
        want = la.gather_catch_up_reference(table, mu, nu, last, uid, count, **HYPER)
        again = la.gather_catch_up(table, mu, nu, last, uid, count, **HYPER)  # the row tickets start over
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
        assert _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
        assert all(_same_bits(a, b) for a, b in zip(again, got))
        assert all(torch.all(g[n_real:] == 0) for g in got)
        last.fill_(count - terms)
        after = [[t.clone() for t in (table, mu, nu, last)] for _ in range(2)]
        la.materialize(*after[0], count, stochastic_rounding=sr, **HYPER)
        la.materialize_reference(*after[1], count, stochastic_rounding=sr, **HYPER)
        torch.cuda.synchronize()
        torch.testing.assert_close(after[0][0], after[1][0], **TABLE_TOL)
        assert all(_same_bits(a, b) for a, b in zip(after[0][1:], after[1][1:]))
        assert torch.all(after[0][3] == count)
        if terms == 0:
            assert all(_same_bits(a, b) for a, b in zip(after[0][:3], (table, mu, nu)))


@pytest.mark.cuda
def test_lazy_wrappers_reject_what_the_kernels_do_not_take(cuda):
    table, mu, nu, last, uid, summed = _lazy_inputs(cuda, 256, 8, 16, 4, 10, torch.float32, torch.float32)
    rows = la.gather_catch_up(table, mu, nu, last, uid, 10, **HYPER)
    with pytest.raises(ValueError, match="uid"):
        la.gather_catch_up(table, mu, nu, last, uid.long(), 10, **HYPER)
    with pytest.raises(ValueError, match="last_step"):
        la.materialize(table, mu, nu, last.long(), 10, **HYPER)
    with pytest.raises(ValueError, match="summed"):
        la.touched_update_scatter(table, mu, nu, last, uid, *rows, summed[:, :4].contiguous(), 10, **HYPER)
    with pytest.raises(ValueError, match="tail_terms"):
        la.materialize(table, mu, nu, last, 10, tail_terms=65, **HYPER)
    with pytest.raises(ValueError, match="bfloat16"):
        la.materialize(table, mu, nu, last, 10, stochastic_rounding=True, **HYPER)
    with pytest.raises(ValueError, match="eps"):
        la.materialize(table, mu, nu, last, 10, **{**HYPER, "eps": 0.0})
    with pytest.raises(ValueError, match="eps"):
        la.gather_catch_up(table, mu, nu, last, uid, 10, **{**HYPER, "eps": 0.0})


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(512, 56, 256), (3, 7, 4), (16, 8, 64),
                                   # the Quickstart: batch 128 (its node buckets 8, 16, 32); run_full_pipeline's
                                   # nodes, GAT weights, FFN
                                   (128, 56, 256), (128, 8, 256), (128, 16, 256), (32, 8, 64), (32, 4, 8, 8),
                                   (32, 8, 256), (32, 16, 64), (32, 4, 16, 16)])
def test_node_dropout_kernel_matches_plain_bit_for_bit(cuda, shape, rate):
    """Forward and backward of the kernel against the plain version on the
    same seed: the same keep bits and the same float32 product, so EQUAL;
    every launch counted, the backward's too."""
    from gat_recommendation_torch.ops import masked, rounding

    gen = torch.Generator(cuda).manual_seed(7)
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    seed = 2**63 + 12345
    leaf = x.clone().requires_grad_(True)
    before = nd.node_dropout.launches
    out = nd.node_dropout(leaf, rate, seed)
    (grad,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert nd.node_dropout.launches == before + 2
    assert torch.equal(out, masked.dropout(x, rate, True, seed))
    assert torch.equal(grad, masked.dropout(g, rate, True, seed))
    kept = rounding.keep_mask(shape, rate, seed, cuda)
    assert torch.equal(out != 0, kept & (x != 0))
    assert nd.node_dropout(x, 0.0, seed) is x
    with pytest.raises(ValueError, match="multiple of 4"):
        nd.node_dropout(torch.ones(3, 5, device=cuda), rate, seed)


# ---- the step block, CUDA graphs of the chained steps ----


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,nu_dtype,sr", LAZY_MOMENTS)
def test_step_row_entry_points_equal_the_int_path_and_plain(cuda, mu_dtype, nu_dtype, sr):
    """Every kernel that reads the step block, given the row of a block of
    several steps, equals the same kernel given the Python int (the one-row
    block the wrapper builds from the host functions of the by-value path) bit
    for bit, and its plain version as above."""
    from gat_recommendation_torch.ops import step_block

    rows, D, U, n_real, count = 999, 36, 64, 64, 70
    table, mu, nu, last, uid, summed = _lazy_inputs(cuda, rows, D, U, n_real, count, mu_dtype, nu_dtype)
    block = step_block.build(count - 3, [11, 12, 13], b1=HYPER["b1"], b2=HYPER["b2"], num_layers=2, device=cuda,
                             seeds_per_layer=2)
    row = block[2]  # the step whose count is `count`
    by_row = la.gather_catch_up(table, mu, nu, last, uid, row, **HYPER)
    by_int = la.gather_catch_up(table, mu, nu, last, uid, count, **HYPER)
    want = la.gather_catch_up_reference(table, mu, nu, last, uid, count, **HYPER)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(by_row, by_int))
    torch.testing.assert_close(by_row[0], want[0], **TABLE_TOL)
    states = [[t.clone() for t in (table, mu, nu, last)] for _ in range(3)]
    la.touched_update_scatter(*states[0], uid, *by_row, summed, row, stochastic_rounding=sr, **HYPER)
    la.touched_update_scatter(*states[1], uid, *by_row, summed, count, stochastic_rounding=sr, **HYPER)
    la.touched_update_scatter_reference(*states[2], uid, *by_row, summed, count, stochastic_rounding=sr,
                                        **HYPER)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(states[0], states[1]))
    assert all(_same_bits(a, b) for a, b in zip(states[0][1:], states[2][1:]))
    sparse = [[t.clone() for t in (table, mu, nu)] for _ in range(3)]
    sp.sparse_adamw(*sparse[0], uid, summed, row, stochastic_rounding=sr, **HYPER)
    sp.sparse_adamw(*sparse[1], uid, summed, count, stochastic_rounding=sr, **HYPER)
    sp.sparse_adamw_reference(*sparse[2], uid, summed, count, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(sparse[0], sparse[1]))
    assert all(_same_bits(a, b) for a, b in zip(sparse[0][1:], sparse[2][1:]))
    grad = 1e-3 * torch.randn(table.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    dense = [[t.clone() for t in (table, mu, nu)] for _ in range(3)]
    ea.embedding_adamw(*dense[0], grad, row, stochastic_rounding=sr, **HYPER)
    ea.embedding_adamw(*dense[1], grad, count, stochastic_rounding=sr, **HYPER)
    ea.embedding_adamw_reference(*dense[2], grad, count, stochastic_rounding=sr, **HYPER)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(dense[0], dense[1]))
    assert all(_same_bits(a, b) for a, b in zip(dense[0][1:], dense[2][1:]))
    # Node dropout reads its layer's seed field; forward and backward.
    x = torch.randn(64, 56, 256, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    node = step_block.seed_field(1, 1, 2)  # the node dropout's seed of a model with 2 seeds a layer
    int_seed = int(block[1, node]) & (2**64 - 1)
    leaves = [x.clone().requires_grad_(True) for _ in range(2)]
    outs = [nd.node_dropout(leaves[0], 0.1, block[1, node]), nd.node_dropout(leaves[1], 0.1, int_seed)]
    grads = [torch.autograd.grad(o, lv, torch.ones_like(o))[0] for o, lv in zip(outs, leaves)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    # The attention reads its layer's seed field; forward and backward.
    seed = step_block.seed_field(1, 0, 2)  # the attention's
    q, k, v, adj = _attn_inputs(cuda, 64, 56, 256)
    int_seed = int(block[1, seed]) & (2**64 - 1)
    leaves = [[t.clone().requires_grad_(True) for t in (q, k, v)] for _ in range(2)]
    outs = [sa.session_attention(*leaves[0], adj, 2, 0.1, block[1, seed]),
            sa.session_attention(*leaves[1], adj, 2, 0.1, int_seed)]
    grads = [torch.autograd.grad(o, lv, torch.ones_like(o)) for o, lv in zip(outs, leaves)]
    assert torch.equal(outs[0], outs[1]) and all(torch.equal(a, b) for a, b in zip(*grads))
    torch.testing.assert_close(outs[0], sa.session_attention_reference(q, k, v, adj, 2, 0.1, int_seed), **ATTN_TOL)


def _train_setup(dev, dropout, lazy, seed=0):
    """A small Graph Transformer on the card, its optimizer state, and four
    training batches of one node bucket with their indexes."""
    from gat_recommendation_torch.data import batching
    from gat_recommendation_torch.models import registry
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW

    model = registry.create_model("graph_transformer_optimized", 600, embedding_dim=64, hidden_dim=64,
                                  laplacian_k=4, dropout=dropout, device=dev,
                                  generator=torch.Generator(dev).manual_seed(seed))
    opt = FusedEmbeddingAdamW(1e-2, weight_decay=1e-4, lazy=lazy)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 9, 400)
    sid = np.repeat(np.arange(400), lengths)
    items = rng.integers(1, 600, int(lengths.sum()))
    ds = batching.SessionDataset((sid, np.arange(len(sid)), items),
                                 (rng.integers(1, 600, 8000), rng.integers(1, 600, 8000)), num_items=600)
    batches = list(batching.iterate_batches(ds, 64, shuffle=True, seed=seed))[:4]
    return model, opt, opt.init(model), batches


def _everything(model, state):
    rest = [t for s in state["rest"].state.values() for t in s.values()]
    return [*model.state_dict().values(), state["emb_mu"], state["emb_nu"], *rest,
            *([state["last_step"]] if "last_step" in state else [])]


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [True, False])
def test_chained_graphs_equal_unchained_steps_bit_for_bit(cuda, lazy):
    """Groups of 1 (a replayed single step: the first call captures, the
    second only replays) and of 4 against the eager unchained steps on the
    same state, dropout 0.1: losses, weights, BatchNorm buffers, moments,
    last_step and the other parameters' AdamW state equal. The launch
    counters count per step run, the capture's warm-up step uncounted."""
    from gat_recommendation_torch.data import batching
    from gat_recommendation_torch.train import trainer
    from gat_recommendation_torch.train.graphs import read_counters
    from gat_recommendation_torch.train.losses import create_loss_function

    loss_fn = create_loss_function("dual")
    seeds = list(range(100, 110))
    runs = []
    for chained in (False, True):
        model, opt, state, batches = _train_setup(cuda, 0.1, lazy)
        groups = [batches[:1], batches[1:2], batches, batches]  # 1, 1 (replay only), 4, 4 (replay only)
        single = trainer.make_sparse_train_step(model, loss_fn, opt, state)
        step = trainer.make_chained_sparse_train_step(model, loss_fn, opt, state)
        losses, i = [], 0
        before = read_counters()
        for group in groups:
            gseeds = seeds[i:i + len(group)]
            if chained:
                gidxs = batching.stack_grad_indices([batching.make_grad_index(b) for b in group])
                stacked, gidxs = batching.to_device((batching.stack_batches(group), gidxs), cuda)
                block = trainer.next_steps_block(model, opt, state, gseeds, cuda)
                losses.append(step(stacked, gidxs, block))
            else:
                for b, s in zip(group, gseeds):
                    gidx = batching.make_grad_index(b)
                    losses.append(single(batching.to_device((b, gidx), cuda), s).reshape(1))
            i += len(group)
        torch.cuda.synchronize()
        counted = [a - b for a, b in zip(read_counters(), before)]
        runs.append((torch.cat(losses), _everything(model, state), state["count"], counted))
        if chained:
            n_graphs = len(step.graphs.graphs)
    (want, want_state, want_count, want_launches), (got, got_state, got_count, got_launches) = runs
    assert torch.equal(got, want) and got_count == want_count == 10
    assert all(_same_bits(a, b) if a.is_floating_point() or a.dtype == torch.int32 else torch.equal(a, b)
               for a, b in zip(got_state, want_state))
    assert got_launches == want_launches  # per step: 2 forward, 2 backward, the table update
    assert n_graphs == 1


@pytest.mark.cuda
def test_sorted_segment_sum_is_capture_safe_and_repeats_its_bits(cuda):
    """torch.segment_reduce (lengths, unsafe) inside a CUDA graph at the full
    step's R = 31,744 gradient rows and U = 16,384 segments equals the eager
    call bit for bit."""
    from gat_recommendation_torch.train.trainer import sorted_segment_sum

    rng = np.random.default_rng(8)
    R, U, D = 31744, 16384, 256
    lengths = np.bincount(np.sort(rng.integers(0, 12000, R)), minlength=U).astype(np.int64)
    rows = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    want = sorted_segment_sum(rows, lengths)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sorted_segment_sum(rows, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sorted_segment_sum(rows, lengths)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[12000:].any()


@pytest.mark.cuda
def test_a_resumed_chained_trainer_equals_an_uninterrupted_one(cuda, tmp_path):
    """Resume builds a new optimizer state and so new graphs: two epochs and a
    resumed third equal three straight epochs bit for bit (chain 4, lazy,
    dropout 0.1, an evaluation after each epoch)."""
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.trainer import Trainer

    def trainer(out, epochs):
        model, opt, _, batches = _train_setup(cuda, 0.1, True)
        return Trainer(model, lambda e: iter(batches * 2), lambda: iter(batches), optimizer=opt,
                       output_dir=tmp_path / out, max_epochs=epochs, loss_fn=create_loss_function("dual"),
                       seed=3, sparse_embedding_grads=True, chain=4)

    straight = trainer("straight", 3)
    want = straight.train()
    trainer("resumed", 2).train()
    resumed = trainer("resumed", 3)
    got = resumed.train(resume=True)
    assert got == want and resumed.chained_dispatches == 2 and resumed.chained_eval_dispatches == 1
    assert all(_same_bits(a, b) for a, b in zip(_everything(resumed.model, resumed.opt_state),
                                                _everything(straight.model, straight.opt_state)))


@pytest.mark.cuda
def test_side_stream_prefetch_of_full_size_batches_equals_the_host_data(cuda):
    """Three hundred full-size items (B = 512, N = 56, with their GradIndex)
    through ``prefetch_to_device`` with three transfer threads: the consumer
    holds its stream back (a spin kernel) before it reads each item, frees the
    item at once, and its device checksums must equal the host data's as it
    is sent (the adjacency bit-packed). A
    read before the side stream's copies land, or an item's memory handed to
    a later copy while the consumer's stream still reads it, breaks a sum."""
    from gat_recommendation_torch.data import batching

    rng = np.random.default_rng(9)
    V, B, N = 466_865, 512, 56
    hosts = []
    for _ in range(6):
        batch = batching.SessionBatch(
            torch.from_numpy(rng.integers(1, V, (B, N), dtype=np.int32)),
            torch.from_numpy(rng.random((B, N)) < 0.8), torch.from_numpy(rng.random((B, N, N)) < 0.3),
            torch.from_numpy(rng.integers(1, N, B, dtype=np.int32)),
            torch.from_numpy(rng.integers(1, V, B, dtype=np.int32)),
            torch.from_numpy(rng.integers(1, V, (B, 5), dtype=np.int32)), torch.from_numpy(rng.random(B) < 0.9))
        hosts.append((batch, batching.make_grad_index(batch)))

    def checksum(item) -> torch.Tensor:
        return torch.stack([t.to(torch.int64).sum() for t in batching._tensors(item)])

    # what goes to the card: the adjacency bit-packed (``to_device`` towards a card)
    want = [checksum(batching.to_device((batching.pack_adj(b), g), "cpu")) for b, g in hosts]
    sums = []
    for item in batching.prefetch_to_device((hosts[i % 6] for i in range(300)), size=4, transfer_workers=3,
                                            device=cuda):
        torch.cuda._sleep(1_000_000)  # the consumer's stream lags behind the side stream
        sums.append(checksum(item))
        del item
    got = torch.stack(sums).cpu()
    assert all(torch.equal(got[i], want[i % 6]) for i in range(300))


@pytest.mark.cuda
@pytest.mark.parametrize("chain", [1, 4])
def test_pipelined_trainer_from_a_cold_graph_cache_equals_the_inline_one(cuda, tmp_path, chain):
    """``Trainer.train()`` with pooled assembly and three transfer threads,
    each run starting from a new Trainer (no graph captured yet, so the
    captures happen while the prefetch thread transfers), equals the run with
    one transfer thread and assembly on the prefetch thread, bit for bit:
    history and the whole state (lazy, dropout 0.1, two epochs)."""
    from gat_recommendation_torch.data import batching
    from gat_recommendation_torch.models import registry
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
    from gat_recommendation_torch.train.trainer import Trainer

    rng = np.random.default_rng(4)
    lengths = np.clip(rng.geometric(0.25, 3000) + 2, 3, 40)
    sid = np.repeat(np.arange(3000), lengths)
    items = rng.integers(1, 2000, int(lengths.sum()))
    ds = batching.SessionDataset((sid, np.arange(len(sid)), items),
                                 (rng.integers(1, 2000, 30000), rng.integers(1, 2000, 30000)), num_items=2000)

    def run(out, workers, transfer_workers):
        model = registry.create_model("graph_transformer_optimized", 2000, embedding_dim=64, hidden_dim=64,
                                      laplacian_k=4, dropout=0.1, device=cuda,
                                      generator=torch.Generator(cuda).manual_seed(0))
        trainer = Trainer(model, lambda e: batching.iterate_batches(ds, 128, shuffle=True, seed=e, workers=workers),
                          lambda: batching.iterate_batches(ds, 128), optimizer=FusedEmbeddingAdamW(1e-2, lazy=True),
                          output_dir=tmp_path / out, max_epochs=2, loss_fn=create_loss_function("dual"), seed=5,
                          sparse_embedding_grads=True, chain=chain, transfer_workers=transfer_workers)
        return trainer, trainer.train()

    plain, want = run("inline", 0, 1)
    piped, got = run("pipelined", 3, 3)
    assert got == want and len(got["train_loss"]) == 2
    assert (piped.chained_dispatches > 0) == (chain > 1)
    assert all(_same_bits(a, b) for a, b in zip(_everything(piped.model, piped.opt_state),
                                                _everything(plain.model, plain.opt_state)))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,node_launches,attention", [
    ("gat", {}, 5, 0), ("graphsage", {"aggregator": "max"}, 3, 0), ("graphsage", {"aggregator": "lstm"}, 3, 0),
    ("graph_transformer", {"laplacian_k": 4}, 9, 3),
])
def test_every_model_runs_its_dropouts_through_the_kernels(cuda, name, kw, node_launches, attention):
    """A train-mode forward and backward of each model on the card, dropout
    0.3: every dropout through the node-dropout kernel (forward and backward
    launches), the Graph Transformer's attention through kernel 1; the output
    and the table's gradient within 1e-4 of a CPU copy from the same seed
    (the keep bits are the same; products sum in another order)."""
    from gat_recommendation_torch.data import batching
    from gat_recommendation_torch.models import registry
    from gat_recommendation_torch.ops.node_dropout import node_dropout

    rng = np.random.default_rng(1)
    lengths = rng.integers(3, 12, 64)
    sid = np.repeat(np.arange(64), lengths)
    ds = batching.SessionDataset((sid, np.arange(len(sid)), rng.integers(1, 300, int(lengths.sum()))),
                                 (rng.integers(1, 300, 3000), rng.integers(1, 300, 3000)), num_items=300)
    batch = next(batching.iterate_batches(ds, 32))
    results = []
    for dev in (cuda, torch.device("cpu")):
        model = registry.create_model(name, 300, embedding_dim=64, hidden_dim=64, dropout=0.3, device="cpu",
                                      generator=torch.Generator().manual_seed(0), **kw).to(dev).train()
        fwd, drops = sa.session_attention.launches, node_dropout.launches
        out = model(batch.to(dev), seed=11)
        (grad,) = torch.autograd.grad(out.square().sum(), model.item_embedding)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert node_dropout.launches - drops == 2 * node_launches
            assert sa.session_attention.launches - fwd == attention
        results.append((out.detach().cpu(), grad.cpu()))
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
