"""The port's int8 candidate scorer (its copy of ``native/scorer.cpp``)
against the JAX package's, on the CPU.

Each package builds its own library. On the same table and query,
``quantize_table`` must give the same int8 rows, scales and row sums byte
for byte, and ``score_int8_topl`` the same candidate ids (and approximate
scores) for 1 and 2 threads and with a seen mask. The AVX2-pinned build
(``load_scorer_variant("avx2")``: ``-mavx2 -mno-avx512f``) must recover
the exact top rows of an adversarial table whose dot products would
saturate a 16-bit pairwise sum, as the JAX package's test holds its own.
"""

import time

import numpy as np
import pytest
import torch

from gat_recommendation_torch.data import native as port_native
from gat_recommendation_tpu.data import native as ref_native

torch.set_num_threads(1)

V, D = 20_000, 64


@pytest.fixture(scope="module")
def jax_library():
    """The JAX package's library. Its first build runs ``make -C native``; a
    test process that loads it while another process is still writing it
    gives up for the session, so the load is tried again until the build has
    finished."""
    for _ in range(120):
        if ref_native.available():
            return ref_native
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the JAX package's C++ library did not build (make -C native)")


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((V, D), dtype=np.float32)
    t[0] = 0.0  # the padding row
    t[V - 100:] = 0.0  # a phantom tail
    t[5] *= 1e-3  # a row of tiny values
    return t


def test_quantize_table_equals_the_jax_librarys_byte_for_byte(jax_library, table):
    want = jax_library.quantize_table(table)
    got = port_native.quantize_table(table)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    q, scale, rowsum = got
    assert scale[0] == 0.0 and not q[0].any() and not scale[V - 100:].any()
    np.testing.assert_array_equal(rowsum, q.astype(np.int64).sum(axis=1))


@pytest.mark.parametrize("n_threads", [1, 2])
@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("L", [64, 1024])
def test_score_int8_topl_ids_equal_the_jax_librarys(jax_library, table, n_threads, with_seen, L):
    q, scale, rowsum = port_native.quantize_table(table)
    rng = np.random.default_rng(L + n_threads)
    seen = None
    for trial in range(3):
        sess = rng.standard_normal(D).astype(np.float32)
        if with_seen:
            seen = np.zeros(V, np.uint8)
            seen[np.argsort(-(table @ sess))[:5]] = 1  # the best rows are seen
            seen[rng.integers(1, V, 200)] = 1
        want_i, want_s = jax_library.score_int8_topl(q, scale, rowsum, sess, L, seen=seen, n_threads=n_threads)
        got_i, got_s = port_native.score_int8_topl(q, scale, rowsum, sess, L, seen=seen, n_threads=n_threads)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
        assert len(got_i) == L and 0 not in got_i and not (got_i >= V - 100).any()
        if with_seen:
            assert not seen[got_i].any()


def test_thread_count_gives_the_same_candidates(table):
    q, scale, rowsum = port_native.quantize_table(table)
    sess = np.random.default_rng(6).standard_normal(D).astype(np.float32)
    got = [set(port_native.score_int8_topl(q, scale, rowsum, sess, 64, n_threads=t)[0].tolist()) for t in (1, 2, 4)]
    assert got[0] == got[1] == got[2]


def test_fewer_eligible_rows_than_L_drops_the_empty_slots():
    t = np.zeros((64, 32), np.float32)
    t[[3, 9, 40]] = 1.0
    q, scale, rowsum = port_native.quantize_table(t)
    idx, _ = port_native.score_int8_topl(q, scale, rowsum, np.ones(32, np.float32), 16)
    assert sorted(idx.tolist()) == [3, 9, 40]


def test_arguments_are_checked_before_the_call(table):
    q, scale, rowsum = port_native.quantize_table(table[:64])
    sess = np.ones(D, np.float32)
    with pytest.raises(ValueError, match="scale"):
        port_native.score_int8_topl(q, scale.astype(np.float64), rowsum, sess, 8)
    with pytest.raises(ValueError, match="seen"):
        port_native.score_int8_topl(q, scale, rowsum, sess, 8, seen=np.zeros(64, bool))
    with pytest.raises(ValueError, match="unknown scorer variant"):
        port_native.load_scorer_variant("sse2")


@pytest.mark.parametrize("variant", ["default", "avx2"])
def test_saturating_rows_stay_candidates(variant):
    """A max-magnitude query against max-magnitude rows with L << V: a
    pairwise 16-bit sum of u8 x s8 products would saturate (2 * 255 * 127 >
    32767) and drop exactly the best rows; the AVX2 build widens to 16 bits
    before multiplying. The approximate scores are the exact int8 dots."""
    lib = port_native.load_scorer_variant("avx2") if variant == "avx2" else None
    rng = np.random.default_rng(7)
    V_, D_ = 1000, 64
    t = 0.05 * rng.standard_normal((V_, D_)).astype(np.float32)
    hot = [3, 500, 997]  # spread over the threads' ranges
    t[hot] = 1.0  # quantizes to +127 everywhere
    q, scale, rowsum = port_native.quantize_table(t, lib=lib)
    idx, approx = port_native.score_int8_topl(q, scale, rowsum, np.ones(D_, np.float32), 8, lib=lib)
    assert set(hot) <= set(idx.tolist()), idx
    exact_int = (q[idx].astype(np.int64) * 127).sum(axis=1)
    np.testing.assert_allclose(approx, scale[idx] * (1.0 / 127.0) * exact_int, rtol=1e-5)


def test_avx2_build_recovers_the_exact_top_k(table):
    """Through the AVX2 build, the candidates of L = 128 re-ranked in float32
    hold the exact top 10 (the serving procedure), as the default build's."""
    lib = port_native.load_scorer_variant("avx2")
    assert port_native.library_path(flags=port_native.VARIANT_FLAGS["avx2"]) != port_native.library_path()
    q, scale, rowsum = port_native.quantize_table(table, lib=lib)
    rng = np.random.default_rng(4)
    for _ in range(5):
        sess = rng.standard_normal(D).astype(np.float32)
        exact = table @ sess
        idx, _ = port_native.score_int8_topl(q, scale, rowsum, sess, 128, lib=lib)
        assert set(np.argsort(-exact)[:10].tolist()) == set(idx[np.argsort(-exact[idx])[:10]].tolist())
        default, _ = port_native.score_int8_topl(*port_native.quantize_table(table), sess, 128)
        assert set(default.tolist()) == set(idx.tolist())
