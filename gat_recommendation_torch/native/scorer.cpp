// Int8 full-catalog candidate scorer for CPU serving hosts, in the port's
// C++ library (C ABI, loaded with ctypes by gat_recommendation_torch/data/
// native.py, which builds it with batcher.cpp into one library at first use).
// A copy of the JAX package's scorer: the same quantization, the same scan
// and the same heaps, so the two packages pick the same candidates.
//
// The Recommender's per-request cost on a CPU host is one [1, D] x [D, V]
// GEMV over the f32 embedding table (V = 466,865, D = 256: 478 MB read a
// request). The table is quantized once at load to int8 with a per-row
// scale (4x fewer bytes), this scan streams it with AVX-512 VNNI (else
// AVX2, else scalar int32 MACs) and returns the top-L candidate rows;
// Python re-ranks the L candidates exactly against the f32 table, so the
// final top-k ordering is computed at full precision. Quantization only
// decides candidate membership at a margin L >> k, where the int8 rounding
// error (|err| <= 0.5 * (s_row + s_sess) * D at worst, ~sqrt(D)/2 typical)
// is negligible.
//
// unsigned x signed: VNNI's dpbusd multiplies u8 x s8. The session vector
// (fixed per query) is biased to unsigned (q + 128); the accumulated surplus
// 128 * sum(row) is removed with a per-row sum precomputed at quantization.
//
// C ABI + ctypes like batcher.cpp; no Python.h dependency.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// Quantize a [V, D] f32 table to int8 rows: q[i] = round(t[i]/scale[i]),
// scale[i] = max|t[i]| / 127 (0-rows get scale 0 and stay all-zero), plus
// the per-row int32 element sum needed by the unsigned-bias correction.
void quantize_table(const float* table, int64_t V, int32_t D, int8_t* q,
                    float* scale, int32_t* rowsum) {
  for (int64_t i = 0; i < V; ++i) {
    const float* row = table + i * D;
    float amax = 0.f;
    for (int32_t d = 0; d < D; ++d) {
      float a = row[d] < 0 ? -row[d] : row[d];
      if (a > amax) amax = a;
    }
    float s = amax / 127.0f;
    scale[i] = s;
    float inv = s > 0 ? 1.0f / s : 0.0f;
    int8_t* qi = q + i * D;
    int32_t sum = 0;
    for (int32_t d = 0; d < D; ++d) {
      float v = row[d] * inv;
      int32_t r = (int32_t)(v >= 0 ? v + 0.5f : v - 0.5f);
      if (r > 127) r = 127;
      if (r < -127) r = -127;
      qi[d] = (int8_t)r;
      sum += r;
    }
    rowsum[i] = sum;
  }
}

static inline int32_t dot_u8s8(const uint8_t* u, const int8_t* s, int32_t D) {
#if defined(__AVX512VNNI__) && defined(__AVX512VL__)
  __m256i acc = _mm256_setzero_si256();
  int32_t d = 0;
  for (; d + 32 <= D; d += 32) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(u + d));
    __m256i b = _mm256_loadu_si256((const __m256i*)(s + d));
    acc = _mm256_dpbusd_epi32(acc, a, b);
  }
  alignas(32) int32_t lanes[8];
  _mm256_store_si256((__m256i*)lanes, acc);
  int32_t r = lanes[0] + lanes[1] + lanes[2] + lanes[3] + lanes[4] + lanes[5] +
              lanes[6] + lanes[7];
  for (; d < D; ++d) r += (int32_t)u[d] * (int32_t)s[d];
  return r;
#elif defined(__AVX2__)
  // maddubs would be 1 uop/32B but its pairwise u8*s8 sums SATURATE at i16
  // (a pair of 255*127 products reaches 64770 > 32767), silently
  // underestimating exactly the highest-scoring rows. Widen
  // both operands to i16 first: madd_epi16 products and pair sums are
  // exact in i32 (max |pair| = 2*255*127 << 2^31).
  __m256i acc = _mm256_setzero_si256();
  int32_t d = 0;
  for (; d + 32 <= D; d += 32) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(u + d));
    __m256i b = _mm256_loadu_si256((const __m256i*)(s + d));
    __m256i alo = _mm256_cvtepu8_epi16(_mm256_castsi256_si128(a));
    __m256i ahi = _mm256_cvtepu8_epi16(_mm256_extracti128_si256(a, 1));
    __m256i blo = _mm256_cvtepi8_epi16(_mm256_castsi256_si128(b));
    __m256i bhi = _mm256_cvtepi8_epi16(_mm256_extracti128_si256(b, 1));
    acc = _mm256_add_epi32(acc, _mm256_madd_epi16(alo, blo));
    acc = _mm256_add_epi32(acc, _mm256_madd_epi16(ahi, bhi));
  }
  alignas(32) int32_t lanes[8];
  _mm256_store_si256((__m256i*)lanes, acc);
  int32_t r = lanes[0] + lanes[1] + lanes[2] + lanes[3] + lanes[4] + lanes[5] +
              lanes[6] + lanes[7];
  for (; d < D; ++d) r += (int32_t)u[d] * (int32_t)s[d];
  return r;
#else
  int32_t r = 0;
  for (int32_t d = 0; d < D; ++d) r += (int32_t)u[d] * (int32_t)s[d];
  return r;
#endif
}

// Small fixed-size min-heap over (score, idx).
struct HeapEntry {
  float score;
  int64_t idx;
};

static void heap_sift_down(HeapEntry* h, int32_t n, int32_t i) {
  for (;;) {
    int32_t l = 2 * i + 1, r = l + 1, m = i;
    if (l < n && h[l].score < h[m].score) m = l;
    if (r < n && h[r].score < h[m].score) m = r;
    if (m == i) return;
    HeapEntry t = h[i];
    h[i] = h[m];
    h[m] = t;
    i = m;
  }
}

// Scan rows [lo, hi) of the quantized table, keep the top-L by approximate
// (dequantized) score in a heap. seen: optional V-byte mask (1 = exclude).
//
// The hot loop processes 4 rows per iteration with independent accumulator
// chains: a single-accumulator row dot is LATENCY-bound on dpbusd (~5-cycle
// chain per 32/64 bytes — measured 5.5 GB/s single-thread), while 4
// interleaved rows keep the FMA ports saturated and push the scan to the
// memory-bandwidth roof.
static void scan_range(const int8_t* q, const float* scale,
                       const int32_t* rowsum, const uint8_t* sess_u,
                       float sess_scale, int32_t sess_bias_sum, int32_t D,
                       const uint8_t* seen, int64_t lo, int64_t hi, int32_t L,
                       std::vector<HeapEntry>& heap) {
  heap.assign(L, HeapEntry{-3.4e38f, -1});
  float hmin = -3.4e38f;
  auto push = [&](int64_t i, int32_t dot) {
    if (seen && seen[i]) return;
    float s = scale[i];
    if (s == 0.f) return;  // zero rows (padding, unused capacity)
    float score = s * sess_scale * (float)dot;
    if (score > hmin) {
      heap[0] = HeapEntry{score, i};
      heap_sift_down(heap.data(), L, 0);
      hmin = heap[0].score;
    }
  };
  int64_t i = lo;
#if defined(__AVX512VNNI__) && defined(__AVX512F__)
  for (; i + 4 <= hi; i += 4) {
    const int8_t* r0 = q + i * D;
    const int8_t* r1 = r0 + D;
    const int8_t* r2 = r1 + D;
    const int8_t* r3 = r2 + D;
    __m512i a0 = _mm512_setzero_si512(), a1 = _mm512_setzero_si512();
    __m512i a2 = _mm512_setzero_si512(), a3 = _mm512_setzero_si512();
    _mm_prefetch((const char*)(r3 + D), _MM_HINT_T0);
    _mm_prefetch((const char*)(r3 + D + 64), _MM_HINT_T0);
    _mm_prefetch((const char*)(r3 + D + 128), _MM_HINT_T0);
    _mm_prefetch((const char*)(r3 + D + 192), _MM_HINT_T0);
    int32_t d = 0;
    for (; d + 64 <= D; d += 64) {
      __m512i u = _mm512_loadu_si512((const void*)(sess_u + d));
      a0 = _mm512_dpbusd_epi32(a0, u, _mm512_loadu_si512((const void*)(r0 + d)));
      a1 = _mm512_dpbusd_epi32(a1, u, _mm512_loadu_si512((const void*)(r1 + d)));
      a2 = _mm512_dpbusd_epi32(a2, u, _mm512_loadu_si512((const void*)(r2 + d)));
      a3 = _mm512_dpbusd_epi32(a3, u, _mm512_loadu_si512((const void*)(r3 + d)));
    }
    int32_t dot0 = _mm512_reduce_add_epi32(a0);
    int32_t dot1 = _mm512_reduce_add_epi32(a1);
    int32_t dot2 = _mm512_reduce_add_epi32(a2);
    int32_t dot3 = _mm512_reduce_add_epi32(a3);
    for (; d < D; ++d) {
      dot0 += (int32_t)sess_u[d] * (int32_t)r0[d];
      dot1 += (int32_t)sess_u[d] * (int32_t)r1[d];
      dot2 += (int32_t)sess_u[d] * (int32_t)r2[d];
      dot3 += (int32_t)sess_u[d] * (int32_t)r3[d];
    }
    push(i + 0, dot0 - 128 * rowsum[i + 0]);
    push(i + 1, dot1 - 128 * rowsum[i + 1]);
    push(i + 2, dot2 - 128 * rowsum[i + 2]);
    push(i + 3, dot3 - 128 * rowsum[i + 3]);
  }
#endif
  for (; i < hi; ++i) {
    int32_t acc = dot_u8s8(sess_u, q + i * D, D);
    // remove the +128 session bias: sum((qs+128)*qr) - 128*sum(qr)
    push(i, acc - 128 * rowsum[i]);
  }
}

// Top-L candidate selection over the int8 table. sess_q is the query vector
// already quantized to int8 with scale sess_scale (Python does the single
// D-length quantization). Returns candidates in out_idx/out_score (approx
// scores), count = min(L, eligible rows); excluded slots hold idx -1.
void score_int8_topl(const int8_t* q, const float* scale,
                     const int32_t* rowsum, int64_t V, int32_t D,
                     const int8_t* sess_q, float sess_scale,
                     const uint8_t* seen, int32_t L, int32_t n_threads,
                     int64_t* out_idx, float* out_score) {
  if (n_threads < 1) n_threads = 1;
  // Bias the session vector to unsigned once.
  std::vector<uint8_t> sess_u(D);
  int32_t bias_sum = 0;
  for (int32_t d = 0; d < D; ++d) {
    sess_u[d] = (uint8_t)((int32_t)sess_q[d] + 128);
    bias_sum += sess_q[d];
  }
  std::vector<std::vector<HeapEntry>> heaps(n_threads);
  std::vector<std::thread> threads;
  int64_t chunk = (V + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < V ? lo + chunk : V;
    if (lo >= hi) {
      heaps[t].assign(L, HeapEntry{-3.4e38f, -1});
      continue;
    }
    threads.emplace_back([&, t, lo, hi] {
      scan_range(q, scale, rowsum, sess_u.data(), sess_scale, bias_sum, D,
                 seen, lo, hi, L, heaps[t]);
    });
  }
  for (auto& th : threads) th.join();
  // Merge the per-thread heaps: collect all entries, partial-select top L.
  std::vector<HeapEntry> all;
  all.reserve((size_t)L * n_threads);
  for (auto& h : heaps)
    for (auto& e : h)
      if (e.idx >= 0) all.push_back(e);
  int32_t keep = (int32_t)(all.size() < (size_t)L ? all.size() : (size_t)L);
  // Selection: heapify a top-L min-heap over `all` (L log L'ish, tiny).
  std::vector<HeapEntry> sel(all.begin(), all.begin() + keep);
  for (int32_t i = keep / 2 - 1; i >= 0; --i)
    heap_sift_down(sel.data(), keep, i);
  for (size_t i = keep; i < all.size(); ++i) {
    if (all[i].score > sel[0].score) {
      sel[0] = all[i];
      heap_sift_down(sel.data(), keep, 0);
    }
  }
  for (int32_t i = 0; i < L; ++i) {
    if (i < keep) {
      out_idx[i] = sel[i].idx;
      out_score[i] = sel[i].score;
    } else {
      out_idx[i] = -1;
      out_score[i] = -3.4e38f;
    }
  }
}

}  // extern "C"
