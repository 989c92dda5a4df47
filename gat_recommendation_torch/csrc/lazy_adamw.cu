// Lazy catch-up AdamW over the item-embedding table for Hopper (sm_90a):
// three row kernels, in place where they write the table. Plain C interface
// for ctypes.
//
// The JAX package has no Pallas source for this work: XLA fuses it there
// (its ops/lazy_adamw.py and train/optimizers.py:259-346).
// Eager PyTorch would spend hundreds of launches on the 64-term series, so the
// port writes it by hand:
//   lazy_gather_catch_up   FusedEmbeddingAdamW.gather_catch_up -> lazy_adamw.catch_up
//   lazy_touched_update    update_sparse_lazy -> touched_update + the row scatters
//   lazy_materialize       materialize -> materialize_arrays
//
// A row last written at step s0 and caught up by m zero-gradient steps
// (a = 1 - lr*wd, kept in log space because it rounds to 1 in float32):
//     c1_j  = f32(b1^j) / (1 - exp((s0+j) * ln b1))
//     c2_j  = sqrt(f32(b2^j) / (1 - exp((s0+j) * ln b2)))
//     fac_j = exp((m-j) * log1p(-lr*wd))                      j = 1 .. min(m, terms)
//     acc   = sum_j fac_j * (c1_j * mu) / (c2_j * sqrt(nu) + eps)
//     w    <- exp(m * a_log) * w - lr * acc,  mu <- exp(m * ln b1) * mu,  nu <- exp(m * ln b2) * nu
// The gather catches the uid rows up to count - 1 (m = count - 1 - s0) into
// float32 [U, D] buffers (zeros for slots outside the table: the sentinel
// tail); the touched update applies the AdamW step at `count` to those
// buffers with this step's summed gradient and scatters table, mu, nu and
// last_step = count to the uid rows (slots outside the table are dropped;
// uid is unique, so no atomics and no order); materialize catches every row
// up to count (m = count - s0) and sets last_step = count. Terms with j > m
// add exactly zero, so each row runs min(m, terms) of them; a row with m = 0
// keeps its bits, so materialize skips it.
//
// Numerics: every operation is the round-to-nearest intrinsic of the plain
// PyTorch version's operation, in its order (ops/lazy_adamw.py): no FMA
// contraction, expf and IEEE division and square root (no fast math). The
// b^j are float32 roundings of the host's double powers, as in the JAX
// package. The moments are widened from bf16 on load and stored as
// embedding_adamw.cu stores them, with the stochastic-rounding counter
// (global row) * D + column.
//
// Design: one warp per row (four rows a block); a row's min(m, terms) triples
// (c1, c2, fac) are computed once by the warp's lanes into shared memory,
// then each lane runs the series over its float4 columns. The b^j constants
// and the other hyper-parameters travel in the kernel parameters
// (__grid_constant__), so a launch needs no copy. The gather and the touched
// update run inside the chained train step's CUDA graphs: they read the step
// count, the bias denominators and the rounding seeds from the step's row of
// the step block (step_block.cuh), which the host refills before each replay.
// Materialize runs outside any graph and takes them by value.
//
// Bound on an H100 SXM (467,456 x 256 table, float32 moments): the gather
// and the touched update move about 74 MB and 86 MB for 12,000 real rows of
// 16,384 slots (0.022 and 0.026 ms at 3.35 TB/s). Materialize moves 2.87 GB
// (0.86 ms) when every row is behind; its series is about 6 float32
// operations an element and term, one an IEEE division, so with all rows 64
// steps behind it does 46 G operations (0.69 ms at 67 TFLOP/s) and the
// division's instruction sequence may bound it instead. chip_smoke.py
// measures all three; PERF.md holds the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moment_io.cuh"
#include "step_block.cuh"

namespace {

constexpr int kWarps = 4;  // rows a block, one warp each (4 beat 8 and 16 in PERF.md)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTerms = 64;

struct Hyper {
  float lr, eps, wd;
  float b1, b2, omb1, omb2;    // touched update: b, 1 - b
  float ln_b1, ln_b2, a_log;   // catch-up: log b1, log b2, log1p(-lr * wd)
  float b1_pow[kMaxTerms];     // float32(b1^j), j = 1 .. terms
  float b2_pow[kMaxTerms];
  unsigned long long seed_mu, seed_nu;  // materialize (the touched update reads its step's row)
  int sr_mu, sr_nu;  // stochastic rounding of a bf16 buffer
  int count;         // materialize: the step number the table catches up to
  int terms;         // series length, <= kMaxTerms
};

// The catch-up of one row by m steps: the per-term row scalars in shared
// memory and the three whole-row factors.
struct Series {
  const float* c1;
  const float* c2;
  const float* fac;
  int n;               // min(m, terms)
  float dw, dmu, dnu;  // exp(m * a_log), exp(m * ln b1), exp(m * ln b2)
};

__device__ __forceinline__ Series row_series(const Hyper& hp, int s0, int m, float* c1, float* c2,
                                             float* fac, int lane) {
  const int n = min(m, hp.terms);
  for (int i = lane; i < n; i += 32) {
    const int j = i + 1;
    const float s = __fadd_rn(static_cast<float>(s0), static_cast<float>(j));
    const float bc1 = __fsub_rn(1.0f, expf(__fmul_rn(s, hp.ln_b1)));
    const float bc2 = __fsub_rn(1.0f, expf(__fmul_rn(s, hp.ln_b2)));
    c1[i] = __fdiv_rn(hp.b1_pow[i], bc1);
    c2[i] = __fsqrt_rn(__fdiv_rn(hp.b2_pow[i], bc2));
    fac[i] = expf(__fmul_rn(static_cast<float>(m - j), hp.a_log));
  }
  __syncwarp();
  const float mf = static_cast<float>(m);
  return {c1, c2, fac, n, expf(__fmul_rn(mf, hp.a_log)), expf(__fmul_rn(mf, hp.ln_b1)),
          expf(__fmul_rn(mf, hp.ln_b2))};
}

__device__ __forceinline__ void catch_up4(const Hyper& hp, const Series& s, float (&w)[4],
                                          float (&mu)[4], float (&nu)[4]) {
  // Where all four mu are 0 (a row never touched, or decayed to nothing)
  // every term is a zero added to acc, and acc never holds -0, so the series
  // is skipped with the same bits: the division would take its slow path for
  // each zero dividend.
  float sq[4], acc[4];
  bool live = false;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    sq[t] = __fsqrt_rn(nu[t]);
    acc[t] = 0.0f;
    live |= mu[t] != 0.0f;
  }
  for (int i = 0; live && i < s.n; ++i) {
    const float c1 = s.c1[i], c2 = s.c2[i], fac = s.fac[i];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float u = __fdiv_rn(__fmul_rn(c1, mu[t]), __fadd_rn(__fmul_rn(c2, sq[t]), hp.eps));
      acc[t] = __fadd_rn(acc[t], __fmul_rn(fac, u));
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    w[t] = __fsub_rn(__fmul_rn(s.dw, w[t]), __fmul_rn(hp.lr, acc[t]));
    mu[t] = __fmul_rn(s.dmu, mu[t]);
    nu[t] = __fmul_rn(s.dnu, nu[t]);
  }
}

template <typename MT, typename NT>
__global__ void __launch_bounds__(kThreads)
gather_catch_up_kernel(const float* __restrict__ table, const MT* __restrict__ mu,
                       const NT* __restrict__ nu, const int* __restrict__ last_step,
                       const int* __restrict__ uid, float* __restrict__ w_c,
                       float* __restrict__ mu_c, float* __restrict__ nu_c,
                       const long long* __restrict__ step, int U, long long rows, int d4,
                       const __grid_constant__ Hyper hp) {
  __shared__ float s_c1[kWarps][kMaxTerms], s_c2[kWarps][kMaxTerms], s_fac[kWarps][kMaxTerms];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (slot >= U) return;
  const long long out = slot * 4LL * d4;
  const long long id = uid[slot];
  if (id < 0 || id >= rows) {  // sentinel slot: zeros, never read by the step
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < d4; c += 32) {
      store4(w_c + out + 4 * c, zero);
      store4(mu_c + out + 4 * c, zero);
      store4(nu_c + out + 4 * c, zero);
    }
    return;
  }
  const int s0 = __shfl_sync(0xffffffffu, lane == 0 ? last_step[id] : 0, 0);
  const Series s = row_series(hp, s0, max(step_block::count(step) - 1 - s0, 0), s_c1[warp],
                              s_c2[warp], s_fac[warp], lane);
  const long long in = id * 4LL * d4;
  for (int c = lane; c < d4; c += 32) {
    float w[4], m[4], v[4];
    load4(table + in + 4 * c, w);
    load4(mu + in + 4 * c, m);
    load4(nu + in + 4 * c, v);
    catch_up4(hp, s, w, m, v);
    store4(w_c + out + 4 * c, w);
    store4(mu_c + out + 4 * c, m);
    store4(nu_c + out + 4 * c, v);
  }
}

template <typename MT, typename NT>
__global__ void __launch_bounds__(kThreads)
touched_update_kernel(float* __restrict__ table, MT* __restrict__ mu, NT* __restrict__ nu,
                      int* __restrict__ last_step, const int* __restrict__ uid,
                      const float* __restrict__ w_c, const float* __restrict__ mu_c,
                      const float* __restrict__ nu_c, const float* __restrict__ summed,
                      const long long* __restrict__ step, int U, long long rows, int d4,
                      const __grid_constant__ Hyper hp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (slot >= U) return;
  const long long id = uid[slot];
  if (id < 0 || id >= rows) return;  // sentinel slot: dropped
  const float bc1 = step_block::as_float(step, step_block::kBc1);
  const float bc2 = step_block::as_float(step, step_block::kBc2);
  const unsigned long long seed_mu = step_block::as_seed(step, step_block::kSeedMu);
  const unsigned long long seed_nu = step_block::as_seed(step, step_block::kSeedNu);
  const long long in = slot * 4LL * d4, out = id * 4LL * d4;
  for (int c = lane; c < d4; c += 32) {
    float w[4], m[4], v[4], g[4];
    load4(w_c + in + 4 * c, w);
    load4(mu_c + in + 4 * c, m);
    load4(nu_c + in + 4 * c, v);
    load4(summed + in + 4 * c, g);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      m[t] = __fadd_rn(__fmul_rn(hp.b1, m[t]), __fmul_rn(hp.omb1, g[t]));
      v[t] = __fadd_rn(__fmul_rn(hp.b2, v[t]), __fmul_rn(hp.omb2, __fmul_rn(g[t], g[t])));
      const float mu_hat = __fdiv_rn(m[t], bc1);
      const float nu_hat = __fdiv_rn(v[t], bc2);
      const float upd = __fadd_rn(__fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), hp.eps)),
                                  __fmul_rn(hp.wd, w[t]));
      w[t] = __fsub_rn(w[t], __fmul_rn(hp.lr, upd));
    }
    const unsigned long long idx = static_cast<unsigned long long>(out + 4 * c);
    store4(table + out + 4 * c, w);
    store4(mu + out + 4 * c, m, hp.sr_mu, seed_mu, idx);
    store4(nu + out + 4 * c, v, hp.sr_nu, seed_nu, idx);
  }
  if (lane == 0) last_step[id] = step_block::count(step);
}

template <typename MT, typename NT>
__global__ void __launch_bounds__(kThreads)
materialize_kernel(float* __restrict__ table, MT* __restrict__ mu, NT* __restrict__ nu,
                   int* __restrict__ last_step, long long rows, int d4,
                   const __grid_constant__ Hyper hp) {
  __shared__ float s_c1[kWarps][kMaxTerms], s_c2[kWarps][kMaxTerms], s_fac[kWarps][kMaxTerms];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  // Lane 0 reads last_step before it writes it; the others take its value.
  const int s0 = __shfl_sync(0xffffffffu, lane == 0 ? last_step[row] : 0, 0);
  const int m = max(hp.count - s0, 0);
  if (m > 0) {
    const Series s = row_series(hp, s0, m, s_c1[warp], s_c2[warp], s_fac[warp], lane);
    const long long base = row * 4LL * d4;
    for (int c = lane; c < d4; c += 32) {
      float w[4], mv[4], v[4];
      load4(table + base + 4 * c, w);
      load4(mu + base + 4 * c, mv);
      load4(nu + base + 4 * c, v);
      catch_up4(hp, s, w, mv, v);
      const unsigned long long idx = static_cast<unsigned long long>(base + 4 * c);
      store4(table + base + 4 * c, w);
      store4(mu + base + 4 * c, mv, hp.sr_mu, hp.seed_mu, idx);
      store4(nu + base + 4 * c, v, hp.sr_nu, hp.seed_nu, idx);
    }
  }
  if (lane == 0) last_step[row] = hp.count;
}

Hyper catch_up_hyper(int count, int terms, float lr, float eps, float ln_b1, float ln_b2,
                     float a_log, const float* b1_pow, const float* b2_pow) {
  Hyper hp = {};
  hp.lr = lr, hp.eps = eps, hp.ln_b1 = ln_b1, hp.ln_b2 = ln_b2, hp.a_log = a_log;
  hp.count = count, hp.terms = terms;
  for (int i = 0; i < terms; ++i) hp.b1_pow[i] = b1_pow[i], hp.b2_pow[i] = b2_pow[i];
  return hp;
}

unsigned grid_for(long long rows) { return static_cast<unsigned>((rows + kWarps - 1) / kWarps); }

// Calls fn with the table's moment pointers cast to their element types.
template <typename Fn>
void with_moments(void* mu, void* nu, int mu_bf16, int nu_bf16, Fn fn) {
  auto* mf = static_cast<float*>(mu);
  auto* nf = static_cast<float*>(nu);
  auto* mb = static_cast<__nv_bfloat16*>(mu);
  auto* nb = static_cast<__nv_bfloat16*>(nu);
  if (mu_bf16 && nu_bf16) fn(mb, nb);
  else if (mu_bf16) fn(mb, nf);
  else if (nu_bf16) fn(mf, nb);
  else fn(mf, nf);
}

}  // namespace

// Shapes are checked by the Python wrappers (ops/lazy_adamw.py): table [rows, D]
// f32 with D % 4 == 0, mu and nu [rows, D] f32 or bf16, last_step [rows] int32,
// uid [U] int32 unique, w_c / mu_c / nu_c / summed [U, D] f32, all contiguous
// and 16-byte aligned; 1 <= terms <= 64; `step` is the device address of the
// step's row of the step block (int64 fields, step_block.cuh). Each returns
// cudaGetLastError().
extern "C" int lazy_gather_catch_up(const void* table, const void* mu, const void* nu,
                                    const void* last_step, const void* uid, void* w_c, void* mu_c,
                                    void* nu_c, const void* step, int U, long long rows, int D,
                                    int mu_bf16, int nu_bf16, int terms, float lr, float eps,
                                    float ln_b1, float ln_b2, float a_log, const float* b1_pow,
                                    const float* b2_pow, void* stream) {
  const Hyper hp = catch_up_hyper(0, terms, lr, eps, ln_b1, ln_b2, a_log, b1_pow, b2_pow);
  if (U > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    with_moments(const_cast<void*>(mu), const_cast<void*>(nu), mu_bf16, nu_bf16, [&](auto* m, auto* n) {
      gather_catch_up_kernel<<<grid_for(U), kThreads, 0, s>>>(
          static_cast<const float*>(table), m, n, static_cast<const int*>(last_step),
          static_cast<const int*>(uid), static_cast<float*>(w_c), static_cast<float*>(mu_c),
          static_cast<float*>(nu_c), static_cast<const long long*>(step), U, rows, D / 4, hp);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lazy_touched_update(void* table, void* mu, void* nu, void* last_step,
                                   const void* uid, const void* w_c, const void* mu_c,
                                   const void* nu_c, const void* summed, const void* step, int U,
                                   long long rows, int D, int mu_bf16, int nu_bf16, int sr_mu,
                                   int sr_nu, float lr, float b1, float b2, float eps, float wd,
                                   float omb1, float omb2, void* stream) {
  Hyper hp = {};
  hp.lr = lr, hp.eps = eps, hp.wd = wd, hp.b1 = b1, hp.b2 = b2, hp.omb1 = omb1, hp.omb2 = omb2;
  hp.sr_mu = sr_mu, hp.sr_nu = sr_nu;
  if (U > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    with_moments(mu, nu, mu_bf16, nu_bf16, [&](auto* m, auto* n) {
      touched_update_kernel<<<grid_for(U), kThreads, 0, s>>>(
          static_cast<float*>(table), m, n, static_cast<int*>(last_step),
          static_cast<const int*>(uid), static_cast<const float*>(w_c),
          static_cast<const float*>(mu_c), static_cast<const float*>(nu_c),
          static_cast<const float*>(summed), static_cast<const long long*>(step), U, rows, D / 4,
          hp);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lazy_materialize(void* table, void* mu, void* nu, void* last_step, long long rows,
                                int D, int mu_bf16, int nu_bf16, int sr_mu, int sr_nu,
                                unsigned long long seed_mu, unsigned long long seed_nu, int count,
                                int terms, float lr, float eps, float ln_b1, float ln_b2,
                                float a_log, const float* b1_pow, const float* b2_pow,
                                void* stream) {
  Hyper hp = catch_up_hyper(count, terms, lr, eps, ln_b1, ln_b2, a_log, b1_pow, b2_pow);
  hp.seed_mu = seed_mu, hp.seed_nu = seed_nu, hp.sr_mu = sr_mu, hp.sr_nu = sr_nu;
  if (rows > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    with_moments(mu, nu, mu_bf16, nu_bf16, [&](auto* m, auto* n) {
      materialize_kernel<<<grid_for(rows), kThreads, 0, s>>>(
          static_cast<float*>(table), m, n, static_cast<int*>(last_step), rows, D / 4, hp);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
