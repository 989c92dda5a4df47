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
// Numerics: the moments and every per-row scalar use the round-to-nearest
// intrinsic of the plain PyTorch version's operation, in its order (no FMA
// contraction, expf and IEEE division and square root), so mu, nu and
// last_step equal the plain version's bit for bit. The series' per-element
// division is the multi-function unit's reciprocal (MUFU.RCP, within 1 ulp)
// times the dividend, with c2 * sqrt(nu) + eps and the sum of terms
// contracted to FMAs: no IEEE check (FCHK) and no slow-path branch. The
// weights stay within rtol 1e-6 / atol 1e-7 of the plain version's (at
// chip_smoke.py's inputs the largest error is 0.43 of that tolerance). Other
// groupings of the terms (a common denominator for two terms, mu or fac
// taken out of the sum) drifted from the plain version's sum by 0.7-0.96 of
// the tolerance in a float32 emulation of a million elements. The b^j are float32 roundings of the host's double
// powers, as in the JAX package. The moments are widened from bf16 on load
// and stored as embedding_adamw.cu stores them, with the stochastic-rounding
// counter (global row) * D + column.
//
// Design of the gather and materialize: persistent warps, in blocks of one
// warp, as many as the card holds at once (at most one a row). Each warp
// takes its rows from a ticket counter in device memory (RowQueue), so a
// warp whose rows ran few terms takes more of them and a row of 64 terms
// holds up no other warp (with a row a warp and blocks of four, a block's
// slot waits for its slowest row). A row is cut into items of 256 columns; a
// lane holds two float4 of an item (8 elements) and runs them through one
// series loop, which reads each term's (c1, c2, fac) from shared memory once
// for all 8. While an item's series runs, the warp's next item (the same
// row's next columns, or its next row) is on its way into shared memory by
// cp.async (two stages a warp), and the scalars of the rows after it (uid,
// last_step) are loaded: the series and the memory traffic overlap. A row's
// min(m, terms) triples (c1, c2, fac) are computed once by the warp's lanes
// into shared memory. The touched update is a warp a row, four rows a block.
// The b^j constants and the other hyper-parameters travel in the kernel
// parameters (__grid_constant__), so a launch needs no copy. The gather and
// the touched update run inside the chained train step's CUDA graphs: they
// read the step count, the bias denominators and the rounding seeds from the
// step's row of the step block (step_block.cuh), which the host refills
// before each replay. Materialize runs outside any graph and takes them by
// value.
//
// Bound on an H100 SXM (467,456 x 256 table, float32 moments): the gather
// and the touched update move about 87 MB and 86 MB for 12,000 real rows of
// 16,384 slots (0.026 ms at 3.35 TB/s). Materialize moves 2.87 GB (0.86 ms)
// when every row is behind. An element and term of the series costs one
// reciprocal on the multi-function unit (16 lanes an SM and clock, an eighth
// of the float32 lanes) and 5.5 issued instructions (the compiled loop,
// counted by chip_smoke.py), so with rows 0 .. 64 terms behind (34 on
// average, 3.9 G element-terms) the reciprocals alone take 0.93 ms and
// materialize is bound by them; the gather stays bound by its bytes.
// chip_smoke.py measures all three; PERF.md holds the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cp_async.cuh"
#include "moment_io.cuh"
#include "step_block.cuh"

namespace {

constexpr int kWarps = 4;  // the touched update: a warp a row, four rows a block
constexpr int kThreads = 32 * kWarps;
// The gather and materialize: blocks of one warp (blocks of four ran the
// gather 8 % slower, PERF.md), as many as the card holds.
constexpr int kSeriesWarps = 1;
constexpr int kSeriesThreads = 32 * kSeriesWarps;
constexpr int kMaxTerms = 64;
constexpr int kItem4 = 64;  // float4 columns an item: two a lane

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

// A warp's shared memory: the current row's terms (c1, c2, fac, -) and two
// stages of an item's table, mu and nu (bf16 moments use the first half of
// their arrays).
struct alignas(16) WarpSmem {
  float4 terms[kMaxTerms];
  struct alignas(16) Stage {
    float w[4 * kItem4], mu[4 * kItem4], nu[4 * kItem4];
  } stage[2];
};

// The catch-up of one row by m steps: the three whole-row factors; the
// per-term scalars are in the warp's shared memory.
struct Series {
  int n;               // min(m, terms)
  float dw, dmu, dnu;  // exp(m * a_log), exp(m * ln b1), exp(m * ln b2)
};

__device__ __forceinline__ Series row_series(const Hyper& hp, int s0, int m, float4* terms, int lane) {
  const int n = min(m, hp.terms);
  __syncwarp();  // every lane is done with the previous row's terms
  for (int i = lane; i < n; i += 32) {
    const int j = i + 1;
    const float s = __fadd_rn(static_cast<float>(s0), static_cast<float>(j));
    const float bc1 = __fsub_rn(1.0f, expf(__fmul_rn(s, hp.ln_b1)));
    const float bc2 = __fsub_rn(1.0f, expf(__fmul_rn(s, hp.ln_b2)));
    terms[i] = make_float4(__fdiv_rn(hp.b1_pow[i], bc1), __fsqrt_rn(__fdiv_rn(hp.b2_pow[i], bc2)),
                           expf(__fmul_rn(static_cast<float>(m - j), hp.a_log)), 0.0f);
  }
  __syncwarp();
  const float mf = static_cast<float>(m);
  return {n, expf(__fmul_rn(mf, hp.a_log)), expf(__fmul_rn(mf, hp.ln_b1)), expf(__fmul_rn(mf, hp.ln_b2))};
}

// 1 / d for d >= eps > 0: the multi-function unit's approximation, within
// 1 ulp; no special cases, so no branch. (A Newton step after it made
// materialize 17 % slower and left the largest error at the same 0.43 of
// the tolerance, PERF.md.)
__device__ __forceinline__ float reciprocal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// A lane's 8 elements caught up. Where all 8 mu are 0 (a row never touched,
// or decayed to nothing) the series is skipped; a zero mu adds exact zeros
// (acc stays +0 whatever its sign), so the bits are the same either way.
__device__ __forceinline__ void catch_up8(const Hyper& hp, const Series& s, const float4* terms,
                                          float (&w)[8], float (&mu)[8], float (&nu)[8]) {
  float sq[8], acc[8];
  bool live = false;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    sq[t] = __fsqrt_rn(nu[t]);
    acc[t] = 0.0f;
    live |= mu[t] != 0.0f;
  }
  if (live) {
#pragma unroll 2
    for (int i = 0; i < s.n; ++i) {
      const float4 c = terms[i];  // one shared load for the 8 elements
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float u = __fmul_rn(__fmul_rn(c.x, mu[t]), reciprocal(fmaf(c.y, sq[t], hp.eps)));
        acc[t] = fmaf(c.z, u, acc[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    w[t] = __fsub_rn(__fmul_rn(s.dw, w[t]), __fmul_rn(hp.lr, acc[t]));
    mu[t] = __fmul_rn(s.dmu, mu[t]);
    nu[t] = __fmul_rn(s.dnu, nu[t]);
  }
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void copy4_async(__nv_bfloat16* dst, const __nv_bfloat16* src) { cp_async8(dst, src); }

// Starts the copies of an item (row `base` = row * D, float4 columns c0 ..
// c0 + 63) into a stage: each lane copies the two float4 it will read.
template <typename MT, typename NT>
__device__ __forceinline__ void fetch_item(WarpSmem::Stage& st, const float* table, const MT* mu, const NT* nu,
                                           long long base, int c0, int d4, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + lane + 32 * k;
    if (c < d4) {
      const int e = 4 * (lane + 32 * k);
      cp_async16(st.w + e, table + base + 4 * c);
      copy4_async(reinterpret_cast<MT*>(st.mu) + e, mu + base + 4 * c);
      copy4_async(reinterpret_cast<NT*>(st.nu) + e, nu + base + 4 * c);
    }
  }
}

// Reads a lane's 8 elements of an item from its stage (once the copies landed).
template <typename MT, typename NT>
__device__ __forceinline__ void read_item(const WarpSmem::Stage& st, int lane, float (&w)[8], float (&mu)[8],
                                          float (&nu)[8]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = 4 * (lane + 32 * k);
    float a[4], b[4], c[4];
    load4(st.w + e, a);
    load4(reinterpret_cast<const MT*>(st.mu) + e, b);
    load4(reinterpret_cast<const NT*>(st.nu) + e, c);
#pragma unroll
    for (int t = 0; t < 4; ++t) w[4 * k + t] = a[t], mu[4 * k + t] = b[t], nu[4 * k + t] = c[t];
  }
}

// Rows of a persistent kernel, handed out in order: the first three of a
// warp fixed by its place in the grid, every later one drawn from a counter
// in device memory (a ticket), so a warp that finishes early takes more rows
// and a row of 64 terms holds up no other warp. A draw runs three rows ahead
// of its use. The last warp to finish drawing sets the counter back to 0 for
// the next launch (launches of one kernel run on one stream at a time).
struct RowQueue {
  int* counter;  // [tickets drawn, warps done drawing]
  long long total, warps;
  long long cur, nxt, nn;  // the warp's row, and its next two
  int ticket;              // lane 0: the draw in flight
  bool drawing;

  __device__ RowQueue(int* counter_, long long total_, int lane) : counter(counter_), total(total_) {
    warps = static_cast<long long>(gridDim.x) * kSeriesWarps;
    cur = static_cast<long long>(blockIdx.x) * kSeriesWarps + (threadIdx.x >> 5);
    nxt = cur + warps;
    nn = nxt + warps;
    ticket = lane == 0 ? atomicAdd(counter, 1) : 0;
    drawing = true;
  }

  // cur <- nxt <- nn <- the drawn row; draws again while rows remain.
  __device__ void advance(int lane) {
    cur = nxt;
    nxt = nn;
    if (!drawing) {
      nn = total;
      return;
    }
    nn = 3 * warps + __shfl_sync(0xffffffffu, ticket, 0);
    if (nn < total) {
      if (lane == 0) ticket = atomicAdd(counter, 1);
    } else {
      done(lane);
    }
  }

  // At the warp's end: waits for a draw still in flight, then counts the warp done.
  __device__ void close(int lane) {
    if (drawing) {
      __shfl_sync(0xffffffffu, ticket, 0);
      done(lane);
    }
  }

  __device__ void done(int lane) {
    drawing = false;
    if (lane == 0 && atomicAdd(counter + 1, 1) == warps - 1) {
      counter[0] = 0;
      counter[1] = 0;
    }
  }
};

// The ticket counters of the two persistent kernels, on each device.
__device__ int g_gather_tickets[2];
__device__ int g_materialize_tickets[2];

// Writes a lane's 8 elements of an item (row `base` = row * D): the
// gather's float32 rows, or materialize's table rows and moments (bf16
// moments rounded with the counter base + column; float32 ignores it).
template <typename MT, typename NT>
__device__ __forceinline__ void store_item(float* w, MT* mu, NT* nu, long long base, int c0, int d4, int lane,
                                           const float (&wv)[8], const float (&mv)[8], const float (&vv)[8],
                                           const Hyper& hp) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + lane + 32 * k;
    if (c < d4) {
      const float a[4] = {wv[4 * k], wv[4 * k + 1], wv[4 * k + 2], wv[4 * k + 3]};
      const float b[4] = {mv[4 * k], mv[4 * k + 1], mv[4 * k + 2], mv[4 * k + 3]};
      const float e[4] = {vv[4 * k], vv[4 * k + 1], vv[4 * k + 2], vv[4 * k + 3]};
      const unsigned long long idx = static_cast<unsigned long long>(base + 4 * c);
      store4(w + base + 4 * c, a);
      store4(mu + base + 4 * c, b, hp.sr_mu, hp.seed_mu, idx);
      store4(nu + base + 4 * c, e, hp.sr_nu, hp.seed_nu, idx);
    }
  }
}

template <typename MT, typename NT>
__global__ void __launch_bounds__(kSeriesThreads)
gather_catch_up_kernel(const float* __restrict__ table, const MT* __restrict__ mu,
                       const NT* __restrict__ nu, const int* __restrict__ last_step,
                       const int* __restrict__ uid, float* __restrict__ w_c,
                       float* __restrict__ mu_c, float* __restrict__ nu_c,
                       const long long* __restrict__ step, int U, long long rows, int d4,
                       const __grid_constant__ Hyper hp) {
  __shared__ WarpSmem smem[kSeriesWarps];
  const int lane = threadIdx.x & 31;
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const long long D = 4LL * d4;
  const int target = step_block::count(step) - 1;
  // Row id of a slot, -1 for a sentinel slot or past the end (every lane
  // loads the same address: one transaction, and no wait until it is used).
  auto id_of = [&](long long slot) -> long long {
    if (slot >= U) return -1;
    const long long id = uid[slot];
    return id < 0 || id >= rows ? -1 : id;
  };
  RowQueue q(g_gather_tickets, U, lane);
  long long id = id_of(q.cur), id_n = id_of(q.nxt), id_nn = id_of(q.nn);
  int s0 = id >= 0 ? last_step[id] : 0, s0_n = id_n >= 0 ? last_step[id_n] : 0;
  if (id >= 0) fetch_item(sm.stage[0], table, mu, nu, id * D, 0, d4, lane);
  cp_async_commit();
  Series s{};
  int c0 = 0;
  for (int st = 0; q.cur < U; st ^= 1) {
    // Start the next item's copies: this row's next columns, or the next row's first.
    const bool last = c0 + kItem4 >= d4;
    const long long next_id = last ? id_n : id;
    if (next_id >= 0) fetch_item(sm.stage[st ^ 1], table, mu, nu, next_id * D, last ? 0 : c0 + kItem4, d4, lane);
    cp_async_commit();
    float w[8] = {}, m[8] = {}, v[8] = {};  // a sentinel slot gets zeros, never read by the step
    if (id >= 0) {
      if (c0 == 0) s = row_series(hp, s0, max(target - s0, 0), sm.terms, lane);
      cp_async_wait<1>();  // this item's copies have landed; the next one's fly on
      read_item<MT, NT>(sm.stage[st], lane, w, m, v);
      catch_up8(hp, s, sm.terms, w, m, v);
    }
    store_item(w_c, mu_c, nu_c, q.cur * D, c0, d4, lane, w, m, v, hp);
    if (last) {  // the scalars of the rows ahead are loaded now and used a row or two later
      q.advance(lane);
      id = id_n, s0 = s0_n, id_n = id_nn;
      s0_n = id_n >= 0 ? last_step[id_n] : 0;
      id_nn = id_of(q.nn);
      c0 = 0;
    } else {
      c0 += kItem4;
    }
  }
  q.close(lane);
  cp_async_wait<0>();
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
__global__ void __launch_bounds__(kSeriesThreads)
materialize_kernel(float* __restrict__ table, MT* __restrict__ mu, NT* __restrict__ nu,
                   int* __restrict__ last_step, long long rows, int d4,
                   const __grid_constant__ Hyper hp) {
  __shared__ WarpSmem smem[kSeriesWarps];
  const int lane = threadIdx.x & 31;
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const long long D = 4LL * d4;
  // Steps a row is behind (0 past the end). A row already at the count is
  // neither read nor written; it only gets last_step = count.
  auto lag_of = [&](long long row) { return row < rows ? max(hp.count - last_step[row], 0) : 0; };
  RowQueue q(g_materialize_tickets, rows, lane);
  int m = lag_of(q.cur), m_n = lag_of(q.nxt), m_nn = lag_of(q.nn);
  if (m > 0) fetch_item(sm.stage[0], table, mu, nu, q.cur * D, 0, d4, lane);
  cp_async_commit();
  Series s{};
  int c0 = 0;
  for (int st = 0; q.cur < rows; st ^= 1) {
    const bool last = c0 + kItem4 >= d4;
    if (last ? m_n > 0 : m > 0) {
      fetch_item(sm.stage[st ^ 1], table, mu, nu, (last ? q.nxt : q.cur) * D, last ? 0 : c0 + kItem4, d4, lane);
    }
    cp_async_commit();
    if (m > 0) {
      if (c0 == 0) s = row_series(hp, hp.count - m, m, sm.terms, lane);
      cp_async_wait<1>();
      float w[8], mv[8], v[8];
      read_item<MT, NT>(sm.stage[st], lane, w, mv, v);
      catch_up8(hp, s, sm.terms, w, mv, v);
      store_item(table, mu, nu, q.cur * D, c0, d4, lane, w, mv, v, hp);
    }
    if (last) {
      if (lane == 0) last_step[q.cur] = hp.count;
      q.advance(lane);
      m = m_n, m_n = m_nn, m_nn = lag_of(q.nn);
      c0 = 0;
    } else {
      c0 += kItem4;
    }
  }
  q.close(lane);
  cp_async_wait<0>();
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

// Blocks of a persistent kernel (blocks of kSeriesWarps): as many as the
// card holds at once (the occupancy the compiled kernel allows; asked once a
// device), at most one warp a row.
template <typename Kernel>
unsigned persistent_grid(Kernel kernel, long long rows) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  dev = std::min(dev, kMaxDevices - 1);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSeriesThreads, 0);
    resident[dev] = std::max(sms * per_sm, 1);
  }
  return static_cast<unsigned>(std::min<long long>(resident[dev], (rows + kSeriesWarps - 1) / kSeriesWarps));
}

template <typename P>
using elem_t = std::remove_const_t<std::remove_pointer_t<P>>;

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
      auto* kernel = gather_catch_up_kernel<elem_t<decltype(m)>, elem_t<decltype(n)>>;
      kernel<<<persistent_grid(kernel, U), kSeriesThreads, 0, s>>>(
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
      auto* kernel = materialize_kernel<elem_t<decltype(m)>, elem_t<decltype(n)>>;
      kernel<<<persistent_grid(kernel, rows), kSeriesThreads, 0, s>>>(
          static_cast<float*>(table), m, n, static_cast<int*>(last_step), rows, D / 4, hp);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
