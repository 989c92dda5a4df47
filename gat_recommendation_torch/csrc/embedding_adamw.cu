// AdamW over the item-embedding table for Hopper (sm_90a): the sparse and the
// dense update, one pass each, in place. Plain C interface for ctypes.
//
// Replaces two Pallas kernels of the JAX package:
//   ops/pallas/sparse_adamw.py::fused_sparse_adamw      -> sparse_adamw
//   ops/pallas/embedding_adamw.py::fused_embedding_adamw -> embedding_adamw
//
// sparse_adamw: the table gradient arrives as (uid, summed): ascending unique
// GLOBAL row ids with a sentinel tail (2^31 - 1), and the summed gradient row
// of each. For every row r of this table (global id row_offset + r):
//     mu = b1 * (mu + c1 * s),  nu = b2 * (nu + c2 * (s * s))     s = summed row of r, or 0
//     w  = w - lr * ((mu * ibc1) / (sqrt(nu * ibc2) + eps) + wd * w)
// with c1 = (1 - b1) / b1, c2 = (1 - b2) / b2 (the contribution is added
// BEFORE the decay multiply, so touched rows get b*m + (1-b)*g and the rest
// b*m), ibc = 1 / (1 - b^count) computed by the host in float32. uid values
// outside [row_offset, row_offset + rows) touch nothing. Both updates read ibc
// and the rounding seeds from the step's row of the step block (step_block.cuh):
// the sparse one runs inside the chained train step's CUDA graphs, which would
// freeze a by-value argument at the captured step.
//
// embedding_adamw: the same tail from a dense gradient,
//     mu = b1 * mu + (1 - b1) * g,  nu = b2 * nu + (1 - b2) * (g * g).
//
// Moments are stored as f32, or as bf16 rounded to nearest, or as bf16 with
// stochastic rounding: add 16 random bits to the f32 pattern and truncate.
// The bits are counter_hash(seed of the buffer, global row * D + column), so
// the plain PyTorch version draws the same bits; the arithmetic is written
// with the round-to-nearest intrinsics (no FMA contraction) in the order of
// the plain version, so both produce the same moments bit for bit.
//
// Design: no tile of rows is held anywhere; there is no cap on the number of
// uid slots. One thread per float4 of the table. In the sparse kernel the
// uid slice that can match a block's rows is found once per block (two
// threads binary-search the block's first row and its last row + 1 while the
// others already have their table and moment loads in flight), then each
// thread searches that slice, which holds a handful of entries at most.
//
// Bound on an H100 SXM: bytes. At 467,456 x 256 with f32 moments the sparse
// update reads and writes table, mu and nu once each (6 x 478.7 MB) plus the
// summed rows: about 2.87 GB, 0.86 ms at 3.35 TB/s; with bf16 moments about
// 1.91 GB, 0.57 ms. The dense update reads the gradient too: 3.35 GB, 1.00 ms.
// chip_smoke.py measures both; PERF.md holds the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moment_io.cuh"
#include "step_block.cuh"

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, b2, eps, wd;
  float a1, a2;      // sparse: c1, c2; dense: 1 - b1, 1 - b2
  int sr_mu, sr_nu;  // stochastic rounding of a bf16 buffer
};

// First position in uid[lo, hi) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ uid, int lo, int hi,
                                           long long key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)uid[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename MT, typename NT, bool kSparse>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ w, MT* __restrict__ mu, NT* __restrict__ nu,
             const float* __restrict__ grad, const int* __restrict__ uid,
             const long long* __restrict__ step, int U, long long rows, int d4,
             long long row_offset, Hyper hp) {
  const long long total = rows * d4;
  const long long first = (long long)blockIdx.x * kThreads;
  const long long e = first + threadIdx.x;
  const bool live = e < total;
  const long long row = live ? e / d4 : 0;
  const long long off = live ? row * (4LL * d4) + (e % d4) * 4 : 0;

  float wv[4], m[4], n[4], g[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    load4(w + off, wv);
    load4(mu + off, m);
    load4(nu + off, n);
    if (!kSparse) load4(grad + off, g);
  }

  bool touched = !kSparse;
  if (kSparse) {
    __shared__ int range[2];
    if (threadIdx.x < 2) {
      long long edge = threadIdx.x == 0 ? first : first + kThreads - 1;
      if (edge > total - 1) edge = total - 1;
      range[threadIdx.x] = lower_bound(uid, 0, U, row_offset + edge / d4 + threadIdx.x);
    }
    __syncthreads();
    if (live) {
      const long long key = row_offset + row;
      const int slot = lower_bound(uid, range[0], range[1], key);
      if (slot < range[1] && (long long)uid[slot] == key) {
        touched = true;
        load4(grad + (long long)slot * (4LL * d4) + (e % d4) * 4, g);
      }
    }
  }
  if (!live) return;
  const float ibc1 = step_block::as_float(step, step_block::kIbc1);
  const float ibc2 = step_block::as_float(step, step_block::kIbc2);
  const unsigned long long seed_mu = step_block::as_seed(step, step_block::kSeedMu);
  const unsigned long long seed_nu = step_block::as_seed(step, step_block::kSeedNu);

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (kSparse) {
      if (touched) {
        m[t] = __fadd_rn(m[t], __fmul_rn(hp.a1, g[t]));
        n[t] = __fadd_rn(n[t], __fmul_rn(hp.a2, __fmul_rn(g[t], g[t])));
      }
      m[t] = __fmul_rn(hp.b1, m[t]);
      n[t] = __fmul_rn(hp.b2, n[t]);
    } else {
      m[t] = __fadd_rn(__fmul_rn(hp.b1, m[t]), __fmul_rn(hp.a1, g[t]));
      n[t] = __fadd_rn(__fmul_rn(hp.b2, n[t]), __fmul_rn(hp.a2, __fmul_rn(g[t], g[t])));
    }
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(n[t], ibc2)), hp.eps);
    const float upd =
        __fadd_rn(__fdiv_rn(__fmul_rn(m[t], ibc1), den), __fmul_rn(hp.wd, wv[t]));
    wv[t] = __fsub_rn(wv[t], __fmul_rn(hp.lr, upd));
  }
  const unsigned long long idx = (unsigned long long)(row_offset + row) * (4ULL * d4) + (e % d4) * 4;
  store4(w + off, wv, 0, 0ULL, 0ULL);
  store4(mu + off, m, hp.sr_mu, seed_mu, idx);
  store4(nu + off, n, hp.sr_nu, seed_nu, idx);
}

template <bool kSparse>
int launch(void* w, void* mu, void* nu, const void* grad, const void* uid, const void* step, int U,
           long long rows, int D, long long row_offset, int mu_bf16, int nu_bf16, const Hyper& hp,
           void* stream) {
  const long long total = rows * (D / 4);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    auto* wp = static_cast<float*>(w);
    auto* gp = static_cast<const float*>(grad);
    auto* up = static_cast<const int*>(uid);
    auto* sp = static_cast<const long long*>(step);
    auto* mf = static_cast<float*>(mu);
    auto* nf = static_cast<float*>(nu);
    auto* mb = static_cast<__nv_bfloat16*>(mu);
    auto* nb = static_cast<__nv_bfloat16*>(nu);
    const unsigned grid = (unsigned)blocks;
    if (mu_bf16 && nu_bf16)
      adamw_kernel<__nv_bfloat16, __nv_bfloat16, kSparse>
          <<<grid, kThreads, 0, s>>>(wp, mb, nb, gp, up, sp, U, rows, D / 4, row_offset, hp);
    else if (mu_bf16)
      adamw_kernel<__nv_bfloat16, float, kSparse>
          <<<grid, kThreads, 0, s>>>(wp, mb, nf, gp, up, sp, U, rows, D / 4, row_offset, hp);
    else if (nu_bf16)
      adamw_kernel<float, __nv_bfloat16, kSparse>
          <<<grid, kThreads, 0, s>>>(wp, mf, nb, gp, up, sp, U, rows, D / 4, row_offset, hp);
    else
      adamw_kernel<float, float, kSparse>
          <<<grid, kThreads, 0, s>>>(wp, mf, nf, gp, up, sp, U, rows, D / 4, row_offset, hp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrappers: table [rows, D] f32 with D % 4 == 0,
// mu and nu [rows, D] f32 or bf16, uid [U] int32 ascending, summed [U, D] f32,
// all contiguous and 16-byte aligned; rows * D / 4 / 256 blocks must fit a grid.
// `step` is the device address of the step's row of the step block (int64
// fields, step_block.cuh) for both. Both return cudaGetLastError().
extern "C" int sparse_adamw(void* table, void* mu, void* nu, const void* uid, const void* summed,
                            const void* step, int U, long long rows, int D, long long row_offset,
                            int mu_bf16, int nu_bf16, int sr_mu, int sr_nu, float lr, float b1,
                            float b2, float eps, float wd, float c1, float c2, void* stream) {
  const Hyper hp = {lr, b1, b2, eps, wd, c1, c2, sr_mu, sr_nu};
  return launch<true>(table, mu, nu, summed, uid, step, U, rows, D, row_offset, mu_bf16, nu_bf16,
                      hp, stream);
}

extern "C" int embedding_adamw(void* w, void* mu, void* nu, const void* grad, const void* step,
                               long long rows, int D, long long row_offset, int mu_bf16,
                               int nu_bf16, int sr_mu, int sr_nu, float lr, float b1, float b2,
                               float eps, float wd, float omb1, float omb2, void* stream) {
  const Hyper hp = {lr, b1, b2, eps, wd, omb1, omb2, sr_mu, sr_nu};
  return launch<false>(w, mu, nu, grad, nullptr, step, 0, rows, D, row_offset, mu_bf16, nu_bf16,
                       hp, stream);
}
