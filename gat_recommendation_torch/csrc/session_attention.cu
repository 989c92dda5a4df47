// Session attention for Hopper (sm_90a): forward with attention dropout, and
// backward. Plain C interface for ctypes.
//
// Replaces the JAX package's Pallas kernel ops/pallas/session_attention.py::
// fused_session_attention (which has neither dropout nor a backward: the JAX
// package trains through XLA's plain attention). For each session b, head h
// and destination node i:
//     s_j   = (q_i . k_j) / sqrt(d)            where adj[b, i, j], else -1e30
//     m     = max_j s_j, set to 0 when m <= -5e29 (row with no in-edges)
//     e_j   = exp(s_j - m) * adj[b, i, j]
//     a_j   = e_j / max(sum_j e_j, 1e-16)
//     p_j   = keep(b, h, i, j) ? a_j / (1 - p_drop) : 0     (train mode only)
//     out_i = sum_j p_j * v_j
// so a destination with no in-edges outputs exact zeros. keep() is a pure
// function of (seed, b, h, i, j): bit 8.. of counter_hash(seed, linear index)
// below (1 - p_drop) * 2^24. No mask tensor is stored; the backward draws the
// same bits from the same seed.
//
// Backward, with dO the gradient of out:
//     dV_j  = sum_i p_ij dO_i
//     dA_ij = keep_ij ? (dO_i . v_j) / (1 - p_drop) : 0
//     dS_ij = a_ij (dA_ij - sum_j' a_ij' dA_ij')          (0 where masked)
//     dQ_i  = sum_j dS_ij k_j / sqrt(d),   dK_j = sum_i dS_ij q_i / sqrt(d)
// The forward saves nothing but its inputs: the backward recomputes the
// scores, the row max and the row sum.
//
// Layout: q, k, v, out and their gradients are [B, N, H*d] f32 contiguous;
// adj is [B, N, N] uint8 (a torch bool tensor's bytes), adj[b, dst, src].
//
// Forward design: one warp per (b, h, i). Lane l scores sources j = l and
// l + 32 (so N <= 64), reading q_i and k_j as float4; a warp-shuffle max and
// sum give the softmax; then lane l accumulates output columns l, l+32, l+64,
// l+96 (so d <= 128) over all j, reading p_j from the warp's 64 floats of
// shared memory. Warps of one block are consecutive i of the same (b, h), so
// K and V rows are reused out of L1.
//
// Backward design: one block of 512 threads per (b, h). dK and dV reduce over
// destinations, so the block stages the q, k, v and dO tiles (N x d each, row
// stride d + 4 floats so that float4 reads of neighbouring rows fall on
// different banks) and two N x N matrices in dynamic shared memory (144 KB
// at N = 56, d = 128; opted in above the 48 KB default) and needs no atomics:
// the result is deterministic. Pass 1: one thread per (i, j) edge computes
// s_ij and dO_i . v_j. Pass 2: one warp per row i does the softmax, the
// dropout and dS (shuffles only here, outside the long loops). Pass 3: one
// thread per (row, 4 columns) accumulates dV, dK and dQ over the other index.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at serving shapes (B=1,
// N<=56, H*d=256) the forward reads about 172 KB, 0.05 us of bytes, so launch
// and memory latency bound it, not bytes. At the train shape B=512, N=56 the
// forward must move 119 MB (about 36 us) and the backward 206 MB (about
// 61 us of bytes, and about as much of float32 operations when the adjacency
// is dense). Neither simple design reaches its bound: the forward's per-warp
// k_j row reads are strided, and the backward runs one block per SM on plain
// FMAs. chip_smoke.py measures both; PERF.md holds the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kKeepAll = 1u << 24;  // keep_threshold of "no dropout"
constexpr int kBwdThreads = 512;
constexpr int kTilePad = 4;  // floats of padding per staged row

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kDropout = false is the eval and serving path: it compiles to the kernel
// without any dropout code, so its registers and its time do not change.
template <bool kDropout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
session_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ adj,
                         float* __restrict__ out, int B, int N, int H, int d, float scale,
                         float keep_prob, uint32_t keep_threshold, unsigned long long seed) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)B * H * N) return;  // the whole warp leaves together
  const int i = (int)(warp % N);
  const int h = (int)((warp / N) % H);
  const long long b = warp / ((long long)N * H);
  const long long HD = (long long)H * d;

  const float4* q4 = reinterpret_cast<const float4*>(q + (b * N + i) * HD + h * d);
  const float* kb = k + b * N * HD + h * d;
  const float* vb = v + b * N * HD + h * d;
  const uint8_t* adj_row = adj + (b * N + i) * N;

  float s[2];
  bool on[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    on[t] = j < N && adj_row[j] != 0;
    s[t] = kNegInf;
    if (on[t]) {
      const float4* k4 = reinterpret_cast<const float4*>(kb + j * HD);
      float acc = 0.f;
      for (int c = 0; c < d / 4; ++c) {
        const float4 a = q4[c];
        const float4 w = k4[c];
        acc = fmaf(a.x, w.x, acc);
        acc = fmaf(a.y, w.y, acc);
        acc = fmaf(a.z, w.z, acc);
        acc = fmaf(a.w, w.w, acc);
      }
      s[t] = acc / scale;
    }
  }

  float m = warp_max(fmaxf(s[0], s[1]));
  if (m <= kNegInf / 2) m = 0.f;
  const float e0 = on[0] ? expf(s[0] - m) : 0.f;
  const float e1 = on[1] ? expf(s[1] - m) : 0.f;
  const float denom = fmaxf(warp_sum(e0 + e1), 1e-16f);
  // The weights go through shared memory, not a shuffle per j: a loop that
  // holds a shuffle is not unrolled (nvcc keeps convergent operations out of
  // a remainder loop), so each j would wait on its own v_j loads.
  __shared__ float alpha_all[kWarpsPerBlock][64];
  float* alpha = alpha_all[threadIdx.x >> 5];
  float a0 = e0 / denom;
  float a1 = e1 / denom;
  if (kDropout) {
    const unsigned long long row = ((unsigned long long)(b * H + h) * N + i) * N;
    a0 = (counter_hash(seed, row + lane) >> 8) < keep_threshold ? a0 / keep_prob : 0.f;
    a1 = (counter_hash(seed, row + lane + 32) >> 8) < keep_threshold ? a1 / keep_prob : 0.f;
  }
  alpha[lane] = a0;
  alpha[lane + 32] = a1;
  __syncwarp();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < N; ++j) {
    const float a = alpha[j];
    const float* vj = vb + j * HD;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = lane + 32 * t;
      if (c < d) acc[t] = fmaf(a, vj[c], acc[t]);
    }
  }
  float* out_row = out + (b * N + i) * HD + h * d;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = lane + 32 * t;
    if (c < d) out_row[c] = acc[t];
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  acc = fmaf(a.w, w.w, acc);
  return acc;
}

__global__ void __launch_bounds__(kBwdThreads)
session_attention_backward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const uint8_t* __restrict__ adj,
                                  const float* __restrict__ dout, float* __restrict__ dq,
                                  float* __restrict__ dk, float* __restrict__ dv, int B, int N,
                                  int H, int d, float scale, float keep_prob,
                                  uint32_t keep_threshold, unsigned long long seed) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kTilePad;  // row stride of the staged tiles
  const int ln = N + 1;         // row stride of the N x N matrices
  float* sq = smem;
  float* sk = sq + N * ld;
  float* sv = sk + N * ld;
  float* sdo = sv + N * ld;
  float* sp = sdo + N * ld;  // scores s_ij, then dropped-out weights p_ij
  float* sg = sp + N * ln;   // dO_i . v_j, then dS_ij / sqrt(d)

  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const long long HD = (long long)H * d;
  const long long base = b * N * HD + (long long)h * d;
  const int d4 = d / 4;
  const uint8_t* adj_b = adj + b * N * N;

  for (int t = threadIdx.x; t < N * d4; t += kBwdThreads) {
    const int r = t / d4, c = (t % d4) * 4;
    const long long g = base + r * HD + c;
    *reinterpret_cast<float4*>(sq + r * ld + c) = *reinterpret_cast<const float4*>(q + g);
    *reinterpret_cast<float4*>(sk + r * ld + c) = *reinterpret_cast<const float4*>(k + g);
    *reinterpret_cast<float4*>(sv + r * ld + c) = *reinterpret_cast<const float4*>(v + g);
    *reinterpret_cast<float4*>(sdo + r * ld + c) = *reinterpret_cast<const float4*>(dout + g);
  }
  __syncthreads();

  // Pass 1: scores and dO . v over the edges present.
  for (int p = threadIdx.x; p < N * N; p += kBwdThreads) {
    const int i = p / N, j = p % N;
    float s = kNegInf, dp = 0.f;
    if (adj_b[p] != 0) {
      const float4* qi = reinterpret_cast<const float4*>(sq + i * ld);
      const float4* kj = reinterpret_cast<const float4*>(sk + j * ld);
      const float4* oi = reinterpret_cast<const float4*>(sdo + i * ld);
      const float4* vj = reinterpret_cast<const float4*>(sv + j * ld);
      float acc = 0.f;
      for (int c = 0; c < d4; ++c) {
        acc = dot4(qi[c], kj[c], acc);
        dp = dot4(oi[c], vj[c], dp);
      }
      s = acc / scale;
    }
    sp[i * ln + j] = s;
    sg[i * ln + j] = dp;
  }
  __syncthreads();

  // Pass 2: one warp per destination row: softmax, dropout, dS.
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < N; i += kBwdThreads / 32) {
    float s[2], g[2];
    bool on[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      on[t] = j < N && adj_b[i * N + j] != 0;
      s[t] = on[t] ? sp[i * ln + j] : kNegInf;
      g[t] = on[t] ? sg[i * ln + j] : 0.f;
    }
    float m = warp_max(fmaxf(s[0], s[1]));
    if (m <= kNegInf / 2) m = 0.f;
    const float e0 = on[0] ? expf(s[0] - m) : 0.f;
    const float e1 = on[1] ? expf(s[1] - m) : 0.f;
    const float denom = fmaxf(warp_sum(e0 + e1), 1e-16f);
    const float a[2] = {e0 / denom, e1 / denom};
    float pw[2] = {a[0], a[1]};
    if (keep_threshold < kKeepAll) {
      const unsigned long long row = ((unsigned long long)(b * H + h) * N + i) * N;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool keep = (counter_hash(seed, row + lane + 32 * t) >> 8) < keep_threshold;
        pw[t] = keep ? a[t] / keep_prob : 0.f;
        g[t] = keep ? g[t] / keep_prob : 0.f;  // dA_ij
      }
    }
    const float rowsum = warp_sum(a[0] * g[0] + a[1] * g[1]);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        sp[i * ln + j] = pw[t];
        sg[i * ln + j] = a[t] * (g[t] - rowsum) / scale;
      }
    }
  }
  __syncthreads();

  // Pass 3: dV_r = sum_x p_xr dO_x, dK_r = sum_x dS_xr q_x, dQ_r = sum_x dS_rx k_x.
  for (int t = threadIdx.x; t < N * d4; t += kBwdThreads) {
    const int r = t / d4, c = (t % d4) * 4;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), ak = av, aq = av;
    for (int x = 0; x < N; ++x) {
      fma4(av, sp[x * ln + r], *reinterpret_cast<const float4*>(sdo + x * ld + c));
      fma4(ak, sg[x * ln + r], *reinterpret_cast<const float4*>(sq + x * ld + c));
      fma4(aq, sg[r * ln + x], *reinterpret_cast<const float4*>(sk + x * ld + c));
    }
    const long long g = base + r * HD + c;
    *reinterpret_cast<float4*>(dv + g) = av;
    *reinterpret_cast<float4*>(dk + g) = ak;
    *reinterpret_cast<float4*>(dq + g) = aq;
  }
}

size_t backward_smem_bytes(int N, int d) {
  return sizeof(float) * (4 * (size_t)N * (d + kTilePad) + 2 * (size_t)N * (N + 1));
}

}  // namespace

// Shapes are checked by the Python wrapper: 1 <= N <= 64, d % 4 == 0,
// 4 <= d <= 128, 16-byte aligned contiguous tensors. keep_threshold is
// (1 - p_drop) * 2^24 rounded, 2^24 for no dropout; keep_prob is 1 - p_drop.
// Returns cudaGetLastError().
extern "C" int session_attention_forward(const void* q, const void* k, const void* v,
                                         const void* adj, void* out, int B, int N, int H,
                                         int d, float scale, float keep_prob,
                                         unsigned int keep_threshold, unsigned long long seed,
                                         void* stream) {
  const long long warps = (long long)B * H * N;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    auto* kernel = keep_threshold < kKeepAll ? session_attention_kernel<true>
                                             : session_attention_kernel<false>;
    kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(adj),
        static_cast<float*>(out), B, N, H, d, scale, keep_prob, keep_threshold, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int session_attention_backward(const void* q, const void* k, const void* v,
                                          const void* adj, const void* dout, void* dq, void* dk,
                                          void* dv, int B, int N, int H, int d, float scale,
                                          float keep_prob, unsigned int keep_threshold,
                                          unsigned long long seed, void* stream) {
  static bool opted_in = false;  // the largest tile set the wrapper admits: N = 64, d = 128
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        session_attention_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)backward_smem_bytes(64, 128));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const long long blocks = (long long)B * H;
  if (blocks > 0) {
    session_attention_backward_kernel<<<(unsigned)blocks, kBwdThreads, backward_smem_bytes(N, d),
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(adj),
        static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), B, N, H, d, scale, keep_prob, keep_threshold, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
