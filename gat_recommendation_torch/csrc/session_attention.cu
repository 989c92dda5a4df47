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
// Two forward kernels; session_attention_forward chooses by B * H
// (kStagedMinPairs below). Both do the same float32 operations per output in
// the same order (one fmaf chain over d per score, one over j per output).
//
// Forward, few sessions (serving): one warp per (b, h, i). Lane l scores
// sources j = l and l + 32 (so N <= 64), reading q_i and k_j as float4; a
// warp-shuffle max and sum give the softmax; then lane l accumulates output
// columns l, l+32, l+64, l+96 (so d <= 128) over all j, reading p_j from the
// warp's 64 floats of shared memory. With B * H * N warps it fills the card
// from the smallest batch on, but every warp re-reads all of K and V, and a
// lane's k_j rows are 512 bytes apart, so it is far from its bytes at a
// training batch.
//
// Forward, many sessions (training, evaluation): one block per (b, h), K and
// V staged once. Coalesced 16-byte cp.async brings the Q and K tiles (N x d,
// row stride d + 4 floats: float4 reads of consecutive rows fall on different
// bank groups) and the N x N adjacency bytes into dynamic shared memory.
// Pass 1: a thread owns an R x R tile of scores (R = 4, or 2 for N <= 16),
// destinations ti + T a and sources tj + T c with ti fastest across the warp,
// so K reads broadcast, Q reads and the stores of the transposed score matrix
// sp[j][i] are conflict-free; a tile without any edge is skipped. When pass 1
// is done the V tile is copied over Q's (Q is dead), hidden behind pass 2: a
// warp per destination, two destinations in flight, does the softmax and the
// dropout in place on its column of sp (shuffles only here), with one
// division a row and products after it: e / sum with a tiny e takes the
// division's slow path lane by lane, and made this pass a quarter of the
// kernel. Pass 3: a thread owns 8 destinations x 4 columns, and per source
// reads 8 weights as two float4 (a broadcast) and one float4 of V for 32
// FMAs; float4 stores, a warp writes whole 512-byte rows. Two tiles, the
// weights and the adjacency are 75.7 KB at N = 56, d = 128, and the kernel
// is held to 80 registers, so three blocks share an SM (89 KB and two blocks
// at N = 64).
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
// forward must move 119 MB (about 36 us; its 1.6 GFLOP at full density are
// 25 us) and the backward 206 MB (about 61 us of bytes, and about as much of
// float32 operations when the adjacency is dense). The staged forward reads
// each byte once, and with three blocks an SM the reads hide behind the other
// blocks' passes: without its loads and stores the kernel takes 0.9 of its
// time, without its FMA passes 0.6. What keeps it above the bound is the
// passes themselves, at about a third of the FMA rate: 4 x 4 and 8 x 4
// register tiles give 8 to 11 FMAs per LDS.128, and larger tiles leave too
// few warps (four a block) to hide the shared-memory latency, which measured
// slower. A grid of resident blocks with the next (b, h) prefetched into a
// second buffer (by every thread's cp.async, or by one loading warp with
// mbarriers and the copy engine) was slower too: one block an SM computes
// more slowly than three. The backward runs one block per SM on plain FMAs.
// chip_smoke.py measures all of them; PERF.md holds the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "counter_hash.cuh"
#include "cp_async.cuh"

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

// ---- the staged forward: one block per (b, h) ----

constexpr int kStagedMinPairs = 64;  // B * H from here up takes the staged kernel; set from chip_smoke.py's crossover table
constexpr int kStagedMaxThreads = 256;
constexpr int kStagedMinBlocks = 3;  // blocks per SM the register budget leaves room for

__host__ __device__ inline int staged_weights_ld(int N) { return (N + 7) / 8 * 8 + 4; }

// R x R scores per thread; kDropout as in the kernel above.
template <bool kDropout, int R>
__global__ void __launch_bounds__(kStagedMaxThreads, kStagedMinBlocks)
session_attention_staged_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const uint8_t* __restrict__ adj,
                                float* __restrict__ out, int B, int N, int H, int d, float scale,
                                float keep_prob, uint32_t keep_threshold,
                                unsigned long long seed) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kTilePad;          // row stride of the staged tiles
  const int ldp = staged_weights_ld(N);  // row stride of sp, the weights as [source][destination]
  float* sq = smem;  // Q, and after pass 1 V
  float* sk = sq + N * ld;
  float* sp = sk + N * ld;
  uint8_t* sadj = reinterpret_cast<uint8_t*>(sp + N * ldp);

  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const long long HD = (long long)H * d;
  const long long base = b * N * HD + (long long)h * d;
  const int d4 = d / 4;
  const uint8_t* adj_b = adj + b * N * N;

  for (int t = threadIdx.x; t < N * d4; t += blockDim.x) {
    const int r = t / d4, c = (t % d4) * 4;
    cp_async16(sq + r * ld + c, q + base + r * HD + c);
    cp_async16(sk + r * ld + c, k + base + r * HD + c);
  }
  // The adjacency rides along: 16-byte pieces where N * N and its address
  // allow, else byte by byte (visible after the barrier below either way).
  if ((N * N) % 16 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0) {
    for (int t = threadIdx.x * 16; t < N * N; t += blockDim.x * 16) cp_async16(sadj + t, adj_b + t);
  } else {
    for (int t = threadIdx.x; t < N * N; t += blockDim.x) sadj[t] = adj_b[t];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Pass 1: scores over the edges present, into sp[j][i].
  const int T = (N + R - 1) / R;
  for (int t = threadIdx.x; t < T * T; t += blockDim.x) {
    const int ti = t % T, tj = t / T;
    uint32_t on = 0;  // bit a * R + c: edge (ti + T a) <- (tj + T c) is present
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = ti + T * a, j = tj + T * c;
        if (i < N && j < N && sadj[i * N + j] != 0) on |= 1u << (a * R + c);
      }
    }
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) acc[a][c] = 0.f;
    }
    if (on != 0) {
      // Rows past N are clamped to a real row; their sums are not stored.
      const float4* qrow[R];
      const float4* krow[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        qrow[a] = reinterpret_cast<const float4*>(sq + min(ti + T * a, N - 1) * ld);
        krow[a] = reinterpret_cast<const float4*>(sk + min(tj + T * a, N - 1) * ld);
      }
      for (int c4 = 0; c4 < d4; ++c4) {
        float4 qa[R], kb[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          qa[a] = qrow[a][c4];
          kb[a] = krow[a][c4];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int c = 0; c < R; ++c) acc[a][c] = dot4(qa[a], kb[c], acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = ti + T * a, j = tj + T * c;
        if (i < N && j < N) sp[j * ldp + i] = (on >> (a * R + c)) & 1u ? acc[a][c] / scale : kNegInf;
      }
    }
  }
  __syncthreads();  // Q is dead: V takes its place while pass 2 runs

  for (int t = threadIdx.x; t < N * d4; t += blockDim.x) {
    const int r = t / d4, c = (t % d4) * 4;
    cp_async16(sq + r * ld + c, v + base + r * HD + c);
  }
  cp_async_commit();

  // Pass 2: a warp per destination, two destinations in flight: softmax and
  // dropout in place on column i of sp (the only shuffles of the kernel).
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float inv_keep = 1.f / keep_prob;
  for (int i0 = threadIdx.x >> 5; i0 < N; i0 += 2 * n_warps) {
    float a[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = min(i0 + u * n_warps, N - 1);  // a second row past N repeats the last one
      float s[2];
      bool on[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        on[t] = j < N && sadj[i * N + j] != 0;
        s[t] = on[t] ? sp[j * ldp + i] : kNegInf;
      }
      float m = warp_max(fmaxf(s[0], s[1]));
      if (m <= kNegInf / 2) m = 0.f;
      const float e0 = on[0] ? expf(s[0] - m) : 0.f;
      const float e1 = on[1] ? expf(s[1] - m) : 0.f;
      // One division a row, then products: e / denom with a tiny e takes the
      // division's slow path lane by lane, which made this pass the longest.
      const float inv = 1.f / fmaxf(warp_sum(e0 + e1), 1e-16f);
      a[u][0] = e0 * inv;
      a[u][1] = e1 * inv;
      if (kDropout) {
        const unsigned long long row = ((unsigned long long)(b * H + h) * N + i) * N;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bool keep = (counter_hash(seed, row + lane + 32 * t) >> 8) < keep_threshold;
          a[u][t] = keep ? a[u][t] * inv_keep : 0.f;
        }
      }
    }
    __syncwarp();  // the repeated last row is read before its owner writes it
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * n_warps;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (i < N && j < N) sp[j * ldp + i] = a[u][t];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Pass 3: out_i = sum_j p_ij v_j for 8 destinations x 4 columns per thread.
  // Destinations past N read unwritten weights; their sums are not stored.
  const float* sv = sq;
  const int groups = (N + 7) / 8;
  for (int t = threadIdx.x; t < groups * d4; t += blockDim.x) {
    const int c = (t % d4) * 4, i0 = (t / d4) * 8;
    float4 acc[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < N; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(sp + j * ldp + i0);
      const float4 p1 = *reinterpret_cast<const float4*>(sp + j * ldp + i0 + 4);
      const float4 vj = *reinterpret_cast<const float4*>(sv + j * ld + c);
      fma4(acc[0], p0.x, vj);
      fma4(acc[1], p0.y, vj);
      fma4(acc[2], p0.z, vj);
      fma4(acc[3], p0.w, vj);
      fma4(acc[4], p1.x, vj);
      fma4(acc[5], p1.y, vj);
      fma4(acc[6], p1.z, vj);
      fma4(acc[7], p1.w, vj);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (i0 + a < N) *reinterpret_cast<float4*>(out + base + (i0 + a) * HD + c) = acc[a];
    }
  }
}

size_t staged_smem_bytes(int N, int d) {
  return sizeof(float) * (2 * (size_t)N * (d + kTilePad) + (size_t)N * staged_weights_ld(N)) +
         ((size_t)N * N + 15) / 16 * 16;
}

template <bool kDropout, int R>
int launch_staged(const float* q, const float* k, const float* v, const uint8_t* adj, float* out,
                  int B, int N, int H, int d, float scale, float keep_prob,
                  uint32_t keep_threshold, unsigned long long seed, cudaStream_t stream) {
  static bool opted_in = false;  // the largest tile set the wrapper admits: N = 64, d = 128
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        session_attention_staged_kernel<kDropout, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)staged_smem_bytes(64, 128));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // As many threads as the wider of pass 1 (R x R score tiles) and pass 3
  // (8 x 4 output tiles) has work items, in whole warps.
  const int T = (N + R - 1) / R;
  const int items = std::max(T * T, (N + 7) / 8 * (d / 4));
  const int threads = std::min(kStagedMaxThreads, std::max(64, (items + 31) / 32 * 32));
  session_attention_staged_kernel<kDropout, R><<<(unsigned)(B * H), threads, staged_smem_bytes(N, d), stream>>>(
      q, k, v, adj, out, B, N, H, d, scale, keep_prob, keep_threshold, seed);
  return 0;
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
// `staged` names the forward kernel: nonzero one block per (b, h), zero one
// warp per (b, h, i). Returns a cudaError_t.
extern "C" int session_attention_forward_variant(const void* q, const void* k, const void* v,
                                                 const void* adj, void* out, int B, int N, int H,
                                                 int d, float scale, float keep_prob,
                                                 unsigned int keep_threshold,
                                                 unsigned long long seed, int staged,
                                                 void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* adjb = static_cast<const uint8_t*>(adj);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dropout = keep_threshold < kKeepAll;
  const long long warps = (long long)B * H * N;
  if (warps == 0) return 0;
  if (staged) {
    auto* launch = dropout ? (N <= 16 ? launch_staged<true, 2> : launch_staged<true, 4>)
                           : (N <= 16 ? launch_staged<false, 2> : launch_staged<false, 4>);
    const int err = launch(qf, kf, vf, adjb, outf, B, N, H, d, scale, keep_prob, keep_threshold, seed, s);
    if (err != 0) return err;
  } else {
    const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    auto* kernel = dropout ? session_attention_kernel<true> : session_attention_kernel<false>;
    kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        qf, kf, vf, adjb, outf, B, N, H, d, scale, keep_prob, keep_threshold, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// The port's entry point: the staged kernel from kStagedMinPairs (b, h) pairs up.
extern "C" int session_attention_forward(const void* q, const void* k, const void* v,
                                         const void* adj, void* out, int B, int N, int H,
                                         int d, float scale, float keep_prob,
                                         unsigned int keep_threshold, unsigned long long seed,
                                         void* stream) {
  return session_attention_forward_variant(q, k, v, adj, out, B, N, H, d, scale, keep_prob,
                                           keep_threshold, seed,
                                           (long long)B * H >= kStagedMinPairs, stream);
}

extern "C" int session_attention_staged_min_pairs() { return kStagedMinPairs; }

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
