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
// same bits from the same seed. The seed is read from device memory (the
// layer's field of the step's row of the step block, ops/step_block.py), so
// that a CUDA graph of the train step replays each step with its own seed; the
// kernels without dropout never read it.
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
// Two forward kernels; session_attention_forward chooses by the blocks the
// first would need (kStagedMinRowBlocks below). One fmaf chain over j per
// output in both; a score is one fmaf chain over d in the staged kernel and
// the sum of two (even and odd float4 of d) in the row kernel.
//
// Forward, few sessions (serving): one warp per (b, h, i), four destinations
// of one (b, h) to a block, so that a single session still spreads over
// B * H * N / 4 SMs. The block brings its Q rows and K, then V, into shared
// memory with coalesced 16-byte cp.async in two groups (57 KB at N = 56,
// d = 128), and scores while V is on its way. Lane l scores sources l and
// l + 32 (so N <= 64) from the staged K row (row stride d + 4 floats: the 32
// lanes' float4 reads take the four wavefronts their 512 bytes need) against
// a broadcast of q_i; a warp-shuffle max and sum give the softmax, with one
// reciprocal a row; then lane l owns output columns 4 l .. 4 l + 3 (so
// d <= 128) and reads one float4 of V per source, the weight from the warp's
// 64 floats of shared memory. The bytes bound says nothing at B = 1 (0.07 us):
// an empty kernel of the same grid takes 1.2-1.4 us, and the kernel's own
// 4.5 us at N = 56 are one round trip for the tiles, the score loop at the
// shared-memory rate of one SM (four warps x 64 LDS.128 x 4 wavefronts) and
// 56 dependent steps over V. Measured slower at B = 1: eight or sixteen rows
// a block (more LDS on one SM), two or one (too few threads to start the
// copies), two destinations a warp (half the LDS, but twice the instructions
// of a warp that runs alone on its scheduler).
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
// Backward: one block per (b, h), no atomics (dK and dV reduce over
// destinations inside the block), so two runs give equal bits. Not all four
// tiles are live at once, so the block holds two tile buffers and two N x N
// matrices sp, sg ([destination][source], row stride as the forward's
// weights), 89 KB at N = 56, d = 128 and 107 KB at N = 64: two blocks an SM,
// where one block with four tiles (144 KB) took 2.5 times as long. The
// buffers are refilled with cp.async as their tiles die:
//   load q, k and the adjacency
//   1  s_ij = q_i . k_j / sqrt(d) over the edges            (q, k -> sp)
//   load dO, v over q, k, behind pass 2
//   2  row softmax and dropout: p -> sp, a -> sg; which destinations have an
//      in-edge and which sources an out-edge (ballots) -> two 64-bit masks
//   3  dV_j = sum_i p_ij dO_i                                (sp, dO)
//   4  dA_ij = (dO_i . v_j) / keep_prob where p_ij != 0     (dO, v -> sp)
//   load q, k again over dO, v, behind pass 5
//   5  dS_ij / sqrt(d) = a_ij (dA_ij - sum_j' a_ij' dA_ij') / sqrt(d) -> sg
//   6  dK_j = sum_i dS_ij q_i, dQ_i = sum_j dS_ij k_j        (sg, q, k)
// Passes 1 and 4 are the staged forward's register tiles (R x R dots a
// thread, R = 4 or 2 for N <= 16, empty tiles skipped, one fmaf chain over d
// ascending per dot), with sources fastest across the warp because sp is
// [destination][source] here. Passes 2 and 5 are a warp per row, two rows in
// flight, one reciprocal a row and 1 / keep_prob, 1 / sqrt(d) as products.
// Passes 3 and 6 give a thread 8 outputs x 4 columns: dV and dK read two
// float4 of weights and one of the tile for 32 FMAs per reduced row, dQ reads
// its weights along the row, eight float4 and four of the tile for 128 FMAs;
// each output is one fmaf chain over the reduced index, ascending. A session
// whose edges reach fewer than half of its nodes walks only the rows (groups
// of four columns) that the masks name; a zero term leaves an fmaf chain as
// it was, so the bits do not depend on the path. Destinations without
// in-edges have a = 0 throughout, so their dq is an exact zero.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the train shape B=512,
// N=56 the forward must move 119 MB (about 36 us; its 1.6 GFLOP at full
// density are 25 us) and the backward 206 MB (about 61 us of bytes, and about
// as much of float32 operations when the adjacency is dense); the backward
// reads q and k twice, 265 MB, the second time mostly from L2. The staged
// forward reads each byte once, and with three blocks an SM the reads hide
// behind the other blocks' passes: without its loads and stores the kernel
// takes 0.9 of its time, without its FMA passes 0.6. What keeps both above
// their bounds is the passes themselves, at about a third of the FMA rate:
// 4 x 4 and 8 x 4 register tiles give 8 to 11 FMAs per LDS.128, which keeps
// the shared-memory pipe nearly as busy as the FMA pipe, and larger tiles
// leave too few warps (four a block) to hide the shared-memory latency, which
// measured slower. The backward at density 0.3 takes 0.92 of its time without
// its loads and stores, 0.77 without the dots, 0.68 without the reducing
// passes, 0.93 without the row passes, and 1.3 times as long with one block
// an SM. A grid of resident blocks with the next (b, h) prefetched into a
// second buffer (by every thread's cp.async, or by one loading warp with
// mbarriers and the copy engine) was slower for the forward: one block an SM
// computes more slowly than three. chip_smoke.py measures all of them;
// scripts/gpu/kernel_variants.py times the parts; PERF.md holds the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "counter_hash.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kKeepAll = 1u << 24;  // keep_threshold of "no dropout"
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

// Rows [0, n_rows) of one head's [*, d] slice of two [*, H*d] tensors into
// two shared-memory tiles of row stride ld, as 16-byte cp.async by the whole
// block.
__device__ __forceinline__ void stage_two_tiles(float* dst_a, const float* src_a, float* dst_b,
                                                const float* src_b, int n_rows, int d4, int ld,
                                                long long HD) {
  for (int t = threadIdx.x; t < n_rows * d4; t += blockDim.x) {
    const int r = t / d4, c = (t % d4) * 4;
    cp_async16(dst_a + r * ld + c, src_a + r * HD + c);
    cp_async16(dst_b + r * ld + c, src_b + r * HD + c);
  }
}

__device__ __forceinline__ void stage_tile(float* dst, const float* src, int n_rows, int d4, int ld,
                                           long long HD) {
  for (int t = threadIdx.x; t < n_rows * d4; t += blockDim.x) {
    const int r = t / d4, c = (t % d4) * 4;
    cp_async16(dst + r * ld + c, src + r * HD + c);
  }
}

// ---- the row forward: one warp per destination, K and V staged per block ----

constexpr int kRowWarps = 4;  // destinations of one (b, h) that share a block's K and V tiles

__host__ __device__ inline int row_groups(int N) { return (N + kRowWarps - 1) / kRowWarps; }

// kDropout = false is the eval and serving path: it compiles to the kernel
// without any dropout code, so its registers and its time do not change.
template <bool kDropout>
__global__ void __launch_bounds__(kRowWarps * 32)
session_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ adj,
                         float* __restrict__ out, int B, int N, int H, int d, float scale,
                         float keep_prob, uint32_t keep_threshold,
                         const unsigned long long* __restrict__ seed_p) {
  extern __shared__ __align__(16) float smem[];
  const unsigned long long seed = kDropout ? *seed_p : 0ULL;  // the step's seed, from device memory
  const int ld = d + kTilePad;
  float* sk = smem;
  float* sv = sk + N * ld;
  float* sq = sv + N * ld;               // the block's kRowWarps rows of Q
  float* alpha_all = sq + kRowWarps * ld;  // 64 weights per warp

  const int groups = row_groups(N);
  const int i0 = (blockIdx.x % groups) * kRowWarps;
  const int h = (blockIdx.x / groups) % H;
  const long long b = blockIdx.x / (groups * H);
  const long long HD = (long long)H * d;
  const long long base = b * N * HD + (long long)h * d;
  const int d4 = d / 4;

  // Two copy groups: Q rows and K first, V behind them, so that the scores
  // and the softmax run while V is still on its way.
  stage_tile(sq, q + base + i0 * HD, min(kRowWarps, N - i0), d4, ld, HD);
  stage_tile(sk, k + base, N, d4, ld, HD);
  cp_async_commit();
  stage_tile(sv, v + base, N, d4, ld, HD);
  cp_async_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = i0 + warp;
  const bool active = i < N;  // the whole warp together
  bool on[2] = {false, false};
  if (active) {
    const uint8_t* adj_row = adj + (b * N + i) * N;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      on[t] = j < N && adj_row[j] != 0;
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  float* alpha = alpha_all + warp * 64;
  if (active) {
    // Lane l scores sources l and l + 32 (rows past N are clamped to a real
    // row and masked), two sums a score over the even and the odd float4 of d.
    const float4* q4 = reinterpret_cast<const float4*>(sq + warp * ld);
    const float4* k0 = reinterpret_cast<const float4*>(sk + min(lane, N - 1) * ld);
    const float4* k1 = reinterpret_cast<const float4*>(sk + min(lane + 32, N - 1) * ld);
    float even[2] = {0.f, 0.f}, odd[2] = {0.f, 0.f};
    if (N > 32) {
      int c = 0;
      for (; c + 1 < d4; c += 2) {
        const float4 a = q4[c], a2 = q4[c + 1];
        even[0] = dot4(a, k0[c], even[0]);
        even[1] = dot4(a, k1[c], even[1]);
        odd[0] = dot4(a2, k0[c + 1], odd[0]);
        odd[1] = dot4(a2, k1[c + 1], odd[1]);
      }
      if (c < d4) {
        even[0] = dot4(q4[c], k0[c], even[0]);
        even[1] = dot4(q4[c], k1[c], even[1]);
      }
    } else {
      int c = 0;
      for (; c + 1 < d4; c += 2) {
        even[0] = dot4(q4[c], k0[c], even[0]);
        odd[0] = dot4(q4[c + 1], k0[c + 1], odd[0]);
      }
      if (c < d4) even[0] = dot4(q4[c], k0[c], even[0]);
    }
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) s[t] = on[t] ? (even[t] + odd[t]) / scale : kNegInf;

    float m = warp_max(fmaxf(s[0], s[1]));
    if (m <= kNegInf / 2) m = 0.f;
    const float e0 = on[0] ? expf(s[0] - m) : 0.f;
    const float e1 = on[1] ? expf(s[1] - m) : 0.f;
    // One division a row, then products (see the staged kernel's pass 2).
    const float inv = 1.f / fmaxf(warp_sum(e0 + e1), 1e-16f);
    float a0 = e0 * inv;
    float a1 = e1 * inv;
    if (kDropout) {
      const float inv_keep = 1.f / keep_prob;
      const unsigned long long row = ((unsigned long long)(b * H + h) * N + i) * N;
      a0 = (counter_hash(seed, row + lane) >> 8) < keep_threshold ? a0 * inv_keep : 0.f;
      a1 = (counter_hash(seed, row + lane + 32) >> 8) < keep_threshold ? a1 * inv_keep : 0.f;
    }
    alpha[lane] = a0;
    alpha[lane + 32] = a1;
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed; every warp's weights are written

  // Lane l owns output columns 4 l .. 4 l + 3: one float4 of V per source.
  if (active && 4 * lane < d) {
    const float* vcol = sv + 4 * lane;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < N; ++j) fma4(o, alpha[j], *reinterpret_cast<const float4*>(vcol + j * ld));
    *reinterpret_cast<float4*>(out + base + i * HD + 4 * lane) = o;
  }
}

size_t row_smem_bytes(int N, int d) {
  return sizeof(float) * ((2 * (size_t)N + kRowWarps) * (d + kTilePad) + kRowWarps * 64);
}

// The launch floor of the row kernel: nothing but its grid, block and shared memory.
__global__ void __launch_bounds__(kRowWarps * 32) empty_kernel() {}

// ---- the staged forward: one block per (b, h) ----

// The wrapper's choice: the staged kernel once the row kernel would need this
// many blocks (B * H * ceil(N / kRowWarps)), set from chip_smoke.py's crossover
// table. The row kernel's time is level while its blocks fit the card at once
// and grows with them after; above 32 nodes its two tiles leave room for three
// blocks an SM (396 at once), below for six and more. The staged kernel
// starts higher (a whole (b, h) on one SM) and stays level up to a full wave.
constexpr int kStagedMinRowBlocks = 1024;     // N <= 32
constexpr int kStagedMinRowBlocksWide = 448;  // N > 32
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
                                const unsigned long long* __restrict__ seed_p) {
  extern __shared__ __align__(16) float smem[];
  const unsigned long long seed = kDropout ? *seed_p : 0ULL;  // the step's seed, from device memory
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

  stage_two_tiles(sq, q + base, sk, k + base, N, d4, ld, HD);
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

  stage_tile(sq, v + base, N, d4, ld, HD);
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

// Threads of a block per (b, h), forward and backward: as many as the wider of
// the dot passes (R x R tiles) and the reducing passes (8 x 4 output tiles)
// has work items, in whole warps.
int staged_threads(int N, int d, int R) {
  const int T = (N + R - 1) / R;
  const int items = std::max(T * T, (N + 7) / 8 * (d / 4));
  return std::min(kStagedMaxThreads, std::max(64, (items + 31) / 32 * 32));
}

size_t staged_smem_bytes(int N, int d) {
  return sizeof(float) * (2 * (size_t)N * (d + kTilePad) + (size_t)N * staged_weights_ld(N)) +
         ((size_t)N * N + 15) / 16 * 16;
}

template <bool kDropout, int R>
int launch_staged(const float* q, const float* k, const float* v, const uint8_t* adj, float* out,
                  int B, int N, int H, int d, float scale, float keep_prob,
                  uint32_t keep_threshold, const unsigned long long* seed, cudaStream_t stream) {
  static bool opted_in = false;  // the largest tile set the wrapper admits: N = 64, d = 128
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        session_attention_staged_kernel<kDropout, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)staged_smem_bytes(64, 128));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  session_attention_staged_kernel<kDropout, R><<<(unsigned)(B * H), staged_threads(N, d, R), staged_smem_bytes(N, d), stream>>>(
      q, k, v, adj, out, B, N, H, d, scale, keep_prob, keep_threshold, seed);
  return 0;
}

// ---- the backward: one block per (b, h), two tile buffers ----

constexpr int kBwdMinBlocks = 2;  // blocks per SM: 89 KB of shared memory at N = 56, 104 KB at N = 64

// out[i][j] = value(x_i . y_j, on(i, j)) for all i, j < N: a thread owns an
// R x R tile, rows ti + T a of x and tj + T c of y with tj fastest across the
// warp (y reads and the stores are conflict-free, x reads broadcast), and
// skips the dots of a tile where on() is false throughout. One fmaf chain
// over d per dot, in ascending order.
template <int R, typename On, typename Value>
__device__ __forceinline__ void tile_dots(const float* x, const float* y, float* out, int N, int ld,
                                          int ldp, int d4, On on_fn, Value value_fn) {
  const int T = (N + R - 1) / R;
  for (int t = threadIdx.x; t < T * T; t += blockDim.x) {
    const int tj = t % T, ti = t / T;
    uint32_t on = 0;  // bit a * R + c: entry (ti + T a, tj + T c) is wanted
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = ti + T * a, j = tj + T * c;
        if (i < N && j < N && on_fn(i, j)) on |= 1u << (a * R + c);
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
      const float4* xrow[R];
      const float4* yrow[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        xrow[a] = reinterpret_cast<const float4*>(x + min(ti + T * a, N - 1) * ld);
        yrow[a] = reinterpret_cast<const float4*>(y + min(tj + T * a, N - 1) * ld);
      }
      for (int c4 = 0; c4 < d4; ++c4) {
        float4 xa[R], yb[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          xa[a] = xrow[a][c4];
          yb[a] = yrow[a][c4];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int c = 0; c < R; ++c) acc[a][c] = dot4(xa[a], yb[c], acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = ti + T * a, j = tj + T * c;
        if (i < N && j < N) out[i * ldp + j] = value_fn(acc[a][c], ((on >> (a * R + c)) & 1u) != 0);
      }
    }
  }
}

// dst_j = sum_x w[x][j] rows_x for 8 outputs j x 4 columns per thread, x
// ascending: per x two float4 of weights (a broadcast) and one float4 of the
// tile for 32 FMAs. Bit x of `active` says that row x of w holds a nonzero
// (destination x has an in-edge); the other rows add exact zeros, and with
// kSkip the loop walks the set bits only (without it the compiler unrolls the
// counted loop and batches its reads, which is faster when most rows are
// active). Outputs past N read padding; their sums are not stored.
template <bool kSkip>
__device__ __forceinline__ void reduce_over_rows(const float* w, const float* rows, float* dst, int N,
                                                 int ld, int ldp, int d4, long long HD,
                                                 unsigned long long active) {
  const int groups = (N + 7) / 8;
  for (int t = threadIdx.x; t < groups * d4; t += blockDim.x) {
    const int c = (t % d4) * 4, j0 = (t / d4) * 8;
    float4 acc[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add_row = [&](int x) {
      const float4 w0 = *reinterpret_cast<const float4*>(w + x * ldp + j0);
      const float4 w1 = *reinterpret_cast<const float4*>(w + x * ldp + j0 + 4);
      const float4 row = *reinterpret_cast<const float4*>(rows + x * ld + c);
      fma4(acc[0], w0.x, row);
      fma4(acc[1], w0.y, row);
      fma4(acc[2], w0.z, row);
      fma4(acc[3], w0.w, row);
      fma4(acc[4], w1.x, row);
      fma4(acc[5], w1.y, row);
      fma4(acc[6], w1.z, row);
      fma4(acc[7], w1.w, row);
    };
    if (kSkip) {
      for (unsigned long long m = active; m != 0; m &= m - 1) add_row(__ffsll((long long)m) - 1);
    } else {
      for (int x = 0; x < N; ++x) add_row(x);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (j0 + a < N) *reinterpret_cast<float4*>(dst + (j0 + a) * HD + c) = acc[a];
    }
  }
}

// dst_i = sum_x w[i][x] rows_x for 8 outputs i x 4 columns per thread, x
// ascending, four x at a time: eight float4 of weights (broadcasts) and four
// float4 of the tile for 128 FMAs. Bit x of `active` says that column x of w
// holds a nonzero (source x has an out-edge); with kSkip four columns without
// one are passed over.
template <bool kSkip>
__device__ __forceinline__ void reduce_over_columns(const float* w, const float* rows, float* dst, int N,
                                                    int ld, int ldp, int d4, long long HD,
                                                    unsigned long long active) {
  const int groups = (N + 7) / 8;
  for (int t = threadIdx.x; t < groups * d4; t += blockDim.x) {
    const int c = (t % d4) * 4, i0 = (t / d4) * 8;
    float4 acc[8];
    const float* wrow[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
      wrow[a] = w + min(i0 + a, N - 1) * ldp;  // rows past N repeat the last; not stored
    }
    for (int x = 0; x < N; x += 4) {
      if (kSkip && !((active >> x) & 15ull)) continue;
      float4 wx[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) wx[a] = *reinterpret_cast<const float4*>(wrow[a] + x);
      {
        const float4 row = *reinterpret_cast<const float4*>(rows + x * ld + c);
#pragma unroll
        for (int a = 0; a < 8; ++a) fma4(acc[a], wx[a].x, row);
      }
      if (x + 1 < N) {
        const float4 row = *reinterpret_cast<const float4*>(rows + (x + 1) * ld + c);
#pragma unroll
        for (int a = 0; a < 8; ++a) fma4(acc[a], wx[a].y, row);
      }
      if (x + 2 < N) {
        const float4 row = *reinterpret_cast<const float4*>(rows + (x + 2) * ld + c);
#pragma unroll
        for (int a = 0; a < 8; ++a) fma4(acc[a], wx[a].z, row);
      }
      if (x + 3 < N) {
        const float4 row = *reinterpret_cast<const float4*>(rows + (x + 3) * ld + c);
#pragma unroll
        for (int a = 0; a < 8; ++a) fma4(acc[a], wx[a].w, row);
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (i0 + a < N) *reinterpret_cast<float4*>(dst + (i0 + a) * HD + c) = acc[a];
    }
  }
}

// R x R dots per thread in the two product passes (4, or 2 for N <= 16).
template <int R>
__global__ void __launch_bounds__(kStagedMaxThreads, kBwdMinBlocks)
session_attention_backward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const uint8_t* __restrict__ adj,
                                  const float* __restrict__ dout, float* __restrict__ dq,
                                  float* __restrict__ dk, float* __restrict__ dv, int B, int N,
                                  int H, int d, float scale, float keep_prob,
                                  uint32_t keep_threshold,
                                  const unsigned long long* __restrict__ seed_p) {
  extern __shared__ __align__(16) float smem[];
  const unsigned long long seed = keep_threshold < kKeepAll ? *seed_p : 0ULL;  // from device memory
  const int ld = d + kTilePad;           // row stride of the staged tiles
  const int ldp = staged_weights_ld(N);  // row stride of the N x N matrices, [destination][source]
  float* ta = smem;  // q, then dO, then q
  float* tb = ta + N * ld;  // k, then v, then k
  float* sp = tb + N * ld;  // scores, then dropped-out weights p, then dA
  float* sg = sp + N * ldp;  // weights a, then dS / sqrt(d)
  uint8_t* sadj = reinterpret_cast<uint8_t*>(sg + N * ldp);
  // per warp: the destinations with an in-edge, the sources with an out-edge
  unsigned long long* smask = reinterpret_cast<unsigned long long*>(sadj + (N * N + 15) / 16 * 16);

  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const long long HD = (long long)H * d;
  const long long base = b * N * HD + (long long)h * d;
  const int d4 = d / 4;
  const uint8_t* adj_b = adj + b * N * N;

  stage_two_tiles(ta, q + base, tb, k + base, N, d4, ld, HD);
  // The adjacency rides along, as in the staged forward.
  if ((N * N) % 16 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0) {
    for (int t = threadIdx.x * 16; t < N * N; t += blockDim.x * 16) cp_async16(sadj + t, adj_b + t);
  } else {
    for (int t = threadIdx.x; t < N * N; t += blockDim.x) sadj[t] = adj_b[t];
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Pass 1: scores over the edges present, -1e30 elsewhere.
  tile_dots<R>(
      ta, tb, sp, N, ld, ldp, d4, [&](int i, int j) { return sadj[i * N + j] != 0; },
      [&](float acc, bool on) { return on ? acc / scale : kNegInf; });
  __syncthreads();  // q and k are dead: dO and v take their places while pass 2 runs

  stage_two_tiles(ta, dout + base, tb, v + base, N, d4, ld, HD);
  cp_async_commit();

  // Pass 2: a warp per destination, two in flight: softmax and dropout of row
  // i in place; a goes to sg. One reciprocal a row, products after it.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float inv_keep = 1.f / keep_prob;
  const float inv_scale = 1.f / scale;
  const bool dropout = keep_threshold < kKeepAll;
  unsigned long long with_in_edge = 0, with_out_edge = 0;
  for (int i0 = warp; i0 < N; i0 += 2 * n_warps) {
    float a[2][2], p[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = min(i0 + u * n_warps, N - 1);  // a second row past N repeats the last one
      float s[2];
      bool on[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        on[t] = j < N && sadj[i * N + j] != 0;
        s[t] = on[t] ? sp[i * ldp + j] : kNegInf;
      }
      const unsigned long long sources = (unsigned long long)__ballot_sync(0xffffffffu, on[0]) |
                                         (unsigned long long)__ballot_sync(0xffffffffu, on[1]) << 32;
      with_out_edge |= sources;
      with_in_edge |= (unsigned long long)(sources != 0) << i;
      float m = warp_max(fmaxf(s[0], s[1]));
      if (m <= kNegInf / 2) m = 0.f;
      const float e0 = on[0] ? expf(s[0] - m) : 0.f;
      const float e1 = on[1] ? expf(s[1] - m) : 0.f;
      const float inv = 1.f / fmaxf(warp_sum(e0 + e1), 1e-16f);
      a[u][0] = e0 * inv;
      a[u][1] = e1 * inv;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        p[u][t] = a[u][t];
        if (dropout) {
          const unsigned long long row = ((unsigned long long)(b * H + h) * N + i) * N;
          const bool keep = (counter_hash(seed, row + lane + 32 * t) >> 8) < keep_threshold;
          p[u][t] = keep ? a[u][t] * inv_keep : 0.f;
        }
      }
    }
    __syncwarp();  // a repeated last row is read before its owner writes it
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * n_warps;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (i < N && j < N) {
          sp[i * ldp + j] = p[u][t];
          sg[i * ldp + j] = a[u][t];
        }
      }
    }
  }
  if (lane == 0) {
    smask[2 * warp] = with_in_edge;
    smask[2 * warp + 1] = with_out_edge;
  }
  cp_async_wait<0>();
  __syncthreads();
  with_in_edge = with_out_edge = 0;
  for (int w = 0; w < n_warps; ++w) {
    with_in_edge |= smask[2 * w];
    with_out_edge |= smask[2 * w + 1];
  }

  // A session with edges into fewer than half of its nodes takes the skipping
  // loops in passes 3 and 6 (the whole block together).
  const bool sparse = 2 * __popcll(with_in_edge) < N;

  // Pass 3: dV_j = sum_i p_ij dO_i.
  if (sparse) {
    reduce_over_rows<true>(sp, ta, dv + base, N, ld, ldp, d4, HD, with_in_edge);
  } else {
    reduce_over_rows<false>(sp, ta, dv + base, N, ld, ldp, d4, HD, with_in_edge);
  }
  __syncthreads();  // p is dead: dA overwrites it

  // Pass 4: dA_ij = (dO_i . v_j) / keep_prob where a weight was kept, else 0.
  tile_dots<R>(
      ta, tb, sp, N, ld, ldp, d4, [&](int i, int j) { return sp[i * ldp + j] != 0.f; },
      [&](float acc, bool on) { return on ? acc * inv_keep : 0.f; });
  __syncthreads();  // dO and v are dead: q and k come back while pass 5 runs

  stage_two_tiles(ta, q + base, tb, k + base, N, d4, ld, HD);
  cp_async_commit();

  // Pass 5: dS_ij / sqrt(d) = a_ij (dA_ij - sum_j' a_ij' dA_ij') / sqrt(d), row i in place in sg.
  for (int i0 = warp; i0 < N; i0 += 2 * n_warps) {
    float ds[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = min(i0 + u * n_warps, N - 1);
      float a[2], g[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        a[t] = j < N ? sg[i * ldp + j] : 0.f;
        g[t] = j < N ? sp[i * ldp + j] : 0.f;
      }
      const float rowsum = warp_sum(a[0] * g[0] + a[1] * g[1]);
#pragma unroll
      for (int t = 0; t < 2; ++t) ds[u][t] = a[t] * (g[t] - rowsum) * inv_scale;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * n_warps;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (i < N && j < N) sg[i * ldp + j] = ds[u][t];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Pass 6: dK_j = sum_i dS_ij q_i / sqrt(d) and dQ_i = sum_j dS_ij k_j / sqrt(d).
  if (sparse) {
    reduce_over_rows<true>(sg, ta, dk + base, N, ld, ldp, d4, HD, with_in_edge);
    reduce_over_columns<true>(sg, tb, dq + base, N, ld, ldp, d4, HD, with_out_edge);
  } else {
    reduce_over_rows<false>(sg, ta, dk + base, N, ld, ldp, d4, HD, with_in_edge);
    reduce_over_columns<false>(sg, tb, dq + base, N, ld, ldp, d4, HD, with_out_edge);
  }
}

size_t backward_smem_bytes(int N, int d) {
  return sizeof(float) * (2 * (size_t)N * (d + kTilePad) + 2 * (size_t)N * staged_weights_ld(N)) +
         ((size_t)N * N + 15) / 16 * 16 + 2 * sizeof(unsigned long long) * (kStagedMaxThreads / 32);
}

template <int R>
int launch_backward(const float* q, const float* k, const float* v, const uint8_t* adj,
                    const float* dout, float* dq, float* dk, float* dv, int B, int N, int H, int d,
                    float scale, float keep_prob, uint32_t keep_threshold,
                    const unsigned long long* seed, cudaStream_t stream) {
  static bool opted_in = false;  // the largest tile set the wrapper admits: N = 64, d = 128
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        session_attention_backward_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)backward_smem_bytes(64, 128));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  session_attention_backward_kernel<R><<<(unsigned)(B * H), staged_threads(N, d, R), backward_smem_bytes(N, d), stream>>>(
      q, k, v, adj, dout, dq, dk, dv, B, N, H, d, scale, keep_prob, keep_threshold, seed);
  return 0;
}

// The row forward and its empty twin, opted in to their shared memory once.
int opt_in_rows() {
  static bool opted_in = false;
  if (opted_in) return 0;
  const int bytes = (int)row_smem_bytes(64, 128);
  cudaError_t err = cudaFuncSetAttribute(session_attention_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(session_attention_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  opted_in = err == cudaSuccess;
  return static_cast<int>(err);
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
                                                 const void* seed, int staged, void* stream) {
  const auto* seedp = static_cast<const unsigned long long*>(seed);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* adjb = static_cast<const uint8_t*>(adj);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dropout = keep_threshold < kKeepAll;
  if ((long long)B * H * N == 0) return 0;
  if (staged) {
    auto* launch = dropout ? (N <= 16 ? launch_staged<true, 2> : launch_staged<true, 4>)
                           : (N <= 16 ? launch_staged<false, 2> : launch_staged<false, 4>);
    const int err =
        launch(qf, kf, vf, adjb, outf, B, N, H, d, scale, keep_prob, keep_threshold, seedp, s);
    if (err != 0) return err;
  } else {
    const int err = opt_in_rows();
    if (err != 0) return err;
    auto* kernel = dropout ? session_attention_kernel<true> : session_attention_kernel<false>;
    kernel<<<(unsigned)((long long)B * H * row_groups(N)), kRowWarps * 32, row_smem_bytes(N, d), s>>>(
        qf, kf, vf, adjb, outf, B, N, H, d, scale, keep_prob, keep_threshold, seedp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int session_attention_takes_staged(int B, int N, int H) {
  return (long long)B * H * row_groups(N) >= (N <= 32 ? kStagedMinRowBlocks : kStagedMinRowBlocksWide);
}

// The port's entry point: the staged kernel where session_attention_takes_staged says so.
extern "C" int session_attention_forward(const void* q, const void* k, const void* v,
                                         const void* adj, void* out, int B, int N, int H,
                                         int d, float scale, float keep_prob,
                                         unsigned int keep_threshold, const void* seed,
                                         void* stream) {
  return session_attention_forward_variant(q, k, v, adj, out, B, N, H, d, scale, keep_prob,
                                           keep_threshold, seed,
                                           session_attention_takes_staged(B, N, H), stream);
}

// An empty kernel with the row forward's grid, block and shared memory at
// this shape: what a launch costs before any work. Measurement only.
extern "C" int session_attention_launch_floor(int B, int N, int H, int d, void* stream) {
  if ((long long)B * H * N == 0) return 0;
  const int err = opt_in_rows();
  if (err != 0) return err;
  empty_kernel<<<(unsigned)((long long)B * H * row_groups(N)), kRowWarps * 32, row_smem_bytes(N, d),
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int session_attention_backward(const void* q, const void* k, const void* v,
                                          const void* adj, const void* dout, void* dq, void* dk,
                                          void* dv, int B, int N, int H, int d, float scale,
                                          float keep_prob, unsigned int keep_threshold,
                                          const void* seed, void* stream) {
  if ((long long)B * H * N == 0) return 0;
  auto* launch = N <= 16 ? launch_backward<2> : launch_backward<4>;
  const int err = launch(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const uint8_t*>(adj),
                         static_cast<const float*>(dout), static_cast<float*>(dq),
                         static_cast<float*>(dk), static_cast<float*>(dv), B, N, H, d, scale,
                         keep_prob, keep_threshold, static_cast<const unsigned long long*>(seed),
                         static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
