// Full-catalog scores plus 32-column chunk maxes for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the JAX package's Pallas kernel ops/pallas/score_chunkmax.py::
// fused_score_chunkmax, phase 1 of the exact two-level top-k
// (ops/scoring.py::two_level_topk_scores there):
//     scores[b, c] = sess[b] . table[c]    if c < num_items and !exclude[b, c]
//                  = -inf                  otherwise
//     maxes[b, g]  = max(scores[b, 32g : 32g + 32])
// The exclusion mask (seen items and the padding row when serving) is the
// same `where` the TPU kernel applies to phantom columns, with one more
// predicate, so the chunk maxes describe exactly the scores that phase 2
// gathers. Maxes are [B, V/32] (row-major, session first); the TPU kernel
// wrote them transposed for its lane layout.
//
// Layout: sess [B, D] f32, table [V, D] f32, exclude [B, V] uint8 or null,
// scores [B, V] f32, maxes [B, V/32] f32, all contiguous; V % 32 == 0,
// D % 4 == 0, D <= 512 (the per-session kernel's four float4 slots a lane).
//
// Two kernels; score_chunkmax_forward chooses by B (kTileMinBatch below).
//
// One session at a time (serving, B below kTileMinBatch): one warp per 32-row
// chunk (grid-stride). Each lane holds its float4 slots of sess[b] in
// registers (D=256: two float4, 8 floats a lane), loads 8 table rows at a
// time as coalesced float4 (each row 1 KB across the warp), and reduces each
// row's dot product with a warp butterfly; lane r keeps row r's score, so the
// score write is one coalesced 128-byte store and the chunk max one more
// butterfly. A warp loops over the sessions, so its time grows with B.
// Bound at B=1, V=467,456, D=256 on an H100 SXM (3.35 TB/s): one read of the
// 478.7 MB table, about 143 us; the 0.5 GFLOP of FMAs are far below that.
//
// A batch (evaluation, B from kTileMinBatch up): the work is a
// [B, D] x [D, V] product, at B=512 122.5 GFLOP against 1.47 GB moved, so
// float32 operations bound it (1.83 ms at 67 TFLOP/s, bytes 0.44 ms) and the
// design is a register-tiled float32 product. A block of 256 threads owns
// 128 sessions x 128 items (4 chunks) and walks D in steps of 32 through a
// ring of 3 shared-memory stages (108 KB) filled by 16-byte cp.async, the
// ragged edges (B, V, D) zero-filled by the copy. Both operands are
// K-contiguous, so a tile is staged as [row][k] with a row stride of 36
// floats: a thread reads float4 along k, and 8 consecutive rows fall on 8
// different 16-byte bank groups. One block an SM, its 64 sums, 36 operand
// registers and the loads of the next step held without spilling (two blocks
// at 128 registers spill and measured slower).
// Thread (ty, tx) keeps sessions ty + 16 j and items tx + 16 i
// (j, i < 8) as 64 sums in registers: 16 LDS.128 feed 256 FMAs. Each sum is
// one fmaf chain over k ascending in full float32 (no TF32). The epilogue
// stays in registers: both predicates, the score stores (16 consecutive
// floats per half-warp), and per session and chunk the max over the two
// columns a thread holds and a 4-step shuffle over the 16 threads that hold
// the rest; the scores are never read back. The grid runs the session tiles
// of one item tile next to each other, so a table tile comes from device
// memory once and from L2 for the other session tiles.
//
// chip_smoke.py measures both kernels against their bounds; PERF.md holds
// the times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kChunk = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerStep = 8;

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NV = float4 slots a lane holds: D <= 128 * NV.
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
score_chunkmax_kernel(const float* __restrict__ sess, const float* __restrict__ table,
                      const uint8_t* __restrict__ exclude, float* __restrict__ scores,
                      float* __restrict__ maxes, int B, int V, int D, int num_items) {
  const int lane = threadIdx.x & 31;
  const int d4 = D / 4;
  const long long n_chunks = V / kChunk;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long chunk = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       chunk < n_chunks; chunk += stride) {
    const float4* rows = reinterpret_cast<const float4*>(table) + chunk * kChunk * d4;
    const long long col = chunk * kChunk + lane;
    for (int b = 0; b < B; ++b) {
      const float4* s4 = reinterpret_cast<const float4*>(sess + (long long)b * D);
      float4 sv[NV];
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int f = lane + 32 * t;
        sv[t] = f < d4 ? s4[f] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mine = 0.f;
#pragma unroll 1
      for (int r0 = 0; r0 < kChunk; r0 += kRowsPerStep) {
        float4 w[kRowsPerStep][NV];
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const int f = lane + 32 * t;
            w[u][t] = f < d4 ? __ldg(rows + (r0 + u) * d4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < NV; ++t) acc = dot4(sv[t], w[u][t], acc);
          acc = warp_sum(acc);
          if (lane == r0 + u) mine = acc;
        }
      }
      const long long at = (long long)b * V + col;
      const bool keep = col < num_items && (exclude == nullptr || exclude[at] == 0);
      const float val = keep ? mine : -INFINITY;
      scores[at] = val;
      const float cmax = warp_max(val);
      if (lane == 0) maxes[(long long)b * n_chunks + chunk] = cmax;
    }
  }
}

// ---- the batch kernel: 128 sessions x 128 items per block ----

constexpr int kTileMinBatch = 6;  // B from here up takes the batch kernel; set from chip_smoke.py's crossover table
constexpr int kTile = 128;        // sessions and items per block
constexpr int kTileK = 32;        // floats of D per stage
constexpr int kTileLd = kTileK + 4;  // row stride of a staged tile: odd in float4 units
constexpr int kStages = 3;
constexpr int kTileThreads = 256;  // 16 x 16 threads, an 8 x 8 micro-tile each
constexpr int kStageFloats = 2 * kTile * kTileLd;
constexpr int kTileSmemBytes = kStages * kStageFloats * (int)sizeof(float);

__global__ void __launch_bounds__(kTileThreads, 1)
score_chunkmax_tile_kernel(const float* __restrict__ sess, const float* __restrict__ table,
                           const uint8_t* __restrict__ exclude, float* __restrict__ scores,
                           float* __restrict__ maxes, int B, int V, int D, int num_items,
                           int m_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x & 15;  // items tx + 16 i
  const int ty = threadIdx.x >> 4;  // sessions ty + 16 j
  const int m0 = (blockIdx.x % m_tiles) * kTile;
  const long long n0 = (long long)(blockIdx.x / m_tiles) * kTile;
  const int n_k = (D + kTileK - 1) / kTileK;

  // One stage: the session tile, then the item tile, each [128][kTileLd].
  // 8 threads copy the 128 bytes of one row; rows or k past the edge are zeros.
  auto load_stage = [&](int stage, int kt) {
    float* dst = smem + stage * kStageFloats;
    const int k0 = kt * kTileK;
#pragma unroll
    for (int t = threadIdx.x; t < 2 * kTile * (kTileK / 4); t += kTileThreads) {
      const bool items = t >= kTile * (kTileK / 4);
      const int r = (t / (kTileK / 4)) % kTile;
      const int c = k0 + (t % (kTileK / 4)) * 4;
      const long long row = items ? n0 + r : m0 + r;
      const bool valid = c < D && row < (items ? V : B);
      const float* src = (items ? table : sess) + (valid ? row * D + c : 0);
      cp_async16_or_zero(dst + (items ? kTile * kTileLd : 0) + r * kTileLd + (c - k0), src, valid);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();               // everyone's have, and everyone is done with stage kt - 1
    if (kt + kStages - 1 < n_k) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const float* a = smem + (kt % kStages) * kStageFloats + ty * kTileLd;
    const float* b = smem + (kt % kStages) * kStageFloats + (kTile + tx) * kTileLd;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 4) {
      float4 bf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) bf[i] = *reinterpret_cast<const float4*>(b + 16 * i * kTileLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 af = *reinterpret_cast<const float4*>(a + 16 * j * kTileLd + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = dot4(af, bf[i], acc[j][i]);
      }
    }
  }

  // Epilogue. Chunk g of the tile is items 32 g .. 32 g + 31: this thread's
  // columns i = 2 g and 2 g + 1, and the same of the 15 other tx of its
  // half-warp (one ty per half-warp, so the xor shuffle stays inside it).
  const long long n_chunks = V / kChunk;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = m0 + ty + 16 * j;
    const bool row_ok = row < B;
    const long long at = (long long)row * V;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float cmax = -INFINITY;
#pragma unroll
      for (int i = 2 * g; i < 2 * g + 2; ++i) {
        const long long col = n0 + tx + 16 * i;
        float val = -INFINITY;
        if (row_ok && col < V) {
          const bool keep = col < num_items && (exclude == nullptr || exclude[at + col] == 0);
          val = keep ? acc[j][i] : -INFINITY;
          scores[at + col] = val;
        }
        cmax = fmaxf(cmax, val);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      const long long chunk = n0 / kChunk + g;
      if (tx == 0 && row_ok && chunk < n_chunks) maxes[(long long)row * n_chunks + chunk] = cmax;
    }
  }
}

int launch_tile(const void* sess, const void* table, const void* exclude, void* scores,
                void* maxes, int B, int V, int D, int num_items, cudaStream_t stream) {
  static bool opted_in = false;  // 108 KB of dynamic shared memory: above the 48 KB default
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_chunkmax_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int m_tiles = (B + kTile - 1) / kTile;
  const long long blocks = (long long)m_tiles * ((V + kTile - 1) / kTile);
  if (blocks == 0) return 0;
  score_chunkmax_tile_kernel<<<(unsigned)blocks, kTileThreads, kTileSmemBytes, stream>>>(
      static_cast<const float*>(sess), static_cast<const float*>(table),
      static_cast<const uint8_t*>(exclude), static_cast<float*>(scores),
      static_cast<float*>(maxes), B, V, D, num_items, m_tiles);
  return 0;
}

template <int NV>
void launch(const void* sess, const void* table, const void* exclude, void* scores,
            void* maxes, int B, int V, int D, int num_items, cudaStream_t stream) {
  const long long n_chunks = V / kChunk;
  const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0 || B == 0) return;
  score_chunkmax_kernel<NV><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(sess), static_cast<const float*>(table),
      static_cast<const uint8_t*>(exclude), static_cast<float*>(scores),
      static_cast<float*>(maxes), B, V, D, num_items);
}

}  // namespace

// Shapes are checked by the Python wrapper. `exclude` may be null (no
// exclusion); it is read with row stride V. `tile` names the kernel: nonzero
// the batch kernel, zero the per-session one. Returns a cudaError_t.
extern "C" int score_chunkmax_forward_variant(const void* sess, const void* table,
                                              const void* exclude, void* scores, void* maxes,
                                              int B, int V, int D, int num_items, int tile,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (tile) {
    const int err = launch_tile(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
    if (err != 0) return err;
  } else if (D <= 128) {
    launch<1>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  } else if (D <= 256) {
    launch<2>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  } else {
    launch<4>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The port's entry point: the batch kernel from kTileMinBatch sessions up.
extern "C" int score_chunkmax_forward(const void* sess, const void* table, const void* exclude,
                                      void* scores, void* maxes, int B, int V, int D,
                                      int num_items, void* stream) {
  return score_chunkmax_forward_variant(sess, table, exclude, scores, maxes, B, V, D, num_items,
                                        B >= kTileMinBatch, stream);
}

extern "C" int score_chunkmax_tile_min_batch() { return kTileMinBatch; }
