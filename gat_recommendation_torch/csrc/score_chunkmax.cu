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
// D % 4 == 0, D <= 512.
//
// Design: one warp per 32-row chunk (grid-stride). Each lane holds its
// float4 slots of sess[b] in registers (D=256: two float4, 8 floats a lane),
// loads 8 table rows at a time as coalesced float4 (each row 1 KB across the
// warp), and reduces each row's dot product with a warp butterfly; lane r
// keeps row r's score, so the score write is one coalesced 128-byte store and
// the chunk max one more butterfly. f32 accumulation, no TF32. For B > 1 each
// warp loops over the sessions and re-reads its chunk from L1: correct but
// slow at B=512 (a tensor-core tile version is later work).
//
// Bound on an H100 SXM (3.35 TB/s): at B=1, V=467,456, D=256 one read of the
// 478.7 MB table is about 143 us; the 0.5 GFLOP of FMAs and the 1.9 MB of
// scores written are far below that, so the kernel is bound by bytes
// (chip_smoke.py measured 0.160 ms on an H100 80GB HBM3 at 700 W: 90 % of
// the bound).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// exclusion); it is read with row stride V. Returns cudaGetLastError().
extern "C" int score_chunkmax_forward(const void* sess, const void* table, const void* exclude,
                                      void* scores, void* maxes, int B, int V, int D,
                                      int num_items, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 128) {
    launch<1>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  } else if (D <= 256) {
    launch<2>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  } else if (D <= 512) {
    launch<4>(sess, table, exclude, scores, maxes, B, V, D, num_items, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
