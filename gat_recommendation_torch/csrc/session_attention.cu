// Session attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the JAX package's Pallas kernel ops/pallas/session_attention.py::
// fused_session_attention (forward only; no attention dropout, no backward).
// For each session b, head h and destination node i:
//     s_j   = (q_i . k_j) / sqrt(d)            where adj[b, i, j], else -1e30
//     m     = max_j s_j, set to 0 when m <= -5e29 (row with no in-edges)
//     e_j   = exp(s_j - m) * adj[b, i, j]
//     out_i = sum_j e_j / max(sum_j e_j, 1e-16) * v_j
// so a destination with no in-edges outputs exact zeros.
//
// Layout: q, k, v, out are [B, N, H*d] f32 contiguous; adj is [B, N, N]
// uint8 (a torch bool tensor's bytes), adj[b, dst, src].
//
// Design: one warp per (b, h, i). Lane l scores sources j = l and l + 32
// (so N <= 64), reading q_i and k_j as float4; a warp-shuffle max and sum
// give the softmax; then lane l accumulates output columns l, l+32, l+64,
// l+96 (so d <= 128) over all j, reading alpha_j from the warp's 64 floats
// of shared memory. Warps of one block are consecutive i of the same (b, h),
// so K and V rows are reused out of L1.
//
// Bound on an H100 SXM (3.35 TB/s): at serving shapes (B=1, N<=56, H*d=256)
// it reads about 172 KB, 0.05 us of bytes, so launch and memory latency
// bound it, not bytes (chip_smoke.py measured 5-10 us of device time for
// N = 8..56 on an H100 80GB HBM3 at 700 W). At the eval shape B=512, N=56
// it must read 88 MB (q, k, v, adj) and write 29 MB, about 35 us at
// 3.35 TB/s; the per-warp k_j row reads are strided, so this simple design
// does not reach that bound (0.25 ms on the same card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kNegInf = -1e30f;

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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
session_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ adj,
                         float* __restrict__ out, int B, int N, int H, int d, float scale) {
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
  alpha[lane] = e0 / denom;
  alpha[lane + 32] = e1 / denom;
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

}  // namespace

// Shapes are checked by the Python wrapper: 1 <= N <= 64, d % 4 == 0,
// 4 <= d <= 128, 16-byte aligned contiguous tensors. Returns cudaGetLastError().
extern "C" int session_attention_forward(const void* q, const void* k, const void* v,
                                         const void* adj, void* out, int B, int N, int H,
                                         int d, float scale, void* stream) {
  const long long warps = (long long)B * H * N;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    session_attention_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(adj),
        static_cast<float*>(out), B, N, H, d, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
