// The f32 variant of the port's attention kernels: one query row over a run
// of keys, on the CUDA cores, f32 throughout (no tensor cores: TF32 would
// not be f32). paged_attention.cu and flash_attention.cu each launch it
// behind their f32 entry points, with their own key addressing.
//
// What bounds it: neither bytes nor operations, but its simplicity. Each
// block (128 threads) owns one (query position, query head) and reads every
// key it sees from device memory, so a GQA group reads its K/V G times, and
// the scores are dot products of one warp's lanes over D. An engine serves
// f32 as an option (``dtype: float32``); bf16, the worker's default, takes
// the tensor-core kernels.
//
// Numerics: the f32 form of the JAX kernels' online softmax. Keys are walked
// in 64-key tiles at absolute 64-key boundaries; Q.K in f32 (fmaf over D, a
// warp's lanes summed by butterfly), the 1/sqrt(D) scale after the dot,
// masked keys at -1e30, p zeroed where masked, acc * exp(m_prev - m_new) +
// P.V, the denominator floored at 1e-30.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32attn {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// One row: q[0..kD) attends the keys first..last (absolute positions, both
// included; none when last < first) and writes out[0..kD). row_of(key) is
// the element offset of the key's K/V row (for this kv head) in k and v.
// Every thread of the block calls it.
template <int kD, class RowOf>
__device__ __forceinline__ void attend_row(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           float* __restrict__ out, int first, int last,
                                           RowOf row_of, float scale) {
  constexpr int kPerThread = (kD + kThreads - 1) / kThreads;
  __shared__ float qs[kD];
  __shared__ float ss[kTile];
  __shared__ float ps[kTile];
  __shared__ int64_t rows[kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int d = tid; d < kD; d += kThreads) qs[d] = q[d];
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  __syncthreads();

  for (int t0 = first >= 0 ? (first / kTile) * kTile : 0; t0 <= last; t0 += kTile) {
    // scores: warp w takes keys t0 + 16w .. t0 + 16w + 15
    for (int i = 0; i < kTile / 4; ++i) {
      const int j = warp * (kTile / 4) + i;
      const int key = t0 + j;
      const bool seen = key >= first && key <= last;
      const int64_t off = seen ? row_of(key) : -1;
      float dot = 0.f;
      if (seen) {
        for (int d = lane; d < kD; d += 32) dot = fmaf(qs[d], k[off + d], dot);
        dot = warp_sum(dot);
      }
      if (lane == 0) {
        ss[j] = seen ? dot * scale : kNegInf;
        rows[j] = off;
      }
    }
    __syncthreads();
    float mt = kNegInf;
    for (int j = 0; j < kTile; ++j) mt = fmaxf(mt, ss[j]);
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);  // 1 while nothing was seen: acc, l are 0
    if (tid < kTile) ps[tid] = rows[tid] >= 0 ? expf(ss[tid] - m_new) : 0.f;
    __syncthreads();
    float lt = 0.f;
    for (int j = 0; j < kTile; ++j) lt += ps[j];
    l = l * corr + lt;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d >= kD) break;
      float a = 0.f;
      for (int j = 0; j < kTile; ++j)
        if (rows[j] >= 0) a = fmaf(ps[j], v[rows[j] + d], a);
      acc[i] = acc[i] * corr + a;
    }
    m = m_new;
    __syncthreads();  // ss, ps and rows are read before the next tile refills them
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < kD) out[d] = acc[i] / fmaxf(l, 1e-30f);
  }
}

// Zeros for a row that attends nothing by contract (ragged padding, flash
// positions at or past the length).
template <int kD>
__device__ __forceinline__ void zero_row(float* __restrict__ out) {
  for (int d = threadIdx.x; d < kD; d += kThreads) out[d] = 0.f;
}

}  // namespace f32attn
