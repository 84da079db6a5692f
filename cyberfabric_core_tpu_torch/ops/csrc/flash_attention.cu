// Flash self-attention for Hopper (sm_90a): causal prefill over a fresh prompt.
//
// Replaces the Pallas TPU kernel of cyberfabric_core_tpu/ops/flash_attention.py:
//   flash_self_attention (:125, body _flash_kernel :45) -> flash_self_attention_bf16
//
// What bounds it: operations. A prompt of length n costs ~4*Hq*D*n(n+1)/2
// flops (Q.K and P.V over the causal triangle) against ~n*(Hq+2*Hkv)*D*2 bytes
// in and n*Hq*D*2 bytes out; at n = 2048 that is ~470 flops per byte, above
// the H100's ~295 bf16 flops/byte ridge. So the products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// What the design does about it:
//   * One block per (batch row, kv head, tile of query rows). The block's 64
//     rows are (position, head) pairs: 64/G positions times the G query
//     heads of its kv head, so each K/V tile is read from device memory once
//     per GQA group rather than once per query head.
//   * The TPU's sequential kv-block grid axis becomes a loop over 64-key tiles
//     inside the block, from the window's first visible key to the block's
//     last visible key (min of its last position and len-1); tiles wholly in
//     the future, past the length or before the window are never read. A
//     block whose first position is at or past the length reads nothing and
//     writes zeros. Blocks are launched heaviest (latest positions) first.
//   * K and V tiles are double-buffered in shared memory with cp.async, so
//     the next tile loads while this one is multiplied. Rows are padded by
//     16 bytes: fragment reads of K and the transposing ldmatrix of V hit 32
//     distinct banks.
//   * The block's Q rows sit in shared memory (read by ldmatrix per 16-dim
//     step). Each of the 4 warps owns 16 rows; the TPU's m/l/acc VMEM scratch
//     is registers: S (16x64) and O (16x128) in the mma accumulator layout.
//
// Numerics follow the JAX kernel: Q.K in f32 from bf16 operands, the 1/sqrt(D)
// scale applied to the f32 scores, masked scores at -1e30, p zeroed where
// masked, acc * exp(m_prev - m_new) + P.V, denominator floored at 1e-30. P.V
// takes the f32 P as three bf16 terms (hi = bf16(p), mid = bf16(p - hi),
// lo = bf16(p - hi - mid)), which carry its 24 bits: with one term P would
// keep 8 bits, with two 16, and every small difference in p would then jump
// the output by a rounding step of the last term. Tensor-core accumulation
// truncates relative to the running sum, so every 16-deep product starts from
// zero and partial sums are added in IEEE f32 (see the comment at S).
// Positions at or past the length are exact zeros.
// Not yet done (later work): wgmma and TMA, a persistent schedule.

#include "sm90_common.cuh"

namespace {

constexpr int kD = 128;               // head dim
constexpr int kRows = 64;             // (position, head) rows per block
constexpr int kWarps = kRows / 16;    // one m16 tile of rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;               // keys per tile
constexpr int kStride = kD + 8;       // padded K/V row in shared memory (bf16)
constexpr int kTileElems = kBK * kStride;
constexpr int kQElems = kRows * kStride;
constexpr int kSmemBytes = (kQElems + 2 * 2 * kTileElems) * 2;  // Q + 2 stages x (K, V)
constexpr float kNegInf = -1e30f;

using sm90::bf16_round;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait_one;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;
using sm90::pack_bf16;

// grid: (ceil(T / (64/G)), Hkv, B); block: 128 threads.
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int window,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tiles = qs + kQElems;

  const int G = Hq / Hkv;
  const int P = kRows / G;  // positions per block
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int pos0 = (gridDim.x - 1 - blockIdx.x) * P;  // heaviest blocks first
  const int len = min(lengths[b], T);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;   // mma row group
  const int tig = lane & 3;    // thread in group

  // this thread's two rows of the warp's m16 tile: r = warp*16 + grp (+8)
  int qpos[2];
  int64_t qoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + grp + 8 * i;
    qpos[i] = pos0 + r / G;
    const int head = kvh * G + r % G;
    qoff[i] = ((static_cast<int64_t>(b) * T + qpos[i]) * Hq + head) * kD;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (pos0 < len) {
    // the block's Q rows into shared memory (their cp.async copies join the
    // first K/V tile's group)
    for (int c = tid; c < kRows * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8);
      const int dc = (c % (kD / 8)) * 8;
      const int pos = pos0 + r / G;
      const bool valid = pos < T;
      const int64_t off = valid
          ? ((static_cast<int64_t>(b) * T + pos) * Hq + kvh * G + r % G) * kD + dc : 0;
      cp_async16(qs + r * kStride + dc, q + off, valid);
    }
    // this lane's row address for the A-fragment ldmatrix of the warp's rows
    const __nv_bfloat16* qrow = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride
                                + (lane >> 4) * 8;

    const int last_key = min(pos0 + P - 1, len - 1);
    const int first_key = window > 0 ? max(0, pos0 - window + 1) : 0;
    const int t_lo = first_key / kBK;
    const int t_hi = last_key / kBK;

    auto load_tile = [&](int stage, int t) {
      __nv_bfloat16* ks = tiles + stage * 2 * kTileElems;
      __nv_bfloat16* vs = ks + kTileElems;
      const int kt0 = t * kBK;
      for (int c = tid; c < kBK * (kD / 8); c += kThreads) {
        const int key = c / (kD / 8);
        const int dc = (c % (kD / 8)) * 8;
        const bool valid = kt0 + key < T;
        const int64_t off = valid
            ? ((static_cast<int64_t>(b) * T + kt0 + key) * Hkv + kvh) * kD + dc : 0;
        cp_async16(ks + key * kStride + dc, k + off, valid);
        cp_async16(vs + key * kStride + dc, v + off, valid);
      }
      cp_async_commit();
    };

    load_tile(0, t_lo);
    for (int t = t_lo; t <= t_hi; ++t) {
      const int stage = (t - t_lo) & 1;
      if (t < t_hi) {
        load_tile(stage ^ 1, t + 1);
      } else {
        cp_async_commit();  // empty group: wait_group 1 then waits for tile t
      }
      cp_async_wait_one();
      __syncthreads();
      const __nv_bfloat16* ks = tiles + stage * 2 * kTileElems;
      const __nv_bfloat16* vs = ks + kTileElems;
      const int kt0 = t * kBK;

      // S = Q K^T: 8 n-tiles of 8 keys. Each 16-dim product starts from a
      // zero accumulator and is added in IEEE f32: the tensor cores' own
      // accumulation truncates relative to the running sum, so chaining all
      // 8 steps through it would bias large scores by several f32 ulps.
      float s[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qrow + kk * 16);
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          const __nv_bfloat16* kp = ks + (n * 8 + grp) * kStride + kk * 16 + tig * 2;
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(t4, qa, *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += t4[e];
        }
      }

      // scale, mask, row max
      uint32_t vis = 0u;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = kt0 + n * 8 + tig * 2 + (e & 1);
          const bool ok = key <= qpos[i] && key < len &&
                          (window <= 0 || key > qpos[i] - window);
          s[n][e] = ok ? s[n][e] * scale : kNegInf;
          vis |= static_cast<uint32_t>(ok) << (n * 4 + e);
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
      float corr[2], m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new[i]);
        m[i] = m_new[i];
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[n][e] = (vis >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_new[i]) : 0.f;
          ls[i] += s[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        l[i] = l[i] * corr[i] + ls[i];
      }
      // O = O * corr + P V, P as hi + mid + lo bf16 terms, in 4 steps of 16
      // keys. As for S, each 16-key product starts from zero and is added
      // in IEEE f32.
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      // V rows of the tile through a transposing ldmatrix: lane supplies the
      // row address of matrix lane/8, keys + (mat & 1) * 8, dims + (mat >> 1) * 8
      const int mat = lane >> 3;
      const __nv_bfloat16* vrow =
          vs + ((lane & 7) + (mat & 1) * 8) * kStride + (mat >> 1) * 8;
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t a_hi[4], a_mid[4], a_lo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // n-tile 2j + h: keys 16j + 8h ..
#pragma unroll
          for (int i = 0; i < 2; ++i) {    // rows grp, grp+8
            const float p0 = s[2 * j + h][2 * i];
            const float p1 = s[2 * j + h][2 * i + 1];
            const float h0 = bf16_round(p0), h1 = bf16_round(p1);
            const float m0 = bf16_round(p0 - h0), m1 = bf16_round(p1 - h1);
            a_hi[2 * h + i] = pack_bf16(h0, h1);
            a_mid[2 * h + i] = pack_bf16(m0, m1);
            a_lo[2 * h + i] = pack_bf16(p0 - h0 - m0, p1 - h1 - m1);
          }
        }
#pragma unroll
        for (int dn = 0; dn < kD / 8; dn += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + j * 16 * kStride + dn * 8);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float t4[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t4, a_lo, bv[2 * u], bv[2 * u + 1]);
            mma_bf16(t4, a_mid, bv[2 * u], bv[2 * u + 1]);
            mma_bf16(t4, a_hi, bv[2 * u], bv[2 * u + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[dn + u][e] += t4[e];
          }
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

  // epilogue: rows at or past the length are zeros; rows past T are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= T) continue;
    const bool valid = qpos[i] < len;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float x0 = valid ? o[n][2 * i] / denom : 0.f;
      const float x1 = valid ? o[n][2 * i + 1] / denom : 0.f;
      *reinterpret_cast<uint32_t*>(out + qoff[i] + n * 8 + tig * 2) = pack_bf16(x0, x1);
    }
  }
}

}  // namespace

extern "C" {

// q/out [B, T, Hq, 128] bf16; k/v [B, T, Hkv, 128] bf16; lengths [B] int32.
// window 0 = none. Returns a cudaError_t.
int flash_self_attention_bf16(const void* q, const void* k, const void* v,
                              const int* lengths, void* out, int B, int T, int Hq,
                              int Hkv, int window, float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || kRows % (Hq / Hkv) != 0 || Hq / Hkv > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int P = kRows / (Hq / Hkv);
  const dim3 grid((T + P - 1) / P, Hkv, B);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out),
      T, Hq, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
