// Flash self-attention for Hopper (sm_90a): causal prefill over a fresh prompt.
//
// Replaces the Pallas TPU kernel of cyberfabric_core_tpu/ops/flash_attention.py:
//   flash_self_attention (:125, body _flash_kernel :45) -> flash_self_attention_bf16
//   (and, for f32 inputs, flash_self_attention_f32: the CUDA-core kernel of
//   attention_f32.cuh, one block per (position, query head))
//
// What bounds it: operations. A prompt of length n costs ~4*Hq*D*n(n+1)/2
// flops (Q.K and P.V over the causal triangle) against ~n*(Hq+2*Hkv)*D*2 bytes
// in and n*Hq*D*2 bytes out; at n = 2048 that is ~470 flops per byte, above
// the H100's ~295 bf16 flops/byte ridge. So both products run on wgmma, the
// only way to the tensor cores' full rate, fed by TMA.
//
// What the design does about it:
//   * One block per (batch row, kv head, tile of 128 query rows). The rows
//     are (position, head) pairs: P = floor(128/G) positions times the G
//     query heads of the kv head (R = P*G rows; at G = 3, 5, 6, 7 the last
//     rows of the tile are unused: never loaded, never written), so each K/V
//     tile is read from device memory once per GQA group rather than once
//     per query head. Two consumer warpgroups own 64 rows each; one thread
//     of a third, producer warpgroup does all the loading (warp
//     specialisation: the consumers spend no instruction on addresses or
//     copies, and setmaxnreg hands the producer's registers to them).
//   * Loads by TMA (cp.async.bulk.tensor) into the swizzle that wgmma's
//     descriptors read. The tensor maps are 4-D over (D, heads, T, B),
//     encoded on the host per call and passed as __grid_constant__
//     parameters. A box is one swizzle row wide: the widest swizzle (128, 64
//     or 32 bytes) that D's row divides into, so D 64, 128 and 256 take one,
//     two and four 64-dim boxes in the 128-byte swizzle, D 96 three 32-dim
//     boxes in the 64-byte swizzle, D 16 one 16-dim box in the 32-byte
//     swizzle. Keys or positions at or past T arrive as zeros, and no box
//     reaches into the next batch row. The block's Q rows are one box per
//     column block (positions x the G heads, adjacent in [B, T, Hq, D]); a
//     K or V tile is [kBK keys, box dims] per column block.
//   * The producer keeps a ring of kStages K/V stages full. K and V each
//     complete on an mbarrier of their own, so Q.K starts before V has
//     landed; each consumer warp frees a stage on a third after its last
//     product that reads it.
//   * S = Q K^T is wgmma m64n{kBK}k16 with Q and K from shared memory (both
//     K-major). O += P V is wgmma m64n{D}k16, with P from registers (the S
//     accumulator layout is the A fragment's) and V from shared memory read
//     MN-major. Softmax and the masks run on the CUDA cores, on the S
//     accumulator in registers; O (64 rows x D) and the TPU's m/l scratch
//     are registers too. A key tile is 64 keys up to D 128; at D 256, where
//     O alone takes 128 registers a thread, it is 32 keys, so S, the next
//     tile's S and P's fragments fit beside O under setmaxnreg 240. Within
//     a warpgroup the tiles are pipelined: Q.K of tile t is issued with P.V
//     of tile t-1, and its softmax runs while that P.V finishes.
//   * The TPU's sequential kv-block grid axis becomes a loop over key tiles
//     inside the block, from the window's first visible key to the block's
//     last visible key (min of its last position and len-1); tiles wholly in
//     the future, past the length or before the window are never loaded. A
//     warpgroup multiplies only the tiles its own rows can see (a tile no
//     row of it can see is an exact no-op of the update) but takes part in
//     every stage's barriers. A block whose first position is at or past the
//     length loads nothing and writes zeros. Blocks are launched heaviest
//     (latest positions) first.
//
// Numerics follow the JAX kernel: Q.K in f32 from bf16 operands, the 1/sqrt(D)
// scale applied to the f32 scores, masked scores at -1e30, p zeroed where
// masked, acc * exp(m_prev - m_new) + P.V, denominator floored at 1e-30. P.V
// takes the f32 P as three bf16 terms that sum to it exactly: hi = p cut to
// its top 16 bits (a bf16), mid = (p - hi) cut the same way, lo = p - hi -
// mid (at most 8 significant bits, so a bf16 too); cutting is integer work,
// not a conversion. With one term P would keep 8 bits, with two 16, and every
// small difference in p would then jump the output by a rounding step of the
// last term. Both products chain their 16-deep steps in the tensor cores:
// Q.K over all of D, and P.V's terms (lo, mid, hi of each 16 keys) straight
// into O. The tensor cores' accumulation truncates relative to the running
// sum; with P in three exact terms that meets the one-ulp bar at every shape
// the checks use, as ops/flash_sweep.py measures. Positions at or past the
// length are exact zeros.
//
// Diagnostic build (not what the port loads; ops/flash_sweep.py times it):
// -DFLASH_P_TERMS=1 takes P as one bf16 term, rounded to nearest as the JAX
// kernel's p.astype(v.dtype) does.

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled

#include "attention_f32.cuh"
#include "sm90_common.cuh"

#ifndef FLASH_P_TERMS
#define FLASH_P_TERMS 3
#endif
static_assert(FLASH_P_TERMS == 1 || FLASH_P_TERMS == 3, "P is one or three bf16 terms");

namespace {

constexpr int kWgRows = 64;                      // rows per consumer warpgroup (wgmma M)
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kRows = kWgRows * kConsumers;      // (position, head) rows per block
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: the block holds 168 a thread at entry
// (384 threads, one block an SM), and 2 x 128 x 240 + 128 x 24 is the same sum
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kStages = 3;                       // K/V ring depth
constexpr int kMaxG = 8;                         // query heads per kv head

// The shapes that follow from the head dim D.
template <int kD>
struct Shape {
  static_assert(kD % 16 == 0 && kD >= 16 && kD <= 256, "D is a multiple of 16, at most 256");
  static constexpr int kBK = kD > 128 ? 32 : 64;  // keys per tile
  // one swizzled row: the widest swizzle span D's row divides into
  static constexpr uint32_t kRowBytes = (kD * 2) % 128 == 0 ? 128 : (kD * 2) % 64 == 0 ? 64 : 32;
  static constexpr int kBoxD = kRowBytes / 2;     // dims per box
  static constexpr int kBoxes = kD / kBoxD;       // column blocks of a row
  static constexpr int kStepsPerBox = kRowBytes / 32;  // 16-dim k steps in a row
  static constexpr uint32_t kLayout = sm90::swizzle_layout(kRowBytes);
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;  // 8 swizzled rows
  static constexpr uint32_t kQBoxBytes = kRows * kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBoxBytes;
  static constexpr uint32_t kTileBoxBytes = kBK * kRowBytes;
  static constexpr uint32_t kTileBytes = kBoxes * kTileBoxBytes;  // one K or V tile
  static constexpr int kSmemBytes = 1024 /* alignment */ + kQBytes + 2 * kStages * kTileBytes +
                                    8 * (1 + 3 * kStages) /* mbarriers */;
  static_assert(kTileBoxBytes % 1024 == 0 && kQBoxBytes % 1024 == 0,
                "every box starts on a 1024-byte boundary");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};
constexpr float kNegInf = -1e30f;

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::reg_fence;
using sm90::wgmma_commit;
using sm90::wgmma_desc;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

// The block's mbarriers, 8 bytes each from ``base``: the Q rows landed; the
// K and the V tile of each stage landed; each stage freed by every consumer
// warp.
struct Barriers {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int st) const { return base + 8u * (1 + st); }
  __device__ uint32_t v_full(int st) const { return base + 8u * (1 + kStages + st); }
  __device__ uint32_t freed(int st) const { return base + 8u * (1 + 2 * kStages + st); }
};

// x cut to its top 16 bits: a bf16 value, x - cut(x) exact in f32.
__device__ __forceinline__ float cut16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// The top halves of two f32 that are bf16 values, as a bf16 pair (lo first).
__device__ __forceinline__ uint32_t pack_top(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// P's bf16 terms for keys 16j..16j+15 as A fragments, in the order they are
// multiplied (lo, mid, hi): the S accumulator's n-tiles 2j and 2j+1 are the
// A fragment's k halves.
template <int kN>
__device__ __forceinline__ void split_p(const float (&p)[kN], int j,
                                        uint32_t (&a)[FLASH_P_TERMS][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {    // n-tile 2j + h: keys 16j + 8h ..
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows grp, grp + 8
      const float p0 = p[(2 * j + h) * 4 + 2 * i];
      const float p1 = p[(2 * j + h) * 4 + 2 * i + 1];
#if FLASH_P_TERMS == 3
      const float h0 = cut16(p0), h1 = cut16(p1);
      const float r0 = p0 - h0, r1 = p1 - h1;
      const float m0 = cut16(r0), m1 = cut16(r1);
      a[0][2 * h + i] = pack_top(r0 - m0, r1 - m1);
      a[1][2 * h + i] = pack_top(m0, m1);
      a[2][2 * h + i] = pack_top(h0, h1);
#else
      a[0][2 * h + i] = pack_bf16(p0, p1);
#endif
    }
  }
}

// S = Q K^T for one key tile, issued (not waited for): D/16 steps of 16
// dims chained in the tensor cores. Q and K are K-major: a 16-dim step is 32
// bytes along a swizzled row, and the next column block starts a box on.
template <int kD>
__device__ __forceinline__ void issue_qk(float (&s)[Shape<kD>::kBK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  using S = Shape<kD>;
  const uint64_t q_desc = wgmma_desc(q_tile, 16, S::kAtomBytes, S::kLayout);
  const uint64_t k_desc = wgmma_desc(k_tile, 16, S::kAtomBytes, S::kLayout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int box = kk / S::kStepsPerBox, step = kk % S::kStepsPerBox;
    const uint32_t off = (box * S::kTileBoxBytes + step * 32) >> 4;  // 16-byte units
    const uint32_t q_off = (box * S::kQBoxBytes + step * 32) >> 4;
    sm90::WgmmaSsK<S::kBK>::run(s, q_desc + q_off, k_desc + off, kk);
  }
  wgmma_commit();
}

// O += P V for one key tile, issued (not waited for): P's terms for keys
// 16j.. (lo, mid, hi) chained into O. V is MN-major: keys 16j.. start 16
// rows in, and the next column block is a box on (the lbo). The fragments
// must stay untouched until the product has completed.
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const float (&p)[Shape<kD>::kBK / 2],
                                         uint32_t (&a)[Shape<kD>::kBK / 16][FLASH_P_TERMS][4],
                                         uint32_t v_tile) {
  using S = Shape<kD>;
#pragma unroll
  for (int j = 0; j < S::kBK / 16; ++j) split_p(p, j, a[j]);
  const uint64_t v_desc = wgmma_desc(v_tile, S::kTileBoxBytes, S::kAtomBytes, S::kLayout);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < S::kBK / 16; ++j)
#pragma unroll
    for (int u = 0; u < FLASH_P_TERMS; ++u)
      sm90::WgmmaRsMn<kD>::run(o, a[j][u], v_desc + ((j * 16 * S::kRowBytes) >> 4), 1);
  wgmma_commit();
}

// The online-softmax update of one tile on the S accumulator, in place: s
// becomes p, m and l move on, and corr is what O must be scaled by before
// this tile's P V is added. Row i of this thread sees keys kt0 + c with
// lo_key[i] < c - 2 * tig <= hi_key[i]; kMask false: the caller knows that
// every row of the warpgroup sees every key of the tile. kN = kBK / 2.
template <bool kMask, int kN>
__device__ __forceinline__ void softmax(float (&s)[kN], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], const int (&qpos)[2], int kt0,
                                        int len, int window, float scale, int tig) {
  int hi_key[2], lo_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi_key[i] = min(qpos[i], len - 1) - kt0 - tig * 2;
    lo_key[i] = (window > 0 ? qpos[i] - window : -1) - kt0 - tig * 2;
  }
  // scale, mask, row max (a row's keys lie on the 4 threads of its quad)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int i = (e >> 1) & 1;
    const int key = (e >> 2) * 8 + (e & 1);
    s[e] = !kMask || (key <= hi_key[i] && key > lo_key[i]) ? s[e] * scale : kNegInf;
    mx[i] = fmaxf(mx[i], s[e]);
  }
  // a row that sees no key yet keeps m = -1e30; p = exp(s - m_use) is then
  // 0 for every masked score, and the row's own update an exact no-op
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new);
    m[i] = m_new;
    m_use[i] = m_new == kNegInf ? 0.f : m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    s[e] = expf(s[e] - m_use[(e >> 1) & 1]);
    ls[(e >> 1) & 1] += s[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
    ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
    l[i] = l[i] * corr[i] + ls[i];
  }
}

// A consumer thread: its warpgroup's tiles, then the epilogue. The tiles are
// pipelined within the warpgroup: tile t's Q.K runs while P.V of tile t-1
// runs, and the softmax of tile t while P.V of tile t-1 finishes. Stages the
// warpgroup does not multiply are waited for and freed all the same. Rows
// r >= R = P*G (the tile's unused rows) compute on whatever shared memory
// holds there and are never written.
template <int kD>
__device__ __forceinline__ void consumer(uint32_t q_s, uint32_t k_s, uint32_t v_s, Barriers bars,
                                         __nv_bfloat16* __restrict__ out, int pos0, int len,
                                         int b, int kvh, int G, int T, int Hq, int t_lo,
                                         int t_hi, int window, float scale) {
  using S = Shape<kD>;
  constexpr int kBK = S::kBK;
  constexpr int kN = kBK / 2;  // S accumulator values a thread
  const int tid = threadIdx.x;
  // warpgroup wg, and this thread's two rows of the warp's 16
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // accumulator row group
  const int tig = lane & 3;   // thread in group
  const int R = (kRows / G) * G;  // rows in use
  int qpos[2];
  bool row_out[2];
  int64_t qoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * kWgRows + ((tid >> 5) & 3) * 16 + grp + 8 * i;
    qpos[i] = pos0 + r / G;
    row_out[i] = r < R && qpos[i] < T;
    const int head = kvh * G + r % G;
    qoff[i] = ((static_cast<int64_t>(b) * T + qpos[i]) * Hq + head) * kD;
  }

  float o[kD / 2];
#pragma unroll
  for (int e = 0; e < kD / 2; ++e) o[e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (pos0 < len) {
    // this warpgroup's positions [wpos0, wpos1] (of its rows in use), and
    // the tiles they can see, [w_lo, w_hi] (none when all of them lie at or
    // past the length)
    const int wpos0 = pos0 + (wg * kWgRows) / G;
    const int wpos1 = pos0 + min(wg * kWgRows + kWgRows - 1, R - 1) / G;
    const int w_last = min(wpos1, len - 1);
    const int w_first = window > 0 ? max(0, wpos0 - window + 1) : 0;
    const int w_lo = wpos0 < len ? max(t_lo, w_first / kBK) : t_hi + 1;
    const int w_hi = w_last / kBK;
    const uint32_t q_tile = q_s + wg * kWgRows * S::kRowBytes;
    // tile t needs no mask when every row of the warpgroup sees all its keys
    const int interior_hi = min(wpos0, len - 1) - (kBK - 1);
    const int interior_lo = window > 0 ? wpos1 - window : -1;
    const auto update = [&](float (&sc)[kN], float (&cr)[2], int t) {
      const int kt0 = t * kBK;
      if (kt0 <= interior_hi && kt0 > interior_lo) {
        softmax<false>(sc, m, l, cr, qpos, kt0, len, window, scale, tig);
      } else {
        softmax<true>(sc, m, l, cr, qpos, kt0, len, window, scale, tig);
      }
    };
    int st = 0;
    uint32_t parity = 0;
    const auto advance = [&]() {
      if (++st == kStages) {
        st = 0;
        parity ^= 1u;
      }
    };
    const auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.freed(stage));
    };
    const auto skip = [&]() {
      mbar_wait(bars.k_full(st), parity);
      mbar_wait(bars.v_full(st), parity);
      release(st);
      advance();
    };
    int t = t_lo;
    for (; t < w_lo && t <= t_hi; ++t) skip();
    if (t <= w_hi) {
      float s[kN], corr[2];
      uint32_t a[kBK / 16][FLASH_P_TERMS][4];
      mbar_wait(bars.q_full(), 0);
      mbar_wait(bars.k_full(st), parity);
      __syncwarp();
      issue_qk<kD>(s, q_tile, k_s + st * S::kTileBytes);
      wgmma_wait<0>();
      reg_fence(s);
      update(s, corr, t);
      int prev = st;
      uint32_t prev_parity = parity;
      advance();
      for (++t; t <= w_hi; ++t) {
        float sn[kN];
        mbar_wait(bars.k_full(st), parity);
        mbar_wait(bars.v_full(prev), prev_parity);
        __syncwarp();
        issue_qk<kD>(sn, q_tile, k_s + st * S::kTileBytes);
        issue_pv<kD>(o, s, a, v_s + prev * S::kTileBytes);
        wgmma_wait<1>();  // Q.K of tile t
        reg_fence(sn);
        float cn[2];
        update(sn, cn, t);
        wgmma_wait<0>();  // P.V of tile t-1
        reg_fence(o);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
          for (int u = 0; u < FLASH_P_TERMS; ++u) reg_fence(a[j][u]);
        release(prev);
#pragma unroll
        for (int e = 0; e < kD / 2; ++e) o[e] *= cn[(e >> 1) & 1];
#pragma unroll
        for (int e = 0; e < kN; ++e) s[e] = sn[e];
        prev = st;
        prev_parity = parity;
        advance();
      }
      mbar_wait(bars.v_full(prev), prev_parity);
      __syncwarp();
      issue_pv<kD>(o, s, a, v_s + prev * S::kTileBytes);
      wgmma_wait<0>();
      reg_fence(o);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
        for (int u = 0; u < FLASH_P_TERMS; ++u) reg_fence(a[j][u]);
      release(prev);
    }
    for (; t <= t_hi; ++t) skip();
  }

  // epilogue: rows at or past the length are zeros; unused rows and rows
  // past T are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_out[i]) continue;
    const bool valid = qpos[i] < len;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float x0 = valid ? o[n * 4 + 2 * i] / denom : 0.f;
      const float x1 = valid ? o[n * 4 + 2 * i + 1] / denom : 0.f;
      *reinterpret_cast<uint32_t*>(out + qoff[i] + n * 8 + tig * 2) = pack_bf16(x0, x1);
    }
  }
}

// grid: (ceil(T / P), Hkv, B), P = floor(128 / G); block: 2 consumer
// warpgroups, then the producer warpgroup (one of its threads issues the
// loads).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int window, float scale) {
  using S = Shape<kD>;
  constexpr int kBK = S::kBK;
  extern __shared__ unsigned char smem[];
  // the swizzle's 8-row atoms must sit on 1024-byte boundaries
  const uint32_t q_s = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;
  const uint32_t v_s = k_s + kStages * S::kTileBytes;
  const Barriers bars{v_s + kStages * S::kTileBytes};

  const int G = Hq / Hkv;
  const int P = kRows / G;  // positions per block
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int pos0 = (gridDim.x - 1 - blockIdx.x) * P;  // heaviest blocks first
  const int len = min(lengths[b], T);
  const int tid = threadIdx.x;
  const bool work = pos0 < len;
  const int last_key = min(pos0 + P - 1, len - 1);
  const int first_key = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int t_lo = first_key / kBK;
  const int t_hi = last_key / kBK;

  if (work && tid == 0) {
    sm90::mbar_init(bars.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bars.k_full(st), 1);
      sm90::mbar_init(bars.v_full(st), 1);
      sm90::mbar_init(bars.freed(st), kConsumerThreads / 32);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (work && tid == kConsumerThreads) {
      // the Q box holds the P * G rows in use
      mbar_expect_tx(bars.q_full(), S::kBoxes * P * G * S::kRowBytes);
      for (int c = 0; c < S::kBoxes; ++c)
        sm90::tma_load_4d(q_s + c * S::kQBoxBytes, &q_map, bars.q_full(), c * S::kBoxD,
                          kvh * G, pos0, b);
      int st = 0;
      uint32_t parity = 0;
      for (int t = t_lo; t <= t_hi; ++t) {
        if (t - t_lo >= kStages) mbar_wait(bars.freed(st), parity ^ 1u);  // its last use freed
        const uint32_t ks = k_s + st * S::kTileBytes, vs = v_s + st * S::kTileBytes;
        mbar_expect_tx(bars.k_full(st), S::kTileBytes);
        for (int c = 0; c < S::kBoxes; ++c)
          sm90::tma_load_4d(ks + c * S::kTileBoxBytes, &k_map, bars.k_full(st), c * S::kBoxD,
                            kvh, t * kBK, b);
        mbar_expect_tx(bars.v_full(st), S::kTileBytes);
        for (int c = 0; c < S::kBoxes; ++c)
          sm90::tma_load_4d(vs + c * S::kTileBoxBytes, &v_map, bars.v_full(st), c * S::kBoxD,
                            kvh, t * kBK, b);
        if (++st == kStages) {
          st = 0;
          parity ^= 1u;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consumer<kD>(q_s, k_s, v_s, bars, out, pos0, len, b, kvh, G, T, Hq, t_lo, t_hi, window,
                 scale);
  }
}

// grid: (T, Hq, B); block: f32attn::kThreads. Position t of row b for query
// head h: keys max(0, t - window + 1) .. t, zeros at or past the length.
template <int kD>
__global__ void __launch_bounds__(f32attn::kThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ out, int T, int Hq, int Hkv,
    int window, float scale) {
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int64_t qoff = ((static_cast<int64_t>(b) * T + t) * Hq + h) * kD;
  if (t >= lengths[b]) {
    f32attn::zero_row<kD>(out + qoff);
    return;
  }
  const int first = window > 0 ? max(0, t - window + 1) : 0;
  const auto row_of = [&](int key) -> int64_t {
    return ((static_cast<int64_t>(b) * T + key) * Hkv + kvh) * kD;
  };
  f32attn::attend_row<kD>(q + qoff, k, v, out + qoff, first, t, row_of, scale);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime's entry-point query, so the library needs no link against libcuda.
// It runs on the host only and enqueues nothing, so a CUDA graph may capture
// the launch it prepares.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, T, H, D] bf16 as a 4-D map over (D, H, T, B), boxes of (kBoxD, box_h,
// box_t, 1) in the swizzle of a kBoxD-dim row, zeros outside.
template <int kD>
CUresult encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int T, int H,
                    int box_h, int box_t) {
  using S = Shape<kD>;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kD * 2, static_cast<cuuint64_t>(H) * kD * 2,
                                 static_cast<cuuint64_t>(T) * H * kD * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::kBoxD), static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_t), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = S::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : S::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, const int* lengths, void* out, int B,
                int T, int Hq, int Hkv, int window, float scale, cudaStream_t stream) {
  using S = Shape<kD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const int G = Hq / Hkv;
  const int P = kRows / G;
  CUtensorMap q_map, k_map, v_map;
  CUresult r = encode_map<kD>(encode, &q_map, q, B, T, Hq, G, P);
  if (r == CUDA_SUCCESS) r = encode_map<kD>(encode, &k_map, k, B, T, Hkv, 1, S::kBK);
  if (r == CUDA_SUCCESS) r = encode_map<kD>(encode, &v_map, v, B, T, Hkv, 1, S::kBK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((T + P - 1) / P, Hkv, B);
  flash_attention_kernel<kD><<<grid, kThreads, S::kSmemBytes, stream>>>(
      q_map, k_map, v_map, lengths, static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out, int B,
               int T, int Hq, int Hkv, int window, float scale, cudaStream_t stream) {
  flash_f32_kernel<kD><<<dim3(T, Hq, B), f32attn::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lengths, static_cast<float*>(out), T, Hq, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool args_ok(int Hq, int Hkv) {
  return Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv >= 1 && Hq / Hkv <= kMaxG;
}

// Calls fn<D>(args...) for a head dim of the model registry.
#define FLASH_DISPATCH_D(D, fn, ...)                               \
  switch (D) {                                                     \
    case 16: return fn<16>(__VA_ARGS__);                           \
    case 64: return fn<64>(__VA_ARGS__);                           \
    case 96: return fn<96>(__VA_ARGS__);                           \
    case 128: return fn<128>(__VA_ARGS__);                         \
    case 256: return fn<256>(__VA_ARGS__);                         \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

}  // namespace

extern "C" {

// q/out [B, T, Hq, D] bf16; k/v [B, T, Hkv, D] bf16, all 16-byte aligned, D
// in {16, 64, 96, 128, 256}, Hq/Hkv in 1..8; lengths [B] int32. window 0 =
// none. Returns a cudaError_t, or minus the CUresult when a tensor map
// cannot be made.
int flash_self_attention_bf16(const void* q, const void* k, const void* v,
                              const int* lengths, void* out, int B, int T, int Hq,
                              int Hkv, int D, int window, float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!args_ok(Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, launch_bf16, q, k, v, lengths, out, B, T, Hq, Hkv, window, scale, st)
}

// The same for f32 q, k, v and out.
int flash_self_attention_f32(const void* q, const void* k, const void* v, const int* lengths,
                             void* out, int B, int T, int Hq, int Hkv, int D, int window,
                             float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!args_ok(Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, launch_f32, q, k, v, lengths, out, B, T, Hq, Hkv, window, scale, st)
}

}  // extern "C"
