// Paged attention for Hopper (sm_90a): ragged mixed-batch and decode.
//
// Replaces the two Pallas TPU kernels of cyberfabric_core_tpu/ops/paged_attention.py:
//   ragged_paged_attention (:421, body _ragged_kernel :263)  -> ragged_paged_attention_bf16
//   paged_decode_attention (:188, body _paged_kernel :76)    -> paged_decode_attention_bf16
// (and ragged_paged_attention_f32 / paged_decode_attention_f32 for f32 inputs).
//
// Three __global__ functions serve both bf16 entry points:
//
//   split_kernel + combine_kernel: the decode path. One query (all G = Hq/Hkv
//     heads of one kv head) over one split of its keys. A query of length L
//     has its keys cut into splits at fixed absolute key boundaries, every
//     kSplitPages pages, so its splits depend only on its length: not on the
//     batch, the card or which entry point was called. Each (row, kv head,
//     split) block streams the split's pages through two cp.async stages in
//     shared memory and writes a partial (m, l, acc[D]) in f32 to scratch the
//     wrapper allocates; combine_kernel merges a query's partials in split
//     order 0..n-1. Decode sends every row's query through it; the ragged
//     entry sends every position of a short span (q_len <= kShortSpan), one
//     after the other in the row's blocks, with the position's own length
//     hist+i+1. Each position runs the same walk as a decode query of that
//     length, so ragged q_len=1 equals decode bitwise, and every position of
//     a short span equals decoding that token alone.
//   chunk_kernel: prompt-chunk spans (q_len > kShortSpan) of the ragged
//     entry, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate), built like flash_attention.cu: one block per (row, tile
//     of 64/G span positions, kv head) whose 64 rows are (position, head)
//     pairs, walking the row's page chain in 64-key tiles through the page
//     table, double-buffered with cp.async, from the window's first key to
//     the tile's last visible key; the page ids of the next tile are read
//     while the current one is multiplied. It also writes the zeros of
//     every position past a row's q_len.
//
// What bounds it: bytes for decode (~1 flop per K/V byte at one query per
// row; the H100's bf16 ridge is ~295); for a prompt chunk the work grows
// with chunk length x history and the scalar CUDA cores would bound it, so
// the chunk rows run on the tensor cores. What the design does about it:
// decode fills the card with (row, kv head, split) blocks (288 that work at
// the main-path shape of 8 rows, against 64 with one block per row and head),
// overlaps each page's load with the previous page's arithmetic, and runs
// Q.K and P.V on the tensor cores (the G heads of a query padded to 16
// rows), so the CUDA cores are left the softmax; chunk blocks reuse each
// K/V tile across 64 (position, head) rows, and blocks over padding, idle
// rows or short spans load nothing.
//
// Numerics follow the JAX kernels: Q.K in f32 from bf16 operands, the
// 1/sqrt(D) scale applied to the f32 scores, masked scores at -1e30, online
// softmax in f32, P.V in f32, a running max still at the floor gives
// correction 0, denominator floored at 1e-30. Both paths run Q.K and P.V on
// the tensor cores as flash_attention.cu does: every 16-deep product
// started from zero and the partials added in IEEE f32, P as three bf16
// terms (hi, mid, lo), which keeps them within one bf16 ulp of a float64
// reference. The split path's softmax and combine use explicitly rounded
// f32 intrinsics (no contraction left to the compiler). An empty partial
// (a split wholly before the window) is m = -1e30, l = 0, and the combine
// skips it: an exact no-op. In the chunk path a row's value depends only on
// its own q, its position and the K/V: tiles sit at absolute 64-key
// boundaries and a tile a row cannot see is an exact no-op of its update,
// so neither tile placement nor the chunk's start changes its bits. Rows
// past q_len are exact zeros.
// Head dims: every kernel is a template on D, built for the head dims of the
// model registry (16, 64, 96, 128, 256); the entry points take D and launch
// the matching build. Where D changes the work split: the split path's P.V
// hands each warp a run of 16-dim column pairs (all four warps at D >= 64),
// the combine kernel walks the D output dims with its 128 threads, and the
// chunk path copies D/16 16-byte pieces of each 64-key tile a thread. Shared
// memory grows with D (at 256: ~137 KB split, ~169 KB chunk, one block an SM).
//
// f32 inputs take the entry points *_f32: the CUDA-core kernel of
// attention_f32.cuh, one block per (position, query head), walking the
// row's keys through the page table.
//
// Not yet done (later work): wgmma and TMA; several positions of a short
// span sharing the split path's page loads and mma rows.

#include "attention_f32.cuh"
#include "sm90_common.cuh"

#ifndef PAGED_SPLIT_PAGES
#define PAGED_SPLIT_PAGES 4  // pages per split; override with -D to compare
#endif

namespace {

using sm90::bf16_round;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait_one;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;
using sm90::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kMaxPage = 64;          // tokens per page
constexpr int kMaxG = 8;              // query heads per kv head
constexpr int kShortSpan = 8;         // ragged spans up to this take the split path
constexpr int kSplitPages = PAGED_SPLIT_PAGES;
constexpr int kThreads = 128;         // 4 warps
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSplitPages >= 1, "a split holds at least one page");

constexpr int kRows = 64;             // chunk path: (position, head) rows per block
constexpr int kBK = 64;               // chunk path: keys per tile

// The shapes that follow from the head dim D.
template <int kD>
struct Dims {
  static_assert(kD % 16 == 0 && kD >= 16 && kD <= 256, "D is a multiple of 16, at most 256");
  // K, V (and Q) rows in shared memory are padded by 16 bytes: fragment
  // reads of K and the transposing ldmatrix of V spread over the banks
  static constexpr int kStride = kD + 8;
  // split path: 2 stages of one page of K and V, the page's
  // scores/probabilities as [key][head] and the heads' corrections
  static constexpr int kPageElems = kMaxPage * kStride;
  static constexpr int kSplitSmem = 2 * 2 * kPageElems * 2 + kMaxPage * kMaxG * 4 + kMaxG * 4;
  // split path P.V: the D/16 pairs of 8-dim n-tiles, a run of kPairsPerWarp
  // of them for each warp
  static constexpr int kPairs = kD / 16;
  static constexpr int kPairsPerWarp = (kPairs + 3) / 4;
  // chunk path, as flash_attention.cu: Q + 2 stages x (K, V); a thread
  // copies the 16-byte pieces tid + kThreads * c, c < kPieces, of a tile
  static constexpr int kTileElems = kBK * kStride;
  static constexpr int kQElems = kRows * kStride;
  static constexpr int kChunkSmem = (kQElems + 2 * 2 * kTileElems) * 2;
  static constexpr int kPieces = kBK * (kD / 8) / kThreads;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Butterfly sum, then lane 0's value for everyone: the lanes' trees round
// differently, so one of them is picked to keep every lane on one number.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

// The decode-path positions of row b: decode (q_lens null) 1; ragged the
// span's positions when it is short, else none.
__device__ __forceinline__ int row_positions(const int* __restrict__ q_lens, int b,
                                             int Qmax) {
  if (q_lens == nullptr) return 1;
  const int qlen = min(q_lens[b], Qmax);
  return qlen <= kShortSpan ? max(qlen, 0) : 0;
}

// The key count of decode-path position i of row b: decode the row's
// length; ragged hist + i + 1.
__device__ __forceinline__ int position_length(const int* __restrict__ hist_or_len,
                                               const int* __restrict__ q_lens, int b,
                                               int i) {
  return q_lens == nullptr ? max(hist_or_len[b], 0) : hist_or_len[b] + i + 1;
}

// The splits of a position: the keys the table holds, cut every
// kSplitPages pages from key 0.
__device__ __forceinline__ int n_splits(int len, int page, int Pmax) {
  const int kmax = min(len, Pmax * page);
  const int span = kSplitPages * page;
  return (kmax + span - 1) / span;
}

// Split s of position i of row b, for kv head kvh: its partial (m, l,
// acc[D]) for each of the G heads into slot (b * n_pos + i, kvh, s).
template <int kD>
__device__ __forceinline__ void split_position(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ page_table,
    float* __restrict__ part_acc, float* __restrict__ part_ml, unsigned char* smem,
    int b, int i, int kvh, int s, int len, int Qmax, int n_pos, int Hq, int Hkv,
    int N, int page, int Pmax, int n_split, int window, float scale) {
  using S = Dims<kD>;
  constexpr int kStride = S::kStride;
  constexpr int kPageElems = S::kPageElems;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;   // mma row group
  const int tig = lane & 3;    // thread in group
  const int qpos = len - 1;
  const int kmax = min(len, Pmax * page);
  const int first_key = window > 0 ? max(0, qpos - window + 1) : 0;
  const int p_lo = max(s * kSplitPages, first_key / page);
  const int p_hi = min((s + 1) * kSplitPages, (kmax + page - 1) / page) - 1;
  const int64_t slot =
      ((static_cast<int64_t>(b) * n_pos + i) * Hkv + kvh) * n_split + s;
  float* ml = part_ml + slot * G * 2;
  float* acc_out = part_acc + slot * G * kD;
  if (p_lo > p_hi) {  // the split lies wholly before the window
    if (tid < G) {
      ml[2 * tid] = kNegInf;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  bf16* k_st = reinterpret_cast<bf16*>(smem);                    // [2][kMaxPage][kStride]
  bf16* v_st = k_st + 2 * kPageElems;                             // [2][kMaxPage][kStride]
  float* ps = reinterpret_cast<float*>(v_st + 2 * kPageElems);    // [key][kMaxG]
  float* cs = ps + kMaxPage * kMaxG;                              // [kMaxG]
  const int page16 = (page + 15) & ~15;  // a page's keys in whole mma k-steps

  // K and V rows of one page for this kv head; rows page..page16-1 are
  // zero-filled, so the tensor cores never multiply stale shared memory
  auto load_page = [&](int stage, int j) {
    int pid = page_table[static_cast<int64_t>(b) * Pmax + j];
    if (pid < 0 || pid >= N) pid = 0;  // never read outside the pool
    const int64_t base = (static_cast<int64_t>(pid) * page * Hkv + kvh) * kD;
    bf16* ks = k_st + stage * kPageElems;
    bf16* vs = v_st + stage * kPageElems;
    for (int c = tid; c < page16 * (kD / 8); c += kThreads) {
      const int t = c / (kD / 8);
      const int dc = (c % (kD / 8)) * 8;
      const bool valid = t < page;
      const int64_t off = valid ? base + static_cast<int64_t>(t) * Hkv * kD + dc : 0;
      cp_async16(ks + t * kStride + dc, k_pool + off, valid);
      cp_async16(vs + t * kStride + dc, v_pool + off, valid);
    }
    cp_async_commit();
  };

  load_page(0, p_lo);
  // the query as the mma's A operand: row grp is head grp (rows G..15 are
  // zero); this lane holds dims kk*16 + tig*2 (+1) and kk*16 + 8 + tig*2 (+1)
  uint32_t qa[kD / 16][2];
  {
    const bf16* qrow = q + ((static_cast<int64_t>(b) * Qmax + i) * Hq + kvh * G + grp) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][0] = grp < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + tig * 2) : 0u;
      qa[kk][1] = grp < G ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8 + tig * 2)
                          : 0u;
    }
  }

  // warp w keeps the running max and sum of heads w and w + 4; lane (grp,
  // tig) of warp w accumulates head grp at dims 16p + 8u + tig*2 (+1) of
  // its pairs p = w * kPairsPerWarp + pp (pp < kPairsPerWarp, p < kPairs)
  constexpr int kPPW = S::kPairsPerWarp;
  const int pair0 = warp * kPPW;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float o[2 * kPPW][2];
#pragma unroll
  for (int n = 0; n < 2 * kPPW; ++n) o[n][0] = o[n][1] = 0.f;

  for (int j = p_lo; j <= p_hi; ++j) {
    const int stage = (j - p_lo) & 1;
    if (j < p_hi) {
      load_page(stage ^ 1, j + 1);
    } else {
      cp_async_commit();  // empty group: wait_group 1 then waits for page j
    }
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks = k_st + stage * kPageElems;
    const bf16* vs = v_st + stage * kPageElems;
    const int k0 = j * page;

    // S = Q K^T: warp w scores keys 16w .. 16w+15 (two n-tiles of 8), each
    // 16-dim product started from a zero accumulator and added in IEEE f32
    if (16 * warp < page) {
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* kp = ks + (16 * warp + 8 * nt + grp) * kStride + kk * 16 + tig * 2;
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(t4, a, *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = __fadd_rn(sc[nt][e], t4[e]);
        }
      }
      if (grp < G) {  // accumulator rows grp + 8 are padding
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 16 * warp + 8 * nt + tig * 2 + e;
            const int kpos = k0 + t;
            if (t < page)
              ps[t * kMaxG + grp] = kpos < kmax && (window <= 0 || kpos > qpos - window)
                                        ? __fmul_rn(sc[nt][e], scale) : kNegInf;
          }
      }
    }
    __syncthreads();

    // online softmax: warp w updates heads w and w + 4 (keys lane, lane+32)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = warp + 4 * h;
      if (g >= G) break;
      const bool in0 = lane < page, in1 = lane + 32 < page;
      const float s0 = in0 ? ps[lane * kMaxG + g] : kNegInf;
      const float s1 = in1 ? ps[(lane + 32) * kMaxG + g] : kNegInf;
      const float m_new = fmaxf(m_run[h], warp_max(fmaxf(s0, s1)));
      // a head with no visible key yet sits at the floor: it carries no
      // mass, so its correction is 0 (never exp(0) = 1 on garbage)
      const float corr = m_new > 0.5f * kNegInf ? expf(__fsub_rn(m_run[h], m_new)) : 0.f;
      const float p0 = s0 > 0.5f * kNegInf ? expf(__fsub_rn(s0, m_new)) : 0.f;
      const float p1 = s1 > 0.5f * kNegInf ? expf(__fsub_rn(s1, m_new)) : 0.f;
      if (in0) ps[lane * kMaxG + g] = p0;
      if (in1) ps[(lane + 32) * kMaxG + g] = p1;
      l_run[h] = __fadd_rn(__fmul_rn(l_run[h], corr), warp_sum(__fadd_rn(p0, p1)));
      m_run[h] = m_new;
      if (lane == 0) cs[g] = corr;
    }
    __syncthreads();

    // O = O * corr + P V: warp w owns its pairs of n-tiles of 8 dims; P as
    // hi + mid + lo bf16 terms, each 16-key product started from zero and
    // added in IEEE f32
    if (grp < G) {
      const float corr = cs[grp];
#pragma unroll
      for (int n = 0; n < 2 * kPPW; ++n) {
        o[n][0] = __fmul_rn(o[n][0], corr);
        o[n][1] = __fmul_rn(o[n][1], corr);
      }
    }
    const int mat = lane >> 3;
    const bf16* vrow = vs + ((lane & 7) + (mat & 1) * 8) * kStride + (mat >> 1) * 8 + 16 * pair0;
    for (int jj = 0; jj < page16 / 16; ++jj) {
      // A: row grp (head grp) at keys 16jj + tig*2 (+1), 16jj + 8 + tig*2 (+1)
      float pk[4] = {0.f, 0.f, 0.f, 0.f};
      if (grp < G) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * jj + (e >> 1) * 8 + tig * 2 + (e & 1);
          pk[e] = t < page ? ps[t * kMaxG + grp] : 0.f;
        }
      }
      uint32_t a_hi[4] = {0u, 0u, 0u, 0u}, a_mid[4] = {0u, 0u, 0u, 0u},
               a_lo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a[0]: keys tig*2 (+1); a[2]: keys 8 + tig*2 (+1)
        const float p0 = pk[2 * h], p1 = pk[2 * h + 1];
        const float h0f = bf16_round(p0), h1f = bf16_round(p1);
        const float m0 = bf16_round(p0 - h0f), m1 = bf16_round(p1 - h1f);
        a_hi[2 * h] = pack_bf16(h0f, h1f);
        a_mid[2 * h] = pack_bf16(m0, m1);
        a_lo[2 * h] = pack_bf16(p0 - h0f - m0, p1 - h1f - m1);
      }
#pragma unroll
      for (int pp = 0; pp < kPPW; ++pp) {
        if (pair0 + pp >= S::kPairs) break;  // warp-uniform
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + jj * 16 * kStride + pp * 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(t4, a_lo, bv[2 * u], bv[2 * u + 1]);
          mma_bf16(t4, a_mid, bv[2 * u], bv[2 * u + 1]);
          mma_bf16(t4, a_hi, bv[2 * u], bv[2 * u + 1]);
          o[2 * pp + u][0] = __fadd_rn(o[2 * pp + u][0], t4[0]);
          o[2 * pp + u][1] = __fadd_rn(o[2 * pp + u][1], t4[1]);
        }
      }
    }
    __syncthreads();  // the stage, ps and cs are consumed before refilled
  }

  if (grp < G) {
#pragma unroll
    for (int n = 0; n < 2 * kPPW; ++n)
      if (pair0 + n / 2 < S::kPairs)
        *reinterpret_cast<float2*>(acc_out + grp * kD + 16 * pair0 + 8 * n + tig * 2) =
            make_float2(o[n][0], o[n][1]);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = warp + 4 * h;
      if (g < G) {
        ml[2 * g] = m_run[h];
        ml[2 * g + 1] = l_run[h];
      }
    }
  }
}

// grid: (B, Hkv, n_split); block: kThreads. Block (b, kvh, s) computes
// split s of each decode-path position of row b in turn (decode: the row's
// one query; ragged: each position of a short span), every position by the
// same walk whatever the entry point. q is [B, Qmax, Hq, D] (decode passes
// Qmax = n_pos = 1); slot (b * n_pos + i, kvh, s) of the scratch holds the
// partial.
template <int kD>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ hist_or_len, const int* __restrict__ q_lens,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Qmax,
    int n_pos, int Hq, int Hkv, int N, int page, int Pmax, int n_split,
    int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int n_i = row_positions(q_lens, b, Qmax);
  for (int i = 0; i < n_i; ++i) {
    const int len = position_length(hist_or_len, q_lens, b, i);
    if (static_cast<int>(blockIdx.z) >= n_splits(len, page, Pmax)) continue;
    split_position<kD>(q, k_pool, v_pool, page_table, part_acc, part_ml, smem, b, i,
                   blockIdx.y, blockIdx.z, len, Qmax, n_pos, Hq, Hkv, N, page, Pmax,
                   n_split, window, scale);
  }
}

// grid: (B * n_pos, Hkv); block: kThreads (thread t = output dims t + 128i);
// dynamic shared memory: 2 * kMaxG * n_split floats. Merges the partials of
// decode-path position i of row b in split order 0..n-1 against their
// common max M: warp w finds M for heads w, w + 4 with its lanes over the
// splits, and each split's correction c_s = exp(m_s - M) and l_s * c_s;
// lane 0 sums l in split order; then thread t sums acc_s[t] * c_s in split
// order. An empty partial (m at the floor) has c_s = 0 and is skipped, its
// acc never used. Every load of a sum is issued before its additions.
template <int kD>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const int* __restrict__ hist_or_len, const int* __restrict__ q_lens,
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    bf16* __restrict__ out, int Qmax, int n_pos, int Hq, int Hkv, int page,
    int Pmax, int n_split) {
  extern __shared__ float comb_s[];  // corrections, then l * correction: [kMaxG][n_split] each
  __shared__ float l_tot[kMaxG];
  const int b = blockIdx.x / n_pos;
  const int i = blockIdx.x % n_pos;
  const int kvh = blockIdx.y;
  if (i >= row_positions(q_lens, b, Qmax)) return;
  const int n = n_splits(position_length(hist_or_len, q_lens, b, i), page, Pmax);
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t slot0 = ((static_cast<int64_t>(b) * n_pos + i) * Hkv + kvh) * n_split;
  const float* ml = part_ml + slot0 * G * 2;
  const float* pacc = part_acc + slot0 * G * kD;
  float* corr_s = comb_s;
  float* lc_s = comb_s + kMaxG * n_split;

  for (int g = warp; g < G; g += kThreads / 32) {
    float M = kNegInf;
    for (int s = lane; s < n; s += 32) M = fmaxf(M, ml[(s * G + g) * 2]);
    M = warp_max(M);
    for (int s = lane; s < n; s += 32) {
      const float ms = ml[(s * G + g) * 2];
      const float c = ms > 0.5f * kNegInf ? expf(__fsub_rn(ms, M)) : 0.f;
      corr_s[g * n_split + s] = c;
      lc_s[g * n_split + s] = c != 0.f ? __fmul_rn(ml[(s * G + g) * 2 + 1], c) : 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      float L = 0.f;
      for (int s = 0; s < n; ++s)
        if (corr_s[g * n_split + s] != 0.f) L = __fadd_rn(L, lc_s[g * n_split + s]);
      l_tot[g] = L;
    }
  }
  __syncthreads();

  bf16* orow = out + ((static_cast<int64_t>(b) * Qmax + i) * Hq + kvh * G) * kD;
  for (int g = 0; g < G; ++g) {
    for (int d = tid; d < kD; d += kThreads) {
      float a = 0.f;
      for (int s0 = 0; s0 < n; s0 += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)  // an empty partial's acc is loaded, never used
          v[j] = s0 + j < n ? pacc[((s0 + j) * G + g) * kD + d] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float c = s0 + j < n ? corr_s[g * n_split + s0 + j] : 0.f;
          if (c != 0.f) a = __fadd_rn(a, __fmul_rn(v[j], c));
        }
      }
      orow[g * kD + d] = __float2bfloat16_rn(__fdiv_rn(a, fmaxf(l_tot[g], 1e-30f)));
    }
  }
}

// Span positions [pos0, pos0 + P) of row b for kv head kvh, P = 64 / G:
// 64 (position, head) rows on 4 warps x 16 rows.
template <int kD>
__device__ __forceinline__ void chunk_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ hist, const int* __restrict__ q_lens,
    bf16* __restrict__ out, unsigned char* smem, int pos0, int b, int kvh, int Qmax,
    int Hq, int Hkv, int N, int page, int page_shift, int Pmax, int window,
    float scale) {
  using S = Dims<kD>;
  constexpr int kStride = S::kStride;
  constexpr int kTileElems = S::kTileElems;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* tiles = qs + S::kQElems;

  const int G = Hq / Hkv;
  const int P = kRows / G;     // span positions per block
  const int R = P * G;         // rows in use (64 unless G does not divide 64)
  const int qlen = min(q_lens[b], Qmax);
  const int h0 = hist[b];
  const int kcap = Pmax * page;  // keys the page table can hold
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;   // mma row group
  const int tig = lane & 3;    // thread in group

  const int last_key = min(h0 + min(qlen, pos0 + P) - 1, kcap - 1);
  const int first_key = window > 0 ? max(0, h0 + pos0 - window + 1) : 0;
  if (qlen <= kShortSpan || pos0 >= qlen || last_key < first_key) {
    // nothing to attend: zeros for this block's positions past the span (a
    // short span's own positions are combine_kernel's) and, in the
    // degenerate case of keys past the table, for its valid ones
    const int zero_from = qlen <= kShortSpan ? qlen : 0;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int c = tid; c < R * (kD / 8); c += kThreads) {
      const int r = c / (kD / 8);
      const int pi = pos0 + r / G;
      if (pi >= Qmax || pi < zero_from) continue;
      const int64_t off = ((static_cast<int64_t>(b) * Qmax + pi) * Hq + kvh * G + r % G) * kD
                          + (c % (kD / 8)) * 8;
      *reinterpret_cast<uint4*>(out + off) = z;
    }
    return;
  }

  // this thread's two rows of the warp's m16 tile: r = warp*16 + grp (+8)
  int qpos[2];
  bool row_out[2], row_valid[2];
  int64_t qoff[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int r = warp * 16 + grp + 8 * ii;
    const int pi = pos0 + r / G;
    row_out[ii] = r < R && pi < Qmax;
    row_valid[ii] = r < R && pi < qlen;
    qpos[ii] = row_valid[ii] ? h0 + pi : -1;  // -1: sees no key
    qoff[ii] = ((static_cast<int64_t>(b) * Qmax + pi) * Hq + kvh * G + r % G) * kD;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // the block's Q rows into shared memory (their cp.async copies join the
  // first K/V tile's group)
  for (int c = tid; c < kRows * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8);
    const int dc = (c % (kD / 8)) * 8;
    const int pi = pos0 + r / G;
    const bool valid = r < R && pi < qlen;
    const int64_t off = valid
        ? ((static_cast<int64_t>(b) * Qmax + pi) * Hq + kvh * G + r % G) * kD + dc : 0;
    cp_async16(qs + r * kStride + dc, q + off, valid);
  }
  // this lane's row address for the A-fragment ldmatrix of the warp's rows
  const bf16* qrow = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride
                     + (lane >> 4) * 8;

  const int t_lo = first_key / kBK;
  const int t_hi = last_key / kBK;

  // one 64-key tile at absolute keys [t*64, t*64+64), each key read
  // through the page table; keys past the table are zero-filled and masked.
  // This thread copies the 16-byte pieces tid + kThreads * c of a tile (key
  // piece / (D/8), dims 8 * (piece % (D/8)) ..); their pool rows for the
  // next tile are read one tile ahead, so the page-table reads wait behind a
  // tile of arithmetic, not before a copy.
  constexpr int kPieces = S::kPieces;
  int pool_row[kPieces];  // the key's row in the pool (page * page size + offset), -1 past the table
  auto fetch_rows = [&](int t) {
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int key = t * kBK + (tid + kThreads * c) / (kD / 8);
      int row = -1;
      if (key < kcap) {
        const int pg = page_shift >= 0 ? key >> page_shift : key / page;
        int pid = page_table[static_cast<int64_t>(b) * Pmax + pg];
        if (pid < 0 || pid >= N) pid = 0;  // never read outside the pool
        row = pid * page + key - pg * page;
      }
      pool_row[c] = row;
    }
  };
  auto load_tile = [&](int stage, int t) {
    bf16* ks = tiles + stage * 2 * kTileElems;
    bf16* vs = ks + kTileElems;
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int piece = tid + kThreads * c;
      const int dc = (piece % (kD / 8)) * 8;
      const bool valid = pool_row[c] >= 0;
      const int64_t off =
          valid ? (static_cast<int64_t>(pool_row[c]) * Hkv + kvh) * kD + dc : 0;
      const int row = (piece / (kD / 8)) * kStride + dc;
      cp_async16(ks + row, k_pool + off, valid);
      cp_async16(vs + row, v_pool + off, valid);
    }
    cp_async_commit();
    if (t < t_hi) fetch_rows(t + 1);
  };

  fetch_rows(t_lo);
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
    const bf16* ks = tiles + stage * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
    const int kt0 = t * kBK;

    // S = Q K^T: 8 n-tiles of 8 keys, each 16-dim product started from a
    // zero accumulator and added in IEEE f32
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
        const bf16* kp = ks + (n * 8 + grp) * kStride + kk * 16 + tig * 2;
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
        const int ii = e >> 1;
        const int key = kt0 + n * 8 + tig * 2 + (e & 1);
        const bool ok = key <= qpos[ii] && key < kcap &&
                        (window <= 0 || key > qpos[ii] - window);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        vis |= static_cast<uint32_t>(ok) << (n * 4 + e);
        mx[ii] = fmaxf(mx[ii], s[n][e]);
      }
    }
    float corr[2], m_new[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(kFull, mx[ii], 1));
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(kFull, mx[ii], 2));
      m_new[ii] = fmaxf(m[ii], mx[ii]);
      corr[ii] = expf(m[ii] - m_new[ii]);
      m[ii] = m_new[ii];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        s[n][e] = (vis >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_new[ii]) : 0.f;
        ls[ii] += s[n][e];
      }
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      ls[ii] += __shfl_xor_sync(kFull, ls[ii], 1);
      ls[ii] += __shfl_xor_sync(kFull, ls[ii], 2);
      l[ii] = l[ii] * corr[ii] + ls[ii];
    }
    // O = O * corr + P V, P as hi + mid + lo bf16 terms, in 4 steps of 16
    // keys, each 16-key product started from zero and added in IEEE f32
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    // V rows of the tile through a transposing ldmatrix: lane supplies the
    // row address of matrix lane/8, keys + (mat & 1) * 8, dims + (mat >> 1) * 8
    const int mat = lane >> 3;
    const bf16* vrow = vs + ((lane & 7) + (mat & 1) * 8) * kStride + (mat >> 1) * 8;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a_hi[4], a_mid[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // n-tile 2j + h: keys 16j + 8h ..
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) { // rows grp, grp+8
          const float p0 = s[2 * j + h][2 * ii];
          const float p1 = s[2 * j + h][2 * ii + 1];
          const float h0f = bf16_round(p0), h1f = bf16_round(p1);
          const float m0 = bf16_round(p0 - h0f), m1 = bf16_round(p1 - h1f);
          a_hi[2 * h + ii] = pack_bf16(h0f, h1f);
          a_mid[2 * h + ii] = pack_bf16(m0, m1);
          a_lo[2 * h + ii] = pack_bf16(p0 - h0f - m0, p1 - h1f - m1);
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

  // epilogue: rows past q_len are zeros; rows past Qmax are not written
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    if (!row_out[ii]) continue;
    const float denom = fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float x0 = row_valid[ii] ? o[n][2 * ii] / denom : 0.f;
      const float x1 = row_valid[ii] ? o[n][2 * ii + 1] / denom : 0.f;
      *reinterpret_cast<uint32_t*>(out + qoff[ii] + n * 8 + tig * 2) = pack_bf16(x0, x1);
    }
  }
}

// grid: (ceil(Qmax / P), Hkv, B), the span's latest (heaviest) tiles
// first; block: 128 threads.
template <int kD>
__global__ void __launch_bounds__(kThreads) chunk_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ hist, const int* __restrict__ q_lens,
    bf16* __restrict__ out, int Qmax, int Hq, int Hkv, int N, int page,
    int page_shift, int Pmax, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = kRows / (Hq / Hkv);
  chunk_tile<kD>(q, k_pool, v_pool, page_table, hist, q_lens, out, smem,
             (gridDim.x - 1 - blockIdx.x) * P, blockIdx.z, blockIdx.y, Qmax, Hq, Hkv,
             N, page, page_shift, Pmax, window, scale);
}

int set_smem(const void* fn, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

bool args_ok(int Hq, int Hkv, int page) {
  return page > 0 && page <= kMaxPage && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= kMaxG;
}

int n_split_of(int Pmax) { return (Pmax + kSplitPages - 1) / kSplitPages; }

// log2(page) for a power-of-two page (the chunk path then finds a key's
// page with a shift), else -1
int page_shift_of(int page) {
  if (page & (page - 1)) return -1;
  int shift = 0;
  while ((1 << shift) < page) ++shift;
  return shift;
}

// The decode path over the n_pos positions of B rows: split_kernel then
// combine_kernel. scratch: f32, B * n_pos * Hkv * n_split * G * (D + 2).
template <int kD>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const int* page_table, const int* hist_or_len, const int* q_lens,
                 void* out, float* scratch, int B, int Qmax, int n_pos, int Hq,
                 int Hkv, int N, int page, int Pmax, int window, float scale,
                 cudaStream_t stream) {
  constexpr int kSplitSmem = Dims<kD>::kSplitSmem;
  static bool smem_set = false;
  const int rc = set_smem(reinterpret_cast<const void*>(split_kernel<kD>), kSplitSmem, smem_set);
  if (rc != 0) return rc;
  const int n_split = n_split_of(Pmax);
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<int64_t>(B) * n_pos * Hkv * n_split * (Hq / Hkv) * kD;
  if (n_split > 0) {  // else no key: the combine writes zeros
    split_kernel<kD><<<dim3(B, Hkv, n_split), kThreads, kSplitSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
        static_cast<const bf16*>(v_pool), page_table, hist_or_len, q_lens, part_acc,
        part_ml, Qmax, n_pos, Hq, Hkv, N, page, Pmax, n_split, window, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int combine_smem = 2 * kMaxG * (n_split > 0 ? n_split : 1) * 4;
  if (combine_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        combine_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, combine_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  combine_kernel<kD><<<dim3(B * n_pos, Hkv), kThreads, combine_smem, stream>>>(
      hist_or_len, q_lens, part_acc, part_ml, static_cast<bf16*>(out), Qmax, n_pos,
      Hq, Hkv, page, Pmax, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_ragged(const void* q, const void* k_pool, const void* v_pool,
                  const int* page_table, const int* hist, const int* q_lens, void* out,
                  void* scratch, int B, int Qmax, int Hq, int Hkv, int N, int page,
                  int Pmax, int window, float scale, cudaStream_t st) {
  constexpr int kChunkSmem = Dims<kD>::kChunkSmem;
  static bool smem_set = false;
  int rc = set_smem(reinterpret_cast<const void*>(chunk_kernel<kD>), kChunkSmem, smem_set);
  if (rc != 0) return rc;
  const int P = kRows / (Hq / Hkv);
  chunk_kernel<kD><<<dim3((Qmax + P - 1) / P, Hkv, B), kThreads, kChunkSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), page_table, hist, q_lens,
      static_cast<bf16*>(out), Qmax, Hq, Hkv, N, page, page_shift_of(page), Pmax,
      window, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n_pos = Qmax < kShortSpan ? Qmax : kShortSpan;
  return launch_split<kD>(q, k_pool, v_pool, page_table, hist, q_lens, out,
                          static_cast<float*>(scratch), B, Qmax, n_pos, Hq, Hkv, N, page,
                          Pmax, window, scale, st);
}

// ------------------------------------------------------------------ f32
// grid: (B * n_pos, Hq); block: f32attn::kThreads. Position i of row b
// (decode: q_lens null, n_pos = Qmax = 1, the row's length; ragged: hist +
// i + 1 for i < q_len, zeros past it) for query head h, over the row's
// page chain.
template <int kD>
__global__ void __launch_bounds__(f32attn::kThreads) paged_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ hist_or_len, const int* __restrict__ q_lens,
    float* __restrict__ out, int Qmax, int Hq, int Hkv, int N, int page, int Pmax,
    int window, float scale) {
  const int b = blockIdx.x / Qmax;
  const int i = blockIdx.x % Qmax;
  const int h = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int64_t qoff = ((static_cast<int64_t>(b) * Qmax + i) * Hq + h) * kD;
  if (q_lens != nullptr && i >= q_lens[b]) {
    f32attn::zero_row<kD>(out + qoff);
    return;
  }
  const int len = position_length(hist_or_len, q_lens, b, i);
  const int qpos = len - 1;
  const int first = window > 0 ? max(0, qpos - window + 1) : 0;
  const int last = min(qpos, Pmax * page - 1);
  const int* table = page_table + static_cast<int64_t>(b) * Pmax;
  const auto row_of = [&](int key) -> int64_t {
    const int pg = key / page;
    int pid = table[pg];
    if (pid < 0 || pid >= N) pid = 0;  // never read outside the pool
    return ((static_cast<int64_t>(pid) * page + key - pg * page) * Hkv + kvh) * kD;
  };
  f32attn::attend_row<kD>(q + qoff, k_pool, v_pool, out + qoff, first, last, row_of, scale);
}

template <int kD>
int launch_f32(const void* q, const void* k_pool, const void* v_pool, const int* page_table,
               const int* hist_or_len, const int* q_lens, void* out, int B, int Qmax,
               int Hq, int Hkv, int N, int page, int Pmax, int window, float scale,
               cudaStream_t st) {
  paged_f32_kernel<kD><<<dim3(B * Qmax, Hq), f32attn::kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), page_table, hist_or_len, q_lens,
      static_cast<float*>(out), Qmax, Hq, Hkv, N, page, Pmax, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn<D>(args...) for a head dim of the model registry.
#define PAGED_DISPATCH_D(D, fn, ...)                               \
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

// Pages per split and the longest span the ragged entry sends through the
// split path (the wrapper sizes the scratch from the first).
int paged_attention_split_pages() { return kSplitPages; }
int paged_attention_short_span() { return kShortSpan; }

// q/out [B, Qmax, Hq, D] bf16; pools [N, page, Hkv, D] bf16, D in {16, 64,
// 96, 128, 256}; page_table [B, Pmax], hist [B], q_lens [B] int32; scratch
// f32 of B * min(Qmax, 8) * Hkv * ceil(Pmax / split_pages) * (Hq/Hkv) * (D + 2).
// Returns a cudaError_t.
int ragged_paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                const int* page_table, const int* hist,
                                const int* q_lens, void* out, void* scratch, int B,
                                int Qmax, int Hq, int Hkv, int N, int page, int Pmax,
                                int D, int window, float scale, void* stream) {
  if (B <= 0 || Qmax <= 0) return 0;
  if (!args_ok(Hq, Hkv, page)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH_D(D, launch_ragged, q, k_pool, v_pool, page_table, hist, q_lens, out,
                   scratch, B, Qmax, Hq, Hkv, N, page, Pmax, window, scale, st)
}

// q/out [B, Hq, D] bf16; lengths [B] int32 (the current token included);
// scratch f32 of B * Hkv * ceil(Pmax / split_pages) * (Hq/Hkv) * (D + 2).
int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                const int* page_table, const int* lengths, void* out,
                                void* scratch, int B, int Hq, int Hkv, int N, int page,
                                int Pmax, int D, int window, float scale, void* stream) {
  if (B <= 0) return 0;
  if (!args_ok(Hq, Hkv, page)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH_D(D, launch_split, q, k_pool, v_pool, page_table, lengths, nullptr, out,
                   static_cast<float*>(scratch), B, 1, 1, Hq, Hkv, N, page, Pmax, window,
                   scale, st)
}

// The same two entry points for f32 q, pools and out (no scratch).
int ragged_paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                               const int* page_table, const int* hist, const int* q_lens,
                               void* out, int B, int Qmax, int Hq, int Hkv, int N, int page,
                               int Pmax, int D, int window, float scale, void* stream) {
  if (B <= 0 || Qmax <= 0) return 0;
  if (!args_ok(Hq, Hkv, page)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH_D(D, launch_f32, q, k_pool, v_pool, page_table, hist, q_lens, out, B, Qmax,
                   Hq, Hkv, N, page, Pmax, window, scale, st)
}

int paged_decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                               const int* page_table, const int* lengths, void* out, int B,
                               int Hq, int Hkv, int N, int page, int Pmax, int D, int window,
                               float scale, void* stream) {
  if (B <= 0) return 0;
  if (!args_ok(Hq, Hkv, page)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH_D(D, launch_f32, q, k_pool, v_pool, page_table, lengths, nullptr, out, B, 1,
                   Hq, Hkv, N, page, Pmax, window, scale, st)
}

}  // extern "C"
