// Device code shared by the attention kernels of the port that read the
// paged pools tile by tile: csrc/fused_decode.cu (write + attention,
// kernels 1 and 5), csrc/paged_decode.cu (attention only, kernel 8) and
// csrc/ragged_attention.cu (decode and slice blocks, kernels 6 and 7).
//
// One decode body, decode_attend_split(): ONE block for one (decode row,
// KV head, one of S splits of the row's positions), the splits merged in
// the same launch by the last block to finish. It optionally writes the
// row's new K/V slice into its page, then runs GQA attention of the
// group's NREP query heads over positions [0, seq_len) read through the
// row's block table, with an f32 online softmax whose running max floors
// at -1e30. Its tiles run through attend_tiles(), which the ragged
// kernels' slice blocks share.
//
// Both are templated on the pool element T: __nv_bfloat16 (kernels 1, 6
// and 8) or int8_t (kernels 5 and 7). Over int8 pools each (position, KV
// head) has a bf16 scale in scale pools shaped (L, P, H_kv, page_size).
// An int8 tile lands with its 64 K and 64 V scales beside it and is
// converted to bf16 in shared memory (exact: |x| <= 128 fits bf16's 8
// significant bits), then runs through the same tensor-core products as
// a bf16 tile. The K scale multiplies the logit in f32, the V scale
// folds into the probability before it is rounded to bf16 for P V, and
// the softmax sum counts the unscaled probability (the TPU kernel's
// order), so no dequantized K/V ever reaches device memory.
//
// What bounds it: bytes. Decode attention does 4 * H * D flops per
// cached position against 2 * GD * 2 bytes of bf16 K/V (2 * GD + 4 * H_kv
// of int8 K/V and scales), 8 to 16 flops a byte, far below the ~295 at
// which an H100 turns compute-bound. Every cached K/V byte is read once:
// a block serves all NREP query heads of its group from the same tile
// (GQA index h = g * NREP + r, no block-diagonal q as on the TPU), and a
// long row is spread over many SMs.
//
// The write-then-read hazard: split 0 writes only its own head's slice of
// the row (over int8 pools also its two scales), and the block that
// covers position seq_len - 1 takes it from the new row, never from the
// pools, so no block waits on another's write. A row with seq_len == 0
// attends to nothing and returns zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace llmq {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
struct is_int8 {
  static constexpr bool value = false;
};
template <>
struct is_int8<int8_t> {
  static constexpr bool value = true;
};

// Index of the scale of (layer, page, KV head g, slot) in a
// (L, P, H_kv, page_size) scale pool.
__device__ __forceinline__ size_t scale_index(int layer, int page, int g,
                                              int slot, int num_pages,
                                              int n_kv_heads, int page_size) {
  return (((size_t)layer * num_pages + page) * n_kv_heads + g) * page_size +
         slot;
}

// The bf16 scales of int8 pools: the (L, P, H_kv, ps) scale pools and the
// new row's K and V scale for the block's head (nullptr without a new
// row). All nullptr for bf16 pools.
struct Scales {
  __nv_bfloat16* k_pool;
  __nv_bfloat16* v_pool;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
};

// Four int8 values (one word, the first in the low byte) as four bf16,
// exactly: byte x + 128 becomes the low mantissa byte of the float
// 2^23 + x + 128, from which 2^23 + 128 is subtracted.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + i)) -
           8388736.f;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// ---- split-K tile machinery ------------------------------------------------
//
// attend_tiles() runs online-softmax attention of NQ query columns of one
// KV head over a range of positions, 64 positions (a tile) at a time, on
// the tensor cores. The decode body below (NQ = the group's NREP query
// heads) and the slice blocks of csrc/ragged_attention.cu (NQ = 8 tokens
// x NREP heads) are built on it. Per tile:
// - the tile's K rows and V rows come in by cp.async (16 bytes a lane,
//   row addresses from the block table) into a two-stage ring, K and V
//   as two commit groups: tile i + 1 loads while tile i is used. A row's
//   16-byte chunk c lands at c ^ (position % 8) (% 4 for an int8 row of
//   64 bytes), so the reads below are free of bank conflicts;
// - int8 pools: once the tile has landed, one pass converts its K and V
//   rows into a bf16 K tile and V tile in the bf16 rows' swizzle, and
//   stores the tile's scales, loaded a tile ahead by plain loads into a
//   register (zero for a position past the range or on a page outside
//   [0, P): a stale NaN scale would survive the masked softmax as 0 *
//   NaN);
// - S^T (64 keys x NQ columns) = K Q^T, one mma.m16n8k16 per 16 keys, 16
//   dims and 8 columns, a warp per 16 keys; K from shared memory by
//   ldmatrix, the Q^T B fragments from the caller (registers or shared
//   memory; columns past NQ are zero). The mask is per (key, column): a
//   key past the range or on a page outside [0, P) never counts, and
//   column c sees positions up to last_pos(c) only. int8: the logit is
//   multiplied by its K scale here;
// - online softmax down each column, a warp per NQ / 4 columns (2 to 32
//   lanes a column, their keys in registers, shuffle reductions within
//   the column's lanes), with the probabilities stored as bf16 [NQ][64]
//   (int8: times their V scale; the sum counts them unscaled);
// - O^T (D x NQ) += V^T P^T, one mma per 16 dims, 16 positions and 8
//   columns; V^T from the V tile by ldmatrix.trans, P^T as B fragments
//   from shared memory; a warp owns D / 4 dims.
// Score and probability rows are padded (68 floats, 72 bf16) so the
// fragment stores and loads hit 32 distinct banks.

constexpr int kSplitTile = 64;     // positions per K/V tile
constexpr int kSplitThreads = 128;
constexpr int kScoreStride = kSplitTile + 4;  // floats per score row
constexpr int kProbStride = kSplitTile + 8;   // bf16 per probability row

// Bytes of dynamic shared memory attend_tiles() needs for NQ columns.
template <int D, int NQ, typename T>
__host__ __device__ constexpr int tiles_smem_bytes() {
  return 2 * 2 * kSplitTile * D * (int)sizeof(T)  // ring: K and V tiles
         + (is_int8<T>::value ? 2 * kSplitTile * D * 2  // converted K, V
                                    + 2 * kSplitTile * 4  // their scales
                              : 0)
         + NQ * kScoreStride * 4                  // scores (f32)
         + NQ * kProbStride * 2                   // probabilities (bf16)
         + 3 * NQ * 4 + 16;                       // m, l, alpha; flag
}

// The regions of attend_tiles()' shared memory.
struct TileSmem {
  uint32_t ring;         // shared-space address of the two-stage ring
  unsigned char* ring_p; // ... and its generic address
  uint32_t cvt;          // int8 pools: the converted bf16 K tile, then V
  unsigned char* cvt_p;
  float* scl;            // int8 pools: the tile's K scales [64], then V [64]
  float* sc;             // scores [NQ][kScoreStride]
  __nv_bfloat16* pb;     // probabilities [NQ][kProbStride]
  float* ml;             // per column: running max at [c], sum at [NQ + c]
  float* alpha;          // per column: the last tile's rescale factor
  int* flag;             // one int for the caller
};

template <int D, int NQ, typename T>
__device__ __forceinline__ TileSmem tile_smem(unsigned char* smem) {
  constexpr bool Q8 = is_int8<T>::value;
  constexpr int RING = 4 * kSplitTile * D * (int)sizeof(T);
  constexpr int CVT = Q8 ? 2 * kSplitTile * D * 2 : 0;
  TileSmem t;
  t.ring_p = smem;
  t.ring = (uint32_t)__cvta_generic_to_shared(smem);
  t.cvt_p = smem + RING;
  t.cvt = t.ring + RING;
  t.scl = reinterpret_cast<float*>(smem + RING + CVT);
  t.sc = t.scl + (Q8 ? 2 * kSplitTile : 0);
  t.pb = reinterpret_cast<__nv_bfloat16*>(t.sc + NQ * kScoreStride);
  t.ml = reinterpret_cast<float*>(t.pb + NQ * kProbStride);
  t.alpha = t.ml + 2 * NQ;
  t.flag = reinterpret_cast<int*>(t.alpha + NQ);
  return t;
}

__device__ __forceinline__ void split_cp16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void split_cp8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void split_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row major) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Attention of NQ query columns of KV head g over positions [c0, c1)
// (c0 < c1), called by every thread of a block of kSplitThreads threads.
// Leaves O^T unnormalised in o: o[mt][n][e] is (dim 16 (warp * MT + mt) +
// gq + 8 (e / 2), column 8 n + 2 tq + e % 2), gq = lane / 4, tq = lane % 4,
// MT = D / 64; and per column the running max at sm.ml[c] and the sum at
// sm.ml[NQ + c], visible to every thread on return.
//   kn, vn:      the new token's K/V slice for head g, read for position
//                sl - 1 in place of the pool, or nullptr (every position
//                from the pool)
//   scl:         int8 pools: the scale pools and, with kn, the new row's
//                scales
//   bt:          the sequence's block table
//   qfrag(kp, n, b): the Q^T B fragments of dims 32 kp ... 32 kp + 31 and
//                columns 8 n ... 8 n + 7: b[0], b[1] for the first 16
//                dims, b[2], b[3] for the next 16
//   last_pos(c): the last position column c sees
// cp.async copies the caller issued and did not commit ride in the first
// commit group (tile 0's K), so they have landed when tile 0 is scored.
template <int D, int NQ, typename T, typename QFrag, typename LastPos>
__device__ __forceinline__ void attend_tiles(
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const T* __restrict__ kn, const T* __restrict__ vn, const Scales& scl,
    const int* __restrict__ bt, int sl, int c0, int c1, int g, int layer,
    int num_pages, int page_size, int gd, float scale,
    const QFrag& qfrag, const LastPos& last_pos, const TileSmem& sm,
    float (&o)[D / 64][(NQ + 7) / 8][4]) {
  constexpr bool Q8 = is_int8<T>::value;
  // The ring holds pool rows; the products read bf16 rows: the ring's
  // own stage over bf16 pools, the converted tiles over int8 pools.
  constexpr int LROWB = D * (int)sizeof(T);  // bytes of one pool row
  constexpr int LCPR = LROWB / 16;           // 16-byte chunks per pool row
  constexpr int LEPC = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int LSWZ = LCPR >= 8 ? 7 : LCPR - 1;
  constexpr int LTILEB = kSplitTile * LROWB; // bytes of a ring K or V tile
  constexpr int ROWB = D * 2;                // bytes of one bf16 row
  constexpr int SWZ = 7;                     // ROWB / 16 >= 8 chunks
  constexpr int TILEB = kSplitTile * ROWB;   // bytes of a bf16 K or V tile
  constexpr int MT = D / 64;                 // P V: 16-dim tiles per warp
  constexpr int NF = (NQ + 7) / 8;           // 8-column fragments
  // Softmax layout: CPW columns a warp, LPC lanes a column, KPL keys a
  // lane (NQ is a power of two).
  constexpr int CPW = (NQ + kSplitThreads / 32 - 1) / (kSplitThreads / 32);
  constexpr int LPC = 32 / CPW;
  constexpr int KPL = kSplitTile / LPC;
  static_assert((NQ & (NQ - 1)) == 0 && CPW * LPC == 32 && KPL % 2 == 0,
                "softmax layout");
  static_assert(ROWB / 16 >= 8, "bf16 row swizzle");
  static_assert(!Q8 || kSplitThreads == 2 * kSplitTile,
                "one K or V scale a thread");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // mma fragment row group
  const int tq = lane % 4;  // ... and column pair
  const int mi = lane / 8;  // ldmatrix: which 8 x 8 matrix this lane names
  const int mr = lane % 8;  // ... and which of its rows
  const int n_tiles = (c1 - c0 + kSplitTile - 1) / kSplitTile;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;

  // K then V rows of tile `it` into its stage, two commit groups. A
  // thread copies chunk lc of PER positions; their block-table reads go
  // out together, once for K and V. Positions past c1 and pages outside
  // [0, P) are zero-filled; position sl - 1 comes from the new row.
  // Returns, over int8 pools, this thread's scale of the tile (K scales
  // on threads 0..63, V scales on 64..127, position p0 + tid % 64), zero
  // where the row is zero-filled.
  constexpr int PER = kSplitTile * LCPR / kSplitThreads;
  static_assert(kSplitThreads % LCPR == 0 && PER > 0, "loader layout");
  const int lc = tid % LCPR;
  const int lj = tid / LCPR;
  auto load = [&](int it) {
    const int p0 = c0 + it * kSplitTile;
    size_t off[PER];  // element offset of the row chunk; ~0 for zeros
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = p0 + lj + k * (kSplitThreads / LCPR);
      const int page = p < c1 ? bt[p / page_size] : -1;
      off[k] = page >= 0 && page < num_pages
                   ? (layer_row0 + (size_t)page * page_size + p % page_size) *
                             gd + g * D + lc * LEPC
                   : ~(size_t)0;
    }
    float s = 0.f;
    if constexpr (Q8) {
      const int p = p0 + tid % kSplitTile;
      const bool is_v = tid >= kSplitTile;
      if (p < c1) {
        if (kn != nullptr && p == sl - 1) {
          s = __bfloat162float(*(is_v ? scl.v_new : scl.k_new));
        } else {
          const int page = bt[p / page_size];
          if (page >= 0 && page < num_pages)
            s = __bfloat162float(
                (is_v ? scl.v_pool : scl.k_pool)[scale_index(
                    layer, page, g, p % page_size, num_pages, gd / D,
                    page_size)]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* pool = half ? v_pool : k_pool;
      const T* nrow = half ? vn : kn;
      const uint32_t base = sm.ring + ((it & 1) * 2 + half) * LTILEB;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = lj + k * (kSplitThreads / LCPR);
        const int p = p0 + j;
        const uint32_t dst = base + j * LROWB + ((lc ^ (j & LSWZ)) << 4);
        if (p < c1 && nrow != nullptr && p == sl - 1) {
          split_cp8(dst, nrow + lc * LEPC);
          split_cp8(dst + 8, nrow + lc * LEPC + LEPC / 2);
        } else {
          const bool ok = off[k] != ~(size_t)0;
          split_cp16(dst, pool + (ok ? off[k] : 0), ok ? 16 : 0);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    return s;
  };
  float s_next = load(0);

  if (tid < NQ) {
    sm.ml[tid] = -1e30f;
    sm.ml[NQ + tid] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NF; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  const float neg_inf = __int_as_float(0xff800000);

  for (int it = 0; it < n_tiles; ++it) {
    const bool more = it + 1 < n_tiles;
    [[maybe_unused]] const float s_cur = s_next;  // int8: this tile's
    if (more) s_next = load(it + 1);
    if constexpr (Q8) {  // K(it) and V(it) have landed
      if (more)
        split_wait<2>();
      else
        split_wait<0>();
    } else {  // K(it) has landed
      if (more)
        split_wait<3>();
      else
        split_wait<1>();
    }
    __syncthreads();
    uint32_t sK = sm.ring + (it & 1) * 2 * TILEB;
    if constexpr (Q8) {
      // int8 K and V rows → bf16 rows, one 16-byte bf16 chunk (8 values)
      // a step, and the tile's scales beside them.
      constexpr int UPR = D / 8;  // bf16 chunks per row
      constexpr int STEPS = 2 * kSplitTile * UPR / kSplitThreads;
      const unsigned char* src = sm.ring_p + (it & 1) * 2 * LTILEB;
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int u = tid + k * kSplitThreads;
        const int half = u / (kSplitTile * UPR);
        const int j = u / UPR % kSplitTile;
        const int c = u % UPR;
        const uint2 w = *reinterpret_cast<const uint2*>(
            src + half * LTILEB + j * LROWB + (((c >> 1) ^ (j & LSWZ)) << 4) +
            (c & 1) * 8);
        const uint2 lo = i8x4_to_bf16x4(w.x);
        const uint2 hi = i8x4_to_bf16x4(w.y);
        *reinterpret_cast<uint4*>(sm.cvt_p + half * TILEB + j * ROWB +
                                  ((c ^ (j & SWZ)) << 4)) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      sm.scl[tid] = s_cur;
      __syncthreads();
      sK = sm.cvt;
    }
    const uint32_t sV = sK + TILEB;
    const int p0 = c0 + it * kSplitTile;

    // 1. S^T = K Q^T for keys 16 warp ... 16 warp + 15.
    {
      float c[NF][4];
#pragma unroll
      for (int n = 0; n < NF; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
      const int key = 16 * warp + mr + (mi % 2) * 8;
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t a0[4], a1[4];
        ldsm_x4(sK + key * ROWB + (((4 * kp + mi / 2) ^ (key & SWZ)) << 4),
                a0);
        ldsm_x4(sK + key * ROWB +
                    (((4 * kp + 2 + mi / 2) ^ (key & SWZ)) << 4),
                a1);
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          uint32_t b[4];
          qfrag(kp, n, b);
          mma_bf16(c[n], a0, b[0], b[1]);
          mma_bf16(c[n], a1, b[2], b[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * warp + gq + 8 * half;
        const int p = p0 + j;
        bool ok = p < c1;
        if (ok && !(kn != nullptr && p == sl - 1)) {
          const int page = bt[p / page_size];
          ok = page >= 0 && page < num_pages;
        }
        float kscale = scale;
        if constexpr (Q8) kscale *= sm.scl[j];
#pragma unroll
        for (int n = 0; n < NF; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * tq + e;
            if (col < NQ)
              sm.sc[col * kScoreStride + j] =
                  ok && p <= last_pos(col) ? c[n][2 * half + e] * kscale
                                           : neg_inf;
          }
        }
      }
    }
    __syncthreads();

    // 2. Online softmax over the tile: warp w owns columns w CPW ...,
    //    LPC lanes a column, KPL consecutive keys a lane.
    if (warp * CPW < NQ) {
      const int r = warp * CPW + lane / LPC;
      const int k0 = (lane % LPC) * KPL;
      float sv[KPL];
      float mx = -1e30f;
#pragma unroll
      for (int i = 0; i < KPL; i += 2) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(sm.sc + r * kScoreStride + k0 + i);
        sv[i] = v2.x;
        sv[i + 1] = v2.y;
        mx = fmaxf(mx, fmaxf(v2.x, v2.y));
      }
#pragma unroll
      for (int o = LPC / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.ml[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; i += 2) {
        float e0 = __expf(sv[i] - m_new);
        float e1 = __expf(sv[i + 1] - m_new);
        sum += e0 + e1;
        if constexpr (Q8) {
          e0 *= sm.scl[kSplitTile + k0 + i];
          e1 *= sm.scl[kSplitTile + k0 + i + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(sm.pb + r * kProbStride + k0 + i) =
            __floats2bfloat162_rn(e0, e1);
      }
#pragma unroll
      for (int o = LPC / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane % LPC == 0) {
        const float a = __expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.ml[r] = m_new;
        sm.ml[NQ + r] = sm.ml[NQ + r] * a + sum;
      }
    }
    if constexpr (!Q8) {  // V(it) has landed
      if (more)
        split_wait<2>();
      else
        split_wait<0>();
    }
    __syncthreads();

    // 3. O^T += V^T P^T for dims 16 (warp * MT + mt) ....
    {
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const int col = 8 * n + 2 * tq;
        const float a0 = col < NQ ? sm.alpha[col] : 1.f;
        const float a1 = col + 1 < NQ ? sm.alpha[col + 1] : 1.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          o[mt][n][0] *= a0;
          o[mt][n][1] *= a1;
          o[mt][n][2] *= a0;
          o[mt][n][3] *= a1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kSplitTile / 16; ++ks) {
        uint32_t b[NF][2];
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          b[n][0] = b[n][1] = 0u;
          const int col = 8 * n + gq;
          if (col < NQ) {
            const __nv_bfloat16* pr =
                sm.pb + col * kProbStride + 16 * ks + 2 * tq;
            b[n][0] = *reinterpret_cast<const uint32_t*>(pr);
            b[n][1] = *reinterpret_cast<const uint32_t*>(pr + 8);
          }
        }
        const int pos = 16 * ks + mr + (mi / 2) * 8;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          const int ch = 2 * (warp * MT + mt) + mi % 2;
          ldsm_x4_t(sV + pos * ROWB + ((ch ^ (pos & SWZ)) << 4), a);
#pragma unroll
          for (int n = 0; n < NF; ++n) mma_bf16(o[mt][n], a, b[n][0], b[n][1]);
        }
      }
    }
    // The ring stage and the score buffers are free again. Over int8
    // pools no barrier is needed: P V read the converted tiles, and the
    // next tile writes them, its scales, scores and probabilities only
    // after its first barrier.
    if constexpr (!Q8) __syncthreads();
  }
}

// ---- the end of a split -----------------------------------------------------
//
// finish_split() turns one split's attend_tiles() result into output. A
// (row, head) that one split covers writes its output directly.
// Otherwise each split writes (acc[NQ][D], m[NQ], l[NQ]) to its slot of
// the f32 workspace, fences, and bumps the (row, head)'s arrival counter;
// the last to arrive merges the splits: per column, lanes over splits
// for the global max M and sum L, each split's weight exp(m - M) / L put
// back into its slot in place of m, then every element with its splits'
// loads in flight together. It writes the output and sets the counter
// back to 0, so the next launch finds it at 0 (workspace and counters
// are the wrapper's, allocated once per kernel and geometry: nothing is
// allocated or cleared per call).

// Floats of workspace one split of one (row, KV head) writes.
template <int D, int NQ>
__host__ __device__ constexpr int split_ws_floats() {
  return NQ * (D + 2);
}

//   o, sm:    attend_tiles()' result
//   ws:       the (row, head)'s workspace, n_splits * split_ws_floats()
//   counter:  the (row, head)'s arrival counter, 0 between launches
//   n_active: the splits that cover the (row, head)'s positions; at 1,
//             ws and counter are not touched (may be nullptr)
//   store(c, d, v): writes output element (column c, dim d) = v
template <int D, int NQ, typename Store>
__device__ __forceinline__ void finish_split(
    const float (&o)[D / 64][(NQ + 7) / 8][4], const TileSmem& sm, float* ws,
    int* counter, int split, int n_active, const Store& store) {
  constexpr int MT = D / 64;
  constexpr int NF = (NQ + 7) / 8;
  constexpr int WS = split_ws_floats<D, NQ>();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  // o[mt][n][e] is (dim 16 (warp * MT + mt) + gq (+8 for e >= 2), column
  // 8 n + 2 tq + e % 2).
  float* mine = ws + (size_t)split * WS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NF; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + e % 2;
        const int d = 16 * (warp * MT + mt) + gq + 8 * (e / 2);
        if (c >= NQ) continue;
        if (n_active == 1)
          store(c, d, o[mt][n][e] / fmaxf(sm.ml[NQ + c], 1e-30f));
        else
          __stcg(mine + c * D + d, o[mt][n][e]);
      }
    }
  }
  if (n_active == 1) return;
  for (int i = tid; i < 2 * NQ; i += kSplitThreads)
    __stcg(mine + NQ * D + i, sm.ml[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *sm.flag = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!*sm.flag) return;
  __threadfence();
  for (int c = warp; c < NQ; c += kSplitThreads / 32) {
    float mx = -1e30f;
    for (int s = lane; s < n_active; s += 32)
      mx = fmaxf(mx, __ldcg(ws + (size_t)s * WS + NQ * D + c));
    mx = warp_max(mx);
    float L = 0.f;
    for (int s = lane; s < n_active; s += 32) {
      const float* part = ws + (size_t)s * WS + NQ * D;
      L += __ldcg(part + NQ + c) * __expf(__ldcg(part + c) - mx);
    }
    const float inv = 1.f / fmaxf(warp_sum(L), 1e-30f);
    for (int s = lane; s < n_active; s += 32) {
      float* m = ws + (size_t)s * WS + NQ * D + c;
      __stcg(m, __expf(__ldcg(m) - mx) * inv);
    }
  }
  __threadfence_block();
  __syncthreads();
  constexpr int EPT = (NQ * D + kSplitThreads - 1) / kSplitThreads;
  constexpr int CH = EPT < 8 ? EPT : 8;  // elements in flight per thread
#pragma unroll 1
  for (int k0 = 0; k0 < EPT; k0 += CH) {
    float acc[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_active; ++s) {
      const float* part = ws + (size_t)s * WS;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int idx = tid + (k0 + k) * kSplitThreads;
        if (idx < NQ * D)
          acc[k] += __ldcg(part + idx) * __ldcg(part + NQ * D + idx / D);
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int idx = tid + (k0 + k) * kSplitThreads;
      if (idx < NQ * D) store(idx / D, idx % D, acc[k]);
    }
  }
  if (tid == 0) atomicExch(counter, 0);
}

// ---- split-K decode body ---------------------------------------------------
//
// decode_attend_split() spreads a row's positions over the S blocks of
// its (row, KV head): grid (B, H_kv, S) in kernels 1, 5 and 8, a range of
// the 1-D grid in kernels 6 and 7, S from host-known shapes, so the
// launch never reads seq_lens on the host. A row of kv_len positions is
// cut into chunks of ceil(kv_len / S) positions rounded up to the
// 64-position tile, so a short row takes a few one-tile blocks and a long
// one all S blocks, and many SMs stream one row's K/V at once. A chunk
// runs through attend_tiles() with the group's NREP query heads as its
// columns, q^T held in registers; a block whose chunk starts at or past
// kv_len exits at once, and finish_split() writes the output or merges
// the splits.

// Bytes of dynamic shared memory decode_attend_split() needs.
template <int D, int NREP, typename T>
__host__ __device__ constexpr int split_smem_bytes() {
  return tiles_smem_bytes<D, NREP, T>();
}

// One (row, KV head g, split) of decode attention; called by every
// thread of a block of kSplitThreads threads.
//   q_row:   the row's H query heads, (H, D)
//   kn, vn:  the row's new K/V slice for head g (D values), or nullptr
//            (kernel 8): then nothing is written and every position, the
//            newest included, is read from the pool
//   scl:     int8 pools: the scale pools and the new slice's two scales,
//            which split 0 writes beside the slice
//   bt:      the row's block table (max_pages,)
//   wp:      page the new K/V lands in (slot (sl - 1) % page_size)
//   out_row: the row's output, (H, D)
//   ws:      this (row, head)'s workspace, n_splits * split_ws_floats()
//   counter: this (row, head)'s arrival counter, 0 between launches
//   split, n_splits: this block's split and the (row, head)'s count
//   smem:    split_smem_bytes<D, NREP, T>() bytes, 16-byte aligned
template <int D, int NREP, typename T>
__device__ void decode_attend_split(
    const __nv_bfloat16* __restrict__ q_row, const T* __restrict__ kn,
    const T* __restrict__ vn, T* k_pool, T* v_pool, const Scales& scl,
    const int* __restrict__ bt, int sl, int wp,
    __nv_bfloat16* __restrict__ out_row, float* ws, int* counter, int g,
    int layer, int num_pages, int page_size, int max_pages, int gd,
    float scale, int split, int n_splits, unsigned char* smem) {
  constexpr int MT = D / 64;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;

  // 1. Split 0 writes this head's slice of the new token in place (and,
  //    over int8 pools, its two scales).
  if (split == 0 && kn != nullptr && sl > 0 && wp >= 0 && wp < num_pages) {
    const int slot = (sl - 1) % page_size;
    const size_t row = layer_row0 + (size_t)wp * page_size + slot;
    for (int i = tid; i < D; i += kSplitThreads) {
      k_pool[row * gd + g * D + i] = kn[i];
      v_pool[row * gd + g * D + i] = vn[i];
    }
    if constexpr (is_int8<T>::value) {
      if (tid == 0) {
        const size_t si =
            scale_index(layer, wp, g, slot, num_pages, gd / D, page_size);
        scl.k_pool[si] = *scl.k_new;
        scl.v_pool[si] = *scl.v_new;
      }
    }
  }
  const int kv_len = min(sl, max_pages * page_size);
  const int per = (kv_len + n_splits - 1) / n_splits;
  const int chunk = max(kSplitTile, (per + kSplitTile - 1) / kSplitTile *
                                        kSplitTile);
  const int c0 = split * chunk;
  __nv_bfloat16* o_row = out_row + (size_t)g * NREP * D;
  if (c0 >= kv_len) {
    if (split == 0)  // kv_len <= 0: nothing to attend to
      for (int i = tid; i < NREP * D; i += kSplitThreads)
        o_row[i] = __float2bfloat16(0.f);
    return;
  }
  const int c1 = min(c0 + chunk, kv_len);
  const int n_active = (kv_len + chunk - 1) / chunk;

  // q^T as B fragments: column gq is query head g * NREP + gq (zero past
  // NREP), rows 16 kk + 2 tq (+1, +8, +9) are dims.
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if (gq < NREP) {
      const __nv_bfloat16* qr = q_row + ((size_t)g * NREP + gq) * D + 16 * kk;
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(qr + 2 * tq);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 + 2 * tq);
    }
  }
  auto qfrag = [&](int kp, int, uint32_t (&b)[4]) {
    b[0] = qb[2 * kp][0];
    b[1] = qb[2 * kp][1];
    b[2] = qb[2 * kp + 1][0];
    b[3] = qb[2 * kp + 1][1];
  };
  auto every_pos = [](int) { return 0x7fffffff; };
  const TileSmem sm = tile_smem<D, NREP, T>(smem);
  float o[MT][1][4];
  attend_tiles<D, NREP, T>(k_pool, v_pool, kn, vn, scl, bt, sl, c0, c1, g,
                           layer, num_pages, page_size, gd, scale, qfrag,
                           every_pos, sm, o);
  finish_split<D, NREP>(o, sm, ws, counter, split, n_active,
                        [&](int r, int d, float v) {
                          o_row[r * D + d] = __float2bfloat16(v);
                        });
}

}  // namespace llmq
