// Device code shared by the decode-attention kernels of the port:
// csrc/fused_decode.cu (write + attention, bf16 and int8 pools),
// csrc/paged_decode.cu (attention only) and the decode blocks of
// csrc/ragged_attention.cu (bf16 and int8 pools).
//
// Two block bodies:
// - decode_attend(): ONE block for one (decode row, KV head), walking
//   every position of the row (kernels 5, 6, 7 and 8);
// - decode_attend_split(): ONE block for one (decode row, KV head, one
//   of S splits of the row's positions), the splits merged in the same
//   launch by the last block to finish (kernel 1 over bf16 pools).
// Both optionally write the row's new K/V slice into its page, then run
// GQA attention of the group's NREP query heads over positions
// [0, seq_len) read through the row's block table, with an f32 softmax
// whose running max floors at -1e30.
//
// The pool element T is __nv_bfloat16 or int8_t. With int8 pools each
// (position, KV head) has a bf16 scale in scale pools shaped
// (L, P, H_kv, page_size); the K scale multiplies the logit and the V
// scale folds into the probability before it weights V (the TPU
// kernel's order), so no dequantized K/V is ever stored. The block of
// head g also writes the new row's two scales.
//
// What bounds it: bytes. Decode attention does 4 * H * D flops per
// cached position against 2 * GD * 2 bytes of bf16 K/V (2 * GD + 4 of
// int8 K/V and scales), 8 to 16 flops a byte, far below the ~295 at
// which an H100 turns compute-bound. Both bodies read every cached K/V
// byte once: a block serves all NREP query heads of its group from the
// same load (GQA index h = g * NREP + r, no block-diagonal q as on the
// TPU), and the mask is the loop bound.
//
// The write-then-read hazard: a block writes only its own head's slice
// of the row and, when it has the new token (kn != nullptr), takes
// position seq_len - 1 from it, never from the pool, so no block waits
// on another's write. A row with seq_len == 0 attends to nothing and
// returns zeros.

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

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  // N consecutive bf16 values, N in {2, 4}: one 4- or 8-byte load.
  if constexpr (N == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h[0]);
    float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// N consecutive pool values as floats, N in {2, 4}: one 2- to 8-byte load.
template <int N>
__device__ __forceinline__ void load_kv(const __nv_bfloat16* p, float* out) {
  load_bf16<N>(p, out);
}

template <int N>
__device__ __forceinline__ void load_kv(const int8_t* p, float* out) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  }
}

// Index of the scale of (layer, page, KV head g, slot) in a
// (L, P, H_kv, page_size) scale pool.
__device__ __forceinline__ size_t scale_index(int layer, int page, int g,
                                              int slot, int num_pages,
                                              int n_kv_heads, int page_size) {
  return (((size_t)layer * num_pages + page) * n_kv_heads + g) * page_size +
         slot;
}

// Floats of shared memory decode_attend() needs.
template <int D, int NREP, int WARPS>
__host__ __device__ constexpr int decode_smem_floats() {
  return WARPS * NREP * (D + 2);
}

// One (row, KV head g) of decode attention; called by every thread of a
// block of WARPS * 32 threads. WARPS warps split the positions
// round-robin; a lane owns D / 32 contiguous dims, dot products reduce
// with warp shuffles, and each warp keeps its own online softmax, merged
// through shared memory at the end. Every position costs a chain of
// NREP shuffle reductions before the next one's loads, so at long
// contexts the body is bound by latency, not bytes.
//   q_row:    the row's H query heads, (H, D)
//   kn, vn:   the row's new K/V slice for head g (D values), or nullptr:
//             then nothing is written and every position is read from
//             the pool
//   kns, vns: int8 pools only: the new slice's bf16 scales (one value
//             each); ks_pool, vs_pool the scale pools. nullptr for bf16.
//   wp:       page the new K/V lands in (slot (sl - 1) % page_size)
//   bt:       the row's block table (max_pages,)
//   out_row:  the row's output, (H, D)
//   smem:     decode_smem_floats<D, NREP, WARPS>() floats
template <int D, int NREP, int WARPS, typename T>
__device__ void decode_attend(const __nv_bfloat16* __restrict__ q_row,
                              const T* __restrict__ kn,
                              const T* __restrict__ vn,
                              const __nv_bfloat16* __restrict__ kns,
                              const __nv_bfloat16* __restrict__ vns,
                              T* k_pool, T* v_pool, __nv_bfloat16* ks_pool,
                              __nv_bfloat16* vs_pool,
                              const int* __restrict__ bt, int sl, int wp,
                              __nv_bfloat16* __restrict__ out_row, int g,
                              int layer, int num_pages, int page_size,
                              int max_pages, int gd, float scale,
                              float* smem) {
  constexpr bool Q8 = is_int8<T>::value;
  constexpr int DPL = D / 32;  // dims per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hkv = gd / D;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;

  // 1. In-place write of this head's slice of the new token (and, for
  //    int8 pools, of its two scales).
  if (kn != nullptr && sl > 0 && wp >= 0 && wp < num_pages) {
    const int slot = (sl - 1) % page_size;
    const size_t row = layer_row0 + (size_t)wp * page_size + slot;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      k_pool[row * gd + g * D + i] = kn[i];
      v_pool[row * gd + g * D + i] = vn[i];
    }
    if constexpr (Q8) {
      if (threadIdx.x == 0) {
        const size_t si =
            scale_index(layer, wp, g, slot, num_pages, hkv, page_size);
        ks_pool[si] = *kns;
        vs_pool[si] = *vns;
      }
    }
  }

  // 2. Online-softmax attention over [0, kv_len), positions split
  //    round-robin over the warps.
  float qv[NREP][DPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    load_bf16<DPL>(q_row + (size_t)(g * NREP + r) * D + lane * DPL, qv[r]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) qv[r][i] *= scale;
  }
  float m[NREP], l[NREP], acc[NREP][DPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int kv_len = min(sl, max_pages * page_size);
  for (int p = warp; p < kv_len; p += WARPS) {
    const T* kp;
    const T* vp;
    float ksc = 1.f, vsc = 1.f;  // int8 pools: this position's scales
    if (kn != nullptr && p == sl - 1) {
      kp = kn;
      vp = vn;
      if constexpr (Q8) {
        ksc = __bfloat162float(*kns);
        vsc = __bfloat162float(*vns);
      }
    } else {
      const int page = bt[p / page_size];
      if (page < 0 || page >= num_pages) continue;
      const size_t row = layer_row0 + (size_t)page * page_size + p % page_size;
      kp = k_pool + row * gd + g * D;
      vp = v_pool + row * gd + g * D;
      if constexpr (Q8) {
        const size_t si = scale_index(layer, page, g, p % page_size,
                                      num_pages, hkv, page_size);
        ksc = __bfloat162float(ks_pool[si]);
        vsc = __bfloat162float(vs_pool[si]);
      }
    }
    float kf[DPL], vf[DPL];
    load_kv<DPL>(kp + lane * DPL, kf);
    load_kv<DPL>(vp + lane * DPL, vf);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qv[r][i] * kf[i];
      s = warp_sum(s);
      if constexpr (Q8) s *= ksc;
      const float m_new = fmaxf(m[r], s);
      const float alpha = __expf(m[r] - m_new);
      const float pe = __expf(s - m_new);
      l[r] = l[r] * alpha + pe;
      const float pv = Q8 ? pe * vsc : pe;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + pv * vf[i];
      m[r] = m_new;
    }
  }

  // 3. Merge the warps' partial softmaxes.
  float* sm_m = smem;                          // [WARPS][NREP]
  float* sm_l = sm_m + WARPS * NREP;           // [WARPS][NREP]
  float* sm_acc = sm_l + WARPS * NREP;         // [WARPS][NREP][D]
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      sm_m[warp * NREP + r] = m[r];
      sm_l[warp * NREP + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      sm_acc[(warp * NREP + r) * D + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NREP * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * NREP + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(sm_m[w * NREP + r] - mx);
      lsum += sm_l[w * NREP + r] * f;
      a += sm_acc[(w * NREP + r) * D + d] * f;
    }
    out_row[(size_t)(g * NREP + r) * D + d] =
        __float2bfloat16(a / fmaxf(lsum, 1e-30f));
  }
}

// ---- split-K body --------------------------------------------------------
//
// decode_attend_split() spreads a row's positions over the S blocks of
// its (row, KV head) (grid (B, H_kv, S), S from host-known shapes, so
// the launch never reads seq_lens on the host): a row of kv_len
// positions is cut into chunks of ceil(kv_len / S) positions rounded up
// to the 64-position tile, so a short row takes a few one-tile blocks and
// a long one all S blocks, and many SMs stream one row's K/V at once
// where one block per (row, head) walked it alone. Inside a block:
// - the chunk's tiles of K rows and V rows come in by cp.async (16 bytes
//   a lane, row addresses from the block table) into a two-stage ring,
//   K and V of a tile as two commit groups: tile i + 1 loads while tile
//   i is used, and V(i) while K(i) is scored. A row's 16-byte chunk c
//   lands at c ^ (position % 8), so the ldmatrix reads below are free of
//   bank conflicts;
// - scores on the tensor cores: S^T (64 keys x 8 heads) = K q^T, one
//   mma.m16n8k16 per 16 keys and 16 dims; K from shared memory by
//   ldmatrix, q^T as the B fragment held in registers for the whole
//   chunk (query heads past NREP are zero columns);
// - online softmax across the chunk's tiles, one warp per head, with
//   the probabilities stored as bf16 [NREP][64];
// - O^T (D x 8 heads) += V^T P^T, one mma per 16 dims and 16 positions;
//   V^T from the V tile by ldmatrix.trans, P^T as the B fragment straight
//   from shared memory; a warp owns D / 4 dims.
// A block whose chunk starts at or past kv_len exits at once. A row
// that fits one chunk writes its output directly. Otherwise each split
// writes (acc[NREP][D], m[NREP], l[NREP]) to the f32 workspace, fences,
// and bumps the (row, head)'s arrival counter; the last to arrive merges
// the splits (lanes over splits for the max and sum, then every element
// with its split loads in flight together), writes the output and sets
// the counter back to 0, so the next launch finds it at 0 (workspace and
// counters are the wrapper's, allocated once per geometry: nothing is
// allocated or cleared per call).

constexpr int kSplitTile = 64;     // positions per K/V tile
constexpr int kSplitThreads = 128;

// Bytes of dynamic shared memory decode_attend_split() needs.
template <int D, int NREP, typename T>
__host__ __device__ constexpr int split_smem_bytes() {
  return 2 * 2 * kSplitTile * D * (int)sizeof(T)  // ring: K and V tiles
         + NREP * kSplitTile * 4                  // scores (f32)
         + NREP * kSplitTile * 2                  // probabilities (bf16)
         + 3 * NREP * 4 + 16;                     // m, l, alpha; flag
}

// Floats of workspace one split of one (row, KV head) writes.
template <int D, int NREP>
__host__ __device__ constexpr int split_ws_floats() {
  return NREP * (D + 2);
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

// One (row, KV head g, split) of decode attention; called by every
// thread of a block of kSplitThreads threads, gridDim.z splits.
//   q_row, kn, vn, k_pool, v_pool, bt, sl, wp, out_row, g, layer, ...:
//            as for decode_attend()
//   ws:      this (row, head)'s workspace, gridDim.z * split_ws_floats()
//   counter: this (row, head)'s arrival counter, 0 between launches
//   smem:    split_smem_bytes<D, NREP, T>() bytes, 16-byte aligned
// Written for bf16 pools; kernel 5's int8 pools still run decode_attend().
template <int D, int NREP, typename T>
__device__ void decode_attend_split(
    const __nv_bfloat16* __restrict__ q_row, const T* __restrict__ kn,
    const T* __restrict__ vn, T* k_pool, T* v_pool,
    const int* __restrict__ bt, int sl, int wp,
    __nv_bfloat16* __restrict__ out_row, float* ws, int* counter, int g,
    int layer, int num_pages, int page_size, int max_pages, int gd,
    float scale, unsigned char* smem) {
  static_assert(!is_int8<T>::value,
                "int8 pools: the scale loads are not written yet");
  constexpr int ROWB = D * (int)sizeof(T);   // bytes of one K/V row
  constexpr int CPR = ROWB / 16;             // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
  constexpr int SWZ = CPR >= 8 ? 7 : CPR - 1;
  constexpr int TILEB = kSplitTile * ROWB;   // bytes of a K or V tile
  constexpr int MT = D / 64;                 // P V: 16-dim tiles per warp
  constexpr int WS = split_ws_floats<D, NREP>();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // mma fragment row group
  const int tq = lane % 4;  // ... and column pair
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;

  // 1. Split 0 writes this head's slice of the new token in place.
  if (split == 0 && kn != nullptr && sl > 0 && wp >= 0 && wp < num_pages) {
    const size_t row =
        layer_row0 + (size_t)wp * page_size + (sl - 1) % page_size;
    for (int i = tid; i < D; i += kSplitThreads) {
      k_pool[row * gd + g * D + i] = kn[i];
      v_pool[row * gd + g * D + i] = vn[i];
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
  const int n_tiles = (c1 - c0 + kSplitTile - 1) / kSplitTile;

  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  float* sc = reinterpret_cast<float*>(smem + 4 * TILEB);   // [NREP][64]
  __nv_bfloat16* pb =
      reinterpret_cast<__nv_bfloat16*>(sc + NREP * kSplitTile);
  // Per head: running max at ml[r], sum at ml[NREP + r], and the last
  // tile's rescale factor at alpha[r].
  float* ml = reinterpret_cast<float*>(pb + NREP * kSplitTile);
  float* alpha = ml + 2 * NREP;
  int* last = reinterpret_cast<int*>(alpha + NREP);

  // K then V rows of tile `it` into its stage, two commit groups. A
  // thread copies chunk lc of PER positions; their block-table reads go
  // out together, once for K and V. Positions past c1 and pages outside
  // [0, P) are zero-filled; position sl - 1 comes from the new row.
  constexpr int PER = kSplitTile * CPR / kSplitThreads;
  static_assert(kSplitThreads % CPR == 0 && PER > 0, "loader layout");
  const int lc = tid % CPR;
  const int lj = tid / CPR;
  auto load = [&](int it) {
    const int p0 = c0 + it * kSplitTile;
    size_t off[PER];  // element offset of the row chunk; ~0 for zeros
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = p0 + lj + k * (kSplitThreads / CPR);
      const int page = p < c1 ? bt[p / page_size] : -1;
      off[k] = page >= 0 && page < num_pages
                   ? (layer_row0 + (size_t)page * page_size + p % page_size) *
                             gd + g * D + lc * EPC
                   : ~(size_t)0;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* pool = half ? v_pool : k_pool;
      const T* nrow = half ? vn : kn;
      const uint32_t base = ring + ((it & 1) * 2 + half) * TILEB;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = lj + k * (kSplitThreads / CPR);
        const int p = p0 + j;
        const uint32_t dst = base + j * ROWB + ((lc ^ (j & SWZ)) << 4);
        if (p < c1 && nrow != nullptr && p == sl - 1) {
          split_cp8(dst, nrow + lc * EPC);
          split_cp8(dst + 8, nrow + lc * EPC + EPC / 2);
        } else {
          const bool ok = off[k] != ~(size_t)0;
          split_cp16(dst, pool + (ok ? off[k] : 0), ok ? 16 : 0);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  load(0);

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
  if (tid < NREP) {
    ml[tid] = -1e30f;
    ml[NREP + tid] = 0.f;
  }
  float o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  const float neg_inf = __int_as_float(0xff800000);
  const int mi = lane / 8;  // ldmatrix: which 8 x 8 matrix this lane names
  const int mr = lane % 8;  // ... and which of its rows

  for (int it = 0; it < n_tiles; ++it) {
    const bool more = it + 1 < n_tiles;
    if (more) {
      load(it + 1);
      split_wait<3>();  // K(it) has landed
    } else {
      split_wait<1>();
    }
    __syncthreads();
    const uint32_t sK = ring + (it & 1) * 2 * TILEB;
    const uint32_t sV = sK + TILEB;
    const int p0 = c0 + it * kSplitTile;

    // 2. S^T = K q^T for keys 16 warp ... 16 warp + 15.
    {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int key = 16 * warp + mr + (mi % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        const int ch = 2 * kk + mi / 2;
        ldsm_x4(sK + key * ROWB + ((ch ^ (key & SWZ)) << 4), a);
        mma_bf16(c, a, qb[kk][0], qb[kk][1]);
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * tq + e;
          if (r < NREP) sc[r * kSplitTile + j] = ok ? c[2 * half + e] * scale
                                                    : neg_inf;
        }
      }
    }
    __syncthreads();

    // 3. Online softmax over the tile, one warp per head.
    for (int r = warp; r < NREP; r += kSplitThreads / 32) {
      const float s0 = sc[r * kSplitTile + lane];
      const float s1 = sc[r * kSplitTile + lane + 32];
      const float m_old = ml[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = __expf(s0 - m_new);
      const float e1 = __expf(s1 - m_new);
      pb[r * kSplitTile + lane] = __float2bfloat16(e0);
      pb[r * kSplitTile + lane + 32] = __float2bfloat16(e1);
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float a = __expf(m_old - m_new);
        alpha[r] = a;
        ml[r] = m_new;
        ml[NREP + r] = ml[NREP + r] * a + sum;
      }
    }
    if (more)
      split_wait<2>();  // V(it) has landed
    else
      split_wait<0>();
    __syncthreads();

    // 4. O^T += V^T P^T for dims 16 (warp * MT + mt) ....
    {
      float a0 = 1.f, a1 = 1.f;
      if (2 * tq < NREP) a0 = alpha[2 * tq];
      if (2 * tq + 1 < NREP) a1 = alpha[2 * tq + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        o[mt][0] *= a0;
        o[mt][1] *= a1;
        o[mt][2] *= a0;
        o[mt][3] *= a1;
      }
#pragma unroll
      for (int ks = 0; ks < kSplitTile / 16; ++ks) {
        uint32_t b0 = 0u, b1 = 0u;
        if (gq < NREP) {
          const __nv_bfloat16* pr = pb + gq * kSplitTile + 16 * ks + 2 * tq;
          b0 = *reinterpret_cast<const uint32_t*>(pr);
          b1 = *reinterpret_cast<const uint32_t*>(pr + 8);
        }
        const int pos = 16 * ks + mr + (mi / 2) * 8;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          const int ch = 2 * (warp * MT + mt) + mi % 2;
          ldsm_x4_t(sV + pos * ROWB + ((ch ^ (pos & SWZ)) << 4), a);
          mma_bf16(o[mt], a, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage and the score buffers are free again
  }

  // 5. o[mt][e] is (dim 16 (warp * MT + mt) + gq (+8 for e >= 2), head
  //    2 tq + e % 2). One split: the output. Otherwise publish and merge.
  float* mine = ws + (size_t)split * WS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * tq + e % 2;
      const int d = 16 * (warp * MT + mt) + gq + 8 * (e / 2);
      if (r >= NREP) continue;
      if (n_active == 1)
        o_row[r * D + d] =
            __float2bfloat16(o[mt][e] / fmaxf(ml[NREP + r], 1e-30f));
      else
        __stcg(mine + r * D + d, o[mt][e]);
    }
  }
  if (n_active == 1) return;
  if (tid < 2 * NREP) __stcg(mine + NREP * D + tid, ml[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // Per head: the global max M (into ml[r]) and 1 / sum (ml[NREP + r]),
  // lanes over splits.
  for (int r = warp; r < NREP; r += kSplitThreads / 32) {
    float mx = -1e30f;
    for (int s = lane; s < n_active; s += 32)
      mx = fmaxf(mx, __ldcg(ws + (size_t)s * WS + NREP * D + r));
    mx = warp_max(mx);
    float L = 0.f;
    for (int s = lane; s < n_active; s += 32) {
      const float* part = ws + (size_t)s * WS + NREP * D;
      L += __ldcg(part + NREP + r) * __expf(__ldcg(part + r) - mx);
    }
    L = warp_sum(L);
    if (lane == 0) {
      ml[r] = mx;
      ml[NREP + r] = 1.f / fmaxf(L, 1e-30f);
    }
  }
  __syncthreads();
  constexpr int EPT = (NREP * D + kSplitThreads - 1) / kSplitThreads;
  float acc[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) acc[k] = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_active; ++s) {
    const float* part = ws + (size_t)s * WS;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int idx = tid + k * kSplitThreads;
      if (idx < NREP * D) {
        const int r = idx / D;
        acc[k] += __ldcg(part + idx) * __expf(__ldcg(part + NREP * D + r) -
                                              ml[r]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = tid + k * kSplitThreads;
    if (idx < NREP * D)
      o_row[idx] = __float2bfloat16(acc[k] * ml[NREP + idx / D]);
  }
  if (tid == 0) atomicExch(counter, 0);
}

}  // namespace llmq
