// Device code shared by the decode-attention kernels of the port:
// csrc/fused_decode.cu (write + attention, bf16 and int8 pools),
// csrc/paged_decode.cu (attention only) and the decode blocks of
// csrc/ragged_attention.cu (bf16 and int8 pools).
//
// decode_attend() is the work of ONE block for one (decode row, KV
// head): optionally write the row's new K/V slice into its page, then
// GQA attention of the group's NREP query heads over positions
// [0, seq_len) read through the row's block table, with an f32 online
// softmax whose running max floors at -1e30.
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
// which an H100 turns compute-bound. The design reads every cached K/V
// byte once: the block serves all NREP query heads of its group from the
// same load (GQA index h = g * NREP + r, no block-diagonal q as on the
// TPU), and the mask is the loop bound.
//
// Layout of the work: WARPS warps split the positions round-robin; a
// lane owns D / 32 contiguous dims, dot products reduce with warp
// shuffles, and each warp keeps its own online softmax, merged through
// shared memory at the end.
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
// block of WARPS * 32 threads.
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

}  // namespace llmq
