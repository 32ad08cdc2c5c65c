// Paged causal prefill attention for Hopper (sm_90a).
//
// Replaces paged_prefill_attention_pallas (_prefill_attn_kernel) of
// llmq_tpu/ops/pallas/prefill_attention.py: causal attention for one
// sequence's chunk q (T, H, D) whose row t sits at absolute position
// start_pos + t, over that sequence's pages of a flat (L, P, ps, GD)
// pool — its own fresh K/V (written just before) and any cached history
// of earlier turns. Visibility is kv_pos <= q_pos.
//
// What bounds it: q and the output are T * H * D * 2 bytes each and the
// K/V history 2 * S * GD * 2, against 4 * H * D flops per visible
// (query, key) pair. At serving chunk sizes the two limits are within a
// small factor of each other: a fresh chunk is bound by bytes, a chunk
// over a long cached history by operations. This first version runs the
// arithmetic on the f32 CUDA cores (tensor-core wgmma tiles are later
// work), so it sits well above the bf16 bound by design.
// The design keeps every intermediate on chip: one block owns 64 query
// rows (64 / n_rep tokens x the n_rep heads of one KV group, GQA index
// h = g * n_rep + r, no block-diagonal q), streams the group's K/V in
// 32-key tiles through shared memory once for all 64 rows, and keeps an
// f32 online softmax (max floored at -1e30) per row in registers.
// Tiles past the block's last visible position are never loaded (the
// "fully masked chunks are skipped" rule); rows past T are computed on
// zeros and not stored.
//
// Work split: 4 warps x 16 rows. For the scores a lane owns one key of
// the tile (K rows padded to D + 1 floats: conflict-free); for P @ V a
// lane owns D / 32 output dims and reads P back from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;         // query-head rows per block
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;         // keys per tile: one per lane

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * D + kKeys * (D + 1) + kKeys * D +
                          kWarps * kRowsPerWarp * kKeys);
}

template <int D, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (T, H, D)
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ block_table,   // (MP,)
                         __nv_bfloat16* __restrict__ out,       // (T, H, D)
                         int T, int start_pos, int layer, int num_pages,
                         int page_size, int max_pages, int n_kv_heads,
                         float scale) {
  constexpr int BQ = kRows / NREP;  // tokens per block
  constexpr int DPL = D / 32;       // output dims per lane
  constexpr int KSTRIDE = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                         // kRows x D (pre-scaled)
  float* Ks = Qs + kRows * D;               // kKeys x (D + 1)
  float* Vs = Ks + kKeys * KSTRIDE;         // kKeys x D
  float* Ps = Vs + kKeys * D;               // kWarps x 16 x kKeys

  const int g = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int H = n_kv_heads * NREP;
  const int gd = n_kv_heads * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;

  // Block row R holds token t0 + R / NREP, head g * NREP + R % NREP.
  for (int idx = tid; idx < kRows * D; idx += blockDim.x) {
    const int R = idx / D;
    const int d = idx % D;
    const int t = t0 + R / NREP;
    float v = 0.f;
    if (t < T)
      v = __bfloat162float(q[((size_t)t * H + g * NREP + R % NREP) * D + d]) *
          scale;
    Qs[idx] = v;
  }
  const int t_last = min(T, t0 + BQ) - 1;
  const int kv_end = min(start_pos + t_last + 1, max_pages * page_size);

  const int row0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  float* P = Ps + warp * kRowsPerWarp * kKeys;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // Q written / previous tile consumed
    for (int idx = tid; idx < kKeys * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx % D;
      const int p = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (p < kv_end) {
        const int page = block_table[p / page_size];
        if (page >= 0 && page < num_pages) {
          const size_t off =
              (layer_row0 + (size_t)page * page_size + p % page_size) * gd +
              g * D + d;
          kv = __bfloat162float(k_pool[off]);
          vv = __bfloat162float(v_pool[off]);
        }
      }
      Ks[j * KSTRIDE + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    // Scores: lane j scores key k0 + j against the warp's 16 rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KSTRIDE;
    for (int d = 0; d < D; d += 4) {
      const float k0f = krow[d], k1f = krow[d + 1];
      const float k2f = krow[d + 2], k3f = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r] += q4.x * k0f + q4.y * k1f + q4.z * k2f + q4.w * k3f;
      }
    }
    const int p = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q_pos = start_pos + t0 + (row0 + r) / NREP;
      const bool ok = p < kv_end && p <= q_pos;
      const float sv = ok ? s[r] : -1e30f;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = __expf(m[r] - m_new);
      const float pe = ok ? __expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pe);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      P[r * kKeys + lane] = pe;
    }
    __syncwarp();

    // P @ V: lane owns dims [lane * DPL, lane * DPL + DPL).
    for (int j = 0; j < kKeys; ++j) {
      float vf[DPL];
      if constexpr (DPL == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * D + lane * 4);
        vf[0] = v4.x; vf[1] = v4.y; vf[2] = v4.z; vf[3] = v4.w;
      } else {
        const float2 v2 = *reinterpret_cast<const float2*>(Vs + j * D + lane * 2);
        vf[0] = v2.x; vf[1] = v2.y;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = P[r * kKeys + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vf[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int R = row0 + r;
    const int t = t0 + R / NREP;
    if (t >= T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* o = out + ((size_t)t * H + g * NREP + R % NREP) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = __float2bfloat16(acc[r][i] * inv);
  }
}

template <int D, int NREP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, void* out, int T, int start_pos,
           int layer, int num_pages, int page_size, int max_pages,
           int n_kv_heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel<D, NREP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  constexpr int BQ = kRows / NREP;
  const dim3 grid((T + BQ - 1) / BQ, n_kv_heads);
  prefill_attention_kernel<D, NREP><<<grid, kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)block_table,
      (__nv_bfloat16*)out, T, start_pos, layer, num_pages, page_size,
      max_pages, n_kv_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head geometry without an instantiation (D in {64, 128},
// n_rep in {1, 2, 4, 8}).
extern "C" int llmq_prefill_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_table, void* out,
                                      int T, int n_heads, int n_kv_heads,
                                      int head_dim, int start_pos, int layer,
                                      int num_pages, int page_size,
                                      int max_pages, float scale,
                                      void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                   \
  if (head_dim == DD && n_rep == RR)                                        \
    return launch<DD, RR>(q, k_pool, v_pool, block_table, out, T,           \
                          start_pos, layer, num_pages, page_size, max_pages, \
                          n_kv_heads, scale, s);
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
