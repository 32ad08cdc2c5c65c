// Fused decode step for Hopper (sm_90a): paged-KV write + GQA attention.
//
// Replaces fused_decode_attention_pallas (_fused_kernel) of
// llmq_tpu/ops/pallas/fused_decode.py. For each decode row b it writes the
// current token's K/V into slot (seq_len - 1) % page_size of
// write_page[b] (in place; write_page == 0 marks an inactive row, whose
// write lands in the reserved null page), then returns attention of the
// row's H query heads over positions [0, seq_len) read through its block
// table, the new token included.
//
// What bounds it: bytes. Decode attention does 4 * H * D flops per
// cached position against 2 * GD * 2 bytes of K/V, about 8 flops a
// byte — far below the ~295 at which an H100 turns compute-bound. The
// design reads every cached K/V byte once: one block per (row, KV head)
// serves all n_rep = H / H_kv query heads of that group from the same
// load (GQA indexing h = g * n_rep + r, no block-diagonal q as on the
// TPU), and the mask is the loop bound (no host-built bias array).
//
// Layout of the work: 8 warps per block split the positions round-robin;
// a lane owns D / 32 contiguous dims, dot products reduce with warp
// shuffles, and each warp keeps an online softmax (f32, running max
// floored at -1e30) that the block merges in shared memory at the end.
//
// The write-then-read hazard: a block writes only its own head's slice
// of the row and takes position seq_len - 1 from k_new / v_new, never
// from the pool, so no block waits on another's write. A row with
// seq_len == 0 attends to nothing and returns zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

template <int D, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, D)
                    const __nv_bfloat16* __restrict__ k_new,  // (B, GD)
                    const __nv_bfloat16* __restrict__ v_new,  // (B, GD)
                    __nv_bfloat16* k_pool,                    // (L, P, ps, GD)
                    __nv_bfloat16* v_pool,
                    const int* __restrict__ block_tables,     // (B, MP)
                    const int* __restrict__ seq_lens,         // (B,)
                    const int* __restrict__ write_page,       // (B,)
                    __nv_bfloat16* __restrict__ out,          // (B, H, D)
                    int layer, int num_pages, int page_size, int max_pages,
                    int n_kv_heads, float scale) {
  constexpr int DPL = D / 32;  // dims per lane
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gd = n_kv_heads * D;
  const int H = n_kv_heads * NREP;
  const int sl = seq_lens[b];
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;
  const __nv_bfloat16* kn = k_new + (size_t)b * gd + g * D;
  const __nv_bfloat16* vn = v_new + (size_t)b * gd + g * D;

  // 1. In-place write of this head's slice of the new token.
  const int wp = write_page[b];
  if (sl > 0 && wp >= 0 && wp < num_pages) {
    const size_t row = layer_row0 + (size_t)wp * page_size + (sl - 1) % page_size;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      k_pool[row * gd + g * D + i] = kn[i];
      v_pool[row * gd + g * D + i] = vn[i];
    }
  }

  // 2. Online-softmax attention over [0, kv_len), positions split
  //    round-robin over the warps.
  float qv[NREP][DPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    load_bf16<DPL>(q + ((size_t)b * H + g * NREP + r) * D + lane * DPL, qv[r]);
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
  const int* bt = block_tables + (size_t)b * max_pages;
  for (int p = warp; p < kv_len; p += kWarps) {
    const __nv_bfloat16* kp;
    const __nv_bfloat16* vp;
    if (p == sl - 1) {
      kp = kn;
      vp = vn;
    } else {
      const int page = bt[p / page_size];
      if (page < 0 || page >= num_pages) continue;
      const size_t row = layer_row0 + (size_t)page * page_size + p % page_size;
      kp = k_pool + row * gd + g * D;
      vp = v_pool + row * gd + g * D;
    }
    float kf[DPL], vf[DPL];
    load_bf16<DPL>(kp + lane * DPL, kf);
    load_bf16<DPL>(vp + lane * DPL, vf);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qv[r][i] * kf[i];
      s = warp_sum(s);
      const float m_new = fmaxf(m[r], s);
      const float alpha = __expf(m[r] - m_new);
      const float pe = __expf(s - m_new);
      l[r] = l[r] * alpha + pe;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + pe * vf[i];
      m[r] = m_new;
    }
  }

  // 3. Merge the warps' partial softmaxes.
  __shared__ float sm_m[kWarps][NREP];
  __shared__ float sm_l[kWarps][NREP];
  __shared__ float sm_acc[kWarps][NREP][D];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NREP * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][d] * f;
    }
    out[((size_t)b * H + g * NREP + r) * D + d] =
        __float2bfloat16(a / fmaxf(lsum, 1e-30f));
  }
}

template <int D, int NREP>
void launch(const void* q, const void* k_new, const void* v_new,
            void* k_pool, void* v_pool, const void* block_tables,
            const void* seq_lens, const void* write_page, void* out,
            int batch, int layer, int num_pages, int page_size,
            int max_pages, int n_kv_heads, float scale, cudaStream_t stream) {
  fused_decode_kernel<D, NREP><<<dim3(batch, n_kv_heads), kWarps * 32, 0,
                                 stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (__nv_bfloat16*)k_pool,
      (__nv_bfloat16*)v_pool, (const int*)block_tables,
      (const int*)seq_lens, (const int*)write_page, (__nv_bfloat16*)out,
      layer, num_pages, page_size, max_pages, n_kv_heads, scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head geometry without an instantiation (D in {64, 128},
// n_rep in {2, 4, 8}).
extern "C" int llmq_fused_decode(const void* q, const void* k_new,
                                 const void* v_new, void* k_pool,
                                 void* v_pool, const void* block_tables,
                                 const void* seq_lens, const void* write_page,
                                 void* out, int batch, int n_heads,
                                 int n_kv_heads, int head_dim, int layer,
                                 int num_pages, int page_size, int max_pages,
                                 float scale, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                    \
  if (head_dim == DD && n_rep == RR) {                                       \
    launch<DD, RR>(q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens,  \
                   write_page, out, batch, layer, num_pages, page_size,      \
                   max_pages, n_kv_heads, scale, s);                         \
    return (int)cudaGetLastError();                                          \
  }
  LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
