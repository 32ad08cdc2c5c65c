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
// One block per (row, KV head) runs decode_attend() (decode_attention.cuh,
// shared with csrc/paged_decode.cu and csrc/ragged_attention.cu), which
// also holds what bounds the kernel (bytes) and what the design does
// about it. The write-then-read hazard: a block writes only its own
// head's slice of the row and takes position seq_len - 1 from k_new /
// v_new, never from the pool, so no block waits on another's write. A
// row with seq_len == 0 attends to nothing and returns zeros.

#include "decode_attention.cuh"

namespace {

constexpr int kWarps = 8;

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
  __shared__ float smem[llmq::decode_smem_floats<D, NREP, kWarps>()];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int gd = n_kv_heads * D;
  const size_t hd = (size_t)n_kv_heads * NREP * D;
  llmq::decode_attend<D, NREP, kWarps>(
      q + b * hd, k_new + (size_t)b * gd + g * D,
      v_new + (size_t)b * gd + g * D, k_pool, v_pool,
      block_tables + (size_t)b * max_pages, seq_lens[b], write_page[b],
      out + b * hd, g, layer, num_pages, page_size, max_pages, gd, scale,
      smem);
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
// n_rep in {1, 2, 4, 8}).
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
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
