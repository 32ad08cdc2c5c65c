// Paged decode attention for Hopper (sm_90a), attention only, no write.
//
// Replaces paged_decode_attention_pallas (_decode_kernel) of
// llmq_tpu/ops/pallas/paged_attention.py: for each decode row b, GQA
// attention of q[b] (H, D) over positions [0, seq_lens[b]) of layer
// `layer` of a flat (L, P, ps, GD) pool, read through block_tables[b].
// It is the attention half of the split decode route (the row write is
// csrc/kv_write.cu's kv_cache_write, launched before it). A row with
// seq_len == 0 returns zeros; masked logits floor at -1e30.
//
// It is kernel 1 (csrc/fused_decode.cu) without the write: one block per
// (row, KV head) runs decode_attend() from decode_attention.cuh with no
// new token, so every position, the newest included, is read from the
// pool. What bounds it is bytes (about 8 flops per byte of K/V); the
// block walks only the row's live pages and reads each cached K/V byte
// once for all n_rep query heads of its group.

#include "decode_attention.cuh"

namespace {

constexpr int kWarps = 8;

template <int D, int NREP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,    // (B, H, D)
                    const __nv_bfloat16* k_pool,            // (L, P, ps, GD)
                    const __nv_bfloat16* v_pool,
                    const int* __restrict__ block_tables,   // (B, MP)
                    const int* __restrict__ seq_lens,       // (B,)
                    __nv_bfloat16* __restrict__ out,        // (B, H, D)
                    int layer, int num_pages, int page_size, int max_pages,
                    int n_kv_heads, float scale) {
  __shared__ float smem[llmq::decode_smem_floats<D, NREP, kWarps>()];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const size_t hd = (size_t)n_kv_heads * NREP * D;
  // No new token: decode_attend() neither writes nor reads kn / vn, so
  // the pools are passed through unchanged.
  llmq::decode_attend<D, NREP, kWarps, __nv_bfloat16>(
      q + b * hd, nullptr, nullptr, nullptr, nullptr,
      const_cast<__nv_bfloat16*>(k_pool), const_cast<__nv_bfloat16*>(v_pool),
      nullptr, nullptr, block_tables + (size_t)b * max_pages, seq_lens[b], -1, out + b * hd,
      g, layer, num_pages, page_size, max_pages, n_kv_heads * D, scale,
      smem);
}

template <int D, int NREP>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* block_tables, const void* seq_lens, void* out,
            int batch, int layer, int num_pages, int page_size,
            int max_pages, int n_kv_heads, float scale, cudaStream_t stream) {
  paged_decode_kernel<D, NREP><<<dim3(batch, n_kv_heads), kWarps * 32, 0,
                                 stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)block_tables,
      (const int*)seq_lens, (__nv_bfloat16*)out, layer, num_pages,
      page_size, max_pages, n_kv_heads, scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head geometry without an instantiation (D in {64, 128},
// n_rep in {1, 2, 4, 8}).
extern "C" int llmq_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* block_tables,
                                 const void* seq_lens, void* out, int batch,
                                 int n_heads, int n_kv_heads, int head_dim,
                                 int layer, int num_pages, int page_size,
                                 int max_pages, float scale, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                   \
  if (head_dim == DD && n_rep == RR) {                                      \
    launch<DD, RR>(q, k_pool, v_pool, block_tables, seq_lens, out, batch,   \
                   layer, num_pages, page_size, max_pages, n_kv_heads,      \
                   scale, s);                                               \
    return (int)cudaGetLastError();                                         \
  }
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
