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
// It is kernel 1 (csrc/fused_decode.cu) without the write: grid
// (B, H_kv, S), one block per (row, KV head, chunk of positions), each
// running decode_attend_split() from decode_attention.cuh with no new
// token (kn == nullptr), so nothing is written and every position, the
// newest included, is read from the pool. What bounds it is bytes (about
// 8 flops per byte of K/V): K/V tiles stream by cp.async through a
// two-stage ring, scores and P V run on the tensor cores, each cached
// K/V byte is read once for all n_rep query heads of its group, and a
// long row is spread over many SMs. The last block of a (row, head) to
// finish merges the splits in the same launch, through the wrapper's
// workspace and arrival counters (kept apart from kernel 1's and 6's).

#include "decode_attention.cuh"

namespace {

template <int D, int NREP>
__global__ void __launch_bounds__(llmq::kSplitThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,    // (B, H, D)
                    const __nv_bfloat16* k_pool,            // (L, P, ps, GD)
                    const __nv_bfloat16* v_pool,
                    const int* __restrict__ block_tables,   // (B, MP)
                    const int* __restrict__ seq_lens,       // (B,)
                    __nv_bfloat16* __restrict__ out,        // (B, H, D)
                    float* ws,       // (B, H_kv, S, NREP * (D + 2))
                    int* counters,   // (B, H_kv)
                    int layer, int num_pages, int page_size, int max_pages,
                    int n_kv_heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int gd = n_kv_heads * D;
  const size_t hd = (size_t)n_kv_heads * NREP * D;
  const size_t bg = (size_t)b * n_kv_heads + g;
  // No new token: the body neither writes nor reads kn / vn, so the
  // pools are passed through unchanged.
  llmq::decode_attend_split<D, NREP, __nv_bfloat16>(
      q + b * hd, nullptr, nullptr, const_cast<__nv_bfloat16*>(k_pool),
      const_cast<__nv_bfloat16*>(v_pool), llmq::Scales{},
      block_tables + (size_t)b * max_pages, seq_lens[b], -1, out + b * hd,
      ws + bg * gridDim.z * llmq::split_ws_floats<D, NREP>(), counters + bg,
      g, layer, num_pages, page_size, max_pages, gd, scale, blockIdx.z,
      gridDim.z, smem);
}

template <int D, int NREP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* seq_lens, void* out,
           void* ws, void* counters, int batch, int layer, int num_pages,
           int page_size, int max_pages, int n_kv_heads, int n_splits,
           float scale, cudaStream_t stream) {
  constexpr int smem = llmq::split_smem_bytes<D, NREP, __nv_bfloat16>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<D, NREP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  paged_decode_kernel<D, NREP>
      <<<dim3(batch, n_kv_heads, n_splits), llmq::kSplitThreads, smem,
         stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
          (const __nv_bfloat16*)v_pool, (const int*)block_tables,
          (const int*)seq_lens, (__nv_bfloat16*)out, (float*)ws,
          (int*)counters, layer, num_pages, page_size, max_pages, n_kv_heads,
          scale);
  return (int)cudaGetLastError();
}

}  // namespace

// n_splits blocks per (row, KV head) (n_splits >= 1). ws: B * H_kv *
// n_splits * n_rep * (D + 2) floats; counters: B * H_kv ints, 0 before
// the launch and after it. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a head geometry without an instantiation
// (D in {64, 128}, n_rep in {1, 2, 4, 8}).
extern "C" int llmq_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* block_tables,
                                 const void* seq_lens, void* out, void* ws,
                                 void* counters, int batch, int n_heads,
                                 int n_kv_heads, int head_dim, int layer,
                                 int num_pages, int page_size, int max_pages,
                                 int n_splits, float scale, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (n_splits <= 0) return (int)cudaErrorInvalidValue;
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                   \
  if (head_dim == DD && n_rep == RR)                                        \
    return launch<DD, RR>(q, k_pool, v_pool, block_tables, seq_lens, out,   \
                          ws, counters, batch, layer, num_pages, page_size, \
                          max_pages, n_kv_heads, n_splits, scale, s);
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
