// Fused decode step for Hopper (sm_90a): paged-KV write + GQA attention,
// over bf16 pools (kernel 1) or int8 pools with bf16 scale pools
// (kernel 5).
//
// Replaces fused_decode_attention_pallas (_fused_kernel) and
// fused_decode_attention_q8_pallas (_fused_kernel_q8) of
// llmq_tpu/ops/pallas/fused_decode.py. For each decode row b it writes the
// current token's K/V into slot (seq_len - 1) % page_size of
// write_page[b] (in place; write_page == 0 marks an inactive row, whose
// write lands in the reserved null page), then returns attention of the
// row's H query heads over positions [0, seq_len) read through its block
// table, the new token included. Over int8 pools the row arrives already
// quantized (int8 K/V per (row, KV head) with one bf16 scale each, as the
// JAX package quantizes it outside its kernel); the kernel writes the row
// and its scales.
//
// Both kernels are split-K: grid (B, H_kv, S), one block per (row, KV
// head, chunk of positions), running decode_attend_split() from
// decode_attention.cuh (tensor-core scores and P V over 64-position
// tiles; int8 tiles are converted to bf16 in shared memory, K scales
// multiply the logits and V scales fold into the probabilities). The
// last block of a (row, head) to finish merges the splits in the same
// launch, through the wrapper's cached workspace and arrival counters
// (one pair per kernel). What bounds them is bytes; decode_attention.cuh
// says what the design does about it and about the write-then-read
// hazard. None of the TPU kernel's page DMA, pre-broadcast scale pages or
// block-diagonal q is carried over, and no page-size or head-count limit
// of Mosaic applies: any page size, D in {64, 128}, n_rep in {1, 2, 4, 8}.

#include "decode_attention.cuh"

namespace {

// One block per (row b, KV head g, split). k_new / v_new are (B, H_kv, D)
// rows of the pool element; k_new_scale / v_new_scale (B, H_kv) and the
// scale pools are nullptr for bf16.
template <int D, int NREP, typename T>
__global__ void __launch_bounds__(llmq::kSplitThreads)
fused_decode_split_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, D)
                          const T* __restrict__ k_new,      // (B, GD)
                          const T* __restrict__ v_new,
                          const __nv_bfloat16* __restrict__ k_new_scale,
                          const __nv_bfloat16* __restrict__ v_new_scale,
                          T* k_pool, T* v_pool,             // (L, P, ps, GD)
                          __nv_bfloat16* ks_pool,           // (L, P, H_kv, ps)
                          __nv_bfloat16* vs_pool,
                          const int* __restrict__ block_tables,  // (B, MP)
                          const int* __restrict__ seq_lens,      // (B,)
                          const int* __restrict__ write_page,    // (B,)
                          __nv_bfloat16* __restrict__ out,       // (B, H, D)
                          float* ws,       // (B, H_kv, S, NREP * (D + 2))
                          int* counters,   // (B, H_kv)
                          int layer, int num_pages, int page_size,
                          int max_pages, int n_kv_heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int gd = n_kv_heads * D;
  const size_t hd = (size_t)n_kv_heads * NREP * D;
  const size_t bg = (size_t)b * n_kv_heads + g;
  const llmq::Scales scl{ks_pool, vs_pool,
                         k_new_scale ? k_new_scale + bg : nullptr,
                         v_new_scale ? v_new_scale + bg : nullptr};
  llmq::decode_attend_split<D, NREP, T>(
      q + b * hd, k_new + (size_t)b * gd + g * D,
      v_new + (size_t)b * gd + g * D, k_pool, v_pool, scl,
      block_tables + (size_t)b * max_pages, seq_lens[b], write_page[b],
      out + b * hd, ws + bg * gridDim.z * llmq::split_ws_floats<D, NREP>(),
      counters + bg, g, layer, num_pages, page_size, max_pages, gd, scale,
      blockIdx.z, gridDim.z, smem);
}

template <int D, int NREP, typename T>
int launch_split(const void* q, const void* k_new, const void* v_new,
                 const void* k_new_scale, const void* v_new_scale,
                 void* k_pool, void* v_pool, void* ks_pool, void* vs_pool,
                 const void* block_tables, const void* seq_lens,
                 const void* write_page, void* out, void* ws, void* counters,
                 int batch, int layer, int num_pages, int page_size,
                 int max_pages, int n_kv_heads, int n_splits, float scale,
                 cudaStream_t stream) {
  constexpr int smem = llmq::split_smem_bytes<D, NREP, T>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_split_kernel<D, NREP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  fused_decode_split_kernel<D, NREP, T>
      <<<dim3(batch, n_kv_heads, n_splits), llmq::kSplitThreads, smem,
         stream>>>(
          (const __nv_bfloat16*)q, (const T*)k_new, (const T*)v_new,
          (const __nv_bfloat16*)k_new_scale,
          (const __nv_bfloat16*)v_new_scale, (T*)k_pool, (T*)v_pool,
          (__nv_bfloat16*)ks_pool, (__nv_bfloat16*)vs_pool,
          (const int*)block_tables, (const int*)seq_lens,
          (const int*)write_page, (__nv_bfloat16*)out, (float*)ws,
          (int*)counters, layer, num_pages, page_size, max_pages, n_kv_heads,
          scale);
  return (int)cudaGetLastError();
}

// Dispatch on the head geometry; cudaErrorInvalidValue for one without
// an instantiation (D in {64, 128}, n_rep in {1, 2, 4, 8}) or for
// n_splits < 1.
template <typename T>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* k_new_scale, const void* v_new_scale, void* k_pool,
             void* v_pool, void* ks_pool, void* vs_pool,
             const void* block_tables, const void* seq_lens,
             const void* write_page, void* out, void* ws, void* counters,
             int batch, int n_heads, int n_kv_heads, int head_dim, int layer,
             int num_pages, int page_size, int max_pages, int n_splits,
             float scale, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (n_splits <= 0) return (int)cudaErrorInvalidValue;
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                    \
  if (head_dim == DD && n_rep == RR)                                         \
    return launch_split<DD, RR, T>(                                          \
        q, k_new, v_new, k_new_scale, v_new_scale, k_pool, v_pool, ks_pool,  \
        vs_pool, block_tables, seq_lens, write_page, out, ws, counters,      \
        batch, layer, num_pages, page_size, max_pages, n_kv_heads, n_splits, \
        scale, s);
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 1, bf16 pools: n_splits blocks per (row, KV head) (n_splits >=
// 1). ws: B * H_kv * n_splits * n_rep * (D + 2) floats; counters: B *
// H_kv ints, 0 before the launch and after it. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head geometry without
// an instantiation.
extern "C" int llmq_fused_decode(const void* q, const void* k_new,
                                 const void* v_new, void* k_pool,
                                 void* v_pool, const void* block_tables,
                                 const void* seq_lens, const void* write_page,
                                 void* out, void* ws, void* counters,
                                 int batch, int n_heads, int n_kv_heads,
                                 int head_dim, int layer, int num_pages,
                                 int page_size, int max_pages, int n_splits,
                                 float scale, void* stream) {
  return dispatch<__nv_bfloat16>(
      q, k_new, v_new, nullptr, nullptr, k_pool, v_pool, nullptr, nullptr,
      block_tables, seq_lens, write_page, out, ws, counters, batch, n_heads,
      n_kv_heads, head_dim, layer, num_pages, page_size, max_pages, n_splits,
      scale, stream);
}

// Kernel 5, int8 pools: k_new_q / v_new_q (B, H_kv, D) int8, 8-byte
// aligned rows, with scales (B, H_kv) bf16; scale pools (L, P, H_kv,
// page_size) bf16. Workspace, counters and n_splits as for kernel 1, of
// the kernel's own.
extern "C" int llmq_fused_decode_q8(
    const void* q, const void* k_new_q, const void* k_new_scale,
    const void* v_new_q, const void* v_new_scale, void* k_pool, void* v_pool,
    void* ks_pool, void* vs_pool, const void* block_tables,
    const void* seq_lens, const void* write_page, void* out, void* ws,
    void* counters, int batch, int n_heads, int n_kv_heads, int head_dim,
    int layer, int num_pages, int page_size, int max_pages, int n_splits,
    float scale, void* stream) {
  return dispatch<int8_t>(
      q, k_new_q, v_new_q, k_new_scale, v_new_scale, k_pool, v_pool, ks_pool,
      vs_pool, block_tables, seq_lens, write_page, out, ws, counters, batch,
      n_heads, n_kv_heads, head_dim, layer, num_pages, page_size, max_pages,
      n_splits, scale, stream);
}
