// Paged KV-pool row writes for Hopper (sm_90a).
//
// Replaces the two Pallas write kernels of llmq_tpu/ops/pallas/kv_write.py:
//   - kv_cache_write_pallas  (N token rows to distinct (page, slot) pairs)
//   - kv_prefill_write_pallas (one sequence's prefill chunk through its
//     block table, positions [start_pos, start_pos + n_tokens))
//
// Pools are flat (L, P, page_size, GD) bf16 with GD = H_kv * head_dim.
// Both kernels are pure data movement, so what bounds them on the card
// is bytes: each written row is read once from the new-row buffer and
// written once into the pool, 2 * GD * 2 bytes per token for K and V.
// Design: one block per (row, K-or-V), each thread copying 16-byte
// vectors so a warp moves 512 contiguous bytes per instruction. The
// TPU kernel's page read-modify-write (an 8-sublane tile artefact) is
// gone: a row is written alone, and everything else in the pool is left
// untouched. Page ids come from device memory; an id outside [0, P) is
// skipped rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void copy_row(uint4* __restrict__ dst,
                                         const uint4* __restrict__ src,
                                         int n_vec) {
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) dst[i] = src[i];
}

// grid (n_rows, 2): blockIdx.y == 0 writes K, == 1 writes V.
__global__ void __launch_bounds__(kThreads)
kv_cache_write_kernel(uint16_t* __restrict__ k_pool,
                      uint16_t* __restrict__ v_pool,
                      const uint16_t* __restrict__ k_new,
                      const uint16_t* __restrict__ v_new,
                      const int* __restrict__ page_of,
                      const int* __restrict__ slot_of,
                      int layer, int num_pages, int page_size, int gd) {
  const int n = blockIdx.x;
  const int page = page_of[n];
  const int slot = slot_of[n];
  if (page < 0 || page >= num_pages || slot < 0 || slot >= page_size) return;
  const uint16_t* src = (blockIdx.y == 0 ? k_new : v_new) + (size_t)n * gd;
  uint16_t* pool = blockIdx.y == 0 ? k_pool : v_pool;
  const size_t row =
      ((size_t)layer * num_pages + page) * page_size + slot;
  copy_row(reinterpret_cast<uint4*>(pool + row * gd),
           reinterpret_cast<const uint4*>(src), gd / 8);
}

// grid (n_tokens, 2): token t lands at absolute position start_pos + t.
__global__ void __launch_bounds__(kThreads)
kv_prefill_write_kernel(uint16_t* __restrict__ k_pool,
                        uint16_t* __restrict__ v_pool,
                        const uint16_t* __restrict__ k_rows,
                        const uint16_t* __restrict__ v_rows,
                        const int* __restrict__ block_table,
                        int start_pos, int layer, int num_pages,
                        int page_size, int gd) {
  const int t = blockIdx.x;
  const int pos = start_pos + t;
  const int page = block_table[pos / page_size];
  if (page < 0 || page >= num_pages) return;
  const uint16_t* src = (blockIdx.y == 0 ? k_rows : v_rows) + (size_t)t * gd;
  uint16_t* pool = blockIdx.y == 0 ? k_pool : v_pool;
  const size_t row =
      ((size_t)layer * num_pages + page) * page_size + pos % page_size;
  copy_row(reinterpret_cast<uint4*>(pool + row * gd),
           reinterpret_cast<const uint4*>(src), gd / 8);
}

}  // namespace

extern "C" int llmq_kv_cache_write(void* k_pool, void* v_pool,
                                   const void* k_new, const void* v_new,
                                   const void* page_of, const void* slot_of,
                                   int n_rows, int layer, int num_pages,
                                   int page_size, int gd, void* stream) {
  if (n_rows > 0) {
    kv_cache_write_kernel<<<dim3(n_rows, 2), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (uint16_t*)k_pool, (uint16_t*)v_pool, (const uint16_t*)k_new,
        (const uint16_t*)v_new, (const int*)page_of, (const int*)slot_of,
        layer, num_pages, page_size, gd);
  }
  return (int)cudaGetLastError();
}

extern "C" int llmq_kv_prefill_write(void* k_pool, void* v_pool,
                                     const void* k_rows, const void* v_rows,
                                     const void* block_table, int start_pos,
                                     int n_tokens, int layer, int num_pages,
                                     int page_size, int gd, void* stream) {
  if (n_tokens > 0) {
    kv_prefill_write_kernel<<<dim3(n_tokens, 2), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (uint16_t*)k_pool, (uint16_t*)v_pool, (const uint16_t*)k_rows,
        (const uint16_t*)v_rows, (const int*)block_table, start_pos, layer,
        num_pages, page_size, gd);
  }
  return (int)cudaGetLastError();
}
