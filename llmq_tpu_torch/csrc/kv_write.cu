// Paged KV-pool row writes for Hopper (sm_90a).
//
// Replaces the two Pallas write kernels of llmq_tpu/ops/pallas/kv_write.py:
//   - kv_cache_write_pallas  (N token rows to distinct (page, slot) pairs)
//   - kv_prefill_write_pallas (a prefill chunk through its block table,
//     positions [start_pos, start_pos + n_tokens)), batched: one launch
//     writes every row of a prefill batch or every slice of a ragged
//     step. JAX vmaps the kernel over the wave's rows with a traced
//     start; here each row's descriptors (its first row in the K/V
//     buffer, live count, start position, block-table row) are device
//     int32 tensors, and the grid comes from the buffer's shape alone,
//     so the launch reads nothing from the host and a CUDA graph can
//     hold it.
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

// grid (row_tokens, n_rows, 2): token t of row r is buffer row
// offsets[r] + t and lands at absolute position starts[r] + t through
// row r of block_tables; tokens at or past counts[r] are not written.
__global__ void __launch_bounds__(kThreads)
kv_prefill_write_kernel(uint16_t* __restrict__ k_pool,
                        uint16_t* __restrict__ v_pool,
                        const uint16_t* __restrict__ k_rows,
                        const uint16_t* __restrict__ v_rows,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ offsets,
                        const int* __restrict__ counts,
                        const int* __restrict__ starts, int n_buf_rows,
                        int max_pages, int layer, int num_pages,
                        int page_size, int gd) {
  const int t = blockIdx.x;
  const int r = blockIdx.y;
  // The three descriptor loads go out together, ahead of the test.
  const int count = counts[r];
  const int src_row = offsets[r] + t;
  const int pos = starts[r] + t;
  if (t >= count) return;
  if (src_row < 0 || src_row >= n_buf_rows || pos < 0 ||
      pos / page_size >= max_pages)
    return;
  const int page = block_tables[(size_t)r * max_pages + pos / page_size];
  if (page < 0 || page >= num_pages) return;
  const uint16_t* src =
      (blockIdx.z == 0 ? k_rows : v_rows) + (size_t)src_row * gd;
  uint16_t* pool = blockIdx.z == 0 ? k_pool : v_pool;
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
                                     const void* block_tables,
                                     const void* offsets, const void* counts,
                                     const void* starts, int n_rows,
                                     int row_tokens, int n_buf_rows,
                                     int max_pages, int layer, int num_pages,
                                     int page_size, int gd, void* stream) {
  if (n_rows > 0 && row_tokens > 0) {
    kv_prefill_write_kernel<<<dim3(row_tokens, n_rows, 2), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (uint16_t*)k_pool, (uint16_t*)v_pool, (const uint16_t*)k_rows,
        (const uint16_t*)v_rows, (const int*)block_tables,
        (const int*)offsets, (const int*)counts, (const int*)starts,
        n_buf_rows, max_pages, layer, num_pages, page_size, gd);
  }
  return (int)cudaGetLastError();
}
