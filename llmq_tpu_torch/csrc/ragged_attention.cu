// Ragged mixed attention for Hopper (sm_90a): ONE launch per layer for a
// mixed prefill+decode step, over bf16 pools (kernel 6) or int8 pools
// with bf16 scale pools (kernel 7).
//
// Replaces ragged_mixed_attention_pallas (_ragged_kernel) and
// ragged_mixed_attention_q8_pallas (_ragged_kernel_q8) of
// llmq_tpu/ops/pallas/ragged_paged_attention.py. Inputs: B decode rows
// (one query token each, their new K/V not yet in the pool) and S prefill
// slices packed back to back into one (N, H, D) query buffer, segment s
// at rows [qoff[s], qoff[s] + qlen[s]), each segment starting on a
// multiple of kQBlock = 8 (RAGGED_Q_BLOCK in ops/attention.py). Slice s's
// K/V is already in its pages (kv_prefill_write, or the int8 scatter of
// rows and scales, runs first on the same stream), so the launch only
// reads for the slices.
//
// The grid is one dimension with two ranges of blocks:
//  - slice blocks, one per (8-token q-block, KV head g), first (over a
//    long history they run longest; most decode blocks of short rows exit
//    at once and fill in behind): the block finds the slice that owns its
//    first token by scanning the S descriptors (the TPU kernel's
//    scalar-prefetched owner table; no owner means a dead block, which
//    writes zeros and loads nothing). Query t of slice s sits at absolute
//    position qstart[s] + t - qoff[s] and sees keys at kv_pos <= q_pos,
//    its slice's fresh K/V and any history from earlier turns alike. Rows
//    of a live block past qlen come out as zeros;
//  - then one decode block per (row b, KV head g, split of S), running
//    decode_attend_split() as kernels 1 and 5 do: the row's new K/V
//    written at (write_page[b], (seq_len - 1) % ps), attention over
//    [0, seq_len) with position seq_len - 1 read from k_new / v_new; an
//    inactive row writes page 0, an empty row (seq_len == 0) returns
//    zeros. The splits merge through the wrapper's workspace and counters
//    (one pair per kernel).
//
// Why one launch is safe: a sequence is either decoding or mid-prefill,
// never both, so decode blocks write only pages that no slice block
// reads. Inactive decode rows write the null page 0, which no live slice
// reads (a slice reads only positions below its last query's, all
// backed by its own pages).
//
// What bounds it: a decode block is bound by bytes as kernel 1 is. A
// slice block does 4 * H * D flops per visible (query, key) pair on
// 2 * GD * 2 bytes per key read (2 * GD + 4 * H_kv over int8 pools); for
// a fresh slice bytes dominate, for a slice over a long history
// operations do.
//
// Both kernels are built from the split-K tile machinery of
// decode_attention.cuh, 128 threads a block. A slice block's query
// columns are its 8 tokens x the group's NREP heads (8 to 64 columns;
// column c is token c / NREP at position pos0 + c / NREP, head c % NREP).
// Q comes into shared memory by cp.async, 64-key K/V tiles by cp.async
// into a two-stage ring with row addresses from the block table (int8
// tiles converted to bf16 beside their scales), and attend_tiles() runs
// S^T = K Q^T and O^T += V^T P^T on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulation), the causal mask per (key, column)
// and the online softmax down the columns. Tiles past the block's last
// query position are never loaded; pages outside [0, P) read as zeros.
// wgmma is not used: it needs 64-row tiles, and an 8-token q-block has 64
// columns only at NREP 8 (a 16-token block could straddle two slices), so
// mma.sync is the unit that fits. A slice block walks its q-block's keys
// itself: splitting them over blocks, as decode rows are, was slower at
// every split size tried up to 2048 positions (PERF.md).

#include "decode_attention.cuh"

namespace {

constexpr int kQBlock = 8;   // packed tokens per q-block

// Bytes of dynamic shared memory of a slice block: attend_tiles()' regions
// for 8 * NREP columns, then the block's Q rows (one per column).
template <int D, int NREP, typename T>
__host__ __device__ constexpr int slice_q_offset() {
  return (llmq::tiles_smem_bytes<D, kQBlock * NREP, T>() + 15) / 16 * 16;
}
template <int D, int NREP, typename T>
__host__ __device__ constexpr int slice_smem_bytes() {
  return slice_q_offset<D, NREP, T>() + kQBlock * NREP * D * 2;
}

// One (8-token q-block qb, KV head g) of the slice range; called by every
// thread of a block of kSplitThreads threads. Column c = t * NREP + r is
// token blk0 + t (position pos0 + t), query head g * NREP + r; Q^T's B
// fragments come from the block's Q rows in shared memory by ldmatrix
// (16-byte chunks swizzled as the bf16 K/V tiles are). The block walks
// the q-block's keys [0, pos0 + n_live) itself.
template <int D, int NREP, typename T>
__device__ void slice_attend(const __nv_bfloat16* __restrict__ q_pf,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const llmq::Scales& scl,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ pf_qoff,
                             const int* __restrict__ pf_qlen,
                             const int* __restrict__ pf_qstart,
                             __nv_bfloat16* __restrict__ out_pf, int qb,
                             int g, int batch, int n_slices, int layer,
                             int num_pages, int page_size, int max_pages,
                             int n_kv_heads, float scale,
                             unsigned char* smem) {
  constexpr int NQ = kQBlock * NREP;
  constexpr int ROWB = D * 2;
  constexpr int CPR = ROWB / 16;
  constexpr int SWZ = CPR >= 8 ? 7 : CPR - 1;
  constexpr int MT = D / 64;
  constexpr int NF = NQ / 8;
  const int H = n_kv_heads * NREP;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int blk0 = qb * kQBlock;

  int own = -1;
  for (int s = 0; s < n_slices; ++s) {
    if (blk0 >= pf_qoff[s] && blk0 < pf_qoff[s] + pf_qlen[s]) {
      own = s;
      break;
    }
  }
  const int n_live =
      own < 0 ? 0 : min(pf_qoff[own] + pf_qlen[own] - blk0, kQBlock);
  const int pos0 = own < 0 ? 0 : pf_qstart[own] + blk0 - pf_qoff[own];
  const int kv_end = min(pos0 + n_live, max_pages * page_size);
  if (own < 0 || kv_end <= 0) {  // dead block: zeros, nothing loaded
    for (int idx = tid; idx < kQBlock * NREP * D; idx += llmq::kSplitThreads) {
      const int t = idx / (NREP * D);
      const int rd = idx % (NREP * D);
      out_pf[((size_t)(blk0 + t) * H + g * NREP) * D + rd] =
          __float2bfloat16(0.f);
    }
    return;
  }
  const int* bt = block_tables + (size_t)(batch + own) * max_pages;

  // The block's Q rows by cp.async, zeros past n_live. Not committed
  // here: they ride in attend_tiles()' first group with tile 0's K.
  const uint32_t sQ = (uint32_t)__cvta_generic_to_shared(
      smem + slice_q_offset<D, NREP, T>());
  for (int idx = tid; idx < NQ * CPR; idx += llmq::kSplitThreads) {
    const int c = idx / CPR;
    const int ch = idx % CPR;
    const int t = c / NREP;
    const bool ok = t < n_live;
    const __nv_bfloat16* src =
        q_pf + ((size_t)(blk0 + t) * H + g * NREP + c % NREP) * D + ch * 8;
    llmq::split_cp16(sQ + c * ROWB + ((ch ^ (c & SWZ)) << 4),
                     ok ? src : q_pf, ok ? 16 : 0);
  }
  const int mi = lane / 8;
  const int mr = lane % 8;
  // Four 8 x 8 matrices of columns 8 n ... 8 n + 7: dims 32 kp + 8 mi ....
  auto qfrag = [&](int kp, int n, uint32_t (&b)[4]) {
    const int c = 8 * n + mr;
    llmq::ldsm_x4(sQ + c * ROWB + (((4 * kp + mi) ^ (c & SWZ)) << 4), b);
  };
  auto last_pos = [&](int c) {
    return c / NREP < n_live ? pos0 + c / NREP : -1;
  };
  const llmq::TileSmem sm = llmq::tile_smem<D, NQ, T>(smem);
  float o[MT][NF][4];
  llmq::attend_tiles<D, NQ, T>(
      k_pool, v_pool, nullptr, nullptr, scl, bt, 0, 0, kv_end, g, layer,
      num_pages, page_size, n_kv_heads * D, scale, qfrag, last_pos, sm, o);
  // One split: finish_split() writes o / l directly and touches no
  // workspace. Rows past n_live come out as zeros.
  llmq::finish_split<D, NQ>(
      o, sm, nullptr, nullptr, 0, 1, [&](int c, int d, float v) {
        const int t = c / NREP;
        out_pf[((size_t)(blk0 + t) * H + g * NREP + c % NREP) * D + d] =
            __float2bfloat16(t < n_live ? v : 0.f);
      });
}

// The slice range first (n_slice_blocks = N / 8 * H_kv blocks), then
// n_splits blocks per (decode row b, KV head g). k_new_scale /
// v_new_scale (B, H_kv) and the scale pools are nullptr for bf16.
template <int D, int NREP, typename T>
__global__ void __launch_bounds__(llmq::kSplitThreads)
ragged_split_kernel(const __nv_bfloat16* __restrict__ q_dec,   // (B, H, D)
                    const T* __restrict__ k_new,               // (B, GD)
                    const T* __restrict__ v_new,               // (B, GD)
                    const __nv_bfloat16* __restrict__ k_new_scale,
                    const __nv_bfloat16* __restrict__ v_new_scale,
                    const __nv_bfloat16* __restrict__ q_pf,    // (N, H, D)
                    T* k_pool,                                 // (L, P, ps, GD)
                    T* v_pool,
                    __nv_bfloat16* ks_pool,                    // (L, P, H_kv, ps)
                    __nv_bfloat16* vs_pool,
                    const int* __restrict__ block_tables,      // (B + S, MP)
                    const int* __restrict__ seq_lens,          // (B + S,)
                    const int* __restrict__ write_page,        // (B,)
                    const int* __restrict__ pf_qoff,           // (S,)
                    const int* __restrict__ pf_qlen,           // (S,)
                    const int* __restrict__ pf_qstart,         // (S,)
                    __nv_bfloat16* __restrict__ out_dec,       // (B, H, D)
                    __nv_bfloat16* __restrict__ out_pf,        // (N, H, D)
                    float* ws,      // (B, H_kv, n_splits, NREP * (D + 2))
                    int* counters,  // (B, H_kv)
                    int batch, int n_slices, int n_slice_blocks,
                    int n_splits, int layer, int num_pages, int page_size,
                    int max_pages, int n_kv_heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x;
  if (bx < n_slice_blocks) {
    slice_attend<D, NREP, T>(q_pf, k_pool, v_pool,
                             llmq::Scales{ks_pool, vs_pool, nullptr, nullptr},
                             block_tables, pf_qoff, pf_qlen, pf_qstart,
                             out_pf, bx / n_kv_heads, bx % n_kv_heads, batch,
                             n_slices, layer, num_pages, page_size, max_pages,
                             n_kv_heads, scale, smem);
    return;
  }
  const int i = bx - n_slice_blocks;
  const int split = i % n_splits;
  const int bg = i / n_splits;  // b * H_kv + g
  const int b = bg / n_kv_heads;
  const int g = bg % n_kv_heads;
  const int gd = n_kv_heads * D;
  const size_t hd = (size_t)n_kv_heads * NREP * D;
  const llmq::Scales scl{ks_pool, vs_pool,
                         k_new_scale ? k_new_scale + bg : nullptr,
                         v_new_scale ? v_new_scale + bg : nullptr};
  llmq::decode_attend_split<D, NREP, T>(
      q_dec + b * hd, k_new + (size_t)b * gd + g * D,
      v_new + (size_t)b * gd + g * D, k_pool, v_pool, scl,
      block_tables + (size_t)b * max_pages, seq_lens[b], write_page[b],
      out_dec + b * hd,
      ws + (size_t)bg * n_splits * llmq::split_ws_floats<D, NREP>(),
      counters + bg, g, layer, num_pages, page_size, max_pages, gd, scale,
      split, n_splits, smem);
}

template <int D, int NREP, typename T>
int launch_split(const void* q_dec, const void* k_new, const void* v_new,
                 const void* k_new_scale, const void* v_new_scale,
                 const void* q_pf, void* k_pool, void* v_pool, void* ks_pool,
                 void* vs_pool, const void* block_tables,
                 const void* seq_lens, const void* write_page,
                 const void* pf_qoff, const void* pf_qlen,
                 const void* pf_qstart, void* out_dec, void* out_pf,
                 void* ws, void* counters, int batch, int n_slices,
                 int n_slice_blocks, int n_splits, int layer, int num_pages,
                 int page_size, int max_pages, int n_kv_heads, float scale,
                 cudaStream_t stream) {
  constexpr int a = slice_smem_bytes<D, NREP, T>();
  constexpr int b = llmq::split_smem_bytes<D, NREP, T>();
  constexpr int smem = a > b ? a : b;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_split_kernel<D, NREP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks =
      n_slice_blocks + (long long)batch * n_kv_heads * n_splits;
  if (blocks == 0) return (int)cudaGetLastError();
  ragged_split_kernel<D, NREP, T>
      <<<(unsigned)blocks, llmq::kSplitThreads, smem, stream>>>(
          (const __nv_bfloat16*)q_dec, (const T*)k_new, (const T*)v_new,
          (const __nv_bfloat16*)k_new_scale,
          (const __nv_bfloat16*)v_new_scale, (const __nv_bfloat16*)q_pf,
          (T*)k_pool, (T*)v_pool, (__nv_bfloat16*)ks_pool,
          (__nv_bfloat16*)vs_pool, (const int*)block_tables,
          (const int*)seq_lens, (const int*)write_page, (const int*)pf_qoff,
          (const int*)pf_qlen, (const int*)pf_qstart, (__nv_bfloat16*)out_dec,
          (__nv_bfloat16*)out_pf, (float*)ws, (int*)counters, batch,
          n_slices, n_slice_blocks, n_splits, layer, num_pages, page_size,
          max_pages, n_kv_heads, scale);
  return (int)cudaGetLastError();
}

// Dispatch on the head geometry; cudaErrorInvalidValue for one without
// an instantiation (D in {64, 128}, n_rep in {1, 2, 4, 8}) or for an
// inconsistent grid (a packed buffer that is not a multiple of 8 rows,
// n_slice_blocks != N / 8 * H_kv, n_splits < 1).
template <typename T>
int dispatch(const void* q_dec, const void* k_new, const void* v_new,
             const void* k_new_scale, const void* v_new_scale,
             const void* q_pf, void* k_pool, void* v_pool, void* ks_pool,
             void* vs_pool, const void* block_tables, const void* seq_lens,
             const void* write_page, const void* pf_qoff,
             const void* pf_qlen, const void* pf_qstart, void* out_dec,
             void* out_pf, void* ws, void* counters, int batch, int n_slices,
             int n_tokens, int n_heads, int n_kv_heads, int head_dim,
             int layer, int num_pages, int page_size, int max_pages,
             int n_slice_blocks, int n_splits, float scale, void* stream) {
  if (n_tokens % kQBlock || n_splits <= 0 ||
      n_slice_blocks != n_tokens / kQBlock * n_kv_heads)
    return (int)cudaErrorInvalidValue;
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                    \
  if (head_dim == DD && n_rep == RR)                                         \
    return launch_split<DD, RR, T>(                                          \
        q_dec, k_new, v_new, k_new_scale, v_new_scale, q_pf, k_pool, v_pool, \
        ks_pool, vs_pool, block_tables, seq_lens, write_page, pf_qoff,       \
        pf_qlen, pf_qstart, out_dec, out_pf, ws, counters, batch, n_slices,  \
        n_slice_blocks, n_splits, layer, num_pages, page_size, max_pages,    \
        n_kv_heads, scale, s);
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 6, bf16 pools. n_tokens (the packed buffer's N) must be a
// multiple of 8 and n_slice_blocks = N / 8 * H_kv; n_splits >= 1 decode
// blocks per (row, KV head). ws: B * H_kv * n_splits * n_rep * (D + 2)
// floats; counters: B * H_kv ints, 0 before the launch and after it.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head geometry without an instantiation or an inconsistent grid.
extern "C" int llmq_ragged_mixed_attention(
    const void* q_dec, const void* k_new, const void* v_new, const void* q_pf,
    void* k_pool, void* v_pool, const void* block_tables,
    const void* seq_lens, const void* write_page, const void* pf_qoff,
    const void* pf_qlen, const void* pf_qstart, void* out_dec, void* out_pf,
    void* ws, void* counters, int batch, int n_slices, int n_tokens,
    int n_heads, int n_kv_heads, int head_dim, int layer, int num_pages,
    int page_size, int max_pages, int n_slice_blocks, int n_splits,
    float scale, void* stream) {
  return dispatch<__nv_bfloat16>(
      q_dec, k_new, v_new, nullptr, nullptr, q_pf, k_pool, v_pool, nullptr,
      nullptr, block_tables, seq_lens, write_page, pf_qoff, pf_qlen,
      pf_qstart, out_dec, out_pf, ws, counters, batch, n_slices, n_tokens,
      n_heads, n_kv_heads, head_dim, layer, num_pages, page_size, max_pages,
      n_slice_blocks, n_splits, scale, stream);
}

// Kernel 7, int8 pools: k_new_q / v_new_q (B, H_kv, D) int8, 8-byte
// aligned rows, with scales (B, H_kv) bf16; scale pools (L, P, H_kv,
// page_size) bf16. The slices' int8 K/V and scales must already be in
// their pages. Grid, workspace and counters as for kernel 6, of the
// kernel's own.
extern "C" int llmq_ragged_mixed_attention_q8(
    const void* q_dec, const void* k_new_q, const void* k_new_scale,
    const void* v_new_q, const void* v_new_scale, const void* q_pf,
    void* k_pool, void* v_pool, void* ks_pool, void* vs_pool,
    const void* block_tables, const void* seq_lens, const void* write_page,
    const void* pf_qoff, const void* pf_qlen, const void* pf_qstart,
    void* out_dec, void* out_pf, void* ws, void* counters, int batch,
    int n_slices, int n_tokens, int n_heads, int n_kv_heads, int head_dim,
    int layer, int num_pages, int page_size, int max_pages,
    int n_slice_blocks, int n_splits, float scale, void* stream) {
  return dispatch<int8_t>(
      q_dec, k_new_q, v_new_q, k_new_scale, v_new_scale, q_pf, k_pool,
      v_pool, ks_pool, vs_pool, block_tables, seq_lens, write_page, pf_qoff,
      pf_qlen, pf_qstart, out_dec, out_pf, ws, counters, batch, n_slices,
      n_tokens, n_heads, n_kv_heads, head_dim, layer, num_pages, page_size,
      max_pages, n_slice_blocks, n_splits, scale, stream);
}
