// Paged causal prefill attention for Hopper (sm_90a): a tensor-core
// flash kernel.
//
// Replaces paged_prefill_attention_pallas (_prefill_attn_kernel) of
// llmq_tpu/ops/pallas/prefill_attention.py: causal attention for each
// of N sequences' chunks q (N, T, H, D), row n's token t at absolute
// position starts[n] + t, over that sequence's pages (row n of the block
// tables) of a flat (L, P, ps, GD) pool — its own fresh K/V (written
// just before) and any cached history of earlier turns. Visibility is
// kv_pos <= q_pos. Only the first lengths[n] tokens of row n are live.
// JAX vmaps the kernel over a prefill wave's rows with a traced start;
// here starts and lengths are device int32 tensors and the grid comes
// from the shapes alone, (q tiles, H_kv, N), so one launch serves every
// row of a wave and a CUDA graph can hold it.
//
// What bounds it: q and the output are T * H * D * 2 bytes each and the
// K/V history 2 * S * GD * 2, against 4 * H * D flops per visible
// (query, key) pair: a short fresh chunk is bound by bytes, a long chunk
// or one over a long history by operations (989 TFLOP/s of bf16 tensor
// cores). So both products run on the tensor cores, as wgmma:
//
// - Rows. A warpgroup owns 64 query-head rows: 64 / n_rep tokens x the
//   n_rep heads of one KV group (row R is token tw + R / n_rep, head
//   g * n_rep + R % n_rep; no block-diagonal q as on the TPU). A CTA is
//   two warpgroups on consecutive tokens that share every K/V tile, so a
//   tile read from L2 serves 128 rows. CTAs walk the q tiles heaviest
//   (latest) first; a warpgroup skips a tile none of its rows can see.
// - S = Q K^T: wgmma m64n64k16 with Q (64 x D) and a 64-key K tile both
//   K-major in shared memory; f32 scores in registers.
// - Online softmax on the accumulator fragments (max floored at -1e30,
//   2^x of log2e-scaled scores on the SFU); a row's 64 scores sit in the
//   4 lanes of a quad, so its max and sum reduce with two shuffles. The
//   causal mask is applied only on tiles that cross the diagonal or the
//   end.
// - O += P V: P rounded to bf16 in registers is the A operand as it
//   stands (the score fragment of m64nN is the A fragment of m64k16), V
//   the transposed (MN-major) B operand straight from its tile;
//   O (64 x D) f32 in registers.
// - Copies. Q and every K/V tile come in by cp.async, 16 bytes a lane,
//   row addresses from the block table (so any page size works), into
//   a two-stage ring: tile i + 1 loads while tile i computes. Shared
//   tiles are [rows][64] bf16 blocks in the 128-byte swizzle that the
//   wgmma descriptors name (16-byte chunk c of row r at c ^ (r % 8)),
//   D = 128 as two blocks.
// - Tiles past the CTA's last visible position are never loaded; pages
//   outside [0, P) read as zeros (cp.async zero-fill). A q tile wholly
//   at or past lengths[n] writes zeros and returns; inside a live tile,
//   rows at or past lengths[n] are written as zeros too (JAX computes
//   and discards them; zeros keep them defined when a graph's memory is
//   reused).
//
// A thread keeps 64 f32 output and 32 score registers (at most 128 in
// all, for two CTAs of 256 threads an SM); shared memory is 97 KB at
// D = 128, so two CTAs (four warpgroups) share an SM and one's loads
// overlap another's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query-head rows per warpgroup
constexpr int kWgThreads = 128;
constexpr int kWarpgroups = 2;  // per CTA, sharing every K/V tile
constexpr int kThreads = kWarpgroups * kWgThreads;
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;

template <int D>
__host__ __device__ constexpr int wg_q_bytes() { return kRows * D * 2; }
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kKeys * D * 2; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  // + 1024: the swizzle needs 1024-byte aligned blocks.
  return kWarpgroups * wg_q_bytes<D>() + kStages * 2 * tile_bytes<D>() +
         1024;
}

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16
// block under the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy shared writes before the async
// proxy (wgmma) reads them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64) += A (64 x 16, K-major in shared memory) * B (64 x 16,
// K-major in shared memory); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, bf16 fragments in registers) * B (16 x 64,
// MN-major in shared memory: the transposed operand).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, bf16 fragments in registers) * B (16 x 128,
// MN-major in shared memory: the transposed operand).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128_tb(o, a, db);
  else
    wgmma_rs_n64_tb(o, a, db);
}

// 2^x by the SFU (ex2.approx: 2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int NREP>
__global__ void __launch_bounds__(kThreads, 2)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,  // (N,T,H,D)
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ block_tables,  // (N, MP)
                         const int* __restrict__ starts,        // (N,)
                         const int* __restrict__ lengths,       // (N,)
                         __nv_bfloat16* __restrict__ out,       // (N,T,H,D)
                         int T, int layer, int num_pages, int page_size,
                         int max_pages, int n_kv_heads, float scale_log2) {
  constexpr int ROWS = kWarpgroups * kRows;  // query-head rows per CTA
  constexpr int BQW = kRows / NREP;          // tokens per warpgroup
  constexpr int BQ = kWarpgroups * BQW;      // tokens per CTA
  constexpr int CPR = D / 8;          // 16-byte chunks per row
  constexpr int QBLK = kRows * 128;   // bytes of one 64-column block of Q
  constexpr int KBLK = kKeys * 128;   // ... of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int g = blockIdx.y;
  const int n = blockIdx.z;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int H = n_kv_heads * NREP;
  const int gd = n_kv_heads * D;
  const int tid = threadIdx.x;
  q += (size_t)n * T * H * D;
  out += (size_t)n * T * H * D;
  const int* __restrict__ block_table = block_tables + (size_t)n * max_pages;
  const int start_pos = starts[n];
  const int len = min(max(lengths[n], 0), T);  // live tokens of row n
  if (t0 >= len) {
    // A dead tile: its rows (tokens t0.., heads of group g) are zeros.
    for (int idx = tid; idx < ROWS * CPR; idx += kThreads) {
      const int t = t0 + idx / CPR / NREP;
      if (t < T)
        *reinterpret_cast<uint4*>(
            out + ((size_t)t * H + g * NREP + (idx / CPR) % NREP) * D +
            (idx % CPR) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) / 32;
  const int lane = tid % 32;
  const size_t layer_row0 = (size_t)layer * num_pages * page_size;
  const int S = max_pages * page_size;
  const int kv_end = min(start_pos + min(len, t0 + BQ), S);
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  // This warpgroup's tokens start at tw; its keys end at wg_end (it has
  // no row to compute when tw >= len).
  const int tw = t0 + wg * BQW;
  const int wg_end = min(start_pos + min(len, tw + BQW), S);
  const uint32_t sQ = sbase + wg * (wg_q_bytes<D>());

  // Q: row R of a warpgroup holds token tw + R / NREP, head
  // g * NREP + R % NREP; rows past len are zero-filled.
  for (int idx = tid; idx < ROWS * CPR; idx += kThreads) {
    const int RR = idx / CPR;  // row of the CTA
    const int c = idx % CPR;
    const int t = t0 + RR / NREP;
    const __nv_bfloat16* src =
        q + ((size_t)min(t, len - 1) * H + g * NREP + RR % NREP) * D + c * 8;
    cp_async16(sbase + (RR / kRows) * wg_q_bytes<D>() + (c / 8) * QBLK +
                   sw128(RR % kRows, c % 8),
               src, t < len ? 16 : 0);
  }
  // K/V tile `it` (keys it * kKeys ...) into stage it % kStages. A
  // thread copies chunk c of PER keys; their block-table reads go out
  // together.
  constexpr int PER = kKeys * CPR / kThreads;
  static_assert(kThreads % CPR == 0 && PER > 0, "loader layout");
  const int lc = tid % CPR;
  const int lj = tid / CPR;
  auto load_tile = [&](int it) {
    const uint32_t sK = sbase + kWarpgroups * wg_q_bytes<D>() +
                        (it % kStages) * 2 * tile_bytes<D>();
    int page[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = it * kKeys + lj + k * (kThreads / CPR);
      page[k] = p < kv_end ? block_table[p / page_size] : -1;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = lj + k * (kThreads / CPR);
      const int p = it * kKeys + j;
      const bool ok = page[k] >= 0 && page[k] < num_pages;
      const size_t off =
          ok ? (layer_row0 + (size_t)page[k] * page_size + p % page_size) *
                       gd + g * D + lc * 8
             : 0;
      const uint32_t dst = (lc / 8) * KBLK + sw128(j, lc % 8);
      cp_async16(sK + dst, k_pool + off, ok ? 16 : 0);
      cp_async16(sK + tile_bytes<D>() + dst, v_pool + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0);  // Q rides in the group of tile 0

  // This thread's two rows of its warpgroup's 64: r0 and r0 + 8.
  const int r0 = warp * 16 + lane / 4;
  const int qp0 = start_pos + tw + r0 / NREP;
  const int qp1 = start_pos + tw + (r0 + 8) / NREP;
  const int qmin = start_pos + tw;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  const float neg_inf = __int_as_float(0xff800000);

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();  // tile it has landed
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const int k0 = it * kKeys;
    // A warpgroup whose rows see no key of the tile skips it.
    const bool active = tw < len && k0 < wg_end;
    const uint32_t sK = sbase + kWarpgroups * wg_q_bytes<D>() +
                        (it % kStages) * 2 * tile_bytes<D>();
    const uint32_t sV = sK + tile_bytes<D>();
    if (active) {
      // S = Q K^T, 64 x 64, K-steps of 16 along D.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;  // 16 bf16 along the row
        wgmma_ss_n64(s, wgmma_desc(sQ + (kk / 4) * QBLK + koff, 16, 1024),
                     wgmma_desc(sK + (kk / 4) * KBLK + koff, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // Online softmax. s[4c + e] is (row r0, key 8c + 2 * (lane % 4) + e),
      // s[4c + 2 + e] the same key for row r0 + 8.
      const bool full = k0 + kKeys <= kv_end && k0 + kKeys - 1 <= qmin;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = k0 + 8 * c + 2 * (lane % 4) + e;
          float x0 = s[4 * c + e] * scale_log2;
          float x1 = s[4 * c + 2 + e] * scale_log2;
          if (!full) {
            if (!(p < kv_end && p <= qp0)) x0 = neg_inf;
            if (!(p < kv_end && p <= qp1)) x1 = neg_inf;
          }
          s[4 * c + e] = x0;
          s[4 * c + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = fast_exp2(m0 - mx0);
      const float alpha1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * c + e] = fast_exp2(s[4 * c + e] - m0);
          s[4 * c + 2 + e] = fast_exp2(s[4 * c + 2 + e] - m1);
          ls0 += s[4 * c + e];
          ls1 += s[4 * c + 2 + e];
        }
      }
      l0 = l0 * alpha0 + ls0;
      l1 = l1 * alpha1 + ls1;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= alpha0;
        o[4 * c + 1] *= alpha0;
        o[4 * c + 2] *= alpha1;
        o[4 * c + 3] *= alpha1;
      }
      // P as the A fragments of four m64k16 steps (keys 16 kk ...).
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V MN-major, 8-key groups 1024 bytes apart (SBO), 64-dim
      // blocks KBLK apart (LBO).
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(o, pa[kk], wgmma_desc(sV + kk * 16 * 128, KBLK, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    __syncthreads();  // the stage is free for the load two tiles ahead
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = r0 + 8 * half;
    const int t = tw + R / NREP;
    if (t >= T) continue;
    const float inv = t < len ? (half ? inv1 : inv0) : 0.f;
    __nv_bfloat16* orow =
        out + ((size_t)t * H + g * NREP + R % NREP) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * half] * inv,
                                o[4 * c + 2 * half + 1] * inv);
  }
}

template <int D, int NREP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* starts,
           const void* lengths, void* out, int N, int T, int layer,
           int num_pages, int page_size, int max_pages, int n_kv_heads,
           float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel<D, NREP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  constexpr int BQ = kWarpgroups * kRows / NREP;
  const dim3 grid((T + BQ - 1) / BQ, n_kv_heads, N);
  prefill_attention_kernel<D, NREP><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)block_tables,
      (const int*)starts, (const int*)lengths, (__nv_bfloat16*)out, T,
      layer, num_pages, page_size, max_pages, n_kv_heads,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head geometry without an instantiation (D in {64, 128},
// n_rep in {1, 2, 4, 8}).
extern "C" int llmq_prefill_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* starts,
                                      const void* lengths, void* out, int N,
                                      int T, int n_heads, int n_kv_heads,
                                      int head_dim, int layer, int num_pages,
                                      int page_size, int max_pages,
                                      float scale, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaGetLastError();
  const int n_rep = n_heads / n_kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define LLMQ_CASE(DD, RR)                                                   \
  if (head_dim == DD && n_rep == RR)                                        \
    return launch<DD, RR>(q, k_pool, v_pool, block_tables, starts, lengths, \
                          out, N, T, layer, num_pages, page_size, max_pages, \
                          n_kv_heads, scale, s);
  LLMQ_CASE(128, 1) LLMQ_CASE(128, 2) LLMQ_CASE(128, 4) LLMQ_CASE(128, 8)
  LLMQ_CASE(64, 1) LLMQ_CASE(64, 2) LLMQ_CASE(64, 4) LLMQ_CASE(64, 8)
#undef LLMQ_CASE
  return (int)cudaErrorInvalidValue;
}
