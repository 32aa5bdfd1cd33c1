// Device pieces shared by the kernels of msfno_torch/csrc: activation loads,
// cp.async copies, the fixed-order reduces of per-block partials, a split-K
// bf16 WMMA GEMM (the tail's backward weight gradients), and (at the end)
// Hopper's pieces: TMA tensor maps and bulk copies, mbarrier rings, named
// barriers, bf16 and tf32 wgmma with its shared-memory descriptors.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float load_act(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// 16-byte global -> shared copy that bypasses registers; src_bytes == 0
// writes zeros without reading
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Adds each sample's per-block column partials (n_samples, n_blocks, c_out)
// in a fixed order: thread (tx, ty) sums blocks ty, ty + 8, ... of column
// bx*32 + tx, then the 8 partial sums are added in ty order.  Launch with
// grid ((c_out + 31) / 32, n_samples) and block (32, 8).  part_sq and ssq
// may be null: one sum only.
__global__ void stats_reduce(const float* __restrict__ part_sum,
                             const float* __restrict__ part_sq,
                             int n_blocks, int c_out,
                             float* __restrict__ ssum, float* __restrict__ ssq) {
  __shared__ float sh_sum[8][32];
  __shared__ float sh_sq[8][32];
  const int s = blockIdx.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < c_out) {
    for (int i = threadIdx.y; i < n_blocks; i += 8) {
      const long long j = ((long long)s * n_blocks + i) * c_out + c;
      a += part_sum[j];
      if (part_sq) b += part_sq[j];
    }
  }
  sh_sum[threadIdx.y][threadIdx.x] = a;
  sh_sq[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < c_out) {
    float ta = 0.f, tb = 0.f;
    for (int t = 0; t < 8; ++t) {
      ta += sh_sum[t][threadIdx.x];
      tb += sh_sq[t][threadIdx.x];
    }
    ssum[(long long)s * c_out + c] = ta;
    if (ssq) ssq[(long long)s * c_out + c] = tb;
  }
}

// The first level of the partials' fixed-order sum: block (x, b, grp) adds
// partial rows [grp * per, grp * per + per) of columns [32 x, 32 x + 32) of
// sample b in stats_reduce's order (thread row ty takes rows ty, ty + 8,
// ...; then the 8 sums in order) into (B, groups, c); stats_reduce adds
// the groups.  (stats_reduce alone, one block a column slice, took 118 us
// over the head's 8111 rows on the H100.)
__global__ void tile_reduce(const float* __restrict__ part_sum,
                            const float* __restrict__ part_sq, int tiles, int per, int c,
                            float* __restrict__ grp_sum, float* __restrict__ grp_sq) {
  __shared__ float sh_sum[8][32];
  __shared__ float sh_sq[8][32];
  const int b = blockIdx.y, grp = blockIdx.z;
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int t1 = min(tiles, (grp + 1) * per);
  float s = 0.f, q = 0.f;
  if (col < c) {
    for (int i = grp * per + threadIdx.y; i < t1; i += 8) {
      const long long j = ((long long)b * tiles + i) * c + col;
      s += part_sum[j];
      if (part_sq) q += part_sq[j];
    }
  }
  sh_sum[threadIdx.y][threadIdx.x] = s;
  sh_sq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < 8; ++r) {
      ts += sh_sum[r][threadIdx.x];
      tq += sh_sq[r][threadIdx.x];
    }
    const long long o = ((long long)b * gridDim.z + grp) * c + col;
    grp_sum[o] = ts;
    if (grp_sq) grp_sq[o] = tq;
  }
}

// out[j] = sum over i of part[i * n_cols + j], i in order: the fixed-order
// reduce of per-block or per-split partials.  Launch with n_cols threads.
__global__ void sum_rows(const float* __restrict__ part, int n_rows, int n_cols,
                         float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_cols) return;
  float s = 0.f;
  for (int i = 0; i < n_rows; ++i) s += part[(long long)i * n_cols + j];
  out[j] = s;
}

// C (M x N, fp32, row-major) = A (M x K) @ B (K x N) on bf16 WMMA with fp32
// accumulation.  A_T: A is stored as its (K x M) row-major transpose;
// otherwise (M x K) row-major.  B_T: B is stored as its (N x K) row-major
// transpose; otherwise (K x N) row-major.  lda and ldb are the stored rows'
// lengths.  The stored rows' contiguous extents (K or M for A, N or K for B)
// are multiples of 8 and every row starts 16-byte aligned: tiles are copied
// as 16-byte vectors (cp.async), vectors past the end read as zeros.  Where K
// is a contiguous extent (A row-major, or B_T), k_split is a multiple of 8.
// blockIdx.z splits K into ranges of k_split; split z writes its partial
// product to C + z * M * N.  A block computes a GEMM_BM x GEMM_BN tile with
// 8 warps, each one 16-row tile x two 16-column tiles, K in double-buffered
// slabs of GEMM_KC.
constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_KC = 32, GEMM_THREADS = 256;

template <bool A_T, bool B_T>
__device__ __forceinline__ void gemm_stage(const __nv_bfloat16* A, long long lda,
                                           const __nv_bfloat16* B, long long ldb, int M, int N,
                                           long long k0, long long k_end, int m0, int n0,
                                           __nv_bfloat16* as, __nv_bfloat16* bs) {
  // one 16-byte vector of each operand per thread: 64 x 32 values = 256 vectors
  const int t = threadIdx.x;
  if (!A_T) {  // as[m][k], ld GEMM_KC + 8
    const int m = t / 4, k = (t % 4) * 8;
    const bool ok = m0 + m < M && k0 + k < k_end;
    cp_async16(as + m * (GEMM_KC + 8) + k, ok ? (const void*)(A + (m0 + m) * lda + k0 + k) : A,
               ok ? 16 : 0);
  } else {  // as[k][m], ld GEMM_BM + 8
    const int k = t / 8, m = (t % 8) * 8;
    const bool ok = k0 + k < k_end && m0 + m < M;
    cp_async16(as + k * (GEMM_BM + 8) + m, ok ? (const void*)(A + (k0 + k) * lda + m0 + m) : A,
               ok ? 16 : 0);
  }
  if (!B_T) {  // bs[k][n], ld GEMM_BN + 8
    const int k = t / 8, n = (t % 8) * 8;
    const bool ok = k0 + k < k_end && n0 + n < N;
    cp_async16(bs + k * (GEMM_BN + 8) + n, ok ? (const void*)(B + (k0 + k) * ldb + n0 + n) : B,
               ok ? 16 : 0);
  } else {  // bs[n][k], ld GEMM_KC + 8
    const int n = t / 4, k = (t % 4) * 8;
    const bool ok = n0 + n < N && k0 + k < k_end;
    cp_async16(bs + n * (GEMM_KC + 8) + k, ok ? (const void*)(B + (n0 + n) * ldb + k0 + k) : B,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

template <bool A_T, bool B_T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16(const __nv_bfloat16* __restrict__ A, long long lda,
          const __nv_bfloat16* __restrict__ B, long long ldb, float* __restrict__ C, int M,
          int N, long long K, long long k_split) {
  constexpr int A_ELEMS = A_T ? GEMM_KC * (GEMM_BM + 8) : GEMM_BM * (GEMM_KC + 8);
  constexpr int B_ELEMS = B_T ? GEMM_BN * (GEMM_KC + 8) : GEMM_KC * (GEMM_BN + 8);
  __shared__ __align__(128) __nv_bfloat16 as[2][A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 bs[2][B_ELEMS];
  __shared__ __align__(32) float scratch[8][256];
  using FA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                            typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type>;
  using FB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                            typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const long long k_begin = (long long)blockIdx.z * k_split;
  const long long k_end = k_begin + k_split < K ? k_begin + k_split : K;
  const int rt = warp % 4, ct0 = (warp / 4) * 2;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  if (k_begin < k_end) {
    const int n_slabs = (int)((k_end - k_begin + GEMM_KC - 1) / GEMM_KC);
    gemm_stage<A_T, B_T>(A, lda, B, ldb, M, N, k_begin, k_end, m0, n0, as[0], bs[0]);
    for (int s = 0; s < n_slabs; ++s) {
      if (s + 1 < n_slabs) {
        gemm_stage<A_T, B_T>(A, lda, B, ldb, M, N, k_begin + (long long)(s + 1) * GEMM_KC,
                             k_end, m0, n0, as[(s + 1) % 2], bs[(s + 1) % 2]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* a_s = as[s % 2];
      const __nv_bfloat16* b_s = bs[s % 2];
#pragma unroll
      for (int kk = 0; kk < GEMM_KC; kk += 16) {
        FA fa;
        if (A_T)
          wmma::load_matrix_sync(fa, a_s + kk * (GEMM_BM + 8) + rt * 16, GEMM_BM + 8);
        else
          wmma::load_matrix_sync(fa, a_s + rt * 16 * (GEMM_KC + 8) + kk, GEMM_KC + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FB fb;
          if (B_T)
            wmma::load_matrix_sync(fb, b_s + (ct0 + j) * 16 * (GEMM_KC + 8) + kk, GEMM_KC + 8);
          else
            wmma::load_matrix_sync(fb, b_s + kk * (GEMM_BN + 8) + (ct0 + j) * 16, GEMM_BN + 8);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();  // this buffer is refilled two slabs on
    }
  }
  float* out = C + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(scratch[warp], acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int m = m0 + rt * 16 + e / 16, n = n0 + (ct0 + j) * 16 + e % 16;
      if (m < M && n < N) out[(long long)m * N + n] = scratch[warp][e];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): TMA, bulk copies, mbarrier rings, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase after `count` arrivals (and the
// transaction bytes announced by expect_tx).  Initialise from one thread,
// then fence_barrier_init() and a block barrier before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA / bulk-copy transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// waits until the phase of parity `parity` has completed (the n-th
// completion of a barrier has parity n & 1); a wait of more than 10 s traps
// (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 1023) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}

// orders this thread's generic shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the block
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `n` threads, whole warps
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// TMA tile loads into shared memory, completing on `bar`; coordinates
// innermost first, in elements
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0),
         "r"(x1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x0, int x1, int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0),
         "r"(x1), "r"(x2) : "memory");
}
// one contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar)) : "memory");
}

// wgmma operand descriptor of a bf16 tile in the 128-byte swizzle that a
// SWIZZLE_128B tensor map writes (rows of 128 bytes, 1024-byte aligned
// 8-row atoms).  K-major operand: sbo = 1024 (8 rows), lbo unused; a K-step
// of 16 advances the start by 32 bytes.  MN-major operand: lbo = the bytes
// between 64-element MN chunks, sbo = 1024 (8 K-rows); a K-step of 16
// advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// moves registers between warpgroups (each warpgroup executes it whole):
// a producer gives some up, the consumers take them
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// keeps the compiler from moving accumulator accesses across a wgmma
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 fp32, the warpgroup's accumulator fragment) (+)= A (64 x 16
// bf16) @ B (16 x 128 bf16), both from shared memory by descriptor: A
// K-major (TRANS_A 0) or MN-major (TRANS_A 1), B K-major (TRANS_B 0) or
// MN-major (TRANS_B 1); scale_d 0 overwrites d.  Thread t of the warpgroup
// holds d[4q + 2h + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 q +
// 2 (t % 4) + e.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// the m64n64k16 form of wgmma_m64n128k16: d is the warpgroup's 64 x 64
// fragment (32 registers a thread), the same layout for q < 8
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// The nearest tf32 value of x, ties away from zero (its low 13 significand
// bits zero): the tensor cores read only a tf32 operand's top 19 bits, so
// an operand not rounded this way would be truncated
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (64 x N fp32, the warpgroup's accumulator fragment, the layout of
// wgmma_m64n128k16 for q < N / 8) (+)= A (64 x 8 tf32) @ B (8 x N tf32),
// both K-major in shared memory by descriptor (tf32 wgmma has no
// transpose), N 112 or 128; scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 112) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 112 || N == 128, "wgmma_tf32: N is 112 or 128");
  }
}

// Host: a TMA tensor map (CUtensorMap) of a `rank`-dimensional array at
// device address `base`: dims and box innermost first, in elements;
// strides (rank - 1 of them) of the outer dimensions in bytes, multiples of
// 16.  Boxes past the array's edge are filled with zeros.
// cuTensorMapEncodeTiled (a CUDA driver API function) is taken through the
// runtime's entry-point query, so the library links against the runtime
// alone.  Returns a CUDA error
// code, 0 on success.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

typedef CUresult (*CtxGetCurrentFn)(CUcontext*);

// a driver API function by name, nullptr where the driver lacks it
inline void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = (EncodeTiledFn)driver_fn("cuTensorMapEncodeTiled");
  return fn;
}

inline CtxGetCurrentFn ctx_get_current_fn() {
  static const CtxGetCurrentFn fn = (CtxGetCurrentFn)driver_fn("cuCtxGetCurrent");
  return fn;
}

inline int make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                           const void* base, const uint64_t* dims, const uint64_t* strides,
                           const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  const CtxGetCurrentFn get_ctx = ctx_get_current_fn();
  if (fn == nullptr || get_ctx == nullptr) return (int)cudaErrorSymbolNotFound;
  // the encode needs a current context on this thread (a backward pass runs
  // on autograd's own thread, maybe before any runtime call there): where
  // there is none, make the device's primary context current
  CUcontext ctx = nullptr;
  if (get_ctx(&ctx) != CUDA_SUCCESS) return (int)cudaErrorInvalidDevice;
  int dev = 0;
  if (ctx == nullptr && (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess))
    return (int)cudaErrorInvalidDevice;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
