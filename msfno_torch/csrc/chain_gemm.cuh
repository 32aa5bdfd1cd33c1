// Chained wgmma GEMMs over 128-row tiles, shared by grid_encoder_spectral.cu
// (the encoder MLP pass), grid_mlp.cu (the pointwise MLP), spectral_decoder.cu
// (the fused tail) and spectral_decoder_bwd.cu (the tail's backward, which runs its GEMMs on
// m64n64 accumulators and releases the ring its own way: see chain_gemm).
//
// The kernels are persistent: a block per SM walks its tiles of CH_BM = 128
// rows (pixels), and every GEMM of the chain has N <= 256.  Four consumer
// warpgroups split a tile's 128 x 256 output: warpgroup (m, n) owns rows
// [64 m, 64 m + 64) and columns [128 n, 128 n + 128), one m64n128 fp32
// accumulator (64 registers a thread) that every GEMM of the chain reuses.
// Sixteen warps share the epilogues, whose CUDA-core work (the GELU, the
// statistics, the conversions) outweighs the tensor-core work at these
// widths.  One warp of a producer warpgroup streams each GEMM's B operand
// (K x N, row-major bf16: the weights, or the tail's t rows) through an
// mbarrier ring of 64-K stages by TMA, as boxes of 64 x 64 in the 128-byte
// swizzle, MN-major, exactly as row_gemm.cuh's wgmma_gemm loads its
// weights.  The ring runs across the GEMMs of the chain and across tiles,
// so the next GEMM's (and the next tile's) operands arrive while the
// current one computes.
//
// A GEMM's A operand is the block's "A tile": 128 rows x up to 7 K-chunks
// of 64 bf16, K-major in the 128-byte swizzle (a_tile_offset), the layout a
// SWIZZLE_128B TMA box of 64 x 128 writes.  The epilogue of one GEMM writes
// the next GEMM's A operand there (frag_to_a_tile): the two warpgroups of a
// row half write their column halves once both have retired their wgmmas
// (pair_sync), and sync again before the next GEMM reads them.  Raw
// activations (fp32 or bf16 rows of any width) come through the ring and
// enter the tile through rows_to_a_tile.
//
// Also: the exact GELU on a branch-free erf, zero_cols, TMA tensor
// stores (tma_store_3d) and their bulk-group waits, tensor-map and L2
// prefetch.

#pragma once

#include "row_gemm.cuh"

namespace {

constexpr int CH_BM = 128;                    // rows per tile
constexpr int CH_BK = 64;                     // K per ring stage: one 128-byte bf16 row
constexpr int CH_CHUNK = CH_BM * CH_BK * 2;   // 16 KB: one K-chunk of the A tile
constexpr int CH_BOX = CH_BK * 64 * 2;        // 8 KB: one 64 x 64 B box
constexpr int CH_CONSUMERS = 512;             // four consumer warpgroups
// and a producer warpgroup (one warp works): 640 threads, 96 registers
// each at launch (an SM sub-partition's 16K registers hold 5 warps of 96).
// setmaxnreg moves 72 a thread from the producer to the consumers: 24 and
// 112.
constexpr int CH_THREADS = CH_CONSUMERS + 128;
#define CH_KERNEL __global__ void __launch_bounds__(CH_THREADS, 1)
__device__ __forceinline__ void producer_regs() { reg_dealloc<24>(); }
__device__ __forceinline__ void consumer_regs() { reg_alloc<112>(); }

// A consumer thread's place: warpgroup (m, n), its thread t and warp w
struct Role {
  int m, n, t, w;
  __device__ __forceinline__ Role()
      : m(threadIdx.x / 256), n(threadIdx.x / 128 % 2), t(threadIdx.x % 128),
        w(threadIdx.x / 32 % 4) {}
};

// named barriers: 1 all consumers; 2 + m the two warpgroups of row half m;
// 4 + warpgroup one warpgroup
__device__ __forceinline__ void consumers_sync() { named_bar_sync(1, CH_CONSUMERS); }
__device__ __forceinline__ void pair_sync(const Role& r) { named_bar_sync(2 + r.m, 256); }
__device__ __forceinline__ void wg_sync(const Role& r) { named_bar_sync(4 + 2 * r.m + r.n, 128); }

// gelu_exact(v) with erf as a branch-free rational approximation (Eigen's
// f32 erf: x clamped to [-4, 4], an odd degree-13 numerator over an even
// degree-8 denominator; within 4.2e-7 of erf on [-6, 6], its plain mirror
// ops/kernels/grid_encoder_spectral.py:erf_rational is tested against
// erf).  CUDA's erff branches on |x|, which slowed these epilogues, whose
// result is rounded to bf16.
__device__ __forceinline__ float gelu_rational(float v) {
  const float x = fminf(fmaxf(v * 0.70710678118654752f, -4.f), 4.f);
  const float x2 = x * x;
  float p = fmaf(x2, -2.72614225801306e-10f, 2.77068142495902e-08f);
  p = fmaf(x2, p, -2.10102402082508e-06f);
  p = fmaf(x2, p, -5.69250639462346e-05f);
  p = fmaf(x2, p, -7.34990630326855e-04f);
  p = fmaf(x2, p, -2.95459980854025e-03f);
  p = fmaf(x2, p, -1.60960333262415e-02f);
  float q = fmaf(x2, -1.45660718464996e-05f, -2.13374055278905e-04f);
  q = fmaf(x2, q, -1.68282697438203e-03f);
  q = fmaf(x2, q, -7.37332916720468e-03f);
  q = fmaf(x2, q, -1.42647390514189e-02f);
  return 0.5f * v * (1.f + __fdividef(x * p, q));
}

// The dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atoms), offset from the array itself so that the
// compiler keeps knowing every access through it is to shared memory.
__device__ __forceinline__ char* smem_base_1024(char* smem_raw) {
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// byte offset of element (row, k) of the A tile: K-chunk k / 64, 128-byte
// rows, 16-byte units swizzled by the row's low three bits
__device__ __forceinline__ int a_tile_offset(int row, int k) {
  return (k / 64) * CH_CHUNK + row * 128 + ((((k % 64) / 8) ^ (row & 7)) * 16) + (k % 8) * 2;
}

// byte offset of element (row, col) of 64 rows of bf16 loaded by TMA as
// 64-column boxes (a warpgroup's pe in grid_encoder_spectral.cu and
// grid_mlp.cu): 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ int box_offset(int row, int col) {
  return (col / 64) * CH_BOX + row * 128 + ((((col % 64) / 8) ^ (row & 7)) * 16) + (col % 8) * 2;
}

// Writes a warpgroup's 64 x 128 (NACC 64) or 64 x 64 (NACC 32) accumulator
// fragment d (the layout of wgmma_m64n128k16 / m64n64k16) as bf16(f(value,
// column)) into rows [row0, row0 + 64) and columns [col0, col0 + NACC * 2)
// of the A tile below n_cols (even).
template <int NACC, class F>
__device__ __forceinline__ void frag_to_a_tile(const float (&d)[NACC], char* tile, int row0,
                                               int col0, int n_cols, const F& f) {
  const int r = row0 + acc_row0();
#pragma unroll
  for (int q = 0; q < NACC / 4; ++q) {
    const int col = col0 + acc_col(q, 0);
    if (col >= n_cols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + a_tile_offset(r + 8 * h, col)) =
          __floats2bfloat162_rn(f(d[4 * q + 2 * h], col), f(d[4 * q + 2 * h + 1], col + 1));
  }
}

// Columns [from, to) of rows [row0, row0 + 64) of an A tile set to zero
// (from a multiple of 8): chain_gemm runs every K-step of a stage, so A's
// columns past a GEMM's K up to the stage's end must be finite (B's rows
// there are zero).  Thread tid of n_threads.
__device__ __forceinline__ void zero_cols(char* tile, int row0, int from, int to, int tid,
                                          int n_threads) {
  const int units = (to - from) / 8;
  for (int e = tid; e < 64 * units; e += n_threads) {
    const int r = e / units, u = e - r * units;
    *reinterpret_cast<uint4*>(tile + a_tile_offset(row0 + r, from + 8 * u)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}
__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 64 rows of `width` raw values each (row pitch `width`, in shared or
// device memory) into rows [row0, row0 + 64) and columns [k_off, k_off +
// width) of the A tile as bf16, zeros from row row0 + n_valid on and in
// columns up to the next multiple of 16 (the K-steps read them); k_off a
// multiple of 16.  With aff_a, value v of column k enters as v * aff_a[k] +
// aff_b[k] in fp32 (two roundings, as the plain version), then rounded.
// Thread tid of n_threads takes every n_threads-th (row, 8-column group).
// The caller fences (fence_proxy_async) and syncs before a wgmma reads it.
template <typename IN_T>
__device__ __forceinline__ void rows_to_a_tile(const IN_T* src, int n_valid, int width,
                                               char* tile, int row0, int k_off, int tid,
                                               int n_threads, const float* aff_a = nullptr,
                                               const float* aff_b = nullptr) {
  const int groups = (width + 15) / 16 * 2;
  if constexpr (std::is_same<IN_T, __nv_bfloat16>::value) {
    // bf16 rows of whole 16-byte vectors: copied, not converted
    if (aff_a == nullptr && width % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      for (int e = tid; e < 64 * groups; e += n_threads) {
        const int row = e / groups, j = e % groups;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < n_valid && 8 * j < width)
          v = *reinterpret_cast<const uint4*>(src + (long long)row * width + 8 * j);
        *reinterpret_cast<uint4*>(tile + a_tile_offset(row0 + row, k_off + 8 * j)) = v;
      }
      return;
    }
  }
  for (int e = tid; e < 64 * groups; e += n_threads) {
    const int row = e / groups, j = e % groups;
    alignas(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * j + i;
      float u = 0.f;
      if (row < n_valid && k < width) {
        u = to_float(src[(long long)row * width + k]);
        if (aff_a) u = __fadd_rn(__fmul_rn(u, aff_a[k]), aff_b[k]);  // no FMA: the plain rounding
      }
      v[i] = __float2bfloat16_rn(u);
    }
    *reinterpret_cast<uint4*>(tile + a_tile_offset(row0 + row, k_off + 8 * j)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The ring of B stages: `stages` slots of slot_bytes, a full and an empty
// barrier per slot.
struct Ring {
  char* slots;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, stages;
};

// Thread 0, before the block barrier that precedes any use.
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < r.stages; ++s) {
    mbar_init(r.full + s, 1);
    mbar_init(r.empty + s, CH_CONSUMERS / 32);  // every consumer warp
  }
}

// Producer: waits until ring stage s's slot is free and returns it; its
// full barrier is r.full + s % r.stages.
__device__ __forceinline__ char* ring_acquire(const Ring& r, int s) {
  const int slot = s % r.stages;
  if (s >= r.stages) mbar_wait(r.empty + slot, (s / r.stages - 1) & 1);
  return r.slots + slot * r.slot_bytes;
}

// Producer lane: the B boxes of one stage, columns [n0, n0 + n) of K rows
// [k0, k0 + 64) of a row-major (K x N) bf16 matrix, 64 columns a box (z >=
// 0: of matrix z of a 3-D map), announced on bar
__device__ __forceinline__ void load_b_boxes(char* dst, const CUtensorMap* map, uint64_t* bar,
                                             int n, int k0, int z, int n0 = 0) {
  const int boxes = (n + 63) / 64;
  mbar_expect_tx(bar, boxes * CH_BOX);
  for (int b = 0; b < boxes; ++b) {
    if (z >= 0) tma_load_3d(dst + b * CH_BOX, map, bar, n0 + 64 * b, k0, z);
    else tma_load_2d(dst + b * CH_BOX, map, bar, n0 + 64 * b, k0);
  }
}

// Raw rows through the ring: two stages carry the raw rows of the tile's
// two row halves (64 rows of row_bytes each, from src, n_rows of them
// valid), each as one bulk copy when it fits a slot and is 16-byte aligned
// (raw_bytes > 0), else the consumers read them from device memory.
__device__ __forceinline__ uint32_t raw_bytes(const void* src, int n_rows, int row_bytes,
                                              int slot_bytes) {
  const uint32_t bytes = (uint32_t)max(n_rows, 0) * row_bytes;
  return bytes > 0 && bytes % 16 == 0 && bytes <= (uint32_t)slot_bytes &&
                 reinterpret_cast<uintptr_t>(src) % 16 == 0
             ? bytes
             : 0;
}

// Producer lane: ring stage s (already acquired, slot sb) with the raw rows
// of one half
__device__ __forceinline__ void load_raw(const Ring& r, int s, char* sb, const void* src,
                                         int n_rows, int row_bytes) {
  uint64_t* full = r.full + s % r.stages;
  const uint32_t bytes = raw_bytes(src, n_rows, row_bytes, r.slot_bytes);
  if (bytes) {
    mbar_expect_tx(full, bytes);
    bulk_load(sb, src, bytes, full);
  } else {
    mbar_arrive(full);
  }
}

// Consumers of row half m (two warpgroups): its raw rows (ring stage s + m;
// src: the half's first row in device memory, n_rows valid) into rows [64
// m, 64 m + 64), columns [k_off, k_off + width) of the A tile (through the
// affine aff_a, aff_b when given: rows_to_a_tile).  Every warp waits for
// both stages in turn and releases each: a warp that skipped one of a
// slot's phases could later take the next phase's parity for done.
// Returns the ring stage after the two.
template <typename IN_T>
__device__ __forceinline__ int raw_to_a_tile(const Ring& r, int s, const Role& ro,
                                             const IN_T* src, int n_rows, int width, char* tile,
                                             int k_off, const float* aff_a = nullptr,
                                             const float* aff_b = nullptr) {
  for (int h = 0; h < 2; ++h, ++s) {
    const int slot = s % r.stages;
    mbar_wait(r.full + slot, (s / r.stages) & 1);
    if (h == ro.m) {
      const bool bulk = raw_bytes(src, n_rows, width * (int)sizeof(IN_T), r.slot_bytes) > 0;
      rows_to_a_tile<IN_T>(bulk ? reinterpret_cast<const IN_T*>(r.slots + slot * r.slot_bytes)
                                : src,
                           n_rows, width, tile, 64 * ro.m, k_off, ro.n * 128 + ro.t, 256, aff_a,
                           aff_b);
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + slot);
  }
  return s;
}

// KS K-steps of 16 of one stage: acc (+)= A (64 rows at a, K-major) @ B
// (NACC * 2 columns at b, MN-major); `first` overwrites acc at the first step
template <int KS, int NACC>
__device__ __forceinline__ void stage_mma(float (&acc)[NACC], const char* a, const char* b,
                                          bool first) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t da = wgmma_desc(a + ks * 32, 16, 1024);
    const uint64_t db = wgmma_desc(b + ks * 2048, CH_BOX, 1024);
    if constexpr (NACC == 64) wgmma_m64n128k16<1>(acc, da, db, (first && ks == 0) ? 0 : 1);
    else wgmma_m64n64k16<1>(acc, da, db, (first && ks == 0) ? 0 : 1);
  }
}

// The ring's default release: lane 0 of each consumer warp arrives on the
// stage's empty barrier, which the producer waits on.
struct ArriveEmpty {
  static constexpr int chunks = 1;  // see chain_gemm
  const Ring& r;
  __device__ __forceinline__ void operator()(int s) const { mbar_arrive(r.empty + s % r.stages); }
};

// Consumer warpgroup (m, n): one GEMM of the chain over ring stages [s, s +
// ceil(k / (64 chunks))), acc = A[rows of m] @ B[:, columns of n], A's
// K-chunk j at a_of(j, slot), B's boxes at the slot's start, NACC / 32 of
// them a warpgroup (an inactive warpgroup, whose columns are past N, waits
// for each stage and releases it).  A stage holds Release::chunks K-chunks
// of 64 (A's chunks a_of(chunks * j + c), B's boxes of chunk c after those
// of the chunks before it), so that a stage's fixed costs (the barrier
// wait, draining its wgmmas) are paid once for more work.  A stage runs
// all its K-steps of 16, with no branch between its wgmmas: ptxas
// serializes wgmmas that a runtime switch over the K-step count separates
// (C7520, a wait after each).  So the caller keeps B's rows past k zero
// (TMA zero-fills rows past a tensor's end) and A's columns past k, up to
// the stage's end, finite (zero_cols).  Each stage's wgmmas retire before
// the next stage is waited for, and the stage is released at once: one
// more stage of the ring loads while the warp waits (on the H100 this beat
// keeping a stage's wgmmas in flight while waiting for the next: the head
// 1.31 against 1.35 ms, the tail 1.41 against 1.47, the tail's backward
// 4.21 against 4.55).  `release(stage)` is called by lane 0 of each warp
// once the warp is done with that stage (default: ArriveEmpty).  Returns
// the next ring stage.
template <int NACC, class AOf, class Release>
__device__ __forceinline__ int chain_gemm(float (&acc)[NACC], const Ring& r, int s, int k,
                                          const AOf& a_of, const Role& ro, bool active,
                                          const Release& release) {
  constexpr int CHUNKS = Release::chunks;
  // the accumulator's last access before this GEMM's wgmmas, where every
  // thread passes: else ptxas places the wgmma fence it inserts on whatever
  // divergent path (an epilogue's masked store) read acc last, and
  // serializes every wgmma of the kernel (C7520: a wait after each)
  fence_operand(acc);
  const int lane = threadIdx.x % 32;
  const int n_stages = (k + CHUNKS * CH_BK - 1) / (CHUNKS * CH_BK);
  if (!active) {
    for (int j = 0; j < n_stages; ++j, ++s) {
      mbar_wait(r.full + s % r.stages, (s / r.stages) & 1);
      __syncwarp();
      if (lane == 0) release(s);
    }
    return s;
  }
  for (int j = 0; j < n_stages; ++j, ++s) {
    const int slot = s % r.stages;
    char* sb = r.slots + slot * r.slot_bytes;
    mbar_wait(r.full + slot, (s / r.stages) & 1);
    wgmma_fence();
    fence_operand(acc);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int kc = CHUNKS * j + c;
      const char* a = a_of(kc, sb) + ro.m * 8192;
      const char* b = sb + (2 * c + ro.n) * (NACC / 32) * CH_BOX;
      stage_mma<4, NACC>(acc, a, b, j == 0 && c == 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) release(s);
  }
  return s;
}
template <int NACC, class AOf>
__device__ __forceinline__ int chain_gemm(float (&acc)[NACC], const Ring& r, int s, int k,
                                          const AOf& a_of, const Role& ro, bool active) {
  return chain_gemm(acc, r, s, k, a_of, ro, active, ArriveEmpty{r});
}

// brings the 128-byte line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// brings a tensor map's descriptor into the cache before its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA tile store from shared memory (coordinates innermost first, in
// elements; parts of the box past the tensor's edges are not written), in
// this thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x0,
                                             int x1, int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(x0), "r"(x1), "r"(x2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Host: a 2-D (rows x cols, row-major, ld elements a row) or 3-D (z x rows
// x cols) bf16 tensor map of boxes box_rows x box_cols in the 128-byte
// swizzle.  Returns a CUDA error code.
inline int bf16_map(CUtensorMap* map, const void* base, int rows, int cols, long long ld,
                    int box_rows, int box_cols, long long z = 0) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || ld % 8) return (int)cudaErrorInvalidValue;
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)z};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)ld * 2 * rows};
  const uint32_t box[3] = {(uint32_t)box_cols, (uint32_t)box_rows, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z > 0 ? 3 : 2, base, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
