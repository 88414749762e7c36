// bf16 GEMM on Hopper's tensor cores (sm_90a) with an f32 accumulator:
// C(M,N) = A(M,K) · B(K,N), batched on blockIdx.z with per-batch strides.
// A is bf16 row-major (or, on the tile path, M-major: (K, M) read in
// place, gmm_blocks_dw's x (C, d) as xᵀ). C is bf16 (each output rounded to nearest-even
// once) or f32 (the accumulator stored as it is). B is bf16 in one of two
// layouts, read in place:
//   row-major  (K,N) with leading dimension ldb (a weight as stored);
//   K-major    (N,K) with leading dimension ldb: a w whose w.T is
//              contiguous, such as the tied head's embed (V,d) read as
//              embed.T, with no copy.
// With `rows` (one int per batch entry, read on the device), output rows
// r >= rows[z] are zero, and a tile whose rows all lie past rows[z] loads
// nothing: an expert with no rows reads none of its weights. With `klim`
// (one int per batch entry, read on the device; an M-major A only), batch
// entry z contracts over k < klim[z] only: A's and B's k rows past it are
// never read (zero-filled in the copies), a K step wholly past it is not
// taken, and an entry or a K split with nothing left stores zeros
// (gmm_blocks_dw off TMA's grid: dw[e] = x[e]^T dy[e] over the expert's
// group_sizes[e] rows).
//
// Two paths, chosen on the host by plan_bf16_gemm (kernels/matmul.py):
//
//   * tile (M > 16): 64·NWG x 128 output tile, NWG = 1 or 2 consumer
//     warpgroups, K step 64. Each K step is one stage of a 3-deep ring
//     of 16-byte cp.async.cg copies into the 128-byte-swizzled layout
//     that the wgmma descriptors name; every thread both copies and
//     computes (no TMA, no warp specialisation: ragged and unaligned edges
//     are masked in the copies). Products: wgmma.mma_async m64n128k16, A
//     and B from shared memory, A K-major or M-major, B K-major or
//     N-major (the descriptors' transpose bits), with one group of them in flight while
//     the next stage's barrier and copies are issued.
//   * skinny (M <= 16: decode at batch 1-4, MoE blocks of capacity 8):
//     bound by the bytes of B, so each 128-thread block owns a 64-column
//     slab of N (and one batch entry) and streams its B once through a
//     4-deep cp.async ring, with A's <= 16 rows beside it. Products:
//     mma.sync m16n8k16 from ldmatrix fragments (ldmatrix.trans for a
//     row-major B); rows past M are zero-filled in shared memory, never
//     padded in device memory.
//
// Both paths split K when the output tiles alone leave SMs idle: split s
// of `split` takes an equal share of the K steps and writes f32 partials
// to the caller's scratch (split, batch, M, N); a second kernel sums them
// in split order and stores C. No atomics: the same inputs give the same
// bits on every launch.
//
// Unaligned operands (a leading dimension or base address that is not a
// multiple of 16 bytes) are copied element by element into the same
// layout; ragged M, N and K are zero-filled in the copies and masked in
// the store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_torch {
namespace tc {

constexpr int kBK = 64;            // K step: 64 bf16 = one 128-byte row
// cp.async ring depths. The tile path's 3 stages (24 KB each with one
// warpgroup, 32 KB with two) let three or two blocks share an SM; its
// copies run one stage ahead, the skinny path's three.
constexpr int kTileStages = 3;
constexpr int kSkinnyStages = 4;
constexpr int kTileBN = 128;       // tile path: output columns a block
constexpr int kSkinnyBM = 16;      // skinny path: rows (M <= 16)
constexpr int kSkinnyBN = 64;      // skinny path: columns a block
constexpr int kSkinnyThreads = 128;
constexpr int kAtomBytes = 8 * 128;  // one swizzle atom: 8 rows of 128 B

enum Path { kSkinny = 0, kTile = 1 };

struct Problem {
  const __nv_bfloat16* A;  // (batch, M, K), lda = K
  const __nv_bfloat16* B;  // row-major (K,N) or K-major (N,K), ldb
  void* C;                 // (batch, M, N) out, or f32 partials
  const int* rows;         // (batch,) valid rows, or nullptr
  const int* klim;         // (batch,) K depth of each entry, or nullptr
  int M, N, K, ldb;
  long long batch_a, batch_b, batch_c;
  long long split_stride;  // elements between two splits' partials
  int ksteps_per_split;
  int a_vec, b_vec;        // 16-byte copies allowed
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows under the 128-byte swizzle (chunk XOR row mod 8)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the 4 bytes at src into the shared slot dst (cached in L1)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// Copy the 8 bf16 at (row, col..col+7) of a row-major matrix with leading
// dimension ld into the 16-byte shared slot dst; elements outside
// [0, nrows) x [0, ncols) are zero.
__device__ __forceinline__ void load_chunk(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int row, int nrows,
                                           int col, int ncols, int vec) {
  int valid = row < nrows ? ncols - col : 0;
  valid = valid < 0 ? 0 : (valid > 8 ? 8 : valid);
  if (vec) {
    const void* g = valid ? (const void*)(src + (size_t)row * ld + col)
                          : (const void*)src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(g), "r"(valid * 2));
  } else {
    const uint16_t* s =
        reinterpret_cast<const uint16_t*>(src) + (size_t)row * ld + col;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = (2 * j < valid) ? s[2 * j] : 0u;
      const uint32_t hi = (2 * j + 1 < valid) ? s[2 * j + 1] : 0u;
      v[j] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d(16x8) += a(16x16, row) · b(16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, lo in the low half: an mma.sync A or B register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (bits 16-29) and stride byte offset (bits
// 32-45) in 16-byte units, swizzle mode 1 (128 B) in bits 62-63. The
// stride offset steps from one 8-row atom (8 x 128 B) to the next: along
// M or N for a K-major operand, along K for an N-major one. The leading
// offset steps from one 64-column atom to the next along N for an N-major
// B; a K-major operand's 16-deep slice lies inside one 128-byte row, so
// its leading offset is unused (1).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr,
                                               uint32_t lead_bytes) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d(64x128) += A(64x16) · B(16x128), one warpgroup; A K-major (TRANS_A
// 0) or M-major (TRANS_A 1); B K-major (TRANS_B 0) or N-major (TRANS_B 1).
// d0 holds columns 0-63, d1 64-127.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d0)[32],
                                                 float (&d1)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// outputs (r, c) and (r, c + 1), c even; rows in [rows, M) are zero
template <typename TC>
__device__ __forceinline__ void store_pair(TC* C, int M, int N, int rows,
                                           int r, int c, float v0, float v1) {
  if (r >= M || c >= N) return;
  if (r >= rows) v0 = v1 = 0.0f;
  TC* p = C + (size_t)r * N + c;
  if (c + 1 < N && (N & 1) == 0) {
    store2(p, v0, v1);
  } else {
    store1(p, v0);
    if (c + 1 < N) store1(p + 1, v1);
  }
}

__device__ __forceinline__ int valid_rows(const Problem& p, int z) {
  if (p.rows == nullptr) return p.M;
  const int r = p.rows[z];
  return r < 0 ? 0 : (r < p.M ? r : p.M);
}

// the K depth that batch entry z contracts over: K, or its limit
__device__ __forceinline__ int valid_depth(const Problem& p, int z) {
  if (p.klim == nullptr) return p.K;
  const int k = p.klim[z];
  return k < 0 ? 0 : (k < p.K ? k : p.K);
}

// K steps [kbeg, kbeg + n) of split sp, none past the depth kdep
__device__ __forceinline__ int split_steps(const Problem& p, int sp,
                                           int kdep, int* kbeg) {
  *kbeg = sp * p.ksteps_per_split;
  const int n = (kdep + kBK - 1) / kBK - *kbeg;
  return n < p.ksteps_per_split ? n : p.ksteps_per_split;
}

// ---------------------------------------------------------------------------
// tile path: wgmma, NWG consumer warpgroups (BM = 64·NWG), BN 128
// ---------------------------------------------------------------------------
template <int NWG>
__host__ __device__ constexpr int tile_stage_bytes() {
  return NWG * 64 * 128 + kTileBN * 128;
}
template <int NWG>
__host__ __device__ constexpr int tile_smem_bytes() {  // + 1024 to align
  return kTileStages * tile_stage_bytes<NWG>() + 1024;
}

// AMN: A is M-major, (K, M) with leading dimension M (gmm_blocks_dw's x
// (C, d) read in place as xᵀ): stored like an N-major B, 64 rows of k of
// NWG 64-column atoms, which the warpgroups' descriptors take transposed
template <int NWG, bool KMAJOR_B, bool AMN = false>
__device__ __forceinline__ void tile_load_stage(const Problem& p,
                                                const __nv_bfloat16* A,
                                                const __nv_bfloat16* B,
                                                uint32_t sa, int m0, int n0,
                                                int rows, int kdep, int kt) {
  constexpr int BM = 64 * NWG;
  constexpr int THREADS = 128 * NWG;
  const uint32_t sb = sa + BM * 128;
  const int k0 = kt * kBK;
  if constexpr (AMN) {
    for (int q = threadIdx.x; q < kBK * NWG * 8; q += THREADS) {
      const int k = q / (NWG * 8), c = q % (NWG * 8);
      load_chunk(sa + (c >> 3) * (kBK * 128) + swz(k, c & 7), A, p.M,
                 k0 + k, kdep, m0 + c * 8, rows, p.a_vec);
    }
  } else {
    for (int q = threadIdx.x; q < BM * 8; q += THREADS) {
      const int r = q >> 3, c = q & 7;
      load_chunk(sa + swz(r, c), A, p.K, m0 + r, rows, k0 + c * 8, kdep,
                 p.a_vec);
    }
  }
  if constexpr (KMAJOR_B) {  // 128 rows of n, 64 k each
    for (int q = threadIdx.x; q < kTileBN * 8; q += THREADS) {
      const int n = q >> 3, c = q & 7;
      load_chunk(sb + swz(n, c), B, p.ldb, n0 + n, p.N, k0 + c * 8, kdep,
                 p.b_vec);
    }
  } else {  // 64 rows of k, 128 n each: two 64-column atoms
    for (int q = threadIdx.x; q < kBK * 16; q += THREADS) {
      const int k = q >> 4, c = q & 15;
      load_chunk(sb + (c >> 3) * (kBK * 128) + swz(k, c & 7), B, p.ldb,
                 k0 + k, kdep, n0 + c * 8, p.N, p.b_vec);
    }
  }
}

// AMN: A is M-major and p.klim may be given (the one entry with K limits,
// gmm_blocks_dw; the others compile the kernels as they were)
template <int NWG, bool KMAJOR_B, typename TC, bool AMN = false>
__global__ void __launch_bounds__(128 * NWG)
    gemm_tile_kernel(Problem p, int m_tiles) {
  constexpr int BM = 64 * NWG;
  constexpr int STAGE = tile_stage_bytes<NWG>();
  constexpr int S = kTileStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int z = blockIdx.z;
  const int mt = blockIdx.y % m_tiles, sp = blockIdx.y / m_tiles;
  const int m0 = mt * BM, n0 = blockIdx.x * kTileBN;
  const int rows = valid_rows(p, z), kdep = AMN ? valid_depth(p, z) : p.K;
  const __nv_bfloat16* A = p.A + (size_t)z * p.batch_a;
  const __nv_bfloat16* B = p.B + (size_t)z * p.batch_b;
  TC* C = static_cast<TC*>(p.C) + (size_t)sp * p.split_stride +
          (size_t)z * p.batch_c;
  int kbeg;
  const int nks = split_steps(p, sp, kdep, &kbeg);

  const int wg = threadIdx.x / 128;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;

  if (m0 < rows && nks > 0) {
    // S - 2 stages of copies in flight ahead of the one being multiplied,
    // and one group of wgmma in flight behind it: stage t's slot is
    // refilled at step t + 2, once every warpgroup has waited out its
    // products (the barrier of step t + 2 follows the wait of step t + 1)
#pragma unroll
    for (int s = 0; s < S - 2; ++s) {
      if (s < nks)
        tile_load_stage<NWG, KMAJOR_B, AMN>(p, A, B, ring + s * STAGE, m0,
                                            n0, rows, kdep, kbeg + s);
      cp_async_commit();
    }
    for (int t = 0; t < nks; ++t) {
      cp_async_wait<S - 3>();
      fence_proxy_async();
      __syncthreads();  // stage t landed; stage t-2 is no longer read
      const int nt = t + S - 2;
      if (nt < nks)
        tile_load_stage<NWG, KMAJOR_B, AMN>(p, A, B,
                                            ring + (nt % S) * STAGE, m0, n0,
                                            rows, kdep, kbeg + nt);
      cp_async_commit();
      const uint32_t sa = ring + (t % S) * STAGE + wg * (64 * 128);
      const uint32_t sb = ring + (t % S) * STAGE + BM * 128;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        // an M-major A: 16 rows of k (two atoms down) of its one atom
        const uint64_t da = AMN ? wgmma_desc(sa + s * (16 * 128), kBK * 128)
                                : wgmma_desc(sa + s * 32, 16);
        if constexpr (KMAJOR_B) {  // 128 rows of n: 16 atoms down
          wgmma_m64n128k16<0, AMN>(acc[0], acc[1], da,
                                   wgmma_desc(sb + s * 32, 16));
        } else {  // 16 rows of k (two atoms down), two atoms across
          wgmma_m64n128k16<1, AMN>(
              acc[0], acc[1], da,
              wgmma_desc(sb + s * (16 * 128), kBK * 128));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
  }

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w..16w+15; register 4j+{0,1} is (lane/4, 8j + 2(lane%4) + {0,1}),
  // 4j+{2,3} the same 8 rows below; acc[h] is columns 64h..64h+63
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + h * 64 + j * 8 + 2 * (lane & 3);
      store_pair(C, p.M, p.N, rows, r0, c, acc[h][4 * j], acc[h][4 * j + 1]);
      store_pair(C, p.M, p.N, rows, r0 + 8, c, acc[h][4 * j + 2],
                 acc[h][4 * j + 3]);
    }
}

// ---------------------------------------------------------------------------
// skinny path: mma.sync over a streamed 64-column slab of B
// ---------------------------------------------------------------------------
constexpr int kSkinnyStage = kSkinnyBM * 128 + kSkinnyBN * 128;  // 10 KB

template <bool KMAJOR_B>
__device__ __forceinline__ void skinny_load_stage(const Problem& p,
                                                  const __nv_bfloat16* A,
                                                  const __nv_bfloat16* B,
                                                  uint32_t sa, int n0,
                                                  int rows, int kdep,
                                                  int kt) {
  const uint32_t sb = sa + kSkinnyBM * 128;
  const int k0 = kt * kBK;
  {  // A: 16 rows x 8 chunks, one a thread
    const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
    load_chunk(sa + swz(r, c), A, p.K, r, rows, k0 + c * 8, kdep, p.a_vec);
  }
#pragma unroll
  for (int i = 0; i < kSkinnyBN * 8 / kSkinnyThreads; ++i) {
    const int q = threadIdx.x + i * kSkinnyThreads;
    const int r = q >> 3, c = q & 7;
    if constexpr (KMAJOR_B) {  // 64 rows of n, 64 k each
      load_chunk(sb + swz(r, c), B, p.ldb, n0 + r, p.N, k0 + c * 8, kdep,
                 p.b_vec);
    } else {  // 64 rows of k, 64 n each
      load_chunk(sb + swz(r, c), B, p.ldb, k0 + r, kdep, n0 + c * 8, p.N,
                 p.b_vec);
    }
  }
}

template <bool KMAJOR_B, typename TC>
__global__ void __launch_bounds__(kSkinnyThreads)
    gemm_skinny_kernel(Problem p) {
  __shared__ __align__(1024) uint8_t ring_mem[kSkinnyStages * kSkinnyStage];
  const uint32_t ring = smem_addr(ring_mem);

  const int z = blockIdx.z, sp = blockIdx.y;
  const int n0 = blockIdx.x * kSkinnyBN;
  const int rows = valid_rows(p, z), kdep = p.K;
  const __nv_bfloat16* A = p.A + (size_t)z * p.batch_a;
  const __nv_bfloat16* B = p.B + (size_t)z * p.batch_b;
  TC* C = static_cast<TC*>(p.C) + (size_t)sp * p.split_stride +
          (size_t)z * p.batch_c;
  int kbeg;
  const int nks = split_steps(p, sp, kdep, &kbeg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};

  if (rows > 0 && nks > 0) {
#pragma unroll
    for (int s = 0; s < kSkinnyStages - 1; ++s) {
      if (s < nks)
        skinny_load_stage<KMAJOR_B>(p, A, B, ring + s * kSkinnyStage, n0,
                                    rows, kdep, kbeg + s);
      cp_async_commit();
    }
    for (int t = 0; t < nks; ++t) {
      cp_async_wait<kSkinnyStages - 2>();
      __syncthreads();
      const int nt = t + kSkinnyStages - 1;
      if (nt < nks)
        skinny_load_stage<KMAJOR_B>(
            p, A, B, ring + (nt % kSkinnyStages) * kSkinnyStage, n0, rows,
            kdep, kbeg + nt);
      cp_async_commit();
      const uint32_t sa = ring + (t % kSkinnyStages) * kSkinnyStage;
      const uint32_t sb = sa + kSkinnyBM * 128;
      // warp w owns columns 16w..16w+15 of the slab: two n8 tiles
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, sa + swz(lane & 15, 2 * s + (lane >> 4)));
        if constexpr (KMAJOR_B) {
          const int n = warp * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, sb + swz(n, 2 * s + ((lane >> 3) & 1)));
        } else {
          const int k = s * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(b, sb + swz(k, 2 * warp + (lane >> 4)));
        }
        mma_16816(acc[0], a, b[0], b[1]);
        mma_16816(acc[1], a, b[2], b[3]);
      }
    }
    cp_async_wait<0>();
  }

  const int r0 = lane >> 2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = n0 + warp * 16 + j * 8 + 2 * (lane & 3);
    store_pair(C, p.M, p.N, rows, r0, c, acc[j][0], acc[j][1]);
    store_pair(C, p.M, p.N, rows, r0 + 8, c, acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// split-K: sum the partials in split order
// ---------------------------------------------------------------------------
template <typename TC>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ partial,
                         TC* __restrict__ C, long long total, int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < split; ++k) s += partial[(size_t)k * total + i];
    store1(C + i, s);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The shared-memory attribute is set before every launch, not once: a
// flag kept to skip it would be one object across every library that
// instantiates this header (an inline template's static), while each
// library holds its own copy of the kernel; the call costs about a
// microsecond of host time, and only prefill shapes take this path.
template <int NWG, bool KMAJOR_B, typename TC, bool AMN = false>
inline cudaError_t launch_tile(const Problem& p, int batch, int split,
                               cudaStream_t stream) {
  auto kernel = gemm_tile_kernel<NWG, KMAJOR_B, TC, AMN>;
  constexpr int bytes = tile_smem_bytes<NWG>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int m_tiles = (p.M + 64 * NWG - 1) / (64 * NWG);
  dim3 grid((p.N + kTileBN - 1) / kTileBN, m_tiles * split, batch);
  kernel<<<grid, 128 * NWG, bytes, stream>>>(p, m_tiles);
  return cudaGetLastError();
}

// AMN (an M-major A) takes the tile path with a row-major B only
template <typename TC, bool AMN = false>
inline cudaError_t launch_path(const Problem& p, bool b_kmajor, int batch,
                               int path, int bm, int split,
                               cudaStream_t stream) {
  if constexpr (AMN) {
    if (path != kTile || b_kmajor) return cudaErrorInvalidValue;
    return bm == 128 ? launch_tile<2, false, TC, true>(p, batch, split,
                                                       stream)
                     : launch_tile<1, false, TC, true>(p, batch, split,
                                                       stream);
  } else {
    if (path == kSkinny) {
      dim3 grid((p.N + kSkinnyBN - 1) / kSkinnyBN, split, batch);
      if (b_kmajor)
        gemm_skinny_kernel<true, TC><<<grid, kSkinnyThreads, 0, stream>>>(p);
      else
        gemm_skinny_kernel<false, TC><<<grid, kSkinnyThreads, 0, stream>>>(p);
      return cudaGetLastError();
    }
    if (bm == 128)
      return b_kmajor ? launch_tile<2, true, TC>(p, batch, split, stream)
                      : launch_tile<2, false, TC>(p, batch, split, stream);
    return b_kmajor ? launch_tile<1, true, TC>(p, batch, split, stream)
                    : launch_tile<1, false, TC>(p, batch, split, stream);
  }
}

inline bool aligned16(const void* ptr, long long ld, long long batch) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && ld % 8 == 0 &&
         batch % 8 == 0;
}

// Enqueue C = A · B (batched) on `stream` as the host planner decided:
// `path` (kSkinny needs M <= 16; kTile with bm 64 or 128), `split` (a
// divisor of the K steps; > 1 needs `scratch` of split·batch·M·N floats,
// and a batched C contiguous, batch_c == M·N). `rows` (or null): each
// batch entry's valid rows. AMN: A is M-major, (K, M) with leading
// dimension M, on the tile path with a row-major B, and `klim` (or null):
// each batch entry's K depth. Returns the first launch error, checked
// after each launch; cudaErrorInvalidValue for a plan the kernels do not
// take.
template <bool AMN = false, typename TC>
inline int launch_gemm_bf16_tc(const __nv_bfloat16* A,
                               const __nv_bfloat16* B, TC* C,
                               const int* rows, int M, int N, int K, int ldb,
                               bool b_kmajor, int batch, long long batch_a,
                               long long batch_b, long long batch_c, int path,
                               int bm, int split, float* scratch,
                               cudaStream_t stream,
                               const int* klim = nullptr) {
  if (M <= 0 || N <= 0 || batch <= 0) return (int)cudaGetLastError();
  const int ksteps = (K + kBK - 1) / kBK;
  const bool ok_path = (path == kSkinny && M <= kSkinnyBM) ||
                       (path == kTile && (bm == 64 || bm == 128));
  if (!ok_path || K < 0 || split < 1 || (ksteps > 0 && ksteps % split) ||
      (ksteps == 0 && split != 1) || (split > 1 && scratch == nullptr) ||
      (split > 1 && batch > 1 && batch_c != (long long)M * N) ||
      ldb < (b_kmajor ? K : N) || (klim != nullptr && !AMN))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.A = A;
  p.B = B;
  p.rows = rows;
  p.klim = klim;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldb = ldb;
  p.batch_a = batch_a;
  p.batch_b = batch_b;
  p.batch_c = batch_c;
  p.ksteps_per_split = split > 1 ? ksteps / split : ksteps;
  p.a_vec = aligned16(A, AMN ? M : K, batch_a);
  p.b_vec = aligned16(B, ldb, batch_b);
  cudaError_t err;
  if (split == 1) {
    p.C = C;
    p.split_stride = 0;
    err = launch_path<TC, AMN>(p, b_kmajor, batch, path, bm, 1, stream);
  } else {
    const long long total = (long long)batch * M * N;
    p.C = scratch;
    p.split_stride = total;
    err = launch_path<float, AMN>(p, b_kmajor, batch, path, bm, split,
                                  stream);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (total + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    splitk_reduce_kernel<TC><<<(unsigned)blocks, 256, 0, stream>>>(
        scratch, C, total, split);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace tc
}  // namespace repro_torch
