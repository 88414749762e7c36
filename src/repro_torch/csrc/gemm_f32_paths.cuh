// f32 GEMM for Hopper (sm_90a) along the path the host planner chooses
// (kernels/matmul.py plan_f32_gemm): C(M,N) = A(M,K) · B(K,N), all f32,
// IEEE f32 FMA on the CUDA cores (no TF32, no 3xTF32 split: the lossless
// cold path must match the f32 reference), batched over `batch` GEMMs
// with per-batch strides. A is row-major with lda = K.
// B is read in place in one of two layouts:
//   row-major  (K,N) with leading dimension ldb (a weight as stored);
//   K-major    (N,K) with leading dimension ldb: a w whose w.T is
//              contiguous, such as the tied head's embed (V,d) read as
//              embed.T, with no copy.
// It carries matmul's f32 entry (batch 1) and winograd_tile_matmul (the
// 16 GEMMs of Winograd F(2x2,3x3)); matmul_packed, the fused dequant GEMMs
// and gmm_blocks' f32 entry stay on gemm_f32.cuh.
//
// Bound on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): the
// im2col GEMMs of resnet50@224 and its Winograd stages 1-2 by operations,
// the decode GEMMs (M <= 16) by reading B, Winograd's stem and stage 0
// (K = 3, 64) by reading A and writing C. Three paths:
//
//   * tile (M > 16): BM x BN output tile, BM in {64, 96, 128}, BN in
//     {64, 128}, picked per shape with the K split so that the grid fills
//     the 132 SMs in whole waves, two blocks an SM where it can
//     (resnet50's (12544,576)x(576,128): 262 tiles of 96 x 64). 256
//     threads, thread (ty, tx) = (tid/16, tid%16) owns rows ty + 16i and
//     BN/16 columns: a register tile of up to 8 x 8. K steps of 32 go
//     through a 3-deep ring of 16-byte cp.async copies: A and a K-major B
//     as [row][k] (rows padded to 36 floats), a row-major B as [k][n];
//     every operand is read back as float4, so a 4-deep slice of k costs
//     TM + TN shared loads for TM x TN x 4 FMA. One barrier a K step; two
//     stages of copies in flight behind it. Each output's FMAs run in k
//     order, as a plain dot product. blockIdx.z walks batch x split.
//   * stream (batch > 1, K <= 64: Winograd's stem and stage 0): a tile
//     has one or two K steps, so its own ring never fills and nothing
//     hides the copies. Persistent blocks, two an SM, each walk a
//     contiguous run of (batch, column tile, 128-row tile) items, K step
//     by K step (32 deep; 4, 8 or 16 where K is shallower); the
//     cp.async ring of steps (4 deep) runs across items, so the next
//     item's rows of A are copied while the current item's FMAs run. The
//     item's B slab (K x 64) stays in shared memory while consecutive
//     items share it (two slots, swapped when the slab changes). Thread
//     (ty, tx) owns rows ty + 16i (i < 8) and the 4 columns 4tx..4tx+3,
//     stored as one float4 each. With N <= 64 every element of A is read
//     from device memory once.
//   * skinny (M <= 16: decode at batch 1-4, the MoE router): bound by the
//     bytes of B, so B is streamed once in 16-byte loads (eight in flight
//     a thread) with x's rows in shared memory. Row-major B: a block owns
//     128 columns, a thread one float4 of them and every KP-th k row, the
//     KP phases summed in phase order at the end. K-major B: a block owns
//     32 columns (rows of B^T), a warp 4 of them, its lanes stride along
//     k, and the row sums reduce by shuffles. Batch 1 only.
//
// The tile and skinny paths split K when the output tiles alone leave SMs
// idle: split s takes K steps [s·kps, (s+1)·kps) and writes f32 partials
// to the caller's scratch (split, batch, M, N); a second kernel sums them
// in split order. No atomics: the same inputs give the same bits on every
// launch.
//
// Ragged M, N and K are zero-filled in the copies and masked in the store;
// an operand that is not on a 16-byte boundary, or whose rows are not a
// multiple of 4 floats, is copied element by element into the same layout
// (4-byte cp.async copies on the stream path).
// No function-local statics: several libraries may include this header.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_torch {
namespace f32 {

constexpr int kBK = 16;            // K unit of the split (and skinny step)
constexpr int kThreads = 256;
constexpr int kStages = 3;         // tile path cp.async ring
constexpr int kTileBK = 32;        // tile path K step
constexpr int kLDA = kTileBK + 4;  // [row][k] tiles: row stride in floats;
                                   // float4 reads of 8 rows, 36 floats
                                   // apart, hit 8 bank groups
constexpr int kSkinnyMaxM = 16;
constexpr int kSkinnyCols = 128;   // skinny, row-major B: columns a block
constexpr int kSkinnyKCols = 32;   // skinny, K-major B: columns a block
constexpr int kXFloats = 12288;    // skinny: most floats of x a block holds
constexpr int kUnroll = 8;         // skinny, row-major: loads in flight

constexpr int kStreamBM = 128;     // stream path: rows of an item
constexpr int kStreamBN = 64;      // stream path: columns of an item
constexpr int kStreamMaxK = 64;    // stream path: deepest K
constexpr int kStreamStepK = 32;   // stream path: k of a ring step

enum Path { kSkinny = 0, kTile = 1, kStream = 2 };

struct Problem {
  const float* A;          // (batch, M, K), lda = K
  const float* B;          // row-major (K,N) or K-major (N,K), ldb
  float* C;                // (batch, M, N) out, or partials (split, ...)
  int M, N, K, ldb;
  int batch, split;
  long long bsa, bsb, bsc; // floats between two batch entries' A, B, C
  long long split_stride;  // floats between two splits' partials
  int kps;                 // K steps a split
  int a_vec, b_vec, c_vec; // 16-byte copies / stores allowed
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the 4 floats at (row, col..col+3) of a row-major matrix with
// leading dimension ld into the 16-byte shared slot dst; elements outside
// [0, nrows) x [0, ncols) are zero. vec: ncols, ld and the base are
// multiples of 4 floats, so the 4 are wholly inside or outside.
__device__ __forceinline__ void load4(uint32_t dst, const float* src,
                                      long long ld, int row, int nrows,
                                      int col, int ncols, int vec) {
  if (vec) {
    const bool ok = row < nrows && col < ncols;
    cp_async16(dst,
               ok ? (const void*)(src + (size_t)row * ld + col)
                  : (const void*)src,
               ok ? 16 : 0);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row < nrows && col + j < ncols)
                 ? src[(size_t)row * ld + col + j]
                 : 0.0f;
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// tile path
// ---------------------------------------------------------------------------
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16i and BN/16
// columns
template <int BM, int BN, bool KMAJOR>
struct Tile {
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int A_FLOATS = BM * kLDA;  // [m][k]
  static constexpr int B_FLOATS =
      KMAJOR ? BN * kLDA : kTileBK * BN;      // [n][k] / [k][n]
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int BYTES = kStages * STAGE * 4;
};

// column of register j of thread tx: float4 groups 64 apart for a
// row-major B (float4 shared loads along n), tx + 16j for a K-major one
// (float4 shared loads along k, consecutive tx on consecutive rows)
template <int BN, bool KMAJOR>
__device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (KMAJOR)
    return tx + 16 * j;
  else
    return tx * 4 + (j & 3) + 64 * (j >> 2);
}

// one K step: k in [k0, k0 + kTileBK), zero past kend (the split's end)
template <int BM, int BN, bool KMAJOR>
__device__ __forceinline__ void tile_load(const Problem& p, const float* A,
                                          const float* B, uint32_t sa,
                                          int m0, int n0, int k0, int kend) {
  constexpr int BK = kTileBK;
  const uint32_t sb = sa + Tile<BM, BN, KMAJOR>::A_FLOATS * 4;
  for (int q = threadIdx.x; q < BM * (BK / 4); q += kThreads) {
    const int r = q / (BK / 4), c = (q % (BK / 4)) * 4;
    load4(sa + (r * kLDA + c) * 4, A, p.K, m0 + r, p.M, k0 + c, kend,
          p.a_vec);
  }
  if constexpr (KMAJOR) {  // BN rows of B^T, BK k each
    for (int q = threadIdx.x; q < BN * (BK / 4); q += kThreads) {
      const int n = q / (BK / 4), c = (q % (BK / 4)) * 4;
      load4(sb + (n * kLDA + c) * 4, B, p.ldb, n0 + n, p.N, k0 + c, kend,
            p.b_vec);
    }
  } else {  // BK rows of k, BN n each
    for (int q = threadIdx.x; q < BK * (BN / 4); q += kThreads) {
      const int k = q / (BN / 4), c = (q % (BN / 4)) * 4;
      load4(sb + (k * BN + c) * 4, B, p.ldb, k0 + k, kend, n0 + c, p.N,
            p.b_vec);
    }
  }
}

// two blocks an SM (at most 128 registers a thread): a split tile grid
// runs two waves side by side
template <int BM, int BN, bool KMAJOR>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_f32_tile_kernel(Problem p) {
  using TL = Tile<BM, BN, KMAJOR>;
  constexpr int TM = TL::TM, TN = TL::TN, BK = kTileBK, LDA = kLDA;
  extern __shared__ __align__(16) float smem[];
  const uint32_t ring = smem_addr(smem);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int bz = blockIdx.z / p.split, sp = blockIdx.z % p.split;
  const float* A = p.A + bz * p.bsa;
  const float* B = p.B + bz * p.bsb;
  // this split's k range, in steps of BK
  const int kbeg = sp * p.kps * kBK;
  const int kend = min(p.K, kbeg + p.kps * kBK);
  const int nks = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nks)
      tile_load<BM, BN, KMAJOR>(p, A, B, ring + s * TL::STAGE * 4, m0, n0,
                                kbeg + s * BK, kend);
    cp_async_commit();
  }
  for (int t = 0; t < nks; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; the slot of step t - 1 is free
    const int nt = t + kStages - 1;
    if (nt < nks)
      tile_load<BM, BN, KMAJOR>(p, A, B,
                                ring + (nt % kStages) * TL::STAGE * 4, m0,
                                n0, kbeg + nt * BK, kend);
    cp_async_commit();
    const float* As = smem + (t % kStages) * TL::STAGE;
    const float* Bs = As + TL::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if constexpr (KMAJOR) {
        float4 bt[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bt[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * j) * LDA + kk]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(
              &As[(ty + 16 * i) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a4.x, bt[j].x, acc[i][j]);
            acc[i][j] = fmaf(a4.y, bt[j].y, acc[i][j]);
            acc[i][j] = fmaf(a4.z, bt[j].z, acc[i][j]);
            acc[i][j] = fmaf(a4.w, bt[j].w, acc[i][j]);
          }
        }
      } else {
        float4 a4[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              &As[(ty + 16 * i) * LDA + kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bv[TN];
#pragma unroll
          for (int jj = 0; jj < TN / 4; ++jj) {
            const float4 b4 = *reinterpret_cast<const float4*>(
                &Bs[(kk + q) * BN + tx * 4 + 64 * jj]);
            bv[4 * jj] = b4.x;
            bv[4 * jj + 1] = b4.y;
            bv[4 * jj + 2] = b4.z;
            bv[4 * jj + 3] = b4.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = comp(a4[i], q);
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* C = p.C + (size_t)sp * p.split_stride + bz * p.bsc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
    float* row = C + (size_t)r * p.N;
    if (!KMAJOR && p.c_vec) {
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const int c = n0 + tx * 4 + 64 * jj;
        if (c < p.N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                          acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + col_of<BN, KMAJOR>(tx, j);
        if (c < p.N) row[c] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// stream path (batch > 1, K <= kStreamMaxK)
// ---------------------------------------------------------------------------
// rows [0, 128) x k [0, kp) of A's item tile at row m0, as [row][k] with
// row stride kp + 4 floats; k >= K and rows >= M zero-filled
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Copy the 4 floats at (row, col..col+3) into the 16-byte shared slot
// dst, as load4, but always with cp.async: 4-byte copies where the row is
// not on a 16-byte boundary.
__device__ __forceinline__ void load4_async(uint32_t dst, const float* src,
                                            long long ld, int row, int nrows,
                                            int col, int ncols, int vec) {
  if (vec) {
    const bool ok = row < nrows && col < ncols;
    cp_async16(dst,
               ok ? (const void*)(src + (size_t)row * ld + col)
                  : (const void*)src,
               ok ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row < nrows && col + j < ncols;
      cp_async4(dst + 4 * j,
                ok ? (const void*)(src + (size_t)row * ld + col + j)
                   : (const void*)src,
                ok ? 4 : 0);
    }
  }
}

// Item `it` of the walk: (batch entry, column tile, row tile), rows
// fastest, so that consecutive items share B's slab.
struct StreamItem {
  int b, n0, m0;
  __device__ __forceinline__ StreamItem(int it, int tiles_m, int tiles_n) {
    m0 = (it % tiles_m) * kStreamBM;
    const int r = it / tiles_m;
    n0 = (r % tiles_n) * kStreamBN;
    b = r / tiles_n;
  }
  __device__ __forceinline__ int slab(int tiles_n) const {
    return b * tiles_n + n0 / kStreamBN;
  }
};

// The walk's unit is a K step: k [sk·s, sk·s + sk) of one item, sk the
// power of two from 4 to 32 that holds K where K is shallower than 32
// (zero-filled past K, so the step's FMA loop unrolls at a fixed depth).
// `kp` is K rounded up to whole steps.
struct StreamShape {
  int kp, spi, sk;  // K padded; steps an item; k a step
  __device__ __host__ StreamShape(int K) {
    sk = 4;
    while (sk < kStreamStepK && sk < K) sk *= 2;
    spi = K > 0 ? (K + sk - 1) / sk : 1;
    kp = spi * sk;
  }
};

// Start the copies of step `s` of item `t` (rows of A, k from 32·s) into
// ring slot `sa`, and of the item's whole B slab into `sb` when `with_b`
// (the first step of an item whose slab changed).
template <int SK>
__device__ __forceinline__ void stream_load(const Problem& p,
                                            const StreamShape& sh,
                                            const StreamItem& t, int s,
                                            uint32_t sa, uint32_t sb,
                                            bool with_b) {
  constexpr int cq = SK / 4, lds = SK + 4;
  const int k0 = s * SK;
  const float* A = p.A + t.b * p.bsa;
  for (int q = threadIdx.x; q < kStreamBM * cq; q += kThreads) {
    const int r = q / cq, c = (q - r * cq) * 4;
    load4_async(sa + (r * lds + c) * 4, A, p.K, t.m0 + r, p.M, k0 + c, p.K,
                p.a_vec);
  }
  if (with_b) {
    const float* B = p.B + t.b * p.bsb;
    for (int q = threadIdx.x; q < sh.kp * (kStreamBN / 4); q += kThreads) {
      const int k = q / (kStreamBN / 4), c = (q % (kStreamBN / 4)) * 4;
      load4_async(sb + (k * kStreamBN + c) * 4, B, p.ldb, k, p.K, t.n0 + c,
                  p.N, p.b_vec);
    }
  }
}

// Shared memory: NST step slots of A rows ([row][k], rows of SK + 4
// floats: float4 reads of rows ty and ty + 1 fall in other banks), then
// two B slabs.
inline size_t stream_smem_bytes(int K, int nst) {
  const StreamShape sh(K);
  return ((size_t)nst * kStreamBM * (sh.sk + 4) +
          2 * (size_t)sh.kp * kStreamBN) * sizeof(float);
}

// Persistent: block x walks items [x·items/grid, (x+1)·items/grid), step
// by step, through an NST-deep ring of steps that runs across items: the
// copies of the step NST - 1 ahead (the next item's, near an item's end)
// are started before the current step's FMAs, behind one barrier a step.
// NST is 4 where every slab but a run's first and last spans at least 3
// steps, else 2.
template <int NST, int SK>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_f32_stream_kernel(Problem p, int tiles_m, int tiles_n, int items) {
  extern __shared__ __align__(16) float smem[];
  constexpr int lds = SK + 4;
  const StreamShape sh(p.K);
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const int nsteps = (last - first) * sh.spi;
  if (nsteps <= 0) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  constexpr int slot_floats = kStreamBM * lds;
  float* ring = smem;
  float* slabs = smem + NST * slot_floats;
  const uint32_t ring_s = smem_addr(ring), slabs_s = smem_addr(slabs);
  constexpr int TM = kStreamBM / 16;

  // the B slab each item reads: the copying and the computing side each
  // swap slots when the slab changes, in the same order. A slot is
  // rewritten only after the barrier that ends the last step of the slab
  // before the one it holds, so no step still reads it.
  int next_slab = -1, next_slot = 1, comp_slab = -1, comp_slot = 1;
  auto enqueue = [&](int j) {
    const int s = j % sh.spi;
    const StreamItem t(first + j / sh.spi, tiles_m, tiles_n);
    bool with_b = false;
    if (s == 0 && t.slab(tiles_n) != next_slab) {
      next_slab = t.slab(tiles_n);
      next_slot ^= 1;
      with_b = true;
    }
    stream_load<SK>(p, sh, t, s, ring_s + (j % NST) * slot_floats * 4,
                slabs_s + next_slot * sh.kp * kStreamBN * 4, with_b);
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nsteps) enqueue(j);
    cp_async_commit();
  }
  float acc[TM][4];
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // step i landed; the slot of step i - 1 is free
    if (i + NST - 1 < nsteps) enqueue(i + NST - 1);
    cp_async_commit();

    const int s = i % sh.spi;
    const StreamItem t(first + i / sh.spi, tiles_m, tiles_n);
    if (s == 0) {
      if (t.slab(tiles_n) != comp_slab) {
        comp_slab = t.slab(tiles_n);
        comp_slot ^= 1;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    }
    const float* As = ring + (i % NST) * slot_floats;
    const float* Bs =
        slabs + comp_slot * sh.kp * kStreamBN + s * SK * kStreamBN;
#pragma unroll
    for (int kk = 0; kk < SK; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        a4[r] = *reinterpret_cast<const float4*>(
            &As[(ty + 16 * r) * lds + kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            &Bs[(kk + q) * kStreamBN + tx * 4]);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float av = comp(a4[r], q);
          acc[r][0] = fmaf(av, b4.x, acc[r][0]);
          acc[r][1] = fmaf(av, b4.y, acc[r][1]);
          acc[r][2] = fmaf(av, b4.z, acc[r][2]);
          acc[r][3] = fmaf(av, b4.w, acc[r][3]);
        }
      }
    }
    if (s != sh.spi - 1) continue;
    float* C = p.C + t.b * p.bsc;
    const int c0 = t.n0 + tx * 4;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = t.m0 + ty + 16 * r;
      if (row >= p.M) continue;
      float* dst = C + (size_t)row * p.N + c0;
      if (p.c_vec) {
        if (c0 < p.N)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < p.N) dst[c] = acc[r][c];
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// skinny path
// ---------------------------------------------------------------------------
// x's rows [0, M) over this split's k range into shared memory
__device__ __forceinline__ void load_x(const Problem& p, float* xs, int kb0,
                                       int kn) {
  for (int i = threadIdx.x; i < p.M * kn; i += kThreads) {
    const int m = i / kn, kk = i - m * kn;
    xs[i] = p.A[(size_t)m * p.K + kb0 + kk];
  }
}

__device__ __forceinline__ float4 load_b4(const Problem& p, int k, int n,
                                          bool vec) {
  const float* src = p.B + (size_t)k * p.ldb + n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = n + j < p.N ? __ldg(src + j) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int MT>
__device__ __forceinline__ void skinny_fma(float (&acc)[MT][4],
                                           const float* xs, int kn, int kk,
                                           int M, const float4& w) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      const float xv = xs[m * kn + kk];
      acc[m][0] = fmaf(xv, w.x, acc[m][0]);
      acc[m][1] = fmaf(xv, w.y, acc[m][1]);
      acc[m][2] = fmaf(xv, w.z, acc[m][2]);
      acc[m][3] = fmaf(xv, w.w, acc[m][3]);
    }
  }
}

// row-major B: columns [n0, n0 + 128) of split blockIdx.y
template <int MT>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_skinny_kernel(Problem p) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSkinnyCols, sp = blockIdx.y;
  const int kb0 = sp * p.kps * kBK;
  const int kn = max(0, min(p.kps * kBK, p.K - kb0));
  const int M = p.M;
  load_x(p, xs, kb0, kn);
  __syncthreads();

  const int ncols = min(kSkinnyCols, p.N - n0);
  const int CG = (ncols + 3) / 4;  // float4 columns
  const int KP = kThreads / CG;    // k phases
  const int cg = tid % CG, kp = tid / CG;
  const int n = n0 + cg * 4;
  const bool vec = p.b_vec && n + 3 < p.N;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  if (kp < KP) {
    int kk = kp;
    for (; kk + (kUnroll - 1) * KP < kn; kk += kUnroll * KP) {
      float4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        w[u] = load_b4(p, kb0 + kk + u * KP, n, vec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        skinny_fma<MT>(acc, xs, kn, kk + u * KP, M, w[u]);
    }
    for (; kk < kn; kk += KP)
      skinny_fma<MT>(acc, xs, kn, kk, M, load_b4(p, kb0 + kk, n, vec));
  }
  __syncthreads();  // x is no longer read: the buffer takes the sums

  // each row: the KP phases of a column summed in phase order
  float* red = xs;  // [KP][CG][4]
  float* C = p.C + (size_t)sp * p.split_stride;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) red[tid * 4 + e] = acc[m][e];
    __syncthreads();
    if (tid < CG * 4 && n0 + tid < p.N) {
      float s = 0.0f;
      for (int ph = 0; ph < KP; ++ph) s += red[ph * CG * 4 + tid];
      C[(size_t)m * p.N + n0 + tid] = s;
    }
    __syncthreads();
  }
}

// K-major B: columns [n0, n0 + 32) (rows of B^T) of split blockIdx.y
template <int MT>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_skinny_kmajor_kernel(Problem p) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kSkinnyKCols + warp * 4, sp = blockIdx.y;
  const int kb0 = sp * p.kps * kBK;
  const int kn = max(0, min(p.kps * kBK, p.K - kb0));
  const int M = p.M;
  load_x(p, xs, kb0, kn);
  __syncthreads();

  float acc[4][MT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.0f;
  const float* rows[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rows[c] = p.B + (size_t)min(n0 + c, p.N - 1) * p.ldb + kb0;

  if (p.b_vec) {  // kn, kb0 and ldb are multiples of 4: float4 along k
    for (int q = lane; q < kn / 4; q += 32) {
      float4 w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = n0 + c < p.N
                   ? __ldg(reinterpret_cast<const float4*>(rows[c]) + q)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float4 x4 = *reinterpret_cast<const float4*>(&xs[m * kn] +
                                                             4 * q);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[c][m] = fmaf(x4.x, w[c].x, acc[c][m]);
            acc[c][m] = fmaf(x4.y, w[c].y, acc[c][m]);
            acc[c][m] = fmaf(x4.z, w[c].z, acc[c][m]);
            acc[c][m] = fmaf(x4.w, w[c].w, acc[c][m]);
          }
        }
      }
    }
  } else {
    for (int kk = lane; kk < kn; kk += 32) {
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = n0 + c < p.N ? __ldg(rows[c] + kk) : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float xv = xs[m * kn + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c][m] = fmaf(xv, w[c], acc[c][m]);
        }
      }
    }
  }

  float* C = p.C + (size_t)sp * p.split_stride;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      float v = acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && n0 + c < p.N) C[(size_t)m * p.N + n0 + c] = v;
    }
}

// ---------------------------------------------------------------------------
// split-K: sum the partials in split order
// ---------------------------------------------------------------------------
// U loads in flight a thread, summed in order
template <int U>
__global__ void __launch_bounds__(256)
    gemm_f32_splitk_sum_kernel(const float* __restrict__ part,
                               float* __restrict__ C, long long total,
                               int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    int k = 0;
    for (; k + U <= split; k += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = part[(size_t)(k + u) * total + i];
#pragma unroll
      for (int u = 0; u < U; ++u) s += v[u];
    }
    for (; k < split; ++k) s += part[(size_t)k * total + i];
    C[i] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The shared-memory attribute is set before every tile launch (about a
// microsecond of host time) rather than remembered in a static.
template <int BM, int BN, bool KMAJOR>
inline cudaError_t launch_tile(const Problem& p, int split,
                               cudaStream_t stream) {
  auto kernel = gemm_f32_tile_kernel<BM, BN, KMAJOR>;
  constexpr int bytes = Tile<BM, BN, KMAJOR>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch * split);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NST, int SK>
inline cudaError_t launch_stream_k(const Problem& p, int blocks, int tiles_m,
                                   int tiles_n, cudaStream_t stream) {
  const int bytes = (int)stream_smem_bytes(p.K, NST);
  cudaError_t err =
      cudaFuncSetAttribute(gemm_f32_stream_kernel<NST, SK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gemm_f32_stream_kernel<NST, SK><<<blocks, kThreads, bytes, stream>>>(
      p, tiles_m, tiles_n, p.batch * tiles_m * tiles_n);
  return cudaGetLastError();
}

template <int NST>
inline cudaError_t launch_stream_nst(const Problem& p, int blocks, int tiles_m,
                                     int tiles_n, cudaStream_t stream) {
  switch (StreamShape(p.K).sk) {
    case 4: return launch_stream_k<NST, 4>(p, blocks, tiles_m, tiles_n, stream);
    case 8: return launch_stream_k<NST, 8>(p, blocks, tiles_m, tiles_n, stream);
    case 16:
      return launch_stream_k<NST, 16>(p, blocks, tiles_m, tiles_n, stream);
    default:
      return launch_stream_k<NST, 32>(p, blocks, tiles_m, tiles_n, stream);
  }
}

// `blocks` persistent blocks, two an SM at most; a 4-deep ring of steps
// where every slab spans at least 3 steps, else 2-deep.
inline cudaError_t launch_stream(const Problem& p, int blocks,
                                 cudaStream_t stream) {
  const int tiles_m = (p.M + kStreamBM - 1) / kStreamBM;
  const int tiles_n = (p.N + kStreamBN - 1) / kStreamBN;
  if (tiles_m * StreamShape(p.K).spi >= 3)
    return launch_stream_nst<4>(p, blocks, tiles_m, tiles_n, stream);
  return launch_stream_nst<2>(p, blocks, tiles_m, tiles_n, stream);
}

template <bool KMAJOR>
inline cudaError_t launch_tile_shape(const Problem& p, int bm, int bn,
                                     int split, cudaStream_t stream) {
  if (bn == 128) {
    switch (bm) {
      case 64: return launch_tile<64, 128, KMAJOR>(p, split, stream);
      case 96: return launch_tile<96, 128, KMAJOR>(p, split, stream);
      case 128: return launch_tile<128, 128, KMAJOR>(p, split, stream);
    }
  } else if (bn == 64) {
    switch (bm) {
      case 64: return launch_tile<64, 64, KMAJOR>(p, split, stream);
      case 96: return launch_tile<96, 64, KMAJOR>(p, split, stream);
      case 128: return launch_tile<128, 64, KMAJOR>(p, split, stream);
    }
  }
  return cudaErrorInvalidValue;
}

inline bool tile_shape_ok(int bm, int bn) {
  return (bn == 128 || bn == 64) && (bm == 64 || bm == 96 || bm == 128);
}

template <int MT>
inline cudaError_t launch_skinny_mt(const Problem& p, bool kmajor, int split,
                                    cudaStream_t stream) {
  const int kn = p.kps * kBK;
  int floats = p.M * kn;
  if (!kmajor && floats < kThreads * 4) floats = kThreads * 4;  // the sums
  const size_t bytes = (size_t)(floats > 0 ? floats : 1) * sizeof(float);
  if (kmajor) {
    dim3 grid((p.N + kSkinnyKCols - 1) / kSkinnyKCols, split);
    gemm_f32_skinny_kmajor_kernel<MT><<<grid, kThreads, bytes, stream>>>(p);
  } else {
    dim3 grid((p.N + kSkinnyCols - 1) / kSkinnyCols, split);
    gemm_f32_skinny_kernel<MT><<<grid, kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

inline cudaError_t launch_skinny(const Problem& p, bool kmajor, int split,
                                 cudaStream_t stream) {
  if (p.M <= 1) return launch_skinny_mt<1>(p, kmajor, split, stream);
  if (p.M <= 2) return launch_skinny_mt<2>(p, kmajor, split, stream);
  if (p.M <= 4) return launch_skinny_mt<4>(p, kmajor, split, stream);
  if (p.M <= 8) return launch_skinny_mt<8>(p, kmajor, split, stream);
  return launch_skinny_mt<16>(p, kmajor, split, stream);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Enqueue C[z] = A[z] · B[z] for z < batch on `stream` as the host
// planner decided: `path` (kSkinny needs batch 1, M <= 16 and
// kps·16·M <= kXFloats; kTile a (bm, bn) that tile_shape_ok takes;
// kStream K <= kStreamMaxK, no split, and `blocks` persistent blocks),
// `split` (a divisor of the K steps; > 1 needs `scratch` of
// split·batch·M·N floats). Batch entry z of A, B and C starts bsa, bsb and
// bsc floats after entry z - 1. Returns the first launch error, checked
// after each launch; cudaErrorInvalidValue for a plan the kernels do not
// take.
inline int launch_gemm_f32_batched(const float* A, const float* B, float* C,
                                   int batch, long long bsa, long long bsb,
                                   long long bsc, int M, int N, int K,
                                   int ldb, bool kmajor, int path, int bm,
                                   int bn, int split, int blocks,
                                   float* scratch, cudaStream_t stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int ksteps = (K + kBK - 1) / kBK;
  const int kps = split > 0 && ksteps > 0 ? ksteps / split : 0;
  const bool ok_path =
      (path == kSkinny && batch == 1 && M <= kSkinnyMaxM &&
       (long long)kps * kBK * M <= kXFloats) ||
      (path == kTile && tile_shape_ok(bm, bn)) ||
      (path == kStream && !kmajor && K <= kStreamMaxK && split == 1 &&
       bm == kStreamBM && bn == kStreamBN && blocks > 0);
  if (!ok_path || K < 0 || split < 1 || (ksteps > 0 && ksteps % split) ||
      (ksteps == 0 && split != 1) || (split > 1 && scratch == nullptr) ||
      // the split's sum writes C packed
      (split > 1 && batch > 1 && bsc != (long long)M * N) ||
      ldb < (kmajor ? K : N))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.A = A;
  p.B = B;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldb = ldb;
  p.batch = batch;
  p.split = split;
  p.bsa = bsa;
  p.bsb = bsb;
  p.kps = kps;
  p.a_vec = aligned16(A) && K % 4 == 0 && bsa % 4 == 0;
  p.b_vec = aligned16(B) && ldb % 4 == 0 && (kmajor ? K : N) % 4 == 0 &&
            bsb % 4 == 0;
  float* out = split > 1 ? scratch : C;
  // the partials of a split are (split, batch, M, N), packed
  p.bsc = split > 1 ? (long long)M * N : bsc;
  p.c_vec = aligned16(out) && N % 4 == 0 && p.bsc % 4 == 0;
  p.C = out;
  p.split_stride = split > 1 ? (long long)batch * M * N : 0;
  cudaError_t err =
      path == kSkinny
          ? launch_skinny(p, kmajor, split, stream)
          : path == kStream
                ? launch_stream(p, blocks, stream)
                : (kmajor ? launch_tile_shape<true>(p, bm, bn, split, stream)
                          : launch_tile_shape<false>(p, bm, bn, split,
                                                     stream));
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)batch * M * N;
  long long nb = (total + 255) / 256;
  if (nb > 4096) nb = 4096;
  gemm_f32_splitk_sum_kernel<8><<<(unsigned)nb, 256, 0, stream>>>(
      scratch, C, total, split);
  return (int)cudaGetLastError();
}

// One GEMM (matmul's f32 entry): the batched launch at batch 1.
inline int launch_gemm_f32_planned(const float* A, const float* B, float* C,
                                   int M, int N, int K, int ldb, bool kmajor,
                                   int path, int bm, int bn, int split,
                                   float* scratch, cudaStream_t stream) {
  if (path == kStream) return (int)cudaErrorInvalidValue;
  return launch_gemm_f32_batched(A, B, C, 1, 0, 0, 0, M, N, K, ldb, kmajor,
                                 path, bm, bn, split, 1, scratch, stream);
}

}  // namespace f32
}  // namespace repro_torch
