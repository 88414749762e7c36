// f32 GEMM for Hopper (sm_90a) along the path the host planner chooses
// (kernels/matmul.py plan_f32_gemm): C(M,N) = A(M,K) · B(K,N) with an f32
// accumulator, IEEE f32 FMA on the CUDA cores (no TF32, no 3xTF32 split:
// the lossless cold path must match the f32 reference), batched over
// `batch` GEMMs with per-batch strides. A is row-major with lda = K, f32
// or bf16 (TX; bf16 is widened to f32 where it is read back from shared
// memory); C is in A's type, each output rounded once at the store.
// B is read in place in one of five layouts:
//   row-major  (K,N) f32 with leading dimension ldb (a weight as stored);
//   K-major    (N,K) f32 with leading dimension ldb: a w whose w.T is
//              contiguous, such as the tied head's embed (V,d) read as
//              embed.T, with no copy;
//   panels     LinearPacked's (N/128, nK, 128, 128) f32 tiles: for each
//              128-column panel j a row-major (nK·128, 128) matrix,
//              panels `pstride` floats apart. A tile (BN 64 or 128) or a
//              skinny block (128 columns) never straddles two panels, so
//              only the address of a copy's column base changes;
//   int8       (K, N) int8, one k row a byte row: read at its byte count
//              and sign-extended on chip (exact in f32);
//   int4       ((K+1)/2, N) uint8, row 2i in the low nibble of byte
//              (i, n) and 2i+1 in the high one, sign-extended: device
//              memory is read at the packed byte count, and an int4
//              weight is exact in f32.
// With a column scale (the fused dequant GEMMs), the finished sum of
// column n is multiplied once by scale[n]: in the store when K is not
// split, otherwise in the kernel that sums the partials. It is never
// applied to a partial.
// With a row limit (one int per batch entry, read on the device: no host
// sync), rows r >= row_limit[z] of batch entry z are never read from A and
// are written as zeros; a block whose rows all lie past the limit copies
// no B, so a batch entry with no rows reads none of its B. Row limits come
// with the kRowLimit entries, on the tile path (row-major or K-major B)
// and the grouped skinny path (row-major B). With a K limit (the same,
// one int per batch entry; the kAMajorM entries only), batch entry z
// contracts over k < k_limit[z] only: A's and B's k rows past it are
// never read, and a block or a K split with nothing left stores zeros
// (gmm_blocks_dw: dw[e] = x[e]^T dy[e] over the expert's group_sizes[e]
// rows).
// An M-major A (kAMajorM entries: each batch entry's A stored (K, M) and
// read in place, gmm_blocks_dw's x (C, d) as xᵀ) takes the tile path with
// a row-major B: its stage holds A as [k][m] rows of BM floats, read back
// one float a row (the thread's rows lie 16 apart), so a 4-deep slice of
// k costs 4·TM + TN shared loads for TM x TN x 4 FMA.
// It carries matmul's f32 entry (batch 1), winograd_tile_matmul (the 16
// GEMMs of Winograd F(2x2,3x3)), matmul_packed (panels, f32 or bf16 x),
// matmul_dequant_int8 and matmul_dequant_int4 (int8 and int4, f32 or bf16
// x) and gmm_blocks' f32 entry (batched over the experts, group_sizes as
// the row limit).
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
//     as [row][k] (rows padded to 36 floats, 40 bf16), a row-major B as
//     [k][n]; every operand is read back as float4 (A in bf16 as 8 bytes
//     widened), so a 4-deep slice of k costs TM + TN shared loads for TM x
//     TN x 4 FMA. One barrier a K step; two stages of copies in flight
//     behind it. Each output's FMAs run in k order, as a plain dot
//     product. blockIdx.z walks batch x split. With a row limit, A's
//     rows are copied up to the limit, a block past it copies nothing,
//     and its rows past the limit are stored as zeros (a template flag:
//     the other entries' tile kernels compile without it).
//     int8 and int4 B: a stage holds 32 int8 rows or 16 packed int4 rows
//     (BN bytes each: a quarter or an eighth of the f32 stage), copied in
//     16-, 4- or 1-byte pieces as N's alignment allows, through a 4-deep
//     ring; each K step, the block widens the next stage's bytes once into
//     a [k][n] f32 buffer (two, alternating) while the current one feeds
//     the same FMA loop as a row-major B. The widening costs each thread
//     16 values a step against its 1024 FMA (64 x 128 tile), where
//     widening on every read-back would cost one value for every TM FMA.
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
//     from device memory once. f32 only.
//   * skinny (M <= 16: decode at batch 1-4, the MoE router, the resnet50
//     head): bound by the bytes of B, so B is streamed once with eight
//     loads in flight a thread and x's rows in shared memory (as f32).
//     Row-major B and panels: a block owns 128 columns, a thread one
//     float4 of them and every KP-th k row, the KP phases summed in phase
//     order at the end. int8 and int4: the same with V columns a thread,
//     V = 16 (one 16-byte load: 16 columns of one int8 row or of two int4
//     rows; M <= 4), 4 (a 4-byte load; N a multiple of 4, as the resnet50
//     head's 100) or 1 (a byte), every KP-th byte row, the bytes or
//     nibbles sign-extended in registers. Row-major B in a batch
//     (gmm_blocks at decode: C 8 rows of 40 experts) takes the batch entry
//     on blockIdx.z, each block still streaming its 128 columns once and
//     reading x's rows only up to the entry's row limit (none, and no B,
//     past it). K-major B: a block owns 32 columns (rows of B^T), a warp 4
//     of them, its lanes stride along k, and the row sums reduce by
//     shuffles; batch 1 only.
//
// The tile and skinny paths split K when the output tiles alone leave SMs
// idle: split s takes K steps [s·kps, (s+1)·kps) and writes f32 partials
// to the caller's scratch (split, batch, M, N); a second kernel sums them
// in split order, applies the scale and rounds to C's type. No atomics:
// the same inputs give the same bits on every launch.
//
// Ragged M, N and K are zero-filled in the copies and masked in the store
// (an odd K never reads x's column K, and the high nibble of int4's last
// byte adds nothing), and nothing is padded in device memory; an operand
// that is not on a 16-byte boundary, or whose rows are not a multiple of
// 16 bytes, is copied in smaller pieces into the same layout (4-byte
// cp.async copies on the stream path).
// No function-local statics: several libraries may include this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_torch {
namespace f32 {

constexpr int kBK = 16;            // K unit of the split (and skinny step)
constexpr int kThreads = 256;
constexpr int kStages = 3;         // tile path cp.async ring
constexpr int kQStages = 4;        // tile path ring of int8/int4 stages
constexpr int kTileBK = 32;        // tile path K step
constexpr int kLDA = kTileBK + 4;  // [row][k] f32 tiles: row stride in
                                   // floats; float4 reads of 8 rows, 36
                                   // floats apart, hit 8 bank groups
constexpr int kSkinnyMaxM = 16;
constexpr int kSkinnyCols = 128;   // skinny, row-major B: columns a block
constexpr int kSkinnyKCols = 32;   // skinny, K-major B: columns a block
constexpr int kXFloats = 12288;    // skinny: most floats of x a block holds
constexpr int kUnroll = 8;         // skinny, row-major: loads in flight
constexpr int kPanel = 128;        // LinearPacked's panel width (bn = bk)

constexpr int kStreamBM = 128;     // stream path: rows of an item
constexpr int kStreamBN = 64;      // stream path: columns of an item
constexpr int kStreamMaxK = 64;    // stream path: deepest K
constexpr int kStreamStepK = 32;   // stream path: k of a ring step

enum Path { kSkinny = 0, kTile = 1, kStream = 2 };
// f32 B on the tile path (a template parameter: a row-major B keeps the
// panel arithmetic out of its kernels' registers)
enum BLayout { kRowMajorB = 0, kKMajorB = 1, kPanelsB = 2 };

struct Problem {
  const void* A;           // (batch, M, K), lda = K: f32 or bf16
  const void* B;           // f32 row-major (K,N) / K-major (N,K) / panels,
                           // int8 (K, N) or int4 bytes ((K+1)/2, N)
  void* C;                 // (batch, M, N) out in A's type, or f32
                           // partials (split, ...)
  const float* scale;      // per-column scale of the finished sum, or null
  int M, N, K, ldb;
  int batch, split;
  long long bsa, bsb, bsc; // elements between two batch entries' A, B, C
  long long split_stride;  // floats between two splits' partials
  long long pstride;       // panels: floats between two 128-column panels
                           // (0: B is one matrix)
  int kps;                 // K steps a split
  int a_vec, b_vec, c_vec; // 16-byte copies / stores allowed; int8 and
                           // int4 B: b_vec is the copy width, 16, 4 or 1
                           // bytes
  const int* row_limit;    // rows of each batch entry that hold data, or
                           // null (all M)
  const int* k_limit;      // K depth of each batch entry, or null (all K)
};

// ---------------------------------------------------------------------------
// element types
// ---------------------------------------------------------------------------
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// four consecutive outputs in one store (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// nibble b (0..7) of w, sign-extended: rows 2j and 2j+1 of byte j
__device__ __forceinline__ float nib(uint32_t w, int b) {
  return (float)(((int)(w << (28 - 4 * b))) >> 28);
}
// byte b (0..3) of w as a signed int8 value
__device__ __forceinline__ float sx8(uint32_t w, int b) {
  return (float)(((int)(w << (24 - 8 * b))) >> 24);
}

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
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// The same for the 8 bf16 at (row, col..col+7); vec: multiples of 8.
__device__ __forceinline__ void load4(uint32_t dst, const __nv_bfloat16* src,
                                      long long ld, int row, int nrows,
                                      int col, int ncols, int vec) {
  if (vec) {
    const bool ok = row < nrows && col < ncols;
    cp_async16(dst,
               ok ? (const void*)(src + (size_t)row * ld + col)
                  : (const void*)src,
               ok ? 16 : 0);
  } else {
    const unsigned short* s =
        reinterpret_cast<const unsigned short*>(src) + (size_t)row * ld;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo =
          row < nrows && col + 2 * j < ncols ? s[col + 2 * j] : 0u;
      const uint32_t hi =
          row < nrows && col + 2 * j + 1 < ncols ? s[col + 2 * j + 1] : 0u;
      v[j] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A's [row][k] tile in shared memory by element type: row stride (padded
// so that float4 reads of neighbouring rows fall in other banks) and the
// elements of one 16-byte copy
template <typename TX>
struct ATile;
template <>
struct ATile<float> {
  static constexpr int LD = kLDA, PER = 4;
};
template <>
struct ATile<__nv_bfloat16> {
  static constexpr int LD = kTileBK + 8, PER = 8;
};

// k .. k+3 of row `row` of A's tile, as f32
__device__ __forceinline__ float4 a_read4(const float* As, int row, int k) {
  return *reinterpret_cast<const float4*>(&As[row * kLDA + k]);
}
__device__ __forceinline__ float4 a_read4(const __nv_bfloat16* As, int row,
                                          int k) {
  const uint2 u = *reinterpret_cast<const uint2*>(
      &As[row * ATile<__nv_bfloat16>::LD + k]);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// ---------------------------------------------------------------------------
// tile path
// ---------------------------------------------------------------------------
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16i and BN/16
// columns
template <int BM, int BN, bool KMAJOR, typename TX>
struct Tile {
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int A_BYTES = BM * ATile<TX>::LD * (int)sizeof(TX);
  static constexpr int B_BYTES =
      (KMAJOR ? BN * kLDA : kTileBK * BN) * 4;  // [n][k] / [k][n]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BYTES = kStages * STAGE;
};

// The byte rows of an int8 (BITS 8: one k row a byte row) or int4 (BITS
// 4: two k rows a packed byte row) B: the row that holds k, the rows that
// hold [0, kend), and the rows of one K step.
template <int BITS>
struct QRows {
  static constexpr int STEP = BITS == 4 ? kTileBK / 2 : kTileBK;
  static __device__ __forceinline__ int of(int k) {
    return BITS == 4 ? k / 2 : k;
  }
  static __device__ __forceinline__ int end(int kend) {
    return BITS == 4 ? (kend + 1) / 2 : kend;
  }
};

// the int8/int4 ring: A and a K step's byte rows a stage, then two
// widened [k][n] f32 buffers
template <int BM, int BN, int BITS, typename TX>
struct TileQ {
  static constexpr int A_BYTES = Tile<BM, BN, false, TX>::A_BYTES;
  static constexpr int Q_BYTES = QRows<BITS>::STEP * BN;
  static constexpr int STAGE = A_BYTES + Q_BYTES;
  static constexpr int F_FLOATS = kTileBK * BN;
  static constexpr int BYTES = kQStages * STAGE + 2 * F_FLOATS * 4;
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

// The base from which a row-major B's column n, row k lies at
// k·ldb + n for the columns of the 128-wide panel that holds column n0:
// B itself, or for panels B shifted by the panels before (n0 is a
// multiple of BN, which divides 128, so a tile lies in one panel; so
// does a skinny block's 128 columns). A copy's masks stay those of a
// row-major (K, N) matrix.
__device__ __forceinline__ const float* b_panel(const Problem& p,
                                                const float* B, int n0) {
  return p.pstride
             ? B + (long long)(n0 / kPanel) * (p.pstride - kPanel)
             : B;
}

// A's rows [m0, m0 + BM) x k [k0, k0 + kTileBK), zero past kend (the
// split's end) and past row mrows (M, or the batch entry's row limit)
template <int BM, typename TX>
__device__ __forceinline__ void a_tile_load(const Problem& p, const TX* A,
                                            uint32_t sa, int m0, int mrows,
                                            int k0, int kend) {
  constexpr int PER = ATile<TX>::PER, CQ = kTileBK / PER;
  for (int q = threadIdx.x; q < BM * CQ; q += kThreads) {
    const int r = q / CQ, c = (q % CQ) * PER;
    load4(sa + (r * ATile<TX>::LD + c) * (int)sizeof(TX), A, p.K, m0 + r,
          mrows, k0 + c, kend, p.a_vec);
  }
}

// An M-major A's k rows [k0, k0 + kTileBK) x columns [m0, m0 + BM) as
// [k][m] rows of BM floats (the A region of a stage holds them: BM·kLDA
// floats), zero past kend (the split's end or a K limit: whole rows) and
// past column mrows
template <int BM>
__device__ __forceinline__ void a_tile_load_mn(const Problem& p,
                                               const float* A, uint32_t sa,
                                               int m0, int mrows, int k0,
                                               int kend) {
  for (int q = threadIdx.x; q < kTileBK * (BM / 4); q += kThreads) {
    const int k = q / (BM / 4), c = (q % (BM / 4)) * 4;
    load4(sa + (k * BM + c) * 4, A, p.M, k0 + k, kend, m0 + c, mrows,
          p.a_vec);
  }
}

// one K step: k in [k0, k0 + kTileBK), zero past kend (the split's end),
// A's rows zero past mrows. B: as b_panel gives it for a row-major B
template <int BM, int BN, bool KMAJOR, typename TX, bool AMN = false>
__device__ __forceinline__ void tile_load(const Problem& p, const TX* A,
                                          const float* B, uint32_t sa,
                                          int m0, int mrows, int n0, int k0,
                                          int kend) {
  constexpr int BK = kTileBK;
  const uint32_t sb = sa + Tile<BM, BN, KMAJOR, TX>::A_BYTES;
  if constexpr (AMN)
    a_tile_load_mn<BM>(p, A, sa, m0, mrows, k0, kend);
  else
    a_tile_load<BM, TX>(p, A, sa, m0, mrows, k0, kend);
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

// the FMAs of one K step from A's tile As and a row-major B's tile Bs
// ([k][n]) for the int8 and int4 kernels. (The f32 tile kernel runs the
// same loop written in its own body: called as this function there, its
// 96 x 128 tiles took 0.0511 ms of device time at resnet50's
// (3136,1152)x(1152,256) against 0.0503 written inline, on an H100 SXM.)
template <int BM, int BN, typename TX>
__device__ __forceinline__ void tile_fma(float (&acc)[BM / 16][BN / 16],
                                         const TX* As, const float* Bs,
                                         int ty, int tx) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int kk = 0; kk < kTileBK; kk += 4) {
    float4 a4[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a4[i] = a_read4(As, ty + 16 * i, kk);
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
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// the register tile's outputs into C (type TC), each column scaled by
// `scale` where given
template <int BM, int BN, bool KMAJOR, typename TC>
__device__ __forceinline__ void tile_put(
    const Problem& p, TC* C, const float* scale,
    const float (&acc)[BM / 16][BN / 16], int m0, int n0, int ty, int tx) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
    TC* row = C + (size_t)r * p.N;
    if (!KMAJOR && p.c_vec) {
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const int c = n0 + tx * 4 + 64 * jj;
        if (c < p.N) {
          float4 v = make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                                 acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
          if (scale) {
            v.x *= scale[c];
            v.y *= scale[c + 1];
            v.z *= scale[c + 2];
            v.w *= scale[c + 3];
          }
          put4(row + c, v);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + col_of<BN, KMAJOR>(tx, j);
        if (c < p.N) put(row + c, scale ? acc[i][j] * scale[c] : acc[i][j]);
      }
    }
  }
}

// C when K is not split (scaled where SCALED, in TX), else this split's
// f32 partials
template <int BM, int BN, bool KMAJOR, typename TX, bool SCALED>
__device__ __forceinline__ void tile_store(
    const Problem& p, const float (&acc)[BM / 16][BN / 16], int m0, int n0,
    int bz, int sp, int ty, int tx) {
  // an unscaled f32 C and the partials share one layout (split_stride is
  // 0 when K is not split): one store path, as the condition is constant
  if (p.split > 1 || (sizeof(TX) == 4 && !SCALED))
    tile_put<BM, BN, KMAJOR>(
        p, static_cast<float*>(p.C) + (size_t)sp * p.split_stride + bz * p.bsc,
        nullptr, acc, m0, n0, ty, tx);
  else
    tile_put<BM, BN, KMAJOR>(p, static_cast<TX*>(p.C) + bz * p.bsc, p.scale,
                             acc, m0, n0, ty, tx);
}

// the rows of batch entry bz that hold data: M, or its row limit
__device__ __forceinline__ int rows_of(const Problem& p, int bz) {
  return p.row_limit ? min(max(p.row_limit[bz], 0), p.M) : p.M;
}

// the K depth batch entry bz contracts over: K, or its K limit
__device__ __forceinline__ int depth_of(const Problem& p, int bz) {
  return p.k_limit ? min(max(p.k_limit[bz], 0), p.K) : p.K;
}

// two blocks an SM (at most 128 registers a thread): a split tile grid
// runs two waves side by side. LIM: 0 no limits; 1 p.row_limit may be
// given; 2 p.k_limit may be given too (with AMN: A is M-major, f32, with
// a row-major B, and a K limit cuts whole rows of both)
template <int BM, int BN, int LAYOUT, typename TX, int LIM, bool AMN = false>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_f32_tile_kernel(Problem p) {
  static_assert(!AMN || (LAYOUT == kRowMajorB && sizeof(TX) == 4),
                "an M-major A comes f32, with a row-major B");
  constexpr bool LIMIT = LIM > 0, KLIM = LIM == 2;
  constexpr bool KMAJOR = LAYOUT == kKMajorB;
  using TL = Tile<BM, BN, KMAJOR, TX>;
  constexpr int TM = TL::TM, TN = TL::TN, BK = kTileBK;
  extern __shared__ __align__(16) float smem_t[];
  const uint32_t ring = smem_addr(smem_t);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int bz = blockIdx.z / p.split, sp = blockIdx.z % p.split;
  const TX* A = static_cast<const TX*>(p.A) + bz * p.bsa;
  const float* B = static_cast<const float*>(p.B) + bz * p.bsb;
  if constexpr (LAYOUT == kPanelsB) B = b_panel(p, B, n0);
  const int mrows = LIMIT ? rows_of(p, bz) : p.M;
  // this split's k range, in steps of BK, up to the entry's depth; none
  // for a block past the row limit
  const int kbeg = sp * p.kps * kBK;
  const int kend = min(KLIM ? depth_of(p, bz) : p.K, kbeg + p.kps * kBK);
  const int nks = kend > kbeg && (!LIMIT || m0 < mrows)
                      ? (kend - kbeg + BK - 1) / BK
                      : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nks)
      tile_load<BM, BN, KMAJOR, TX, AMN>(p, A, B, ring + s * TL::STAGE, m0,
                                         mrows, n0, kbeg + s * BK, kend);
    cp_async_commit();
  }
  for (int t = 0; t < nks; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; the slot of step t - 1 is free
    const int nt = t + kStages - 1;
    if (nt < nks)
      tile_load<BM, BN, KMAJOR, TX, AMN>(
          p, A, B, ring + (nt % kStages) * TL::STAGE, m0, mrows, n0,
          kbeg + nt * BK, kend);
    cp_async_commit();
    const float* St = smem_t + (t % kStages) * (TL::STAGE / 4);
    const TX* As = reinterpret_cast<const TX*>(St);
    const float* Bs = St + TL::A_BYTES / 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if constexpr (KMAJOR) {
        float4 bt[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bt[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * j) * kLDA + kk]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a4 = a_read4(As, ty + 16 * i, kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a4.x, bt[j].x, acc[i][j]);
            acc[i][j] = fmaf(a4.y, bt[j].y, acc[i][j]);
            acc[i][j] = fmaf(a4.z, bt[j].z, acc[i][j]);
            acc[i][j] = fmaf(a4.w, bt[j].w, acc[i][j]);
          }
        }
      } else if constexpr (AMN) {
        const float* Am = reinterpret_cast<const float*>(St);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = Am[(kk + q) * BM + ty + 16 * i];
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
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      } else {
        float4 a4[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a4[i] = a_read4(As, ty + 16 * i, kk);
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
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (LIMIT) {  // rows past the limit are zeros, whatever B holds
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (m0 + ty + 16 * i >= mrows)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  tile_store<BM, BN, KMAJOR, TX, false>(p, acc, m0, n0, bz, sp, ty, tx);
}

// int8/int4 B: one K step's byte rows (from the row that holds k0) of
// the tile's BN columns (Bq: the column base), zero past the rows that
// hold [0, kend) and past N, in p.b_vec-byte pieces
template <int BN, int BITS>
__device__ __forceinline__ void q_load(const Problem& p, const uint8_t* Bq,
                                       uint32_t sq, int nb, int k0,
                                       int kend) {
  constexpr int R = QRows<BITS>::STEP;
  const int r0 = QRows<BITS>::of(k0), rend = QRows<BITS>::end(kend);
  if (p.b_vec == 16) {
    for (int q = threadIdx.x; q < R * (BN / 16); q += kThreads) {
      const int r = q / (BN / 16), c = (q % (BN / 16)) * 16;
      const bool ok = r0 + r < rend && c < nb;
      cp_async16(sq + r * BN + c,
                 ok ? (const void*)(Bq + (size_t)(r0 + r) * p.N + c)
                    : (const void*)Bq,
                 ok ? 16 : 0);
    }
  } else if (p.b_vec == 4) {
    for (int q = threadIdx.x; q < R * (BN / 4); q += kThreads) {
      const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
      const bool ok = r0 + r < rend && c < nb;
      cp_async4(sq + r * BN + c,
                ok ? (const void*)(Bq + (size_t)(r0 + r) * p.N + c)
                   : (const void*)Bq,
                ok ? 4 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < R * BN; q += kThreads) {
      const int r = q / BN, c = q % BN;
      const uint32_t v = r0 + r < rend && c < nb
                             ? __ldg(Bq + (size_t)(r0 + r) * p.N + c)
                             : 0u;
      asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(sq + r * BN + c), "r"(v)
                   : "memory");
    }
  }
}

// a stage's 16 packed rows -> 32 rows of the [k][n] f32 buffer Fs; rows
// at or past kend are zero (an odd K's last high nibble)
template <int BN>
__device__ __forceinline__ void q4_unpack(const uint8_t* Qs, float* Fs,
                                          int k0, int kend) {
  for (int q = threadIdx.x; q < (kTileBK / 2) * (BN / 4); q += kThreads) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(Qs + r * BN + c);
    const bool lo = k0 + 2 * r < kend, hi = k0 + 2 * r + 1 < kend;
    *reinterpret_cast<float4*>(&Fs[(2 * r) * BN + c]) =
        lo ? make_float4(nib(w, 0), nib(w, 2), nib(w, 4), nib(w, 6))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(&Fs[(2 * r + 1) * BN + c]) =
        hi ? make_float4(nib(w, 1), nib(w, 3), nib(w, 5), nib(w, 7))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// a stage's 32 int8 rows -> the [k][n] f32 buffer Fs (rows past kend were
// copied as zeros)
template <int BN>
__device__ __forceinline__ void q8_widen(const uint8_t* Qs, float* Fs) {
  for (int q = threadIdx.x; q < kTileBK * (BN / 4); q += kThreads) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(Qs + r * BN + c);
    *reinterpret_cast<float4*>(&Fs[r * BN + c]) =
        make_float4(sx8(w, 0), sx8(w, 1), sx8(w, 2), sx8(w, 3));
  }
}

// int8 or int4 B on the tile path (batch 1). Iteration t: wait for stage
// t + 1, one barrier, start the copies of stage t + 3 (into the slot of
// stage t - 1, whose A was read at t - 1 and bytes at t - 2), widen stage
// t + 1 into the buffer that step t - 1 read, run step t's FMAs.
template <int BM, int BN, int BITS, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_q_tile_kernel(Problem p) {
  using TL = TileQ<BM, BN, BITS, TX>;
  constexpr int TM = BM / 16, TN = BN / 16, BK = kTileBK, S = kQStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  float* fbuf = reinterpret_cast<float*>(smem + S * TL::STAGE);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, sp = blockIdx.z;
  const TX* A = static_cast<const TX*>(p.A);
  const uint8_t* Bq = static_cast<const uint8_t*>(p.B) + n0;
  const int nb = p.N - n0;
  const int kbeg = sp * p.kps * kBK;
  const int kend = min(p.K, kbeg + p.kps * kBK);
  const int nks = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  auto load = [&](int s) {
    const uint32_t sa = ring + (s % S) * TL::STAGE;
    a_tile_load<BM, TX>(p, A, sa, m0, p.M, kbeg + s * BK, kend);
    q_load<BN, BITS>(p, Bq, sa + TL::A_BYTES, nb, kbeg + s * BK, kend);
  };
  auto widen = [&](int s) {
    const uint8_t* Qs = smem + (s % S) * TL::STAGE + TL::A_BYTES;
    float* Fs = fbuf + (s & 1) * TL::F_FLOATS;
    if constexpr (BITS == 4)
      q4_unpack<BN>(Qs, Fs, kbeg + s * BK, kend);
    else
      q8_widen<BN>(Qs, Fs);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nks) load(s);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();  // stage 0 landed
  if (nks > 0) widen(0);
  for (int t = 0; t < nks; ++t) {
    cp_async_wait<S - 3>();
    __syncthreads();  // stage t + 1 landed, step t's buffer widened
    if (t + S - 1 < nks) load(t + S - 1);
    cp_async_commit();
    if (t + 1 < nks) widen(t + 1);
    tile_fma<BM, BN, TX>(
        acc, reinterpret_cast<const TX*>(smem + (t % S) * TL::STAGE),
        fbuf + (t & 1) * TL::F_FLOATS, ty, tx);
  }
  cp_async_wait<0>();
  tile_store<BM, BN, false, TX, true>(p, acc, m0, n0, 0, sp, ty, tx);
}

// ---------------------------------------------------------------------------
// stream path (batch > 1, K <= kStreamMaxK; f32)
// ---------------------------------------------------------------------------
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
  const float* A = static_cast<const float*>(p.A) + t.b * p.bsa;
  for (int q = threadIdx.x; q < kStreamBM * cq; q += kThreads) {
    const int r = q / cq, c = (q - r * cq) * 4;
    load4_async(sa + (r * lds + c) * 4, A, p.K, t.m0 + r, p.M, k0 + c, p.K,
                p.a_vec);
  }
  if (with_b) {
    const float* B = static_cast<const float*>(p.B) + t.b * p.bsb;
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
  extern __shared__ __align__(16) float smem_f[];
  constexpr int lds = SK + 4;
  const StreamShape sh(p.K);
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const int nsteps = (last - first) * sh.spi;
  if (nsteps <= 0) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  constexpr int slot_floats = kStreamBM * lds;
  float* ring = smem_f;
  float* slabs = smem_f + NST * slot_floats;
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
    float* C = static_cast<float*>(p.C) + t.b * p.bsc;
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
// x's rows [0, rows) of A over this split's k range into shared memory,
// as f32
template <typename TX>
__device__ __forceinline__ void load_x(const Problem& p, const TX* A,
                                       int rows, float* xs, int kb0,
                                       int kn) {
  for (int i = threadIdx.x; i < rows * kn; i += kThreads) {
    const int m = i / kn, kk = i - m * kn;
    xs[i] = widen(A[(size_t)m * p.K + kb0 + kk]);
  }
}

// columns n .. n+3 of row k (B: as b_panel gives it)
__device__ __forceinline__ float4 load_b4(const Problem& p, const float* B,
                                          int k, int n, bool vec) {
  const float* src = B + (size_t)k * p.ldb + n;
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

// The KP phases of each of the block's columns summed in phase order and
// stored, row by row: `red` holds, for each thread tid = kp·CG + cg, its
// V columns' sums of one row. C is out (scaled, in TX) when K is not
// split, else this split's f32 partials; `off` is the batch entry's
// offset in either.
template <int MT, int V, typename TX>
__device__ __forceinline__ void skinny_store(const Problem& p,
                                             float (&acc)[MT][V], float* red,
                                             int n0, int CG, int KP, int sp,
                                             size_t off) {
  const int tid = threadIdx.x;
  const int n = n0 + tid;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= p.M) break;
#pragma unroll
    for (int e = 0; e < V; ++e) red[tid * V + e] = acc[m][e];
    __syncthreads();
    if (tid < CG * V && n < p.N) {
      float s = 0.0f;
      for (int ph = 0; ph < KP; ++ph) s += red[ph * CG * V + tid];
      const size_t i = off + (size_t)m * p.N + n;
      if (p.split > 1)
        static_cast<float*>(p.C)[(size_t)sp * p.split_stride + i] = s;
      else
        put(static_cast<TX*>(p.C) + i, p.scale ? s * p.scale[n] : s);
    }
    __syncthreads();
  }
}

// row-major B or its panel: columns [n0, n0 + 128) of split blockIdx.y.
// GROUPED: batch entry blockIdx.z, whose rows past its row limit read no
// x and no B and are stored as zeros (their sums never take an FMA)
template <int MT, typename TX, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_skinny_kernel(Problem p) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSkinnyCols, sp = blockIdx.y;
  const int bz = GROUPED ? blockIdx.z : 0;
  const int kb0 = sp * p.kps * kBK;
  const int kn = max(0, min(p.kps * kBK, p.K - kb0));
  const int M = GROUPED ? rows_of(p, bz) : p.M;
  const int ncols = min(kSkinnyCols, p.N - n0);
  const int CG = (ncols + 3) / 4;  // float4 columns
  const int KP = kThreads / CG;    // k phases
  const int cg = tid % CG, kp = tid / CG;
  const int n = n0 + cg * 4;
  const bool vec = p.b_vec && n + 3 < p.N;
  const float* B =
      b_panel(p, static_cast<const float*>(p.B) + bz * p.bsb, n0);
  load_x<TX>(p, static_cast<const TX*>(p.A) + bz * p.bsa, M, xs, kb0, kn);
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  if (kp < KP && (!GROUPED || M > 0)) {
    int kk = kp;
    for (; kk + (kUnroll - 1) * KP < kn; kk += kUnroll * KP) {
      float4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        w[u] = load_b4(p, B, kb0 + kk + u * KP, n, vec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        skinny_fma<MT>(acc, xs, kn, kk + u * KP, M, w[u]);
    }
    // the last rows (fewer than kUnroll), loaded together: a split of a
    // few rows a phase, as at the resnet50 head, waits on one round trip,
    // not one a row (one at a time at MT 16, within the registers)
    constexpr int TB = MT >= 16 ? 1 : kUnroll - 1;
    for (; kk < kn; kk += TB * KP) {
      float4 w[TB];
#pragma unroll
      for (int u = 0; u < TB; ++u)
        if (kk + u * KP < kn)
          w[u] = load_b4(p, B, kb0 + kk + u * KP, n, vec);
#pragma unroll
      for (int u = 0; u < TB; ++u)
        if (kk + u * KP < kn)
          skinny_fma<MT>(acc, xs, kn, kk + u * KP, M, w[u]);
    }
  }
  __syncthreads();  // x is no longer read: the buffer takes the sums
  skinny_store<MT, 4, TX>(p, acc, xs, n0, CG, KP, sp,
                          (size_t)bz * p.bsc);
}

// int8/int4 skinny: V bytes of a byte row, as loaded (V = 16, 4 or 1)
template <int V>
struct QWord;
template <>
struct QWord<16> {
  uint4 v;
  __device__ __forceinline__ void load(const uint8_t* src) {
    v = __ldg(reinterpret_cast<const uint4*>(src));
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct QWord<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* src) {
    v = __ldg(reinterpret_cast<const unsigned int*>(src));
  }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};
template <>
struct QWord<1> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint8_t* src) { v = __ldg(src); }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};

// the FMAs of one packed row (k rows kk and kk + 1 of the split, the
// second only where kk + 1 < kn) over the thread's V columns
template <int MT, int V>
__device__ __forceinline__ void q4_fma(float (&acc)[MT][V], const float* xs,
                                       int kn, int kk, int M,
                                       const QWord<V>& w) {
  const bool two = kk + 1 < kn;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const uint32_t byte = w.word(e / 4) >> (8 * (e % 4));
    const float lo = nib(byte, 0), hi = nib(byte, 1);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        acc[m][e] = fmaf(xs[m * kn + kk], lo, acc[m][e]);
        if (two) acc[m][e] = fmaf(xs[m * kn + kk + 1], hi, acc[m][e]);
      }
    }
  }
}

// the FMAs of one int8 row (k row kk of the split) over the thread's V
// columns
template <int MT, int V>
__device__ __forceinline__ void q8_fma(float (&acc)[MT][V], const float* xs,
                                       int kn, int kk, int M,
                                       const QWord<V>& w) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float b = sx8(w.word(e / 4), e % 4);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) acc[m][e] = fmaf(xs[m * kn + kk], b, acc[m][e]);
  }
}

template <int MT, int V, int BITS>
__device__ __forceinline__ void q_fma(float (&acc)[MT][V], const float* xs,
                                      int kn, int r, int M,
                                      const QWord<V>& w) {
  if constexpr (BITS == 4)
    q4_fma<MT, V>(acc, xs, kn, 2 * r, M, w);
  else
    q8_fma<MT, V>(acc, xs, kn, r, M, w);
}

// int8/int4 B: columns [n0, n0 + 128) of split blockIdx.y; a thread owns
// V of them and every KP-th byte row of the split
template <int MT, int V, int BITS, typename TX>
__global__ void __launch_bounds__(kThreads)
    gemm_q_skinny_kernel(Problem p) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSkinnyCols, sp = blockIdx.y;
  const int kb0 = sp * p.kps * kBK;  // even: a packed row's first k
  const int kn = max(0, min(p.kps * kBK, p.K - kb0));
  const int M = p.M;
  const int ncols = min(kSkinnyCols, p.N - n0);
  const int CG = (ncols + V - 1) / V;  // column groups of V
  const int KP = kThreads / CG;        // byte-row phases
  const int cg = tid % CG, kp = tid / CG;
  const int nrows = QRows<BITS>::end(kn);  // byte rows of the split
  const uint8_t* Bq = static_cast<const uint8_t*>(p.B) +
                      (size_t)QRows<BITS>::of(kb0) * p.N + n0 + cg * V;
  load_x<TX>(p, static_cast<const TX*>(p.A), M, xs, kb0, kn);
  __syncthreads();

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[m][e] = 0.0f;

  if (kp < KP) {  // kUnroll byte rows in flight, as the f32 kernel
    int r = kp;
    for (; r + (kUnroll - 1) * KP < nrows; r += kUnroll * KP) {
      QWord<V> w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        w[u].load(Bq + (size_t)(r + u * KP) * p.N);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q_fma<MT, V, BITS>(acc, xs, kn, r + u * KP, M, w[u]);
    }
    constexpr int TB = MT >= 16 ? 3 : kUnroll - 1;  // the last rows
    for (; r < nrows; r += TB * KP) {
      QWord<V> w[TB];
#pragma unroll
      for (int u = 0; u < TB; ++u)
        if (r + u * KP < nrows) w[u].load(Bq + (size_t)(r + u * KP) * p.N);
#pragma unroll
      for (int u = 0; u < TB; ++u)
        if (r + u * KP < nrows)
          q_fma<MT, V, BITS>(acc, xs, kn, r + u * KP, M, w[u]);
    }
  }
  __syncthreads();  // x is no longer read: the buffer takes the sums
  skinny_store<MT, V, TX>(p, acc, xs, n0, CG, KP, sp, 0);
}

// K-major B: columns [n0, n0 + 32) (rows of B^T) of split blockIdx.y; f32
template <int MT>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_skinny_kmajor_kernel(Problem p) {
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kSkinnyKCols + warp * 4, sp = blockIdx.y;
  const int kb0 = sp * p.kps * kBK;
  const int kn = max(0, min(p.kps * kBK, p.K - kb0));
  const int M = p.M;
  load_x<float>(p, static_cast<const float*>(p.A), M, xs, kb0, kn);
  __syncthreads();

  float acc[4][MT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.0f;
  const float* B = static_cast<const float*>(p.B);
  const float* rows[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rows[c] = B + (size_t)min(n0 + c, p.N - 1) * p.ldb + kb0;

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

  float* C = static_cast<float*>(p.C) + (size_t)sp * p.split_stride;
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
// split-K: sum the partials in split order, then scale and round
// ---------------------------------------------------------------------------
// U loads in flight a thread, summed in order
template <int U, typename TC>
__global__ void __launch_bounds__(256)
    gemm_f32_splitk_sum_kernel(const float* __restrict__ part,
                               TC* __restrict__ C, long long total,
                               int split, const float* __restrict__ scale,
                               int N) {
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
    put(C + i, scale ? s * scale[i % N] : s);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Call l.template go<BM, BN>() for a tile shape the kernels take.
template <typename L>
inline cudaError_t by_tile_shape(int bm, int bn, const L& l) {
  if (bn == 128) {
    switch (bm) {
      case 64: return l.template go<64, 128>();
      case 96: return l.template go<96, 128>();
      case 128: return l.template go<128, 128>();
    }
  } else if (bn == 64) {
    switch (bm) {
      case 64: return l.template go<64, 64>();
      case 96: return l.template go<96, 64>();
      case 128: return l.template go<128, 64>();
    }
  }
  return cudaErrorInvalidValue;
}

inline bool tile_shape_ok(int bm, int bn) {
  return (bn == 128 || bn == 64) && (bm == 64 || bm == 96 || bm == 128);
}

// The shared-memory attribute is set before every tile launch (about a
// microsecond of host time) rather than remembered in a static.
template <typename K>
inline cudaError_t launch_smem(K kernel, dim3 grid, int bytes,
                               const Problem& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int LAYOUT, typename TX, int LIM, bool AMN = false>
struct TileLaunch {
  const Problem& p;
  cudaStream_t stream;
  template <int BM, int BN>
  cudaError_t go() const {
    dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch * p.split);
    return launch_smem(gemm_f32_tile_kernel<BM, BN, LAYOUT, TX, LIM, AMN>,
                       grid,
                       Tile<BM, BN, LAYOUT == kKMajorB, TX>::BYTES, p,
                       stream);
  }
};

template <int BITS, typename TX>
struct QTileLaunch {
  const Problem& p;
  cudaStream_t stream;
  template <int BM, int BN>
  cudaError_t go() const {
    dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.split);
    return launch_smem(gemm_q_tile_kernel<BM, BN, BITS, TX>, grid,
                       TileQ<BM, BN, BITS, TX>::BYTES, p, stream);
  }
};

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
// where every slab spans at least 3 steps, else 2-deep. (A template, so
// that a library that never takes the path compiles none of its kernels.)
template <typename TX>
inline cudaError_t launch_stream(const Problem& p, int blocks,
                                 cudaStream_t stream) {
  static_assert(sizeof(TX) == 4, "the stream path is f32");
  const int tiles_m = (p.M + kStreamBM - 1) / kStreamBM;
  const int tiles_n = (p.N + kStreamBN - 1) / kStreamBN;
  if (tiles_m * StreamShape(p.K).spi >= 3)
    return launch_stream_nst<4>(p, blocks, tiles_m, tiles_n, stream);
  return launch_stream_nst<2>(p, blocks, tiles_m, tiles_n, stream);
}

// the skinny kernels' shared memory: x's split slice, and the phase sums
// (V floats a thread) once x is read
inline size_t skinny_smem_bytes(const Problem& p, int v) {
  const int kn = p.kps * kBK;
  int floats = p.M * kn;
  if (floats < kThreads * v) floats = kThreads * v;
  return (size_t)(floats > 0 ? floats : 1) * sizeof(float);
}

// MT: the rows a thread's register tile holds (M rounded up)
template <typename F>
inline cudaError_t by_rows(int M, const F& f) {
  if (M <= 1) return f.template go<1>();
  if (M <= 2) return f.template go<2>();
  if (M <= 4) return f.template go<4>();
  if (M <= 8) return f.template go<8>();
  return f.template go<16>();
}

// GROUPED: the batch entry on blockIdx.z, with its row limit
template <typename TX, bool GROUPED>
struct SkinnyLaunch {
  const Problem& p;
  bool kmajor;
  cudaStream_t stream;
  template <int MT>
  cudaError_t go() const {
    if constexpr (sizeof(TX) == 4 && !GROUPED) {
      if (kmajor) {
        dim3 grid((p.N + kSkinnyKCols - 1) / kSkinnyKCols, p.split);
        gemm_f32_skinny_kmajor_kernel<MT>
            <<<grid, kThreads, skinny_smem_bytes(p, 0), stream>>>(p);
        return cudaGetLastError();
      }
    }
    dim3 grid((p.N + kSkinnyCols - 1) / kSkinnyCols, p.split,
              GROUPED ? p.batch : 1);
    gemm_f32_skinny_kernel<MT, TX, GROUPED>
        <<<grid, kThreads, skinny_smem_bytes(p, 4), stream>>>(p);
    return cudaGetLastError();
  }
};

template <int MT, int V, int BITS, typename TX>
inline void q_skinny(const Problem& p, dim3 grid, size_t bytes,
                     cudaStream_t stream) {
  gemm_q_skinny_kernel<MT, V, BITS, TX><<<grid, kThreads, bytes, stream>>>(p);
}

// int8/int4 skinny: MT 1, 4 or 16; V = p.b_vec (16 only where MT <= 4)
template <int BITS, typename TX>
inline cudaError_t launch_q_skinny(const Problem& p, cudaStream_t stream) {
  dim3 grid((p.N + kSkinnyCols - 1) / kSkinnyCols, p.split);
  const size_t bytes = skinny_smem_bytes(p, p.b_vec);
  if (p.M <= 1) {
    if (p.b_vec == 16)
      q_skinny<1, 16, BITS, TX>(p, grid, bytes, stream);
    else if (p.b_vec == 4)
      q_skinny<1, 4, BITS, TX>(p, grid, bytes, stream);
    else
      q_skinny<1, 1, BITS, TX>(p, grid, bytes, stream);
  } else if (p.M <= 4) {
    if (p.b_vec == 16)
      q_skinny<4, 16, BITS, TX>(p, grid, bytes, stream);
    else if (p.b_vec == 4)
      q_skinny<4, 4, BITS, TX>(p, grid, bytes, stream);
    else
      q_skinny<4, 1, BITS, TX>(p, grid, bytes, stream);
  } else {
    if (p.b_vec == 4)
      q_skinny<16, 4, BITS, TX>(p, grid, bytes, stream);
    else if (p.b_vec == 1)
      q_skinny<16, 1, BITS, TX>(p, grid, bytes, stream);
    else
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the split's plan checks shared by every entry; fills p's split fields
// and points p.C at the scratch when K is split. `batched_skinny`: the
// entry's skinny path takes a batch
inline bool plan_split(Problem& p, int path, int split, float* scratch,
                       void* C, bool batched_skinny = false) {
  const int ksteps = (p.K + kBK - 1) / kBK;
  const int kps = split > 0 && ksteps > 0 ? ksteps / split : 0;
  if (p.K < 0 || split < 1 || (ksteps > 0 && ksteps % split) ||
      (ksteps == 0 && split != 1) || (split > 1 && scratch == nullptr) ||
      // the split's sum writes C packed
      (split > 1 && p.batch > 1 && p.bsc != (long long)p.M * p.N) ||
      (path == kSkinny &&
       ((p.batch != 1 && !batched_skinny) || p.M > kSkinnyMaxM ||
        (long long)kps * kBK * p.M > kXFloats)))
    return false;
  p.split = split;
  p.kps = kps;
  // the partials of a split are (split, batch, M, N), packed
  p.bsc = split > 1 ? (long long)p.M * p.N : p.bsc;
  p.C = split > 1 ? (void*)scratch : C;
  p.split_stride = split > 1 ? (long long)p.batch * p.M * p.N : 0;
  return true;
}

// after a split launch: the partials summed in split order into C,
// scaled, in C's type
template <typename TC>
inline int finish_split(const Problem& p, cudaError_t err, TC* C,
                        cudaStream_t stream) {
  if (err != cudaSuccess || p.split == 1) return (int)err;
  const long long total = (long long)p.batch * p.M * p.N;
  long long nb = (total + 255) / 256;
  if (nb > 4096) nb = 4096;
  gemm_f32_splitk_sum_kernel<8, TC><<<(unsigned)nb, 256, 0, stream>>>(
      static_cast<const float*>(p.C), C, total, p.split, p.scale, p.N);
  return (int)cudaGetLastError();
}

// What an entry's launches take (template flags, so that each library
// compiles only the kernels its entries launch): kPanels, B is
// LinearPacked's panels (x f32 or bf16; else B is row-major or K-major
// with an f32 x); kStreamPath, the stream path; kRowLimit, a batch with
// per-entry row limits (p.row_limit) on the tile path (row-major or
// K-major B) and on the grouped skinny path (row-major B), which takes the
// batch on blockIdx.z; kAMajorM, an M-major f32 A ((K, M) a batch entry,
// leading dimension M) with per-entry K limits (p.k_limit) on the tile
// path with a row-major B (kRowLimit too), and nothing else.
enum EntryFlags : unsigned {
  kPanels = 1,
  kStreamPath = 2,
  kRowLimit = 4,
  kAMajorM = 8
};

// f32 B: C[z] = A[z] · B[z] on `stream` as the host planner decided. p
// holds the operands, shapes, strides, layout and row limits; `path`
// (kSkinny needs M <= 16, kps·16·M <= kXFloats and batch 1 unless the
// entry is kRowLimit; kTile a (bm, bn) that
// tile_shape_ok takes; kStream, where the entry has it, K <= kStreamMaxK,
// no split, and `blocks` persistent blocks), `split` (a divisor of the K
// steps; > 1 needs `scratch` of split·batch·M·N floats). Returns the
// first launch error, checked after each launch; cudaErrorInvalidValue
// for a plan the kernels do not take.
template <typename TX, unsigned FLAGS>
inline int launch_planned(Problem p, bool kmajor, int path, int bm, int bn,
                          int split, int blocks, float* scratch,
                          cudaStream_t stream) {
  constexpr bool PANELS = FLAGS & kPanels, STREAM = FLAGS & kStreamPath,
                 LIMIT = FLAGS & kRowLimit, AMN = FLAGS & kAMajorM;
  TX* C = static_cast<TX*>(p.C);
  if (p.batch <= 0 || p.M <= 0 || p.N <= 0) return (int)cudaGetLastError();
  if constexpr (AMN) {
    static_assert(LIMIT && !PANELS && !STREAM && sizeof(TX) == 4,
                  "an M-major A comes f32, with K limits");
    if (path != kTile || kmajor || !tile_shape_ok(bm, bn) ||
        p.row_limit != nullptr ||
        !plan_split(p, path, split, scratch, C, true))
      return (int)cudaErrorInvalidValue;
    p.c_vec = aligned16(p.C) && p.N % 4 == 0 && p.bsc % 4 == 0;
    return finish_split(
        p, by_tile_shape(bm, bn, TileLaunch<kRowMajorB, TX, 2, true>{p,
                                                                   stream}),
        C, stream);
  } else {
    // a K-major B takes row limits on the tile path
    const bool kmajor_ok =
        !kmajor || (sizeof(TX) == 4 && !PANELS && (!LIMIT || path == kTile));
    const bool ok_path =
        (path == kSkinny && kmajor_ok) ||
        (path == kTile && tile_shape_ok(bm, bn) && kmajor_ok) ||
        (STREAM && path == kStream && !kmajor && p.row_limit == nullptr &&
         p.K <= kStreamMaxK && split == 1 && bm == kStreamBM &&
         bn == kStreamBN && blocks > 0);
    if (p.k_limit != nullptr || (p.row_limit != nullptr && !LIMIT) ||
        !ok_path || !plan_split(p, path, split, scratch, C, LIMIT))
      return (int)cudaErrorInvalidValue;
    p.c_vec = aligned16(p.C) && p.N % 4 == 0 && p.bsc % 4 == 0;
    cudaError_t err = cudaErrorInvalidValue;
    if (path == kSkinny) {
      if constexpr (LIMIT) {
        err = by_rows(p.M, SkinnyLaunch<TX, true>{p, false, stream});
      } else {
        err = by_rows(p.M, SkinnyLaunch<TX, false>{p, kmajor, stream});
      }
    } else if constexpr (PANELS) {
      err = by_tile_shape(bm, bn, TileLaunch<kPanelsB, TX, 0>{p, stream});
    } else {
      static_assert(sizeof(TX) == 4, "a bf16 x comes only with panels");
      constexpr int LIM = LIMIT ? 1 : 0;
      if (path == kTile && kmajor) {
        err = by_tile_shape(bm, bn, TileLaunch<kKMajorB, TX, LIM>{p, stream});
      } else if (path == kTile) {
        err = by_tile_shape(bm, bn, TileLaunch<kRowMajorB, TX, LIM>{p, stream});
      } else if constexpr (STREAM) {
        err = launch_stream<TX>(p, blocks, stream);
      }
    }
    return finish_split(p, err, C, stream);
  }
}

inline Problem make_problem(const void* A, const void* B, void* C,
                            const float* scale, int M, int N, int K,
                            int ldb) {
  Problem p{};
  p.A = A;
  p.B = B;
  p.C = C;
  p.scale = scale;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldb = ldb;
  p.batch = 1;
  p.split = 1;
  return p;
}

// Enqueue C[z] = A[z] · B[z] for z < batch, all f32 (T, a template only so
// that a library that never calls it compiles none of its kernels), B
// row-major (K,N) or K-major (N,K) with leading dimension ldb; batch entry
// z of A, B and C starts bsa, bsb and bsc floats after entry z - 1, and
// holds data in its first row_limit[z] rows where row_limit is given
// (kRowLimit). The plan and FLAGS as in launch_planned.
template <unsigned FLAGS, typename T>
inline int launch_gemm_f32_batched(const T* A, const float* B, T* C,
                                   int batch, long long bsa, long long bsb,
                                   long long bsc, int M, int N, int K,
                                   int ldb, bool kmajor, int path, int bm,
                                   int bn, int split, int blocks,
                                   float* scratch, cudaStream_t stream,
                                   const int* row_limit = nullptr) {
  if (batch > 0 && M > 0 && N > 0 && ldb < (kmajor ? K : N))
    return (int)cudaErrorInvalidValue;
  Problem p = make_problem(A, B, C, nullptr, M, N, K, ldb);
  p.batch = batch;
  p.bsa = bsa;
  p.bsb = bsb;
  p.bsc = bsc;
  p.row_limit = row_limit;
  p.a_vec = aligned16(A) && K % 4 == 0 && bsa % 4 == 0;
  p.b_vec = aligned16(B) && ldb % 4 == 0 && (kmajor ? K : N) % 4 == 0 &&
            bsb % 4 == 0;
  return launch_planned<T, FLAGS>(p, kmajor, path, bm, bn, split, blocks,
                                  scratch, stream);
}

// One GEMM (matmul's f32 entry): the batched launch at batch 1.
template <typename T>
inline int launch_gemm_f32_planned(const T* A, const float* B, T* C,
                                   int M, int N, int K, int ldb, bool kmajor,
                                   int path, int bm, int bn, int split,
                                   float* scratch, cudaStream_t stream) {
  return launch_gemm_f32_batched<0>(A, B, C, 1, 0, 0, 0, M, N, K, ldb,
                                    kmajor, path, bm, bn, split, 1, scratch,
                                    stream);
}

// x's 16-byte copies: TX's elements of 16 bytes divide K
template <typename TX>
inline bool a_vec_ok(const TX* A, int K) {
  return aligned16(A) && K % (16 / (int)sizeof(TX)) == 0;
}

// matmul_packed: C(M,N) = x(M,K) · W[:K, :N], W stored as LinearPacked's
// (ceil(N/128), nK, 128, 128) f32 panels, K <= nK·128; x and C in TX.
template <typename TX>
inline int launch_gemm_packed(const TX* x, const float* w_packed, TX* C,
                              int M, int N, int K, int nK, int path, int bm,
                              int bn, int split, float* scratch,
                              cudaStream_t stream) {
  if (K > nK * kPanel) return (int)cudaErrorInvalidValue;
  Problem p = make_problem(x, w_packed, C, nullptr, M, N, K, kPanel);
  p.pstride = (long long)nK * kPanel * kPanel;
  p.a_vec = a_vec_ok(x, K);
  // a panel's rows are 128 floats: 4 columns from a multiple of 4 never
  // leave the row, whatever N is
  p.b_vec = aligned16(w_packed);
  return launch_planned<TX, kPanels>(p, false, path, bm, bn, split, 1,
                                     scratch, stream);
}

// matmul_dequant_int8 (BITS 8: q (K, N) int8) and matmul_dequant_int4
// (BITS 4: q ((K+1)/2, N) packed nibbles): C(M,N) = (x(M,K) · q) · scale,
// scale (N) f32; x and C in TX.
template <int BITS, typename TX>
inline int launch_gemm_q(const TX* x, const void* q, const float* scale,
                         TX* C, int M, int N, int K, int path, int bm,
                         int bn, int split, float* scratch,
                         cudaStream_t stream) {
  static_assert(BITS == 4 || BITS == 8, "int8 or int4 B");
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  Problem p = make_problem(x, q, C, scale, M, N, K, N);
  if (path == kStream || (path == kTile && !tile_shape_ok(bm, bn)) ||
      !plan_split(p, path, split, scratch, C))
    return (int)cudaErrorInvalidValue;
  p.a_vec = a_vec_ok(x, K);
  const uintptr_t b = reinterpret_cast<uintptr_t>(q);
  // the copy width: every byte row starts on its boundary; the skinny
  // path's 16-byte loads hold 16 columns of accumulators a row (M <= 4)
  p.b_vec = (b & 15) == 0 && N % 16 == 0 && (path == kTile || M <= 4) ? 16
            : (b & 3) == 0 && N % 4 == 0                              ? 4
                                                                       : 1;
  p.c_vec = aligned16(p.C) && N % 4 == 0;
  const cudaError_t err =
      path == kSkinny
          ? launch_q_skinny<BITS, TX>(p, stream)
          : by_tile_shape(bm, bn, QTileLaunch<BITS, TX>{p, stream});
  return finish_split(p, err, C, stream);
}

}  // namespace f32
}  // namespace repro_torch
