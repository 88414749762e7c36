// ssd_scan_bwd: the Hopper (sm_90a) backward of ssd_scan (csrc/ssd.cu), the
// Mamba2 SSD chunked scan. It replaces no Pallas kernel: the JAX package
// trains by differentiating its jnp ssd_chunked (jax.grad of
// repro/models/ssm.py:36), and this computes the same gradients. Plain C
// entry points, loaded with ctypes by repro_torch/kernels/_native.py.
//
// Given the forward's inputs x (B,S,H,P), dt (B,S,H), A (H), Bm, Cm (B,S,N)
// (G = 1), D (H), its scratch cum (B,nc,H,Q), CB (B,nc,Q,Q) (read on and
// below each chunk's diagonal only) and the chunk-entry states ins
// (B,nc,H,N,P), the gradient dy of y and d final (B,H,P,N) (null: zero),
// it runs the forward's four phases in reverse. With
// L_ij = exp(cum_i - cum_j) for j <= i (exp is taken nowhere else: above
// the diagonal it may overflow) and G_ij = CB_ij L_ij dt_j:
//   4'  dx_j = sum_i G_ij dy_i + D dy_j;  dCB_ij = sum_h L_ij dt_j (dy_i.x_j);
//       ddt_j = sum_i CB_ij L_ij (dy_i.x_j);  M_ij = ddt's term times dt_j
//       adds to dcum_i and subtracts from dcum_j;
//       d in_c = sum_i exp(cum_i) C_i^T dy_i;  dC_i = sum_h exp(cum_i)
//       in_c dy_i, and dcum_i the same dotted with C_i;
//   3'  g = d final; for c = nc-1 .. 0: ds_c = g, dcum_last,c +=
//       exp(cum_last,c) <in_c, g>, g = exp(cum_last,c) g + d in_c;
//       d init = g;
//   2'  w_j = exp(cum_last - cum_j) dt_j: dx_j += w_j B_j ds_c,
//       dB_j = sum_h w_j ds_c x_j, and dw_j = B_j ds_c x_j gives ddt_j
//       exp(cum_last - cum_j) dw_j, dcum_j -w_j dw_j, dcum_last sum w dw;
//   1'  dC += dCB B, dB += dCB^T C; da = the reverse cumulative sum of dcum
//       within the chunk; ddt += da A, dA = sum da dt.
// ddt's and dCB's terms are computed from their own products, never as M
// divided by dt or CB: a zero dt gives no NaN.
//
// Five kernels on one stream:
//   1. din, per (b, chunk, h, 64 state rows): d in_c (N,P) into the scratch
//      ds: phase 2 of the forward (ssd_common.cuh) with C for B, dy for x
//      and exp(cum) for its weights;
//   2. pass, per (b, h, 32 state rows): the reversed phase 3 in reverse
//      chunk order, ds_c written over d in_c in place (bf16: as its hi +
//      lo halves, and in_c's into a scratch of its own, so that the chunk
//      kernel copies both by cp.async), each block's terms of <in_c, g>
//      into dlast (B,nc,H,rows blocks), d init;
//   3. chunk, per (b, chunk, 64-row tile t, group of heads), the tiles
//      launched heaviest (t = 0) first, 512 threads, one block an SM (its
//      shared memory). The block walks its heads in order (the group from
//      plan_ssd_bwd's cost model) and owns, for each: column tile t's
//      pairs i >= j (dx_j's G dy term,
//      ddt's column sums, the head's dCB terms of the column block), row
//      tile t's off-diagonal 4' (dC_i's head term, dcum_i) and 2' terms
//      (dx_j's w B ds term, dB_j's head term, ddt, dcum), and D. dx and
//      ddt's own terms are written once a head; the group's sums of dB,
//      dC (in registers) and dCB (in shared memory) once a block, into
//      (2,groups,B,S,N) and (groups,B,nc,Q,Q) scratch; each head's dcum
//      terms, which cross tiles, into (B,nc,H,tiles,Q) scratch and its dD
//      terms into (B,nc,H,tiles). Below the diagonal L_ij is taken as
//      exp(cum_i - cum_i0) exp(cum_i0 - cum_j) (i0: the row tile's first
//      row), a thread's row and column factors once a tile pair;
//   4. bc, per (b, chunk, 64-row tile, dC or dB, 64 columns of N): dCB =
//      the groups' sum, in group order, times B (dC) or, transposed, times
//      C (dB), plus the groups' sums of the head terms;
//   5. scan, per h: each chunk's dcum (the tiles' terms and dlast's), its
//      reverse cumulative sum da, ddt += da A; dA and dD summed over (b,
//      chunk) in order.
// No atomics and a fixed order for every sum (fixed shuffle trees, then
// shared memory read in order): two launches on the same inputs give the
// same bits.
//
// bf16: kernels 1, 3 and 4 run their products on the tensor cores
// (mma.sync m16n8k16 from ldmatrix, f32 accumulators): dy.x^T, whose
// operands are both bf16, in one product; those with an f32 operand v (in_c,
// ds_c, G, dCB) as v = hi + lo, hi = bf16(v), lo = bf16(v - hi), two
// products into one accumulator that carry v to about 2^-17 of it. bf16
// rows that go in unchanged (x, dy, B, C) and the split states are filled
// by 16-byte cp.async, the next head's and the next row tile's copies in
// flight during this one's products. dx, dB and dC are rounded once to
// bf16; every other output and the scratch stay f32 (but the split
// states). f32 (the lossless path): every product is an IEEE f32 FMA on
// the CUDA cores (no TF32), each thread holding 2 x 4 or 2 x 8 outputs and
// reading its operands as float4 rows of pitch 68 or 132 (phase 2's 8 x 4
// for din). P <= 64, N <= 128; ragged P, N and Q are zero-filled in shared
// memory and masked in the stores.
//
// Bound on an H100 SXM: mamba2-2.7b's training microbatch (B 4, S 512, H 80,
// P 64, N 128, Q 256) needs about 16 GFLOP over the chunks' lower
// triangles (dy_i.x_j and the dx product on the pairs, the two N x P
// products of each of 4' off-diagonal, d in_c and 2') and moves about 100
// MB (x, dy, dx and ins read or written once, d init, B, C, CB's lower
// triangle, cum, dt and their gradients): 0.243 ms of f32 operations at 67
// TFLOP/s, 0.030 ms of bytes at 3.35 TB/s. Measured on an H100 SXM (700
// W): 0.57 ms of device time in bf16, the chunk kernel 0.37 of it, and
// 1.12 ms in f32 (PERF.md). What holds the chunk kernel back is latency:
// one block of 16 warps an SM, each head a chain of fills, products and
// barriers, with the split products' ldmatrix traffic through shared
// memory; left for later: wgmma on the N-wide products, and the four
// row-tile blocks of a head sharing its state tiles.
#include "ssd_common.cuh"  // stages, fills, the hi + lo split, phase 2

namespace {

constexpr int kThreads = 512;      // the chunk and bc kernels: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWC = kWarps / 4;    // bf16: warps across a tile's columns
constexpr int kRowsF = kThreads / 16;  // f32: a thread's row stride
constexpr int kSlotsF = kT / kRowsF;   // f32: rows a thread holds
constexpr int kF64 = kT * kT / kThreads;  // a 64 x 64 tile's elements a
constexpr int kF128 = 2 * kF64;           // thread holds; of a 64 x 128
constexpr int kSmemTiles = 4;      // dCB row tiles a chunk block keeps on chip
constexpr int kLdNh = kNMax + 8;   // bf16 pitch of an N-wide tile (17 chunks)
constexpr int kLdN = kNMax + 4;    // f32 pitch of an N-wide tile
constexpr int kPassRows = 32;      // pass: state rows (n) of a block
constexpr int kLdc = kT + 8;       // f32 pitch of a staged CB tile
constexpr int kMaxSmem = 232448;   // an H100 block's shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// how a thread holds a 64-row tile of outputs (the chunk and bc kernels)
// ---------------------------------------------------------------------------
// bf16 (mma.sync): warp w holds rows 16 (w % 4) + g and + 8 (g = lane / 4)
// and, of a W-wide tile, columns (W / kWC)(w / 4) + 8 nb + 2 (lane % 4) +
// {0, 1}: element k = 4 nb + e, row slot e / 2, column bit e % 2.
// f32 (CUDA cores): thread (tx, ty) = (tid % 16, tid / 16) holds rows ty +
// kRowsF a (slot a) and columns tx + 16 b (the "dot" layout, k = a (W /
// 16) + b: both operands read along k in their rows) or 4 tx + s (the
// "row" layout of a 64-wide tile, k = 4 a + s: B read as [k][n] rows).
// W / 8 elements a thread either way (16 warps).
template <typename T>
struct Lay;

template <>
struct Lay<__nv_bfloat16> {
  static constexpr int kSlots = 2;        // rows a thread holds
  static constexpr int kRowParts = kWC;   // a row's holders after shuffles
  static constexpr int kCols = 16 / kWC;  // columns a thread holds of 64
  static constexpr int kColParts = 4;     // a column's holders likewise
  __device__ static int row(int s) {
    return 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4 + 8 * s;
  }
  template <int W>
  __device__ static int slot(int k) {
    return (k % 4) / 2;
  }
  template <int W>
  __device__ static int col(int k) {
    return (W / kWC) * (threadIdx.x / 128) + 8 * (k / 4) +
           2 * (threadIdx.x % 4) + k % 2;
  }
  __device__ static int rslot(int k) { return slot<64>(k); }
  __device__ static int rcol(int k) { return col<64>(k); }
  // the thread's column index (of kCols) of element k of a 64-wide tile,
  // and that column
  __device__ static int cidx(int k) { return (k / 4) * 2 + k % 2; }
  __device__ static int colof(int ci) {
    return (kT / kWC) * (threadIdx.x / 128) + 8 * (ci / 2) +
           2 * (threadIdx.x % 4) + ci % 2;
  }
  // row partials summed over a row's lanes (lane % 4) by xor shuffles;
  // leaders write them to red[part][row]
  __device__ static void rows_out(float (&v)[kSlots], float* red) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      v[s] += __shfl_xor_sync(0xffffffffu, v[s], 1);
      v[s] += __shfl_xor_sync(0xffffffffu, v[s], 2);
      if (threadIdx.x % 4 == 0) red[(threadIdx.x / 128) * kT + row(s)] = v[s];
    }
  }
  // column partials summed over a column's lanes (lane / 4) likewise
  __device__ static void cols_out(float (&v)[kCols], float* red) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 4);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
      if (threadIdx.x % 32 < 4)
        red[((threadIdx.x / 32) % 4) * kT + colof(c)] = v[c];
    }
  }
};

template <>
struct Lay<float> {
  static constexpr int kSlots = kSlotsF;
  static constexpr int kRowParts = 1;
  static constexpr int kCols = 4;
  static constexpr int kColParts = kWarps;
  __device__ static int row(int s) { return threadIdx.x / 16 + kRowsF * s; }
  template <int W>
  __device__ static int slot(int k) {
    return k / (W / 16);
  }
  template <int W>
  __device__ static int col(int k) {
    return threadIdx.x % 16 + 16 * (k % (W / 16));
  }
  __device__ static int rslot(int k) { return k / 4; }
  __device__ static int rcol(int k) { return 4 * (threadIdx.x % 16) + k % 4; }
  __device__ static int cidx(int k) { return k % 4; }
  __device__ static int colof(int ci) { return threadIdx.x % 16 + 16 * ci; }
  __device__ static void rows_out(float (&v)[kSlots], float* red) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        v[s] += __shfl_xor_sync(0xffffffffu, v[s], o);
      if (threadIdx.x % 16 == 0) red[row(s)] = v[s];
    }
  }
  __device__ static void cols_out(float (&v)[kCols], float* red) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
      if (threadIdx.x % 32 < 16) red[(threadIdx.x / 32) * kT + colof(c)] = v[c];
    }
  }
};

// The totals of a tile's row and column partials (either may be null):
// thread r < 64 gets row r's and column r's, the holders' parts added in
// order. Every thread of the block calls it; red (kRedSet floats) must not
// be written again before a later barrier (callers alternate two).
template <typename T>
constexpr int kRedSet = (Lay<T>::kRowParts + Lay<T>::kColParts) * kT;

template <typename T>
__device__ __forceinline__ void tile_totals(float (*rows)[Lay<T>::kSlots],
                                            float (*cols)[Lay<T>::kCols],
                                            float* red, float& row_total,
                                            float& col_total) {
  using L = Lay<T>;
  float* rred = red;
  float* cred = red + L::kRowParts * kT;
  if (rows != nullptr) L::rows_out(*rows, rred);
  if (cols != nullptr) L::cols_out(*cols, cred);
  __syncthreads();
  row_total = col_total = 0.0f;
  if (threadIdx.x < kT) {
    if (rows != nullptr)
      for (int p = 0; p < L::kRowParts; ++p)
        row_total += rred[p * kT + threadIdx.x];
    if (cols != nullptr)
      for (int p = 0; p < L::kColParts; ++p)
        col_total += cred[p * kT + threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------
// bf16: the lane's ldmatrix address (bytes) in a tile at smem address base
// with pitch ld (elements): of the warp's A fragment (rows m0 .. m0 + 15)
// from an [m][k] tile, or with AT from a [k][m] tile (ldmatrix.trans); of
// the B fragments of the n-blocks n0, n0 + 8 from an [n][k] tile, or with
// BT from a [k][n] tile (.trans)
__device__ __forceinline__ uint32_t lane_a(uint32_t base, int ld, int m0,
                                           bool at) {
  const int lane = threadIdx.x % 32;
  return base + 2u * (uint32_t)(at ? (lane % 8 + (lane / 16) * 8) * ld + m0 +
                                         ((lane / 8) % 2) * 8
                                   : (m0 + lane % 16) * ld + (lane / 16) * 8);
}
__device__ __forceinline__ uint32_t lane_b(uint32_t base, int ld, int n0,
                                           bool bt) {
  const int lane = threadIdx.x % 32;
  return base +
         2u * (uint32_t)(bt ? (lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 +
                                  (lane / 16) * 8
                            : (n0 + (lane / 16) * 8 + lane % 8) * ld +
                                  ((lane / 8) % 2) * 8);
}

// acc (the warp's 16 rows x 8 NB columns) += A · B over ksteps 16-deep
// steps; a2 / b2 (TWO_A / TWO_B) the lo halves of a split operand, at the
// same offsets as a / b; lda, ldb the pitches (elements)
template <int NB, bool AT, bool BT, bool TWO_A, bool TWO_B>
__device__ __forceinline__ void warp_mma(float (&acc)[NB][4], uint32_t a,
                                         uint32_t a2, int lda, uint32_t b,
                                         uint32_t b2, int ldb, int ksteps) {
  const uint32_t a_k = AT ? 32u * lda : 32u;
  const uint32_t b_k = BT ? 32u * ldb : 32u;
  const uint32_t b_n = BT ? 32u : 32u * ldb;  // the next two n-blocks
  for (int kt = 0; kt < ksteps; ++kt) {
    uint32_t af[4], af2[4];
    if constexpr (AT) {
      tc::ldmatrix_x4_trans(af, a + kt * a_k);
      if constexpr (TWO_A) tc::ldmatrix_x4_trans(af2, a2 + kt * a_k);
    } else {
      tc::ldmatrix_x4(af, a + kt * a_k);
      if constexpr (TWO_A) tc::ldmatrix_x4(af2, a2 + kt * a_k);
    }
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      const uint32_t off = kt * b_k + np * b_n;
      uint32_t bf[4], bf2[4];
      if constexpr (BT) {
        tc::ldmatrix_x4_trans(bf, b + off);
        if constexpr (TWO_B) tc::ldmatrix_x4_trans(bf2, b2 + off);
      } else {
        tc::ldmatrix_x4(bf, b + off);
        if constexpr (TWO_B) tc::ldmatrix_x4(bf2, b2 + off);
      }
      tc::mma_16816(acc[2 * np], af, bf[0], bf[1]);
      tc::mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      if constexpr (TWO_A) {
        tc::mma_16816(acc[2 * np], af2, bf[0], bf[1]);
        tc::mma_16816(acc[2 * np + 1], af2, bf[2], bf[3]);
      }
      if constexpr (TWO_B) {
        tc::mma_16816(acc[2 * np], af, bf2[0], bf2[1]);
        tc::mma_16816(acc[2 * np + 1], af, bf2[2], bf2[3]);
      }
    }
  }
}

// f32, the dot layout: acc[a][b] (rows ty + kRowsF a, columns tx + 16 b,
// b < NB) += sum_k A[row][k] B[col][k] over k < kend (a multiple of 4), A
// and B [rows][k] tiles of pitches lda, ldb
template <int NB>
__device__ __forceinline__ void dot_f32(float (&acc)[kSlotsF][NB],
                                        const float* A, int lda,
                                        const float* Bt, int ldb, int kend) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k4 = 0; k4 < kend; k4 += 4) {
    float4 av[kSlotsF], bv[NB];
#pragma unroll
    for (int a = 0; a < kSlotsF; ++a)
      av[a] = ld4(A + (ty + kRowsF * a) * lda + k4);
#pragma unroll
    for (int b = 0; b < NB; ++b) bv[b] = ld4(Bt + (tx + 16 * b) * ldb + k4);
#pragma unroll
    for (int a = 0; a < kSlotsF; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        acc[a][b] = fmaf(av[a].x, bv[b].x, acc[a][b]);
        acc[a][b] = fmaf(av[a].y, bv[b].y, acc[a][b]);
        acc[a][b] = fmaf(av[a].z, bv[b].z, acc[a][b]);
        acc[a][b] = fmaf(av[a].w, bv[b].w, acc[a][b]);
      }
  }
}

// f32, the row layout: acc[a][s] (rows ty + kRowsF a, columns c0 + 4 tx +
// s) += sum_k A[row][k] B[k][col] over k < kend (a multiple of 4): A a
// [rows][k] tile, B a [k][n] tile
__device__ __forceinline__ void row_f32(float (&acc)[kSlotsF][4],
                                        const float* A, int lda,
                                        const float* Bk, int ldb, int c0,
                                        int kend) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k4 = 0; k4 < kend; k4 += 4) {
    float4 av[kSlotsF];
#pragma unroll
    for (int a = 0; a < kSlotsF; ++a)
      av[a] = ld4(A + (ty + kRowsF * a) * lda + k4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv = ld4(Bk + (k4 + u) * ldb + c0 + 4 * tx);
#pragma unroll
      for (int a = 0; a < kSlotsF; ++a) {
        const float x = comp(av[a], u);
        acc[a][0] = fmaf(x, bv.x, acc[a][0]);
        acc[a][1] = fmaf(x, bv.y, acc[a][1]);
        acc[a][2] = fmaf(x, bv.z, acc[a][2]);
        acc[a][3] = fmaf(x, bv.w, acc[a][3]);
      }
    }
  }
}

// a (ROWS x W) f32 tile into shared memory [r][pitch ld], f32 as it is
// or bf16 split (hi, lo at the same offsets): row r of the source at src +
// r * stride, zero at r >= nrows or past ncols. The fill's loads go out
// eight float4 at a time before any is stored (ssd_common.cuh's fill).
template <int ROWS, int W, typename T>
__device__ __forceinline__ void stage_f32(T* dst, T* dst_lo, int ld,
                                          const float* src, size_t stride,
                                          int nrows, int ncols, bool vec) {
  constexpr int W4 = W / 4, ITEMS = ROWS * W4 / kThreads;
  fill<ITEMS, kThreads, W4, (ITEMS < 8 ? ITEMS : 8)>(
      [&](int r, int c4) {
        return r < nrows ? load4(src + r * stride, c4, ncols, vec) : zero4();
      },
      [&](int r, int c4, float4 v) {
        if constexpr (sizeof(T) == 2)
          st_split4(dst, dst_lo, r * ld + c4, v);
        else
          st4(dst + r * ld + c4, v);
      });
}

// rows [row0, row0 + 64) x columns [0, W) of a (rows x ncols) matrix of
// x's type with leading dimension ld, into a [64][ld_s] tile: bf16 by
// 16-byte cp.async (the caller commits and waits), f32 through registers;
// zero outside the matrix
template <int W, typename T>
__device__ __forceinline__ void stage_rows(T* tile, int ld_s, const T* src,
                                           size_t ld, int row0, int nrows,
                                           int ncols, int vec) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t base = tc::smem_addr(tile);
    for (int e = threadIdx.x; e < kT * (W / 8); e += kThreads) {
      const int r = e / (W / 8), ch = e % (W / 8);
      tc::load_chunk(base + (uint32_t)(r * ld_s + ch * 8) * 2, src,
                     (long long)ld, row0 + r, nrows, ch * 8, ncols, vec);
    }
  } else {
    stage_f32<kT, W>(tile, (T*)nullptr, ld_s, src + (size_t)row0 * ld, ld,
                     nrows - row0, ncols, vec);
  }
}

// bf16: the hi + lo copy of an f32 state slice (N,P), in the slice's own
// f32 bytes: each block of 32 rows n0 .. holds the rows' hi halves (rows x
// P bf16), then their lo halves; the offset of row n's hi half (lo: + rows
// x P), in bf16 elements from the slice's start
__device__ __forceinline__ size_t split_row(int n, int N, int P, bool lo) {
  const int n0 = n / kPassRows * kPassRows;
  return (size_t)2 * n0 * P + (size_t)(n - n0) * P +
         (lo ? (size_t)min(kPassRows, N - n0) * P : 0);
}

// ---------------------------------------------------------------------------
// 1. d in_c: phase 2 of the forward with C, dy and exp(cum)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128, 4)
    ssd_bwd_din_f32_kernel(const float* __restrict__ dy,
                           const float* __restrict__ dt,
                           const float* __restrict__ Cm,
                           const float* __restrict__ cum,
                           float* __restrict__ ds, Dims d) {
  state_f32<true>(dy, dt, Cm, cum, ds, d);
}

__global__ void __launch_bounds__(128)
    ssd_bwd_din_tc_kernel(const __nv_bfloat16* __restrict__ dy,
                          const float* __restrict__ dt,
                          const __nv_bfloat16* __restrict__ Cm,
                          const float* __restrict__ cum,
                          float* __restrict__ ds, Dims d) {
  state_tc<true>(dy, dt, Cm, cum, ds, d);
}

// ---------------------------------------------------------------------------
// 2. the reversed phase 3, per (b, h, 32 state rows)
// ---------------------------------------------------------------------------
// grid (ceil(N / 32), B * H), 256 threads, 8 elements of g (N,P) a thread;
// d final and d init go through a shared tile [P][33] so that both their
// (P,N) rows and the scratch's (N,P) rows are read and written along
// contiguous addresses (the forward's phase 3 does the same). A chunk's
// loads are issued while the chunk after it is computed; each chunk's warp
// sums of in_c g wait in shared memory (red: 8 a chunk), and after the
// chunks thread c sums chunk c's in warp order into dlast[b, c, h,
// blockIdx.x]. With SPLIT (bf16), ds_c is written as its hi + lo copy in
// place of its f32 bytes (split_row: the block's rows only, after a
// barrier that retires the chunk's loads), and so is in_c into ins_s.
template <bool SPLIT>
__global__ void __launch_bounds__(256, 2)
    ssd_bwd_pass_kernel(const float* __restrict__ cum,
                        const float* __restrict__ ins,
                        const float* __restrict__ dfinal,
                        float* __restrict__ ds, float* __restrict__ dlast,
                        float* __restrict__ dinit,
                        __nv_bfloat16* __restrict__ ins_s, Dims d) {
  constexpr int kPer = kPMax * kPassRows / 256;
  __shared__ float T[kPMax * (kPassRows + 1)];
  extern __shared__ float red[];  // [nc][8]
  const int n0 = blockIdx.x * kPassRows, bh = blockIdx.y;
  const int b = bh / d.H, h = bh % d.H, tid = threadIdx.x;
  const int rows = min(kPassRows, d.N - n0);
  const float* fin = dfinal + (size_t)bh * d.P * d.N;
  float* ini = dinit + (size_t)bh * d.P * d.N;
  for (int e = tid; e < d.P * kPassRows; e += 256) {
    const int p = e / kPassRows, nn = e % kPassRows;
    T[p * (kPassRows + 1) + nn] =
        dfinal != nullptr && nn < rows ? fin[(size_t)p * d.N + n0 + nn] : 0.0f;
  }
  __syncthreads();
  float g[kPer];
  int slot[kPer];  // T index of the element, -1 past the block's rows
  size_t off[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + 256 * k, nn = e / d.P, p = e % d.P;
    slot[k] = nn < rows ? p * (kPassRows + 1) + nn : -1;
    off[k] = (size_t)(n0 + nn) * d.P + p;
    g[k] = slot[k] >= 0 ? T[slot[k]] : 0.0f;
  }
  const size_t np = (size_t)d.N * d.P;
  const size_t hi0 = (size_t)n0 * d.P, lo0 = (size_t)rows * d.P;
  auto chunk = [&](int c) { return ((size_t)b * d.nc + c) * d.H + h; };
  float din[kPer], iv[kPer];
  auto load = [&](int c, float (&dv)[kPer], float (&inv)[kPer]) {
    const float* dsc = ds + chunk(c) * np;
    const float* in = ins + chunk(c) * np;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      dv[k] = slot[k] >= 0 ? dsc[off[k]] : 0.0f;
      inv[k] = slot[k] >= 0 ? in[off[k]] : 0.0f;
    }
  };
  load(d.nc - 1, din, iv);
  for (int c = d.nc - 1; c >= 0; --c) {
    float din2[kPer], iv2[kPer];
    if (c > 0) load(c - 1, din2, iv2);
    const float decay = expf(cum[chunk(c) * d.Q + d.Q - 1]);
    float* dsc = ds + chunk(c) * np;
    if constexpr (SPLIT) __syncthreads();  // chunk c's f32 loads are done
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      part = fmaf(iv[k], g[k], part);
      if (slot[k] >= 0) {
        if constexpr (SPLIT) {
          // split_row of the block's rows: hi at off + n0 P, lo rows P on
          __nv_bfloat16* dh = reinterpret_cast<__nv_bfloat16*>(dsc) + hi0;
          __nv_bfloat16* ih = ins_s + chunk(c) * 2 * np + hi0;
          const __nv_bfloat16 gh = __float2bfloat16_rn(g[k]);
          const __nv_bfloat16 xh = __float2bfloat16_rn(iv[k]);
          dh[off[k]] = gh;
          dh[off[k] + lo0] = __float2bfloat16_rn(g[k] - __bfloat162float(gh));
          ih[off[k]] = xh;
          ih[off[k] + lo0] = __float2bfloat16_rn(iv[k] - __bfloat162float(xh));
        } else {
          dsc[off[k]] = g[k];
        }
      }
      g[k] = fmaf(decay, g[k], din[k]);
    }
    part = warp_sum(part);
    if (tid % 32 == 0) red[c * 8 + tid / 32] = part;
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        din[k] = din2[k];
        iv[k] = iv2[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (slot[k] >= 0) T[slot[k]] = g[k];
  __syncthreads();
  for (int c = tid; c < d.nc; c += 256) {
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += red[c * 8 + w];
    dlast[chunk(c) * gridDim.x + blockIdx.x] = s;
  }
  for (int e = tid; e < d.P * rows; e += 256) {
    const int p = e / rows, nn = e % rows;
    ini[(size_t)p * d.N + n0 + nn] = T[p * (kPassRows + 1) + nn];
  }
}

// ---------------------------------------------------------------------------
// 3. the chunk kernel
// ---------------------------------------------------------------------------
struct ChunkArgs {
  const void* x;
  const float* dt;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* cum;
  const float* cb;
  const float* ins;
  const __nv_bfloat16* ins_s;  // bf16: in_c's hi + lo copy (split_row)
  const void* dy;
  const float* ds;             // bf16: ds_c's hi + lo copy (split_row)
  void* dx;
  float* ddt;
  float* dbc;   // (2, groups, B, S, N): the groups' dB, then dC
  float* dcb;   // (groups, B, nc, Q, Q)
  float* dcum;  // (B, nc, H, tiles, Q)
  float* dd;    // (B, nc, H, tiles)
  int B, heads, groups, tiles;
};

// shared memory of a chunk block: the state tile (ds_c, then in_c; split
// hi + lo in bf16), B's rows of tile t, x_t, dy_t, dy of the row tiles i,
// G (bf16 [i][j] split; f32 G^T [j][i]), two sets of reduction slots, ddt
// of tile t, the group's dCB terms of up to kSmemTiles row tiles, and per
// row of the chunk cum, dt and dcum. bf16 also stages each CB tile, which
// its mma.sync layout (8 rows a warp's access) would read from global
// memory a sector a row, and doubles x_t, dy_t, cum and dt (the next
// head's copies are in flight during this head) and the row tiles' dy (the
// next tile's during this one's products).
template <typename T>
struct ChunkSmem {
  static constexpr bool kH = sizeof(T) == 2;
  static constexpr int kBufs = kH ? 2 : 1;
  static constexpr size_t kS = kH ? 2 * kNMax * kLdh * 2 : kNMax * kLd * 4;
  static constexpr size_t kB = kH ? kT * kLdNh * 2 : kT * kLdN * 4;
  static constexpr size_t kTile = kH ? kT * kLdh * 2 : kT * kLd * 4;
  static constexpr size_t kG = kH ? 2 * kT * kLdh * 2 : kT * kLd * 4;
  static constexpr size_t kCB = kH ? kT * kLdc * 4 : 0;
  static constexpr size_t kRed = 2 * kRedSet<T> * 4;
  static constexpr size_t kFixed =
      kS + kB + 3 * kBufs * kTile + kG + kCB + kRed + 2 * kT * 4;
  static size_t bytes(int Q) {
    const int tiles = (Q + kT - 1) / kT;
    return kFixed + (size_t)min(tiles, kSmemTiles) * kT * kT * 4 +
           (size_t)(2 * kBufs + 1) * Q * 4;
  }
};

// the f32 CB tile (rows i0.., columns j0..) of one chunk into a [64][kLdc]
// tile by 16-byte cp.async (the rows as bf16 pairs); zero past Q
__device__ __forceinline__ void stage_cb(float* dst, const float* cbc, int Q,
                                         int i0, int j0, int vec) {
  const uint32_t base = tc::smem_addr(dst);
  const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(cbc);
  for (int e = threadIdx.x; e < kT * 16; e += kThreads) {
    const int r = e / 16, ch = e % 16;
    tc::load_chunk(base + (uint32_t)(r * kLdc + ch * 4) * 4, src, 2LL * Q,
                   i0 + r, Q, 2 * (j0 + ch * 4), 2 * Q, vec);
  }
}

// grid (groups, B * nc, tiles), kThreads threads: block (g, bc, t) walks heads
// g * heads .. of chunk bc for the 64-row tile t
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(ChunkArgs a, Dims d) {
  using L = Lay<T>;
  using M = ChunkSmem<T>;
  constexpr bool kH = M::kH;
  constexpr int kBufs = M::kBufs;
  constexpr int ldt = kH ? kLdh : kLd;   // pitch of a 64-wide tile
  constexpr int ldn = kH ? kLdNh : kLdN; // of an N-wide one
  constexpr int kTileT = kT * ldt;       // elements of a 64-wide tile
  extern __shared__ __align__(16) unsigned char sm[];
  T* Ss = reinterpret_cast<T*>(sm);                    // [kNMax][ldt] (x2)
  T* Bt = reinterpret_cast<T*>(sm + M::kS);            // [kT][ldn]
  T* Xb = reinterpret_cast<T*>(sm + M::kS + M::kB);    // x_t [kBufs]
  T* Yb = Xb + kBufs * kTileT;                         // dy_t [kBufs]
  T* Yi = Yb + kBufs * kTileT;                         // dy_i [kBufs]
  T* Gs = Yi + kBufs * kTileT;                         // G (x2) or G^T
  T* Gs_lo = Gs + kTileT;                              // bf16: G's lo half
  float* CBs = reinterpret_cast<float*>(Gs + (kH ? 2 : 1) * kTileT);
  float* red = CBs + M::kCB / 4;                       // [2][kRedSet]
  float* ddt_s = red + 2 * kRedSet<T>;                 // [kT]
  float* misc = ddt_s + kT;                            // [kT]: warp sums
  float* acc_cb = misc + kT;                           // [held][16][256]
  const int tiles = a.tiles;
  const int held = min(tiles, kSmemTiles);
  float* cdt = acc_cb + held * kT * kT;                // [kBufs][cum, dt][Q]
  float* dcum_s = cdt + 2 * kBufs * d.Q;               // [Q]
  T* Ss_lo = Ss + kNMax * kLdh;                        // bf16: the lo half

  const int grp = blockIdx.x, bc = blockIdx.y, t = blockIdx.z;
  const int b = bc / d.nc, c = bc % d.nc, tid = threadIdx.x;
  const int r0 = t * kT;
  const int h0 = grp * a.heads, h1 = min(d.H, h0 + a.heads);
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t xrow = (size_t)d.H * d.P;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bc = static_cast<const T*>(a.Bm) + tok0 * d.N;
  const T* Cc = static_cast<const T*>(a.Cm) + tok0 * d.N;
  const float* cbc = a.cb + (size_t)bc * d.Q * d.Q;
  float* dcb_g = a.dcb + ((size_t)grp * a.B * d.nc + bc) * d.Q * d.Q;
  const int psteps = (d.P + 15) / 16, nsteps = (d.N + 15) / 16;
  const int pend = (d.P + 3) / 4 * 4, nend = (d.N + 3) / 4 * 4;
  const int warp = tid / 32, wr = warp % 4, wc = warp / 4;
  const int wt = (kT / kWC) * wc, wn = (kNMax / kWC) * wc;  // bf16 columns
  int rb = 0;  // the reduction slots of the next tile_totals
  auto next_red = [&]() {
    rb ^= 1;
    return red + rb * kRedSet<T>;
  };

  // the group's sums: dC (E layout) and dB (V layout) of tile t's rows
  float dC[kF128], dB[kF128];
#pragma unroll
  for (int k = 0; k < kF128; ++k) dC[k] = dB[k] = 0.0f;
  for (int e = tid; e < held * kT * kT; e += kThreads) acc_cb[e] = 0.0f;
  // the state tile: ds_c or in_c of head h (bf16: from its hi + lo copy,
  // by cp.async; the caller commits and waits)
  auto stage_state = [&](const float* f32, const void* split) {
    if constexpr (kH) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(split);
      for (int e = tid; e < kNMax * 16; e += kThreads) {
        const int n = e / 16, lo = (e / 8) % 2, ch = e % 8;
        const bool in = n < d.N;
        tc::load_chunk(tc::smem_addr((lo ? Ss_lo : Ss) + n * kLdh + ch * 8),
                       src + (in ? split_row(n, d.N, d.P, lo) : 0), 0, 0,
                       in ? 1 : 0, ch * 8, d.P, d.vec);
      }
    } else {
      stage_f32<kNMax, kPMax>(Ss, Ss_lo, ldt, f32, d.P, d.N, d.P, d.vec);
    }
  };
  auto state_at = [&](const void* base, int h) {  // bf16 split copies
    return static_cast<const __nv_bfloat16*>(base) +
           ((size_t)bc * d.H + h) * 2 * d.N * d.P;
  };
  // x_t, dy_t, cum and dt of head h into buffer hb (bf16: by cp.async)
  auto stage_head = [&](int h, int hb) {
    const size_t off = tok0 * xrow + (size_t)h * d.P;
    stage_rows<kPMax>(Xb + hb * kTileT, ldt, x + off, xrow, r0, d.Q, d.P,
                      d.vec);
    stage_rows<kPMax>(Yb + hb * kTileT, ldt, dy + off, xrow, r0, d.Q, d.P,
                      d.vec);
    float* cs = cdt + hb * 2 * d.Q;
    const float* cum = a.cum + ((size_t)bc * d.H + h) * d.Q;
    const float* dt = a.dt + tok0 * d.H + h;
    for (int q = tid; q < d.Q; q += kThreads) {
      if constexpr (kH) {
        tc::cp_async4(tc::smem_addr(cs + q), cum + q);
        tc::cp_async4(tc::smem_addr(cs + d.Q + q), dt + (size_t)q * d.H);
      } else {
        cs[q] = cum[q];
        cs[d.Q + q] = dt[(size_t)q * d.H];
      }
    }
  };
  // B's rows of tile t, the same for every head; bf16: the first head's
  // x_t, dy_t, cum, dt and ds_c
  stage_rows<kNMax>(Bt, ldn, Bc, d.N, r0, d.Q, d.N, d.vec);
  if constexpr (kH) {
    stage_head(h0, 0);
    stage_state(nullptr, state_at(a.ds, h0));
    tc::cp_async_commit();
  }

  for (int h = h0; h < h1; ++h) {
    const size_t bch = (size_t)bc * d.H + h;
    const T* dyh = dy + tok0 * xrow + (size_t)h * d.P;
    const int hb = kBufs == 2 ? (h - h0) % 2 : 0;
    const T* Xt = Xb + hb * kTileT;
    const T* Yt = Yb + hb * kTileT;
    const float* cum_s = cdt + hb * 2 * d.Q;
    const float* dt_s = cum_s + d.Q;
    __syncthreads();  // the last head's readers are done
    if constexpr (kH) {
      // the next head's x_t, dy_t, cum and dt into the other buffers; the
      // pairs' first row tile below t and CB's diagonal tile; then wait for
      // all but these two groups (this head's x_t .. and ds_c)
      if (h + 1 < h1) stage_head(h + 1, 1 - hb);
      tc::cp_async_commit();
      if (t + 1 < tiles)
        stage_rows<kPMax>(Yi, ldt, dyh, xrow, r0 + kT, d.Q, d.P, d.vec);
      stage_cb(CBs, cbc, d.Q, r0, r0, d.vec);
      tc::cp_async_commit();
      tc::cp_async_wait<2>();
    } else {
      stage_head(h, 0);
      stage_state(a.ds + bch * d.N * d.P, nullptr);
    }
    for (int q = tid; q < d.Q; q += kThreads) dcum_s[q] = 0.0f;
    if (tid < kT) ddt_s[tid] = 0.0f;
    __syncthreads();
    const float cum_last = cum_s[d.Q - 1];

    // -- 2': U = B_t ds_c (64 x P), dw_j = U_j.x_j; dx_j = w_j U_j; V = x_t
    //    ds_c^T (64 x N), dB_j's head term w_j V_j ---------------------------
    float dX[kF64];  // the row layout
    float w[L::kSlots];
#pragma unroll
    for (int s = 0; s < L::kSlots; ++s) {
      const int j = r0 + L::row(s);
      w[s] = j < d.Q ? expf(cum_last - cum_s[j]) * dt_s[j] : 0.0f;
    }
    {
      if constexpr (kH) {
        float acc[kF64 / 4][4] = {};
        warp_mma<kF64 / 4, false, true, false, true>(
            acc, lane_a(tc::smem_addr(Bt), ldn, 16 * wr, false), 0, ldn,
            lane_b(tc::smem_addr(Ss), ldt, wt, true),
            lane_b(tc::smem_addr(Ss_lo), ldt, wt, true), ldt, nsteps);
#pragma unroll
        for (int k = 0; k < kF64; ++k) dX[k] = acc[k / 4][k % 4];
      } else {
        float acc[kSlotsF][4] = {};
        row_f32(acc, reinterpret_cast<const float*>(Bt), ldn,
                reinterpret_cast<const float*>(Ss), ldt, 0, nend);
#pragma unroll
        for (int k = 0; k < kF64; ++k) dX[k] = acc[k / 4][k % 4];
      }
      float dwp[L::kSlots];
#pragma unroll
      for (int s = 0; s < L::kSlots; ++s) dwp[s] = 0.0f;
#pragma unroll
      for (int k = 0; k < kF64; ++k) {
        const int s = L::rslot(k);
        dwp[s] = fmaf(dX[k], to_f32(Xt[L::row(s) * ldt + L::rcol(k)]), dwp[s]);
      }
#pragma unroll
      for (int k = 0; k < kF64; ++k) dX[k] *= w[L::rslot(k)];
      float rt, ct;
      tile_totals<T>(&dwp, nullptr, next_red(), rt, ct);
      if (tid < kT) {
        const int j = r0 + tid;
        float wdw = 0.0f;
        if (j < d.Q) {
          const float eo = expf(cum_last - cum_s[j]);
          const float wj = eo * dt_s[j];
          ddt_s[tid] += eo * rt;
          wdw = wj * rt;
          dcum_s[j] -= wdw;
        }
        // sum_j w_j dw_j goes to dcum_last after the pairs
        wdw = warp_sum(wdw);
        if (tid % 32 == 0) misc[tid / 32] = wdw;
      }
    }
    {
      float V[kF128];
      if constexpr (kH) {
        float acc[kF128 / 4][4] = {};
        warp_mma<kF128 / 4, false, false, false, true>(
            acc, lane_a(tc::smem_addr(Xt), ldt, 16 * wr, false), 0, ldt,
            lane_b(tc::smem_addr(Ss), ldt, wn, false),
            lane_b(tc::smem_addr(Ss_lo), ldt, wn, false), ldt, psteps);
#pragma unroll
        for (int k = 0; k < kF128; ++k) V[k] = acc[k / 4][k % 4];
      } else {
        float acc[kSlotsF][8] = {};
        dot_f32<8>(acc, reinterpret_cast<const float*>(Xt), ldt,
                   reinterpret_cast<const float*>(Ss), ldt, pend);
#pragma unroll
        for (int k = 0; k < kF128; ++k) V[k] = acc[k / 8][k % 8];
      }
#pragma unroll
      for (int k = 0; k < kF128; ++k)
        dB[k] += w[L::template slot<128>(k)] * V[k];
    }

    // Ss = in_c once every warp is past its products with ds_c (bf16: in
    // flight during the pairs; f32: the pairs' barriers order it)
    __syncthreads();
    if constexpr (kH) {
      stage_state(nullptr, state_at(a.ins_s, h));
      tc::cp_async_commit();
    } else {
      stage_state(a.ins + bch * d.N * d.P, nullptr);
    }

    // -- 4' in the chunk: the row tiles i >= t against column tile t --------
    for (int it = t; it < tiles; ++it) {
      const int i0 = it * kT;
      // row tile it > t is in Yi buffer (it - t - 1) % kBufs
      const T* Ys = it == t ? Yt : Yi + ((it - t - 1) % kBufs) * kTileT;
      if (kH && it == t) {  // CB's diagonal tile (in_c may stay in flight)
        tc::cp_async_wait<1>();
        __syncthreads();
      }
      if (it > t) {
        if constexpr (kH) {
          tc::cp_async_wait<0>();  // dy_i and CB's tile (it, t)
          __syncthreads();         // ... of every thread; pair it - 1 done
          if (it + 1 < tiles) {    // its buffer takes row tile it + 1
            stage_rows<kPMax>(Yi + ((it - t) % 2) * kTileT, ldt, dyh, xrow,
                              i0 + kT, d.Q, d.P, d.vec);
            tc::cp_async_commit();
          }
        } else {
          __syncthreads();  // pair it - 1's readers of Yi and G are done
          stage_rows<kPMax>(Yi, ldt, dyh, xrow, i0, d.Q, d.P, d.vec);
          __syncthreads();
        }
      }
      // CB's tile (it, t) of this thread, loaded before the product (bf16:
      // from its staged copy, in pairs of columns)
      float cbv[kF64];
#pragma unroll
      for (int k = 0; k < kF64; k += 2) {
        const int il = L::row(L::template slot<64>(k));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jl = L::template col<64>(k + u);
          const int i = i0 + il, j = r0 + jl;
          float v = 0.0f;
          if constexpr (kH) {
            v = CBs[il * kLdc + jl];
          } else if (i < d.Q && j <= i) {
            v = cbc[(size_t)i * d.Q + j];
          }
          cbv[k + u] = i < d.Q && j <= i ? v : 0.0f;
        }
      }
      // X = dy_i x_j^T (64 x 64)
      float X[kF64];
      if constexpr (kH) {
        float acc[kF64 / 4][4] = {};
        warp_mma<kF64 / 4, false, false, false, false>(
            acc, lane_a(tc::smem_addr(Ys), ldt, 16 * wr, false), 0, ldt,
            lane_b(tc::smem_addr(Xt), ldt, wt, false), 0, ldt, psteps);
#pragma unroll
        for (int k = 0; k < kF64; ++k) X[k] = acc[k / 4][k % 4];
      } else {
        float acc[kSlotsF][4] = {};
        dot_f32<4>(acc, reinterpret_cast<const float*>(Ys), ldt,
                   reinterpret_cast<const float*>(Xt), ldt, pend);
#pragma unroll
        for (int k = 0; k < kF64; ++k) X[k] = acc[k / 4][k % 4];
      }
      const int rel = it - t;
      float* cbacc = rel < held ? acc_cb + rel * kT * kT : nullptr;
      // L_ij = exp(cum_i - cum_j): on the diagonal tile taken per pair
      // (j <= i only); below it as exp(cum_i - cum_i0) exp(cum_i0 - cum_j),
      // both factors of pairs on or below the diagonal, a thread's rows'
      // and columns' factors taken once (zero past Q)
      const bool diag = it == t;
      float rowf[L::kSlots], colf[L::kCols], coldt[L::kCols];
#pragma unroll
      for (int s = 0; s < L::kSlots; ++s) {
        const int i = i0 + L::row(s);
        rowf[s] = i >= d.Q ? 0.0f
                  : diag   ? cum_s[i]
                           : expf(cum_s[i] - cum_s[i0]);
      }
#pragma unroll
      for (int q = 0; q < L::kCols; ++q) {
        const int j = r0 + L::colof(q);
        coldt[q] = j < d.Q ? dt_s[j] : 0.0f;
        colf[q] = j >= d.Q ? 0.0f
                  : diag   ? cum_s[j]
                           : expf(cum_s[i0] - cum_s[j]);
      }
      float rp[L::kSlots], cp[L::kCols];
#pragma unroll
      for (int s = 0; s < L::kSlots; ++s) rp[s] = 0.0f;
#pragma unroll
      for (int q = 0; q < L::kCols; ++q) cp[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < kF64; k += 2) {
        const int s = L::template slot<64>(k), il = L::row(s);
        float gg[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = L::cidx(k + u), jl = L::colof(q);
          float e;
          if (diag)
            e = jl <= il && i0 + il < d.Q ? expf(rowf[s] - colf[q]) : 0.0f;
          else
            e = rowf[s] * colf[q];
          const float ed = e * coldt[q];
          const float td = cbv[k + u] * e * X[k + u];  // ddt's term
          gg[u] = cbv[k + u] * ed;
          rp[s] = fmaf(td, coldt[q], rp[s]);  // M_ij
          cp[q] += td;
          const float dcbv = ed * X[k + u];
          if (cbacc != nullptr) {
            cbacc[(k + u) * kThreads + tid] += dcbv;
          } else if (i0 + il < d.Q && r0 + jl < d.Q) {
            float* p = dcb_g + (size_t)(i0 + il) * d.Q + r0 + jl;
            *p = h == h0 ? dcbv : *p + dcbv;
          }
          if constexpr (!kH) Gs[jl * kLd + il] = gg[u];
        }
        if constexpr (kH) {  // columns jl, jl + 1: one bf16 pair each
          const int jl = L::colof(L::cidx(k));
          const __nv_bfloat162 hi = __floats2bfloat162_rn(gg[0], gg[1]);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              gg[0] - __low2float(hi), gg[1] - __high2float(hi));
          *reinterpret_cast<__nv_bfloat162*>(Gs + il * kLdh + jl) = hi;
          *reinterpret_cast<__nv_bfloat162*>(Gs_lo + il * kLdh + jl) = lo;
        }
      }
      float rt, ct;
      tile_totals<T>(&rp, &cp, next_red(), rt, ct);
      if (tid < kT) {
        if (i0 + tid < d.Q) dcum_s[i0 + tid] += rt;
        if (r0 + tid < d.Q) {
          ddt_s[tid] += ct;
          dcum_s[r0 + tid] -= dt_s[r0 + tid] * ct;
        }
      }
      // bf16: every thread is past its reads of CB's tile, which takes the
      // next one
      if constexpr (kH) {
        if (it + 1 < tiles) {
          stage_cb(CBs, cbc, d.Q, i0 + kT, r0, d.vec);
          tc::cp_async_commit();
        }
      }
      // dx_j += sum_i G_ij dy_i (G visible after tile_totals' barrier)
      const int iend = min(kT, d.Q - i0);
      if constexpr (kH) {
        float acc[kF64 / 4][4];
#pragma unroll
        for (int k = 0; k < kF64; ++k) acc[k / 4][k % 4] = dX[k];
        warp_mma<kF64 / 4, true, true, true, false>(
            acc, lane_a(tc::smem_addr(Gs), ldt, 16 * wr, true),
            lane_a(tc::smem_addr(Gs_lo), ldt, 16 * wr, true), ldt,
            lane_b(tc::smem_addr(Ys), ldt, wt, true), 0, ldt,
            (iend + 15) / 16);
#pragma unroll
        for (int k = 0; k < kF64; ++k) dX[k] = acc[k / 4][k % 4];
      } else {
        float acc[kSlotsF][4];
#pragma unroll
        for (int k = 0; k < kF64; ++k) acc[k / 4][k % 4] = dX[k];
        row_f32(acc, reinterpret_cast<const float*>(Gs), ldt,
                reinterpret_cast<const float*>(Ys), ldt, 0,
                (iend + 3) / 4 * 4);
#pragma unroll
        for (int k = 0; k < kF64; ++k) dX[k] = acc[k / 4][k % 4];
      }
    }

    if constexpr (kH) tc::cp_async_wait<0>();
    __syncthreads();  // in_c
    // -- 4' off the diagonal: E = dy_t in_c^T (64 x N); dC_i's head term
    //    exp(cum_i) E_i, and dcum_i += its dot with C_i -----------------------
    {
      float E[kF128];
      if constexpr (kH) {
        float acc[kF128 / 4][4] = {};
        warp_mma<kF128 / 4, false, false, false, true>(
            acc, lane_a(tc::smem_addr(Yt), ldt, 16 * wr, false), 0, ldt,
            lane_b(tc::smem_addr(Ss), ldt, wn, false),
            lane_b(tc::smem_addr(Ss_lo), ldt, wn, false), ldt, psteps);
#pragma unroll
        for (int k = 0; k < kF128; ++k) E[k] = acc[k / 4][k % 4];
      } else {
        float acc[kSlotsF][8] = {};
        dot_f32<8>(acc, reinterpret_cast<const float*>(Yt), ldt,
                   reinterpret_cast<const float*>(Ss), ldt, pend);
#pragma unroll
        for (int k = 0; k < kF128; ++k) E[k] = acc[k / 8][k % 8];
      }
      float ei[L::kSlots], part[L::kSlots];
#pragma unroll
      for (int s = 0; s < L::kSlots; ++s) {
        const int i = r0 + L::row(s);
        ei[s] = i < d.Q ? expf(cum_s[i]) : 0.0f;
        part[s] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kF128; k += 2) {  // bf16: columns n, n + 1
        const int s = L::template slot<128>(k), n = L::template col<128>(k);
        const int i = r0 + L::row(s);
        float cv[2] = {0.0f, 0.0f};
        if (i < d.Q) {
          const T* cr = Cc + (size_t)i * d.N + n;
          if (kH && d.N % 2 == 0 && n < d.N) {  // n is even: a bf16 pair
            const __nv_bfloat162 c2 =
                __ldg(reinterpret_cast<const __nv_bfloat162*>(cr));
            cv[0] = __low2float(c2);
            cv[1] = __high2float(c2);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int nu = L::template col<128>(k + u);  // f32: n + 16
              if (nu < d.N) cv[u] = to_f32(__ldg(cr + (nu - n)));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float v = ei[s] * E[k + u];
          dC[k + u] += v;
          part[s] = fmaf(v, cv[u], part[s]);
        }
      }
      float rt, ct;
      tile_totals<T>(&part, nullptr, next_red(), rt, ct);
      if (tid < kT && r0 + tid < d.Q) dcum_s[r0 + tid] += rt;
    }

    // bf16: every warp is past its product with in_c: the next head's ds_c
    if constexpr (kH) {
      if (h + 1 < h1) {
        stage_state(nullptr, state_at(a.ds, h + 1));
        tc::cp_async_commit();
      }
    }

    // dx_j = dX + D dy_j in x's dtype; dD's terms dy_j.x_j
    const float Dh = a.D[h];
    float ddp = 0.0f;
    T* dxh = static_cast<T*>(a.dx) + tok0 * xrow + (size_t)h * d.P;
#pragma unroll
    for (int k = 0; k < kF64; ++k) {
      const int jl = L::row(L::rslot(k)), p = L::rcol(k), j = r0 + jl;
      if (j >= d.Q || p >= d.P) continue;
      const float g = to_f32(Yt[jl * ldt + p]);
      ddp = fmaf(g, to_f32(Xt[jl * ldt + p]), ddp);
      dxh[(size_t)j * xrow + p] = from_f32<T>(fmaf(Dh, g, dX[k]));
    }
    ddp = warp_sum(ddp);
    if (tid % 32 == 0) misc[kWarps + warp] = ddp;
    __syncthreads();  // dD's warp sums, dcum_s and ddt_s are complete
    const size_t part = bch * tiles + t;
    if (tid == 0) {
      float s = 0.0f;
      for (int w8 = 0; w8 < kThreads / 32; ++w8) s += misc[kWarps + w8];
      a.dd[part] = s;
      dcum_s[d.Q - 1] += misc[0] + misc[1];  // sum_j w_j dw_j
    }
    if (tid < kT && r0 + tid < d.Q)
      a.ddt[(tok0 + r0 + tid) * d.H + h] = ddt_s[tid];
    __syncthreads();  // dcum_s[Q - 1]
    for (int q = r0 + tid; q < d.Q; q += kThreads)
      a.dcum[part * d.Q + q] = dcum_s[q];
  }

  // the group's sums: dB and dC of tile t's rows, dCB's held row tiles
  const size_t bsn = (size_t)a.B * d.S * d.N;
  float* dbg = a.dbc + (size_t)grp * bsn + tok0 * d.N;
  float* dcg = a.dbc + (size_t)(a.groups + grp) * bsn + tok0 * d.N;
#pragma unroll
  for (int k = 0; k < kF128; ++k) {
    const int i = r0 + L::row(L::template slot<128>(k));
    const int n = L::template col<128>(k);
    if (i < d.Q && n < d.N) {
      dbg[(size_t)i * d.N + n] = dB[k];
      dcg[(size_t)i * d.N + n] = dC[k];
    }
  }
  for (int rel = 0; rel < held && t + rel < tiles; ++rel) {
    const int i0 = (t + rel) * kT;
#pragma unroll
    for (int k = 0; k < kF64; ++k) {
      const int i = i0 + L::row(L::template slot<64>(k));
      const int j = r0 + L::template col<64>(k);
      if (i < d.Q && j < d.Q)
        dcb_g[(size_t)i * d.Q + j] = acc_cb[rel * kT * kT + k * kThreads + tid];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dC and dB of a 64-row tile, 64 columns of N
// ---------------------------------------------------------------------------
// grid (tiles, B * nc, 2 * ceil(N / 64)), 256 threads; blockIdx.z = 2 n64 +
// role: role 0 dC_i = sum_{j <= i} dCB_ij B_j, role 1 dB_j = sum_{i >= j}
// dCB_ij C_i, over 64-deep stages k of the chunk, dCB summed over the
// groups in order into shared memory (bf16: split hi + lo as [rows of dCB]
// [columns]; f32: role 0 as it is, role 1 transposed); then the groups'
// head terms are added and the sum rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_bc_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ dbc,
                      const float* __restrict__ dcb, T* __restrict__ dBm,
                      T* __restrict__ dCm, Dims d, int B, int groups) {
  using L = Lay<T>;
  constexpr bool kH = sizeof(T) == 2;
  constexpr int ldt = kH ? kLdh : kLd;
  extern __shared__ __align__(16) unsigned char sm[];
  T* Ds = reinterpret_cast<T*>(sm);          // [kT][ldt] (x2 in bf16)
  T* Ds_lo = Ds + kT * kLdh;
  T* Os = reinterpret_cast<T*>(sm + (kH ? 2 * kT * kLdh * 2 : kT * kLd * 4));
  const int r = blockIdx.x, bc = blockIdx.y;
  const int role = blockIdx.z % 2, n0 = (blockIdx.z / 2) * kT;
  const int b = bc / d.nc, c = bc % d.nc, tid = threadIdx.x;
  const int r0 = r * kT, tiles = (d.Q + kT - 1) / kT;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const T* Op = (role == 0 ? Bm : Cm) + tok0 * d.N + n0;
  const size_t gstride = (size_t)B * d.nc * d.Q * d.Q;
  const float* dcbc = dcb + (size_t)bc * d.Q * d.Q;
  const int warp = tid / 32, wr = warp % 4, wc = warp / 4;
  const int wt = (kT / kWC) * wc;  // bf16: the warp's first column
  constexpr int kItems = kT * 16 / kThreads;  // float4 items of a dCB tile
  float acc[kF64];
#pragma unroll
  for (int k = 0; k < kF64; ++k) acc[k] = 0.0f;
  const int k_lo = role == 0 ? 0 : r, k_hi = role == 0 ? r : tiles - 1;
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    stage_rows<kT>(Os, ldt, Op, d.N, k0, d.Q, d.N - n0, d.vec);
    if constexpr (kH) tc::cp_async_commit();
    // the dCB tile (rows ri0.., columns cj0..), summed over the groups in
    // order: thread tid takes float4 items tid + kThreads u, u < kItems,
    // and has its items' loads of a group in flight together
    const int ri0 = role == 0 ? r0 : k0, cj0 = role == 0 ? k0 : r0;
    float4 s[kItems];
    const float* src[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = tid + kThreads * u, row = e / 16;
      s[u] = zero4();
      src[u] = ri0 + row < d.Q ? dcbc + (size_t)(ri0 + row) * d.Q + cj0
                               : nullptr;
    }
    for (int g = 0; g < groups; ++g) {
      float4 q[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        q[u] = src[u] != nullptr
                   ? load4(src[u] + g * gstride,
                           ((tid + kThreads * u) % 16) * 4, d.Q - cj0, d.vec)
                   : zero4();
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        s[u] = make_float4(s[u].x + q[u].x, s[u].y + q[u].y, s[u].z + q[u].z,
                           s[u].w + q[u].w);
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = tid + kThreads * u, row = e / 16, v4 = (e % 16) * 4;
      if constexpr (kH) {
        st_split4(Ds, Ds_lo, row * kLdh + v4, s[u]);
      } else if (role == 0) {
        st4(reinterpret_cast<float*>(Ds) + row * kLd + v4, s[u]);
      } else {
        float* Dt = reinterpret_cast<float*>(Ds);
#pragma unroll
        for (int q = 0; q < 4; ++q) Dt[(v4 + q) * kLd + row] = comp(s[u], q);
      }
    }
    if constexpr (kH) tc::cp_async_wait<0>();
    __syncthreads();
    const int kend = min(kT, d.Q - k0);
    if constexpr (kH) {
      float a4[kF64 / 4][4];
#pragma unroll
      for (int k = 0; k < kF64; ++k) a4[k / 4][k % 4] = acc[k];
      const uint32_t ob = lane_b(tc::smem_addr(Os), ldt, wt, true);
      if (role == 0)
        warp_mma<kF64 / 4, false, true, true, false>(
            a4, lane_a(tc::smem_addr(Ds), ldt, 16 * wr, false),
            lane_a(tc::smem_addr(Ds_lo), ldt, 16 * wr, false), ldt, ob, 0,
            ldt, (kend + 15) / 16);
      else
        warp_mma<kF64 / 4, true, true, true, false>(
            a4, lane_a(tc::smem_addr(Ds), ldt, 16 * wr, true),
            lane_a(tc::smem_addr(Ds_lo), ldt, 16 * wr, true), ldt, ob, 0,
            ldt, (kend + 15) / 16);
#pragma unroll
      for (int k = 0; k < kF64; ++k) acc[k] = a4[k / 4][k % 4];
    } else {
      float a4[kSlotsF][4];
#pragma unroll
      for (int k = 0; k < kF64; ++k) a4[k / 4][k % 4] = acc[k];
      row_f32(a4, reinterpret_cast<const float*>(Ds), ldt,
              reinterpret_cast<const float*>(Os), ldt, 0,
              (kend + 3) / 4 * 4);
#pragma unroll
      for (int k = 0; k < kF64; ++k) acc[k] = a4[k / 4][k % 4];
    }
  }
  // + the groups' head terms, in group order; rounded once
  const size_t bsn = (size_t)B * d.S * d.N;
  const float* part = dbc + (role == 0 ? (size_t)groups * bsn : 0) + tok0 * d.N;
  T* out = (role == 0 ? dCm : dBm) + tok0 * d.N;
  float sum[kF64];
#pragma unroll
  for (int k = 0; k < kF64; ++k) sum[k] = 0.0f;
  for (int g = 0; g < groups; ++g) {
    const float* pg = part + g * bsn;
#pragma unroll
    for (int k = 0; k < kF64; ++k) {
      const int i = r0 + L::row(L::rslot(k)), n = n0 + L::rcol(k);
      if (i < d.Q && n < d.N) sum[k] += pg[(size_t)i * d.N + n];
    }
  }
#pragma unroll
  for (int k = 0; k < kF64; ++k) {
    const int i = r0 + L::row(L::rslot(k)), n = n0 + L::rcol(k);
    if (i < d.Q && n < d.N)
      out[(size_t)i * d.N + n] = from_f32<T>(sum[k] + acc[k]);
  }
}

// ---------------------------------------------------------------------------
// 5. the chunks' dcum, its reverse cumulative sum, ddt's A term, dA and dD
// ---------------------------------------------------------------------------
// grid (H), 256 threads: warp w takes chunks (b, c) = w, w + 8, ...: lane
// segments of the chunk and a shuffle suffix scan; then thread 0 sums the
// chunks' dA and dD terms in order (red: 2 B nc floats).
__global__ void __launch_bounds__(256)
    ssd_bwd_scan_kernel(const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ cum,
                        const float* __restrict__ dcum,
                        const float* __restrict__ dlast,
                        const float* __restrict__ dd,
                        float* __restrict__ ddt, float* __restrict__ dA,
                        float* __restrict__ dD, Dims d, int B, int tiles,
                        int nblk) {
  extern __shared__ float red[];
  const int h = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float Ah = A[h];
  const int nbc = B * d.nc;
  for (int bcx = warp; bcx < nbc; bcx += 8) {
    const size_t bch = (size_t)bcx * d.H + h;
    const size_t tok0 = (size_t)(bcx / d.nc) * d.S + (size_t)(bcx % d.nc) * d.Q;
    const float* parts = dcum + bch * tiles * d.Q;
    // the chunk-end term: exp(cum_last) <in_c, g>, summed over the pass's
    // row blocks in order
    float last = 0.0f;
    for (int k = 0; k < nblk; ++k) last += dlast[bch * nblk + k];
    last *= expf(cum[bch * d.Q + d.Q - 1]);
    auto dcum_at = [&](int q) {
      float s = 0.0f;
      for (int t = 0; t <= q / kT; ++t) s += parts[(size_t)t * d.Q + q];
      return q == d.Q - 1 ? s + last : s;
    };
    const int seg = (d.Q + 31) / 32;
    const int q0 = min(lane * seg, d.Q), q1 = min(q0 + seg, d.Q);
    float own = 0.0f;
    for (int q = q0; q < q1; ++q) own += dcum_at(q);
    // the sum over the lanes after this one: an inclusive suffix scan of
    // the segments, shifted by one lane
    float inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, inc, o);
      if (lane + o < 32) inc += v;
    }
    float run = __shfl_down_sync(0xffffffffu, inc, 1);
    if (lane == 31) run = 0.0f;
    float da_part = 0.0f;
    for (int q = q1 - 1; q >= q0; --q) {
      run += dcum_at(q);
      const size_t at = (tok0 + q) * d.H + h;
      da_part = fmaf(run, dt[at], da_part);
      ddt[at] = fmaf(run, Ah, ddt[at]);
    }
    da_part = warp_sum(da_part);
    if (lane == 0) {
      float s = 0.0f;
      for (int t = 0; t < tiles; ++t) s += dd[bch * tiles + t];
      red[bcx] = da_part;
      red[nbc + bcx] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.0f, sd = 0.0f;
    for (int k = 0; k < nbc; ++k) {
      sa += red[k];
      sd += red[nbc + k];
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* D, const float* cum, const float* cb,
           const float* ins, const T* dy, const float* dfinal, T* dx,
           float* ddt, float* dA, T* dBm, T* dCm, float* dD, float* dinit,
           float* ds, float* dlast, float* dbc, float* dcb, float* dcum,
           float* dd, void* insb, int B, int S, int H, int P, int N, int Q,
           int heads, cudaStream_t stream) {
  if (P < 1 || P > kPMax || N < 1 || N > kNMax || Q < 1 || S % Q != 0 ||
      heads < 1 || ChunkSmem<T>::bytes(Q) > (size_t)kMaxSmem ||
      (sizeof(T) == 2 && insb == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  Dims d{S, H, P, N, Q, S / Q, 0, 0};
  d.vec = P % 8 == 0 && N % 8 == 0 && Q % 4 == 0 && aligned16(x) &&
          aligned16(dy) && aligned16(Bm) && aligned16(Cm) && aligned16(ins) &&
          aligned16(ds) && aligned16(cb) && aligned16(dcb) && aligned16(insb);
  const int tiles = (Q + kT - 1) / kT, groups = (H + heads - 1) / heads;
  const int nblk = (N + kPassRows - 1) / kPassRows;
  cudaError_t err;

  // 1. d in_c into ds
  const dim3 din_grid(H, B * d.nc, (N + kT - 1) / kT);
  if constexpr (sizeof(T) == 2) {
    const size_t bytes = (size_t)3 * kT * kLdh * 2 + (size_t)Q * 4;
    if ((err = allow_smem(ssd_bwd_din_tc_kernel, bytes)) != cudaSuccess)
      return (int)err;
    ssd_bwd_din_tc_kernel<<<din_grid, 128, bytes, stream>>>(dy, dt, Cm, cum,
                                                            ds, d);
  } else {
    const size_t bytes = (size_t)2 * kT * kLd * 4 + (size_t)Q * 4;
    if ((err = allow_smem(ssd_bwd_din_f32_kernel, bytes)) != cudaSuccess)
      return (int)err;
    ssd_bwd_din_f32_kernel<<<din_grid, 128, bytes, stream>>>(dy, dt, Cm, cum,
                                                             ds, d);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2. the reversed state passing
  const size_t pass_bytes = (size_t)8 * d.nc * 4;
  auto* pass = ssd_bwd_pass_kernel<sizeof(T) == 2>;
  if ((err = allow_smem(pass, pass_bytes)) != cudaSuccess) return (int)err;
  pass<<<dim3(nblk, B * H), 256, pass_bytes, stream>>>(
      cum, ins, dfinal, ds, dlast, dinit,
      sizeof(T) == 2 ? reinterpret_cast<__nv_bfloat16*>(insb) : nullptr, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. the chunk kernel
  const ChunkArgs ca{x,   dt,  Bm,   Cm,  D,    cum,  cb,   ins,
                     reinterpret_cast<const __nv_bfloat16*>(insb),
                     dy,  ds,  dx,   ddt, dbc,  dcb,  dcum, dd,
                     B,   heads, groups, tiles};
  const size_t chunk_bytes = ChunkSmem<T>::bytes(Q);
  auto* chunk = ssd_bwd_chunk_kernel<T>;
  if ((err = allow_smem(chunk, chunk_bytes)) != cudaSuccess) return (int)err;
  chunk<<<dim3(groups, B * d.nc, tiles), kThreads, chunk_bytes, stream>>>(ca,
                                                                          d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. dC and dB
  const size_t bc_bytes = sizeof(T) == 2
                              ? (size_t)3 * kT * kLdh * 2
                              : (size_t)2 * kT * kLd * 4;
  auto* bck = ssd_bwd_bc_kernel<T>;
  if ((err = allow_smem(bck, bc_bytes)) != cudaSuccess) return (int)err;
  bck<<<dim3(tiles, B * d.nc, 2 * ((N + kT - 1) / kT)), kThreads, bc_bytes,
        stream>>>(Bm, Cm, dbc, dcb, dBm, dCm, d, B, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 5. dcum's reverse cumulative sum, ddt, dA, dD
  const size_t scan_bytes = (size_t)2 * B * d.nc * 4;
  if ((err = allow_smem(ssd_bwd_scan_kernel, scan_bytes)) != cudaSuccess)
    return (int)err;
  ssd_bwd_scan_kernel<<<H, 256, scan_bytes, stream>>>(
      dt, A, cum, dcum, dlast, dd, ddt, dA, dD, d, B, tiles, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dfinal may be null (a zero gradient of the final state); heads is the
// chunk kernel's group of heads (plan_ssd_bwd); ds (B,nc,H,N,P), dlast
// (B,nc,H,ceil(N/32)), dbc (2,groups,B,S,N), dcb (groups,B,nc,Q,Q), dcum
// (B,nc,H,tiles,Q) and dd (B,nc,H,tiles) are f32 scratch of the caller
// (groups = ceil(H / heads), tiles = ceil(Q / 64)), and for bf16 insb
// (B,nc,H,N,2P) bf16 (the f32 path takes null); every other pointer is a
// contiguous tensor of the shape in the header comment.
int repro_ssd_scan_bwd_f32(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, const float* D,
                           const float* cum, const float* cb,
                           const float* ins, const float* dy,
                           const float* dfinal, float* dx, float* ddt,
                           float* dA, float* dBm, float* dCm, float* dD,
                           float* dinit, float* ds, float* dlast, float* dbc,
                           float* dcb, float* dcum, float* dd, void* insb,
                           int B, int S, int H, int P, int N, int Q,
                           int heads, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, cum, cb, ins, dy, dfinal, dx, ddt, dA,
                dBm, dCm, dD, dinit, ds, dlast, dbc, dcb, dcum, dd, insb, B,
                S, H, P, N, Q, heads, static_cast<cudaStream_t>(stream));
}

int repro_ssd_scan_bwd_bf16(const __nv_bfloat16* x, const float* dt,
                            const float* A, const __nv_bfloat16* Bm,
                            const __nv_bfloat16* Cm, const float* D,
                            const float* cum, const float* cb,
                            const float* ins, const __nv_bfloat16* dy,
                            const float* dfinal, __nv_bfloat16* dx,
                            float* ddt, float* dA, __nv_bfloat16* dBm,
                            __nv_bfloat16* dCm, float* dD, float* dinit,
                            float* ds, float* dlast, float* dbc, float* dcb,
                            float* dcum, float* dd, void* insb, int B, int S,
                            int H, int P, int N, int Q, int heads,
                            void* stream) {
  return launch(x, dt, A, Bm, Cm, D, cum, cb, ins, dy, dfinal, dx, ddt, dA,
                dBm, dCm, dD, dinit, ds, dlast, dbc, dcb, dcum, dd, insb, B,
                S, H, P, N, Q, heads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
