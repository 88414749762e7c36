// Helpers shared by the SSD scan's kernels (csrc/ssd.cu) and its backward
// (csrc/ssd_bwd.cu): the 64-row stages, their fills through registers or
// by cp.async, the hi + lo split of an f32 operand for the tensor cores,
// the ldmatrix lane offsets and mma.sync over a stage, and phase 2 of the
// forward (each chunk's own state), whose form the backward's d in_c
// shares. In an unnamed namespace: each source compiles its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_bf16_tc.cuh"  // smem_addr, cp.async, load_chunk, ldmatrix, mma

namespace {

namespace tc = repro_torch::tc;

constexpr int kT = 64;         // CB and output row tile; depth of a stage
constexpr int kLd = kT + 4;    // f32 row pitch of a 64-wide stage
constexpr int kLdh = kT + 8;   // bf16 row pitch of a 64-wide stage
constexpr int kPMax = 64;      // largest head dim P
constexpr int kNMax = 128;     // largest state dim N
constexpr int kDefaultSmem = 48 * 1024;

struct Dims {
  int S, H, P, N, Q, nc;
  int vec;       // 16-byte rows: P % 8, N % 8, Q % 4 == 0, aligned pointers
  int has_init;  // an initial state was given
};

// p[col..col+3] as f32, zero at col + u >= n. With vec, p + col is 16-byte
// (f32) or 8-byte (bf16) aligned whenever col is a multiple of 4.
__device__ __forceinline__ float4 load4(const float* p, int col, int n,
                                        bool vec) {
  if (vec && col + 4 <= n) return *reinterpret_cast<const float4*>(p + col);
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = col + u < n ? p[col + u] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int col,
                                        int n, bool vec) {
  if (vec && col + 4 <= n) {
    const uint2 r = *reinterpret_cast<const uint2*>(p + col);
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = col + u < n ? __bfloat162float(p[col + u]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void st4(float* s, float4 v) {
  *reinterpret_cast<float4*>(s) = v;
}
__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}
__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

// Fill a stage of rows of W4 float4 items: thread t takes items e = t +
// u·THREADS (row e / W4, column (e % W4)·4), u < ITEMS, GROUP at a time:
// the loads of a group are all issued before any of its items is
// transformed or stored. GROUP bounds the registers in flight (a copy
// takes 4, a transform with exp 1).
template <int ITEMS, int THREADS, int W4, int GROUP, typename Load,
          typename Store>
__device__ __forceinline__ void fill(const Load& load, const Store& put) {
  static_assert(ITEMS % GROUP == 0, "whole groups");
#pragma unroll 1
  for (int u0 = 0; u0 < ITEMS; u0 += GROUP) {
    float4 v[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int e = (int)threadIdx.x + (u0 + u) * THREADS;
      v[u] = load(e / W4, (e % W4) * 4);
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int e = (int)threadIdx.x + (u0 + u) * THREADS;
      put(e / W4, (e % W4) * 4, v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core helpers (bf16)
// ---------------------------------------------------------------------------
// A bf16 stage tile is [rows][kLdh]: 144-byte rows, an odd number of
// 16-byte chunks, so the 8 rows of an ldmatrix phase fall in distinct bank
// groups. Warp w owns 16 output rows and all 64 columns (8 n-blocks).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v[0..3] as hi + lo into two bf16 tiles at element offset off (a
// multiple of 4)
__device__ __forceinline__ void st_split4(__nv_bfloat16* hi,
                                          __nv_bfloat16* lo, int off,
                                          float4 v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  __nv_bfloat16 h[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    h[u] = __float2bfloat16_rn(f[u]);
    l[u] = __float2bfloat16_rn(f[u] - __bfloat162float(h[u]));
  }
  *reinterpret_cast<uint2*>(hi + off) =
      make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo + off) =
      make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
}

// ldmatrix lane offsets (bytes) in a [rows][kLdh] bf16 tile:
//   a_rows: A fragment of rows 16w.., k along the row (ldmatrix);
//   a_cols: A fragment read from its transpose [k][rows] (ldmatrix.trans);
//   b_rows: B fragments of two n-blocks from a [k][n] tile (.trans).
__device__ __forceinline__ uint32_t a_rows(int w, int lane) {
  return (uint32_t)((16 * w + lane % 16) * kLdh + (lane / 16) * 8) * 2;
}
__device__ __forceinline__ uint32_t a_cols(int w, int lane) {
  return (uint32_t)((lane % 8 + (lane / 16) * 8) * kLdh + 16 * w +
                    ((lane / 8) % 2) * 8) * 2;
}
__device__ __forceinline__ uint32_t b_rows(int lane) {
  return (uint32_t)((lane % 8 + ((lane / 8) % 2) * 8) * kLdh +
                    (lane / 16) * 8) * 2;
}

// acc(16 x 64) += A0 · B0 [+ A1 · B0] [+ A0 · B1] over ksteps k16 steps of
// a 64-deep stage: a0, a1 are the warp's A fragment addresses at k 0 (read
// from the transpose with A_TRANS), b0, b1 the B tiles' lane addresses at
// k 0; TWO_A / TWO_B add the lo term of a split operand.
template <bool A_TRANS, bool TWO_A, bool TWO_B>
__device__ __forceinline__ void mma_stage(float (&acc)[8][4], uint32_t a0,
                                          uint32_t a1, uint32_t b0,
                                          uint32_t b1, int ksteps) {
  for (int kt = 0; kt < ksteps; ++kt) {
    const uint32_t ka = A_TRANS ? kt * 16 * kLdh * 2 : kt * 32;
    uint32_t af0[4], af1[4];
    if constexpr (A_TRANS)
      tc::ldmatrix_x4_trans(af0, a0 + ka);
    else
      tc::ldmatrix_x4(af0, a0 + ka);
    if constexpr (TWO_A) tc::ldmatrix_x4(af1, a1 + ka);
    const uint32_t kb = kt * 16 * kLdh * 2;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bf0[4], bf1[4];
      tc::ldmatrix_x4_trans(bf0, b0 + kb + nb * 32);
      if constexpr (TWO_B) tc::ldmatrix_x4_trans(bf1, b1 + kb + nb * 32);
      tc::mma_16816(acc[2 * nb], af0, bf0[0], bf0[1]);
      tc::mma_16816(acc[2 * nb + 1], af0, bf0[2], bf0[3]);
      if constexpr (TWO_A) {
        tc::mma_16816(acc[2 * nb], af1, bf0[0], bf0[1]);
        tc::mma_16816(acc[2 * nb + 1], af1, bf0[2], bf0[3]);
      }
      if constexpr (TWO_B) {
        tc::mma_16816(acc[2 * nb], af0, bf1[0], bf1[1]);
        tc::mma_16816(acc[2 * nb + 1], af0, bf1[2], bf1[3]);
      }
    }
  }
}

// Copy rows [row0, row0 + rows) x columns [col0, col0 + 64) of a bf16
// matrix (leading dimension ld, nrows rows, ncols columns) into a
// [rows][kLdh] tile by 16-byte cp.async (element copies where !vec);
// outside the matrix is zero
template <int THREADS>
__device__ __forceinline__ void copy_rows(uint32_t tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int rows,
                                          int nrows, int col0, int ncols,
                                          int vec) {
  for (int e = threadIdx.x; e < rows * 8; e += THREADS) {
    const int r = e / 8, ch = e % 8;
    tc::load_chunk(tile + (uint32_t)(r * kLdh + ch * 8) * 2, src, ld, row0 + r,
                   nrows, col0 + ch * 8, ncols, vec);
  }
}

// Phase 2's weights of head h into shared memory (w_s: Q): the forward's
// w_q = exp(cum_last - cum_q) dt_q, or with DIN the backward's exp(cum_q)
// (d in_c = sum_q C_q^T exp(cum_q) dy_q has phase 2's form)
template <bool DIN, int THREADS>
__device__ __forceinline__ void chunk_weights(const float* cum,
                                              const float* dt, const Dims& d,
                                              int b, int c, int h,
                                              float* w_s) {
  const float* cumh = cum + (((size_t)b * d.nc + c) * d.H + h) * d.Q;
  const float* dth = dt + ((size_t)b * d.S + (size_t)c * d.Q) * d.H + h;
  const float last = cumh[d.Q - 1];
  for (int q = threadIdx.x; q < d.Q; q += THREADS)
    w_s[q] = DIN ? expf(cumh[q]) : expf(last - cumh[q]) * dth[(size_t)q * d.H];
}

// ---------------------------------------------------------------------------
// phase 2: each chunk's own state (with DIN: the backward's d in_c)
// ---------------------------------------------------------------------------
// f32: grid (H, B * nc, ceil(N / 64)), 128 threads. Thread (tx, ty) owns
// state rows n0 + ty*8 .. +7 and columns tx*4 .. +3; per 64-token stage
// the block holds B's rows [j][n] (read down a column: B^T) and w_j x_j
// [j][p].
template <bool DIN>
__device__ __forceinline__ void state_f32(const float* __restrict__ x,
                                          const float* __restrict__ dt,
                                          const float* __restrict__ Bm,
                                          const float* __restrict__ cum,
                                          float* __restrict__ states,
                                          const Dims& d) {
  constexpr int kThreads = 128;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // [kT][kLd]  B of the stage
  float* Xs = As + kT * kLd;      // [kT][kLd]  w_j x_j of the stage
  float* w_s = Xs + kT * kLd;     // [Q]
  const int h = blockIdx.x, b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int n0 = blockIdx.z * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t xrow = (size_t)d.H * d.P;
  const float* xh = x + tok0 * xrow + (size_t)h * d.P;
  const float* Bc = Bm + tok0 * d.N;
  chunk_weights<DIN, kThreads>(cum, dt, d, b, c, h, w_s);
  float acc[8][4] = {};
  for (int j0 = 0; j0 < d.Q; j0 += kT) {
    __syncthreads();  // w_s is in; the last stage's readers are done
    fill<kT * 16 / kThreads, kThreads, 16, 4>(
        [&](int k, int m4) {
          return j0 + k < d.Q
                     ? load4(Bc + (size_t)(j0 + k) * d.N, n0 + m4, d.N, d.vec)
                     : zero4();
        },
        [&](int k, int m4, float4 v) { st4(&As[k * kLd + m4], v); });
    fill<kT * 16 / kThreads, kThreads, 16, 4>(
        [&](int k, int p4) {
          return j0 + k < d.Q ? load4(xh + (j0 + k) * xrow, p4, d.P, d.vec)
                              : zero4();
        },
        [&](int k, int p4, float4 v) {
          st4(&Xs[k * kLd + p4], j0 + k < d.Q ? scale4(v, w_s[j0 + k]) : v);
        });
    __syncthreads();
    const int kend = min(kT, d.Q - j0);
#pragma unroll 4
    for (int k = 0; k < kend; ++k) {
      const float4 a0 = ld4(&As[k * kLd + ty * 8]);
      const float4 a1 = ld4(&As[k * kLd + ty * 8 + 4]);
      const float4 xv = ld4(&Xs[k * kLd + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(a[r], xv.x, acc[r][0]);
        acc[r][1] = fmaf(a[r], xv.y, acc[r][1]);
        acc[r][2] = fmaf(a[r], xv.z, acc[r][2]);
        acc[r][3] = fmaf(a[r], xv.w, acc[r][3]);
      }
    }
  }
  float* out = states + (((size_t)b * d.nc + c) * d.H + h) * d.N * d.P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + ty * 8 + r;
    if (n >= d.N) continue;
    float* o = out + (size_t)n * d.P;
    if (d.vec && tx * 4 < d.P) {
      st4(o + tx * 4, make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (tx * 4 + s < d.P) o[tx * 4 + s] = acc[r][s];
    }
  }
}

// bf16: grid (H, B * nc, ceil(N / 64)), 128 threads; block state rows
// n0 .. n0 + 63, warp w rows n0 + 16w ..; per 64-token stage B's rows
// [j][n] (read as B^T by ldmatrix.trans) and w_j x_j [j][p] as hi + lo.
template <bool DIN>
__device__ __forceinline__ void state_tc(const __nv_bfloat16* __restrict__ x,
                                         const float* __restrict__ dt,
                                         const __nv_bfloat16* __restrict__ Bm,
                                         const float* __restrict__ cum,
                                         float* __restrict__ states,
                                         const Dims& d) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* Bt = reinterpret_cast<__nv_bfloat16*>(smem);  // [kT][kLdh]
  __nv_bfloat16* Xh = Bt + kT * kLdh;
  __nv_bfloat16* Xl = Xh + kT * kLdh;
  float* w_s = reinterpret_cast<float*>(Xl + kT * kLdh);  // [Q]
  const int h = blockIdx.x, b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int n0 = blockIdx.z * kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t xrow = (size_t)d.H * d.P;
  const __nv_bfloat16* xh = x + tok0 * xrow + (size_t)h * d.P;
  const __nv_bfloat16* Bc = Bm + tok0 * d.N;
  const uint32_t bt = tc::smem_addr(Bt);
  const uint32_t a0 = bt + a_cols(warp, lane);
  const uint32_t b0 = tc::smem_addr(Xh) + b_rows(lane);
  const uint32_t b1 = tc::smem_addr(Xl) + b_rows(lane);
  chunk_weights<DIN, 128>(cum, dt, d, b, c, h, w_s);
  float acc[8][4] = {};
  for (int j0 = 0; j0 < d.Q; j0 += kT) {
    __syncthreads();  // w_s is in; the last stage's readers are done
    copy_rows<128>(bt, Bc, d.N, j0, kT, d.Q, n0, d.N, d.vec);
    tc::cp_async_commit();
    fill<8, 128, 16, 4>(
        [&](int k, int p4) {
          return j0 + k < d.Q ? load4(xh + (j0 + k) * xrow, p4, d.P, d.vec)
                              : zero4();
        },
        [&](int k, int p4, float4 v) {
          st_split4(Xh, Xl, k * kLdh + p4,
                    j0 + k < d.Q ? scale4(v, w_s[j0 + k]) : v);
        });
    tc::cp_async_wait<0>();
    __syncthreads();
    mma_stage<true, false, true>(acc, a0, 0, b0, b1,
                                 (min(kT, d.Q - j0) + 15) / 16);
  }
  // accumulator e of n-block nt: row g (e < 2) or g + 8, column
  // 8·nt + 2·tq + (e & 1)
  float* out = states + (((size_t)b * d.nc + c) * d.H + h) * d.N * d.P;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 16 * warp + g + (e >= 2 ? 8 : 0);
      const int p = 8 * nt + 2 * tq + (e & 1);
      if (n < d.N && p < d.P) out[(size_t)n * d.P + p] = acc[nt][e];
    }
}

// the dynamic shared-memory limit is a per-function attribute; raising it
// is needed only above the default, and is set at each such launch
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
