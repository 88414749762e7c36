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
// Six kernels on one stream, the work parallel over (b, chunk, head):
//   1. din, per (b, chunk, h): d in_c (N,P) into the scratch ds;
//   2. pass, per (b, h): the reversed phase 3 in reverse chunk order, ds_c
//      written over d in_c in place, exp(cum_last,c)<in_c, g> into dlast
//      (B,nc,H), d init;
//   3. chunk, per (b, chunk, h): every other term of the head: the
//      off-diagonal 4' (dC's head term into dch, dcum), 2' (dx, dB's head
//      term into dbh, ddt, dcum), the intra-chunk 4' over the 64 x 64 tile
//      pairs on and below the diagonal (dx, ddt, dcum, the head's dCB term
//      into dcbh), D; then the chunk's reverse cumulative sum of dcum (one
//      warp: lane segments and a shuffle suffix scan), ddt written once,
//      and the head's dA and dD terms into dad (2,B,nc,H);
//   4. dcb, per (b, chunk) element on or below the diagonal: dCB = the sum
//      over h of dcbh, in head order; zero above;
//   5. bc, per (b, chunk, 64-row tile): dC and dB = the sum over h of dch
//      and dbh in head order, plus dCB B and dCB^T C;
//   6. ad: dA and dD = the sums over (b, chunk) of dad, in order.
// No atomics and a fixed order for every sum (the 16-lane row sums by xor
// shuffles, column sums through shared memory read in row order): two
// launches on the same inputs give the same bits.
//
// Arithmetic: every product is an IEEE f32 FMA on the CUDA cores (no TF32,
// no tensor cores), bf16 inputs widened as they are loaded and dx, dB, dC
// rounded once to the inputs' dtype; all other outputs and scratch f32.
// Tiles of 64 rows, 256 threads as 16 x 16: thread (ty, tx) owns rows
// ty + 16a and columns tx + 16b of a tile (P-, N- or 64-wide), its operands
// read from shared memory rows of an odd pitch (65 or 129 floats), so a
// half-warp reading one column of 16 rows hits 16 banks. P <= 64, N <= 128;
// ragged P, N and Q are zero-filled in shared memory and masked in the
// stores.
//
// Bound on an H100 SXM: mamba2-2.7b's training microbatch (B 4, S 512, H 80,
// P 64, N 128, Q 256) needs about 16 GFLOP over the chunks' lower
// triangles (dy_i.x_j and the dx product on the pairs, the two N x P
// products of each of 4' off-diagonal, d in_c and 2') and moves about 100
// MB (x, dy, dx and ins read or written once, d init, B, C, CB's lower
// triangle, cum, dt and their gradients): 0.243 ms of f32 operations at 67
// TFLOP/s, 0.030 ms of bytes at 3.35 TB/s. Measured on an H100 SXM (700
// W): 1.88 ms of device time in bf16, 1.91 in f32, two thirds of it the
// chunk kernel. This simple kernel runs the products on the CUDA cores
// and writes each head's dB, dC and dCB terms to scratch (168 MB of f32
// scratch traffic at that shape) for the deterministic head sums; the
// tensor cores (mma.sync with the forward's hi + lo split of f32 operands)
// and sums over heads inside one block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows (and columns) of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPMax = 64;       // largest head dim P
constexpr int kNMax = 128;      // largest state dim N
constexpr int kLdP = kPMax + 1;  // f32 row pitch of a P-wide tile
constexpr int kLdN = kNMax + 1;  // of an N-wide tile
constexpr int kLdT = kT + 1;     // of a 64-wide tile
constexpr int kDinRows = 32;    // rows of a din stage
constexpr int kDefaultSmem = 48 * 1024;

struct Dims {
  int S, H, P, N, Q, nc;
};

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

// the sum over the 16 lanes of a half-warp (one row of the 16 x 16 grid),
// in a fixed tree; every lane gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the block's threads in a fixed order (red: 8 floats);
// thread 0 gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// rows [r0, r0 + rows) of a (Q-row) matrix of `cols` valid columns and
// row stride ld, as f32 into dst[r][c] (pitch ldd, width W): zero past the
// chunk's Q rows and past cols
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src,
                                          size_t ld, int r0, int rows,
                                          int Q, int cols) {
  for (int e = threadIdx.x; e < rows * W; e += kThreads) {
    const int r = e / W, c = e % W;
    dst[r * ldd + c] = r0 + r < Q && c < cols
                           ? to_f32(src[(size_t)(r0 + r) * ld + c])
                           : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 1. d in_c (N,P) = sum_i exp(cum_i) C_i^T dy_i, per (b, chunk, h)
// ---------------------------------------------------------------------------
// grid (H, B * nc), 256 threads; thread (ty, tx) owns rows n = ty + 16a
// and columns p = tx + 16b of d in_c; stages of 32 rows of C and
// exp(cum) dy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_din_kernel(const T* __restrict__ dy, const T* __restrict__ Cm,
                       const float* __restrict__ cum, float* __restrict__ ds,
                       Dims d) {
  __shared__ float Cs[kDinRows * kLdN];
  __shared__ float Ys[kDinRows * kLdP];
  __shared__ float ecum[kDinRows];
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / d.nc, c = bc % d.nc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const float* cumh = cum + ((size_t)bc * d.H + h) * d.Q;
  const T* dyh = dy + tok0 * d.H * d.P + (size_t)h * d.P;
  const T* Cc = Cm + tok0 * d.N;
  float acc[8][4] = {};
  for (int i0 = 0; i0 < d.Q; i0 += kDinRows) {
    __syncthreads();
    if (threadIdx.x < kDinRows)
      ecum[threadIdx.x] =
          i0 + threadIdx.x < d.Q ? expf(cumh[i0 + threadIdx.x]) : 0.0f;
    load_rows<kNMax>(Cs, kLdN, Cc, d.N, i0, kDinRows, d.Q, d.N);
    __syncthreads();
    for (int e = threadIdx.x; e < kDinRows * kPMax; e += kThreads) {
      const int r = e / kPMax, p = e % kPMax;
      Ys[r * kLdP + p] =
          i0 + r < d.Q && p < d.P
              ? ecum[r] * to_f32(dyh[(size_t)(i0 + r) * d.H * d.P + p])
              : 0.0f;
    }
    __syncthreads();
    const int rend = min(kDinRows, d.Q - i0);
    for (int r = 0; r < rend; ++r) {
      float cv[8], yv[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) cv[a] = Cs[r * kLdN + ty + 16 * a];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) yv[bb] = Ys[r * kLdP + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(cv[a], yv[bb], acc[a][bb]);
    }
  }
  float* out = ds + ((size_t)bc * d.H + h) * d.N * d.P;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int n = ty + 16 * a, p = tx + 16 * bb;
      if (n < d.N && p < d.P) out[(size_t)n * d.P + p] = acc[a][bb];
    }
}

// ---------------------------------------------------------------------------
// 2. the reversed phase 3, per (b, h)
// ---------------------------------------------------------------------------
// grid (B * H), 256 threads, each holding 32 elements of g (N,P).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_pass_kernel(const float* __restrict__ cum,
                        const float* __restrict__ ins,
                        const float* __restrict__ dfinal,
                        float* __restrict__ ds, float* __restrict__ dlast,
                        float* __restrict__ dinit, Dims d) {
  constexpr int kPer = kNMax * kPMax / kThreads;
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int np = d.N * d.P;
  float g[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + kThreads * k, n = e / d.P, p = e % d.P;
    g[k] = dfinal != nullptr && e < np
               ? dfinal[((size_t)bh * d.P + p) * d.N + n]
               : 0.0f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const size_t bch = ((size_t)b * d.nc + c) * d.H + h;
    const float decay = expf(cum[bch * d.Q + d.Q - 1]);
    float* dsc = ds + bch * np;
    const float* in = ins + bch * np;
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + kThreads * k;
      if (e >= np) continue;
      const float din = dsc[e];
      part = fmaf(in[e], g[k], part);
      dsc[e] = g[k];
      g[k] = fmaf(decay, g[k], din);
    }
    const float s = block_sum(part, red);
    if (threadIdx.x == 0) dlast[bch] = decay * s;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + kThreads * k, n = e / d.P, p = e % d.P;
    if (e < np) dinit[((size_t)bh * d.P + p) * d.N + n] = g[k];
  }
}

// ---------------------------------------------------------------------------
// 3. every other term of one (b, chunk, h)
// ---------------------------------------------------------------------------
// grid (H, B * nc), 256 threads; dynamic shared memory: the state Ss
// (N x P: in_c, then ds_c), Xs and Ys (64 x P: x_j, dy_i), Ms (64 x N: C_i,
// then B_j), Gs (64 x 64: G), red (16 x 64: column sums), and per row of
// the chunk cum, dt, dcum, ddt and w dw (Q each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ D,
                         const float* __restrict__ cum,
                         const float* __restrict__ cb,
                         const float* __restrict__ ins,
                         const T* __restrict__ dy,
                         const float* __restrict__ ds,
                         const float* __restrict__ dlast, T* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ dbh,
                         float* __restrict__ dch, float* __restrict__ dcbh,
                         float* __restrict__ dad, Dims d, int B) {
  extern __shared__ float smem[];
  float* Ss = smem;                    // [kNMax][kLdP]
  float* Xs = Ss + kNMax * kLdP;       // [kT][kLdP]
  float* Ys = Xs + kT * kLdP;          // [kT][kLdP]
  float* Ms = Ys + kT * kLdP;          // [kT][kLdN]
  float* Gs = Ms + kT * kLdN;          // [kT][kLdT]
  float* red = Gs + kT * kLdT;         // [16][kLdT]
  float* cum_s = red + 16 * kLdT;      // [Q]
  float* dt_s = cum_s + d.Q;
  float* dcum_s = dt_s + d.Q;
  float* ddt_s = dcum_s + d.Q;
  float* wdw_s = ddt_s + d.Q;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / d.nc, c = bc % d.nc;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t bch = (size_t)bc * d.H + h;
  const size_t xrow = (size_t)d.H * d.P, nrow = (size_t)d.H * d.N;
  const T* xh = x + tok0 * xrow + (size_t)h * d.P;
  const T* dyh = dy + tok0 * xrow + (size_t)h * d.P;
  const T* Bc = Bm + tok0 * d.N;
  const T* Cc = Cm + tok0 * d.N;
  const float* cbc = cb + (size_t)bc * d.Q * d.Q;
  float* dcbc = dcbh + bch * d.Q * d.Q;
  float* dbc = dbh + tok0 * nrow + (size_t)h * d.N;
  float* dcc = dch + tok0 * nrow + (size_t)h * d.N;
  const float Ah = A[h], Dh = D[h];
  for (int q = tid; q < d.Q; q += kThreads) {
    cum_s[q] = cum[bch * d.Q + q];
    dt_s[q] = dt[(tok0 + q) * d.H + h];
    dcum_s[q] = 0.0f;
    ddt_s[q] = 0.0f;
  }
  // Ss = in_c (N x P), zero past N and P
  for (int e = tid; e < kNMax * kPMax; e += kThreads) {
    const int n = e / kPMax, p = e % kPMax;
    Ss[n * kLdP + p] = n < d.N && p < d.P
                           ? ins[(bch * d.N + n) * d.P + p]
                           : 0.0f;
  }
  const int tiles = (d.Q + kT - 1) / kT;

  // -- 4' off the diagonal: dC_i's head term exp(cum_i) in_c dy_i, and
  //    dcum_i += its dot with C_i -----------------------------------------
  for (int it = 0; it < tiles; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    load_rows<kPMax>(Ys, kLdP, dyh, xrow, i0, kT, d.Q, d.P);
    load_rows<kNMax>(Ms, kLdN, Cc, d.N, i0, kT, d.Q, d.N);
    __syncthreads();
    float o[4][8] = {};
    for (int p = 0; p < d.P; ++p) {
      float yv[4], sv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) yv[a] = Ys[(ty + 16 * a) * kLdP + p];
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) sv[bb] = Ss[(tx + 16 * bb) * kLdP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) o[a][bb] = fmaf(yv[a], sv[bb], o[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
      const float e = i < d.Q ? expf(cum_s[i]) : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) {
        const int n = tx + 16 * bb;
        const float v = e * o[a][bb];
        part = fmaf(v, Ms[r * kLdN + n], part);
        if (i < d.Q && n < d.N) dcc[(size_t)i * nrow + n] = v;
      }
      part = row_sum16(part);
      if (tx == 0 && i < d.Q) dcum_s[i] += part;
    }
  }
  __syncthreads();
  // Ss = ds_c
  for (int e = tid; e < kNMax * kPMax; e += kThreads) {
    const int n = e / kPMax, p = e % kPMax;
    Ss[n * kLdP + p] = n < d.N && p < d.P
                           ? ds[(bch * d.N + n) * d.P + p]
                           : 0.0f;
  }
  const float cum_last = cum_s[d.Q - 1];
  float dd_part = 0.0f;  // this thread's terms of dD

  for (int jt = 0; jt < tiles; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    load_rows<kPMax>(Xs, kLdP, xh, xrow, j0, kT, d.Q, d.P);
    load_rows<kNMax>(Ms, kLdN, Bc, d.N, j0, kT, d.Q, d.N);
    __syncthreads();

    // -- 2': u_j = B_j ds_c (P), dw_j = u_j.x_j; dx_j = w_j u_j ----------
    float acc[4][4] = {};
    for (int n = 0; n < d.N; ++n) {
      float bv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Ms[(ty + 16 * a) * kLdN + n];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sv[bb] = Ss[n * kLdP + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(bv[a], sv[bb], acc[a][bb]);
    }
    float wj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, j = j0 + r;
      float part = 0.0f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        part = fmaf(acc[a][bb], Xs[r * kLdP + tx + 16 * bb], part);
      const float dw = row_sum16(part);
      const float eo = j < d.Q ? expf(cum_last - cum_s[j]) : 0.0f;
      wj[a] = j < d.Q ? eo * dt_s[j] : 0.0f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] *= wj[a];
      if (tx == 0 && j < d.Q) {
        ddt_s[j] += eo * dw;
        wdw_s[j] = wj[a] * dw;
        dcum_s[j] -= wj[a] * dw;
      }
    }
    // dB_j's head term w_j ds_c x_j (N)
    {
      float v[4][8] = {};
      for (int p = 0; p < d.P; ++p) {
        float xv[4], sv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = Xs[(ty + 16 * a) * kLdP + p];
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) sv[bb] = Ss[(tx + 16 * bb) * kLdP + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb)
            v[a][bb] = fmaf(xv[a], sv[bb], v[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
        if (j >= d.Q) continue;
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) {
          const int n = tx + 16 * bb;
          if (n < d.N) dbc[(size_t)j * nrow + n] = wj[a] * v[a][bb];
        }
      }
    }

    // -- 4' in the chunk: the row tiles i0 >= j0 --------------------------
    for (int it = jt; it < tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // the last pass's readers of Ys and Gs are done
      load_rows<kPMax>(Ys, kLdP, dyh, xrow, i0, kT, d.Q, d.P);
      __syncthreads();
      float dxp[4][4] = {};  // dy_i.x_j: rows i = ty + 16a, cols j
      for (int p = 0; p < d.P; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = Ys[(ty + 16 * a) * kLdP + p];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) xv[bb] = Xs[(tx + 16 * bb) * kLdP + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            dxp[a][bb] = fmaf(yv[a], xv[bb], dxp[a][bb]);
      }
      float colp[4] = {};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        float rowp = 0.0f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = j0 + tx + 16 * bb;
          float gg = 0.0f;
          if (i < d.Q && j <= i) {
            const float e = expf(cum_s[i] - cum_s[j]);
            const float cbv = cbc[(size_t)i * d.Q + j];
            const float ed = e * dt_s[j];
            const float td = cbv * e * dxp[a][bb];   // ddt's term
            gg = cbv * ed;
            rowp = fmaf(td, dt_s[j], rowp);          // M_ij
            colp[bb] += td;
            dcbc[(size_t)i * d.Q + j] = ed * dxp[a][bb];
          } else if (i < d.Q && j < d.Q) {
            dcbc[(size_t)i * d.Q + j] = 0.0f;
          }
          Gs[(ty + 16 * a) * kLdT + tx + 16 * bb] = gg;
        }
        rowp = row_sum16(rowp);
        if (tx == 0 && i < d.Q) dcum_s[i] += rowp;
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) red[ty * kLdT + tx + 16 * bb] = colp[bb];
      __syncthreads();
      if (tid < kT && j0 + tid < d.Q) {
        float s = 0.0f;
        for (int t = 0; t < 16; ++t) s += red[t * kLdT + tid];
        ddt_s[j0 + tid] += s;
        dcum_s[j0 + tid] -= dt_s[j0 + tid] * s;
      }
      // dx_j += sum_i G_ij dy_i
      const int iend = min(kT, d.Q - i0);
      for (int il = 0; il < iend; ++il) {
        float gv[4], yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) gv[a] = Gs[il * kLdT + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) yv[bb] = Ys[il * kLdP + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            acc[a][bb] = fmaf(gv[a], yv[bb], acc[a][bb]);
      }
    }

    // dx_j = acc + D dy_j, in x's dtype; dD's terms dy_j.x_j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, j = j0 + r;
      if (j >= d.Q) continue;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int p = tx + 16 * bb;
        if (p >= d.P) continue;
        const float g = to_f32(dyh[(size_t)j * xrow + p]);
        dd_part = fmaf(g, Xs[r * kLdP + p], dd_part);
        dx[(tok0 + j) * xrow + (size_t)h * d.P + p] =
            from_f32<T>(fmaf(Dh, g, acc[a][bb]));
      }
    }
  }
  __syncthreads();

  // -- the chunk's end: dcum_last's terms, the reverse cumulative sum -----
  if (tid == 0) {
    float s = dlast[bch];
    for (int j = 0; j < d.Q; ++j) s += wdw_s[j];
    dcum_s[d.Q - 1] += s;
  }
  __syncthreads();
  const float dD_sum = block_sum(dd_part, red);
  if (tid < 32) {
    const int lane = tid, seg = (d.Q + 31) / 32;
    const int q0 = min(lane * seg, d.Q), q1 = min(q0 + seg, d.Q);
    float own = 0.0f;
    for (int q = q0; q < q1; ++q) own += dcum_s[q];
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
      run += dcum_s[q];
      da_part = fmaf(run, dt_s[q], da_part);
      ddt[(tok0 + q) * d.H + h] = fmaf(run, Ah, ddt_s[q]);
    }
    da_part = warp_sum(da_part);
    if (lane == 0) {
      dad[bch] = da_part;
      dad[(size_t)B * d.nc * d.H + bch] = dD_sum;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dCB = the sum over heads of dcbh, on and below the diagonal
// ---------------------------------------------------------------------------
// grid (ceil(Q * Q / 256), B * nc), 256 threads: one element a thread.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcb_kernel(const float* __restrict__ dcbh, float* __restrict__ dcb,
                       Dims d) {
  const int bc = blockIdx.y;
  const size_t qq = (size_t)d.Q * d.Q;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= qq) return;
  const int i = (int)(e / d.Q), j = (int)(e % d.Q);
  float s = 0.0f;
  if (j <= i) {
    const float* src = dcbh + (size_t)bc * d.H * qq + e;
    for (int h = 0; h < d.H; ++h) s += src[(size_t)h * qq];
  }
  dcb[(size_t)bc * qq + e] = s;
}

// ---------------------------------------------------------------------------
// 5. dC and dB of a 64-row tile of one (b, chunk)
// ---------------------------------------------------------------------------
// grid (ceil(Q / 64), B * nc), 256 threads; thread (ty, tx) owns rows
// r0 + ty + 16a and columns n = tx + 16b of both; per 64-deep stage k0 the
// block holds B's and C's rows k0.. (64 x N each) and dCB's tiles (rows r0,
// columns k0) and (rows k0, columns r0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_bc_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ dbh,
                      const float* __restrict__ dch,
                      const float* __restrict__ dcb, T* __restrict__ dBm,
                      T* __restrict__ dCm, Dims d) {
  extern __shared__ float smem[];
  float* Bs = smem;               // [kT][kLdN]
  float* Cs = Bs + kT * kLdN;     // [kT][kLdN]
  float* D1 = Cs + kT * kLdN;     // [kT][kLdT]  dCB[r0 + r][k0 + k]
  float* D2 = D1 + kT * kLdT;     // [kT][kLdT]  dCB[k0 + k][r0 + r]
  const int t = blockIdx.x, bc = blockIdx.y, b = bc / d.nc, c = bc % d.nc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, r0 = t * kT;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const float* dcbc = dcb + (size_t)bc * d.Q * d.Q;
  const T* Bc = Bm + tok0 * d.N;
  const T* Cc = Cm + tok0 * d.N;
  float accC[4][8] = {}, accB[4][8] = {};
  const int tiles = (d.Q + kT - 1) / kT;
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_rows<kNMax>(Bs, kLdN, Bc, d.N, k0, kT, d.Q, d.N);
    load_rows<kNMax>(Cs, kLdN, Cc, d.N, k0, kT, d.Q, d.N);
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      // row u, column v of each tile: coalesced reads along v
      const int u = e / kT, v = e % kT;
      D1[u * kLdT + v] = r0 + u < d.Q && k0 + v < d.Q
                             ? dcbc[(size_t)(r0 + u) * d.Q + k0 + v]
                             : 0.0f;
      D2[u * kLdT + v] = k0 + u < d.Q && r0 + v < d.Q
                             ? dcbc[(size_t)(k0 + u) * d.Q + r0 + v]
                             : 0.0f;
    }
    __syncthreads();
    const int kend = min(kT, d.Q - k0);
    if (kt <= t) {  // dC_i += sum_j dCB_ij B_j (zero above the diagonal)
      for (int k = 0; k < kend; ++k) {
        float dv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = D1[(ty + 16 * a) * kLdT + k];
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) bv[bb] = Bs[k * kLdN + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb)
            accC[a][bb] = fmaf(dv[a], bv[bb], accC[a][bb]);
      }
    }
    if (kt >= t) {  // dB_j += sum_i dCB_ij C_i
      for (int k = 0; k < kend; ++k) {
        float dv[4], cv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = D2[k * kLdT + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) cv[bb] = Cs[k * kLdN + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb)
            accB[a][bb] = fmaf(dv[a], cv[bb], accB[a][bb]);
      }
    }
  }
  const size_t nrow = (size_t)d.H * d.N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    if (i >= d.Q) continue;
    const size_t tok = tok0 + i;
#pragma unroll
    for (int bb = 0; bb < 8; ++bb) {
      const int n = tx + 16 * bb;
      if (n >= d.N) continue;
      float sc = 0.0f, sb = 0.0f;
      for (int h = 0; h < d.H; ++h) {
        sc += dch[tok * nrow + (size_t)h * d.N + n];
        sb += dbh[tok * nrow + (size_t)h * d.N + n];
      }
      dCm[tok * d.N + n] = from_f32<T>(sc + accC[a][bb]);
      dBm[tok * d.N + n] = from_f32<T>(sb + accB[a][bb]);
    }
  }
}

// ---------------------------------------------------------------------------
// 6. dA and dD: the sums over (b, chunk) of each head's terms
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
    ssd_bwd_ad_kernel(const float* __restrict__ dad, float* __restrict__ dA,
                      float* __restrict__ dD, Dims d, int B) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= d.H) return;
  const size_t half = (size_t)B * d.nc * d.H;
  float sa = 0.0f, sd = 0.0f;
  for (int bc = 0; bc < B * d.nc; ++bc) {
    sa += dad[(size_t)bc * d.H + h];
    sd += dad[half + (size_t)bc * d.H + h];
  }
  dA[h] = sa;
  dD[h] = sd;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// the dynamic shared-memory limit is a per-function attribute; raising it
// is needed only above the default, and is set at each such launch
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* D, const float* cum, const float* cb,
           const float* ins, const T* dy, const float* dfinal, T* dx,
           float* ddt, float* dA, T* dBm, T* dCm, float* dD, float* dinit,
           float* ds, float* dlast, float* dbh, float* dch, float* dcbh,
           float* dcb, float* dad, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  if (P < 1 || P > kPMax || N < 1 || N > kNMax || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  const Dims d{S, H, P, N, Q, S / Q};
  const int tiles = (Q + kT - 1) / kT;
  cudaError_t err;

  ssd_bwd_din_kernel<T><<<dim3(H, B * d.nc), kThreads, 0, stream>>>(
      dy, Cm, cum, ds, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<<<B * H, kThreads, 0, stream>>>(cum, ins, dfinal, ds,
                                                      dlast, dinit, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t chunk_bytes =
      ((size_t)kNMax * kLdP + 2 * kT * kLdP + kT * kLdN + kT * kLdT +
       16 * kLdT + 5 * (size_t)Q) * 4;
  auto* chunk = ssd_bwd_chunk_kernel<T>;
  if ((err = allow_smem(chunk, chunk_bytes)) != cudaSuccess) return (int)err;
  chunk<<<dim3(H, B * d.nc), kThreads, chunk_bytes, stream>>>(
      x, dt, A, Bm, Cm, D, cum, cb, ins, dy, ds, dlast, dx, ddt, dbh, dch,
      dcbh, dad, d, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t qq = (size_t)Q * Q;
  ssd_bwd_dcb_kernel<<<dim3((unsigned)((qq + kThreads - 1) / kThreads),
                            B * d.nc), kThreads, 0, stream>>>(dcbh, dcb, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t bc_bytes = ((size_t)2 * kT * kLdN + 2 * kT * kLdT) * 4;
  auto* bck = ssd_bwd_bc_kernel<T>;
  if ((err = allow_smem(bck, bc_bytes)) != cudaSuccess) return (int)err;
  bck<<<dim3(tiles, B * d.nc), kThreads, bc_bytes, stream>>>(
      Bm, Cm, dbh, dch, dcb, dBm, dCm, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_ad_kernel<<<(H + 127) / 128, 128, 0, stream>>>(dad, dA, dD, d, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dfinal may be null (a zero gradient of the final state); ds (B,nc,H,N,P),
// dlast (B,nc,H), dbh and dch (B,S,H,N), dcbh (B,nc,H,Q,Q), dcb (B,nc,Q,Q)
// and dad (2,B,nc,H) are f32 scratch of the caller; every other pointer is
// a contiguous tensor of the shape in the header comment.
int repro_ssd_scan_bwd_f32(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, const float* D,
                           const float* cum, const float* cb,
                           const float* ins, const float* dy,
                           const float* dfinal, float* dx, float* ddt,
                           float* dA, float* dBm, float* dCm, float* dD,
                           float* dinit, float* ds, float* dlast, float* dbh,
                           float* dch, float* dcbh, float* dcb, float* dad,
                           int B, int S, int H, int P, int N, int Q,
                           void* stream) {
  return launch(x, dt, A, Bm, Cm, D, cum, cb, ins, dy, dfinal, dx, ddt, dA,
                dBm, dCm, dD, dinit, ds, dlast, dbh, dch, dcbh, dcb, dad, B,
                S, H, P, N, Q, static_cast<cudaStream_t>(stream));
}

int repro_ssd_scan_bwd_bf16(const __nv_bfloat16* x, const float* dt,
                            const float* A, const __nv_bfloat16* Bm,
                            const __nv_bfloat16* Cm, const float* D,
                            const float* cum, const float* cb,
                            const float* ins, const __nv_bfloat16* dy,
                            const float* dfinal, __nv_bfloat16* dx,
                            float* ddt, float* dA, __nv_bfloat16* dBm,
                            __nv_bfloat16* dCm, float* dD, float* dinit,
                            float* ds, float* dlast, float* dbh, float* dch,
                            float* dcbh, float* dcb, float* dad, int B, int S,
                            int H, int P, int N, int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, cum, cb, ins, dy, dfinal, dx, ddt, dA,
                dBm, dCm, dD, dinit, ds, dlast, dbh, dch, dcbh, dcb, dad, B,
                S, H, P, N, Q, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
