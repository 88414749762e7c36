// flash_attention_bwd: the Hopper (sm_90a) backward of flash_attention
// (csrc/flash_attention.cu). It replaces no Pallas kernel: the JAX package
// trains by differentiating its jnp attention (jax.grad of
// repro.kernels.ref.flash_attention_ref, repro/kernels/ref.py:22), and this
// computes the same gradients. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
//
// Given q (B,S,H,D), k, v (B,S,KV,D), the forward's output o and its
// log-sum-exp lse (B,H,S) f32 (m + log l of each query row's scaled,
// softcapped scores), and the output gradient dO (B,S,H,D):
//   s_raw = q kᵀ · scale, t = tanh(s_raw / cap), s = cap · t (no softcap:
//   s = s_raw), masked as the forward masks it (causal, sliding window);
//   P = exp(s - lse);  dP = dO vᵀ;  δ = rowsum(dO ∘ o);
//   dS = P ∘ (dP - δ) [· (1 - t²) with a softcap];
//   dQ = dS k · scale;  dK = dSᵀ q · scale;  dV = Pᵀ dO,
// dK and dV summed over the H/KV query heads of each kv head (GQA),
// the gradients rounded once to the inputs' dtype.
//
// The FA2 split, three kernels on one stream, on either route:
//   1. fab_delta_kernel: δ, one warp a (b, s, h) row, into an f32 scratch
//      (B,H,S) the wrapper allocates;
//   2. dK/dV: one block per (key tile, kv head, b). It holds its K and V
//      tiles, loops over the query heads of its group and over the query
//      tiles that see its key tile (causal: from the tile's own rows on;
//      window: up to its last key + window), recomputes P and dS tile by
//      tile, accumulates dV = Pᵀ dO and dK = dSᵀ q in registers and writes
//      each once: the GQA sum needs no atomics;
//   3. dQ: one block per (query tile, query head, b), looping over the key
//      tiles its rows see (the forward's range), dQ = dS k written once.
// No float atomics anywhere and a fixed order of every sum: two launches on
// the same inputs give the same bits. Fully masked tiles (and, on the
// tensor-core route, a warp's fully masked 16-wide steps) are skipped.
//
// Tensor cores (bf16, D <= 128: fab_mma_*_kernel; plan_flash_bwd's route
// "mma"): 64-row blocks of 4 warps, each warp owning 16 rows (keys for
// dK/dV, queries for dQ). The other side's 64-row tiles (q and dO with
// their lse and δ; or K and V) arrive through a 2-deep ring of 16-byte
// cp.async copies into bf16 rows of DP + 8 elements, D zero-padded to DP,
// a multiple of 16, in shared memory only. A warp takes them 16 columns a
// step: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dQ: S = Q·Kᵀ, dP = dO·Vᵀ) are
// mma.sync m16n8k16 with f32 accumulators from ldmatrix fragments (the
// warp's own fragments stay in registers for DP <= 64); P = exp(s − lse)
// and dS = P∘(dP − δ) [· (1 − t²)]·scale are formed in those registers
// and rounded once to bf16 as the A fragments of dV += Pᵀ·dO and dK +=
// dSᵀ·q (dQ += dS·k), whose B fragments come by ldmatrix.trans: the same
// rounding as the forward's p before P·V. dK and dV (or dQ) stay in f32
// registers, 16 x DP a warp, across every query head of the group.
//
// CUDA cores (f32 in IEEE f32, no TF32; bf16 with D > 128:
// fab_dkdv_kernel, fab_dq_kernel; route "simt"): 256 threads as 16 x 16;
// thread (ty, tx) owns score rows ty + 16·i and key columns tx + 16·j of
// a tile, and of an output tile the rows ty + 16·i and the columns
// tx + 16·j. The q, dO, K and V tiles lie in shared memory as f32 rows of
// DP + 1 floats (an odd stride: the 16 rows a half-warp reads at one column
// fall in 16 banks); P and dS rows of BK + 1. DP <= 128: 64-row query and
// key tiles (166 KB of shared memory at DP 128); DP > 128: 32-row tiles
// (140 KB at DP 256). bf16 inputs are widened as they load.
//
// Bound on an H100 SXM: smollm-360m's training attention (4, 512, 15/5, 64)
// in bf16 does 7 products of 2·S·S·D/2 (causal) a head: the dK/dV kernel
// recomputes q kᵀ and dO vᵀ, and forms Pᵀ dO and dSᵀ q; the dQ kernel
// recomputes both score products and forms dS k: ~7.0 GFLOP, 7 µs at the
// bf16 tensor-core peak, against ~21 MB of q, k, v, o, dO, lse and the
// gradients (6.3 µs): operations. In f32 the CUDA cores' 67 TFLOP/s bound
// it (~105 µs at that shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_bf16_tc.cuh"  // smem_addr, cp.async, load_chunk, ldmatrix, mma

namespace {

constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Per padded width DP: query rows and keys a tile, and the shared row
// strides in floats.
template <int DP>
struct BwdCfg {
  static constexpr int BQ = DP > 128 ? 32 : 64;
  static constexpr int BK = BQ;
  static constexpr int LD = DP + 1;  // q, dO, K, V rows
  static constexpr int LP = BK + 1;  // P, dS rows
};

template <int DP>
constexpr size_t dkdv_smem_floats() {
  using C = BwdCfg<DP>;
  return (size_t)2 * C::BK * C::LD + (size_t)2 * C::BQ * C::LD +
         (size_t)2 * C::BQ * C::LP + (size_t)2 * C::BQ;
}
template <int DP>
constexpr size_t dq_smem_floats() {
  using C = BwdCfg<DP>;
  return (size_t)2 * C::BK * C::LD + (size_t)2 * C::BQ * C::LD +
         (size_t)C::BQ * C::LP + (size_t)2 * C::BQ;
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S) scratch
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV, D, causal, window;
  float scale, cap;  // 1/sqrt(D); softcap (0: none)
  float sl;          // scale·log2e (the tensor-core route's exp2 units)
};

// δ of one (b, s, h) row a warp
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fab_delta_kernel(const BwdArgs a) {
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const long long rows = (long long)a.B * a.S * a.H;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * a.D;
  const T* drow = dout + row * a.D;
  float s = 0.0f;
  for (int d = lane; d < a.D; d += 32)
    s = fmaf(to_f32(orow[d]), to_f32(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const long long bs = row / a.H;
    const int si = (int)(bs % a.S), b = (int)(bs / a.S);
    a.delta[((long long)b * a.H + h) * a.S + si] = s;
  }
}

// rows r0 .. r0 + n - 1 of a (S, ld) slab into shared f32 rows of LD,
// zero past S and past D
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ld, int r0, int n, int S,
                                          int D) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP, s = r0 + r;
    dst[r * LD + d] = s < S && d < D ? to_f32(src[(long long)s * ld + d])
                                     : 0.0f;
  }
}

// lse and δ of query rows q0 .. q0 + BQ - 1 (0 past S)
template <int BQ>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int S) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[q0 + r] : 0.0f;
    dl_s[r] = in ? delta[q0 + r] : 0.0f;
  }
}

// P and dS·scale of the (BQ x BK) tile at (q0, k0): thread (ty, tx) takes
// rows ty + 16·i, columns tx + 16·j. Masked entries (and rows or keys past
// S) give 0.
template <int DP, int BQ, int BK>
__device__ __forceinline__ void score_tile(
    const BwdArgs& a, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* lse_s, const float* dl_s, int q0, int k0,
    float (&p)[BQ / 16][BK / 16], float (&ds)[BQ / 16][BK / 16]) {
  constexpr int LD = DP + 1, RI = BQ / 16, RJ = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RI][RJ], dp[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qa[RI], oa[RI], kb[RJ], vb[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qa[i] = Qs[(ty + 16 * i) * LD + d];
      oa[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      kb[j] = Ks[(tx + 16 * j) * LD + d];
      vb[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const float lr = lse_s[ty + 16 * i], dl = dl_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool ok = row < a.S && col < a.S &&
                      (!a.causal || col <= row) &&
                      (a.window <= 0 || col > row - a.window);
      float x = s[i][j] * a.scale, t = 0.0f;
      if (a.cap > 0.0f) {
        t = tanhf(x / a.cap);
        x = a.cap * t;
      }
      const float pv = ok ? expf(x - lr) : 0.0f;
      float g = pv * (dp[i][j] - dl);
      if (a.cap > 0.0f) g *= 1.0f - t * t;
      p[i][j] = pv;
      ds[i][j] = g * a.scale;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fab_dkdv_kernel(const BwdArgs a) {
  using C = BwdCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int RQ = BQ / 16, RK = BK / 16, CJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* dl_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, rep = H / a.KV;
  const long long qld = (long long)H * D, kvld = (long long)a.KV * D;
  const long long kv_off = (long long)b * S * kvld + (long long)kvh * D;
  load_rows<T, DP>(Ks, static_cast<const T*>(a.k) + kv_off, kvld, k0, BK, S,
                   D);
  load_rows<T, DP>(Vs, static_cast<const T*>(a.v) + kv_off, kvld, k0, BK, S,
                   D);

  float dk[RK][CJ], dv[RK][CJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

  // the query tiles whose rows see some key of this tile
  const int qt0 = a.causal ? k0 / BQ : 0;
  const int q_end = a.window > 0 ? min(S, k0 + BK - 1 + a.window) : S;
  const int qt1 = (q_end + BQ - 1) / BQ;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const long long q_off = (long long)b * S * qld + (long long)h * D;
    const long long st_off = ((long long)b * H + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's q, dO, P and dS are consumed
      load_rows<T, DP>(Qs, static_cast<const T*>(a.q) + q_off, qld, q0, BQ,
                       S, D);
      load_rows<T, DP>(dOs, static_cast<const T*>(a.dout) + q_off, qld, q0,
                       BQ, S, D);
      load_row_stats<BQ>(lse_s, dl_s, a.lse + st_off, a.delta + st_off, q0,
                         S);
      __syncthreads();
      float p[RQ][RK], ds[RQ][RK];
      score_tile<DP, BQ, BK>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, p, ds);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          Ps[(ty + 16 * i) * LP + tx + 16 * j] = p[i][j];
          dSs[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += Pᵀ dO, dK += dSᵀ q: key rows ty + 16·i, columns tx + 16·j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[RK], sa[RK], ob[CJ], qb[CJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pa[i] = Ps[r * LP + ty + 16 * i];
          sa[i] = dSs[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          ob[j] = dOs[r * LD + tx + 16 * j];
          qb[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
            dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + kv_off;
  T* dvp = static_cast<T*>(a.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= D) continue;
      dkp[(long long)key * kvld + d] = from_f32<T>(dk[i][j]);
      dvp[(long long)key * kvld + d] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fab_dq_kernel(const BwdArgs a) {
  using C = BwdCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int RQ = BQ / 16, RK = BK / 16, CJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* dSs = dOs + BQ * LD;
  float* lse_s = dSs + BQ * LP;
  float* dl_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, kvh = h / (H / a.KV);
  const long long qld = (long long)H * D, kvld = (long long)a.KV * D;
  const long long q_off = (long long)b * S * qld + (long long)h * D;
  const long long kv_off = (long long)b * S * kvld + (long long)kvh * D;
  const long long st_off = ((long long)b * H + h) * S;
  load_rows<T, DP>(Qs, static_cast<const T*>(a.q) + q_off, qld, q0, BQ, S,
                   D);
  load_rows<T, DP>(dOs, static_cast<const T*>(a.dout) + q_off, qld, q0, BQ,
                   S, D);
  load_row_stats<BQ>(lse_s, dl_s, a.lse + st_off, a.delta + st_off, q0, S);

  float dq[RQ][CJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dq[i][j] = 0.0f;

  // the key tiles some row of this query tile sees (the forward's range)
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;  // exclusive
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt1 = (k_end + BK - 1) / BK;
  for (int kt = k_begin / BK; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous K, V and dS are consumed
    load_rows<T, DP>(Ks, static_cast<const T*>(a.k) + kv_off, kvld, k0, BK,
                     S, D);
    load_rows<T, DP>(Vs, static_cast<const T*>(a.v) + kv_off, kvld, k0, BK,
                     S, D);
    __syncthreads();
    float p[RQ][RK], ds[RQ][RK];
    score_tile<DP, BQ, BK>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j)
        dSs[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K: query rows ty + 16·i, columns tx + 16·j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sa[RQ], kb[CJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sa[i] = dSs[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kb[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + q_off;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dqp[(long long)row * qld + d] = from_f32<T>(dq[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D <= 128: every product on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc = repro_torch::tc;

constexpr int kMmaRows = 64;     // keys (dK/dV) or queries (dQ) a block
constexpr int kMmaCols = 64;     // queries or keys a ring stage
constexpr int kMmaThreads = 128; // 4 warps of 16 rows

// Shared layout of the mma kernels at padded width DP (a multiple of 16):
// bf16 rows of DP + 8 elements (the 16-byte pad puts the 8 rows of an
// ldmatrix phase in 8 bank groups).
template <int DP>
struct MmaCfg {
  static constexpr int LD = DP + 8;
  static constexpr int TILE = kMmaRows * LD * 2;    // bytes of a 64-row tile
  static constexpr int KT = DP / 16;                // 16-deep steps over D
  static constexpr int NB = DP / 8;                 // 8-wide blocks of D
  // the warp's own A fragments held in registers where they fit
  static constexpr bool AREG = DP <= 64;
  // two fixed tiles, a 2-deep ring of NS items of two tiles each, and
  // per item of a stage its lse and δ
  template <int NS = 1>
  static constexpr int smem() {
    return 2 * TILE + 2 * NS * 2 * TILE + 2 * NS * 2 * kMmaCols * 4;
  }
};

// rows r0 .. r0 + 63 of a (S, ld) bf16 slab into a shared tile of DP + 8
// columns by 16-byte cp.async copies (element loads where !vec), zero
// past S and past D
template <int DP>
__device__ __forceinline__ void mma_load_tile(uint32_t dst,
                                              const __nv_bfloat16* src,
                                              long long ld, int r0, int S,
                                              int D, int vec) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < kMmaRows * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    tc::load_chunk(dst + (r * MmaCfg<DP>::LD + c * 8) * 2, src, ld, r0 + r,
                   S, c * 8, D, vec);
  }
}

// The 16 x 16 step both kernels take: the warp's 16 rows (A: its tile at
// `ra` for the scores, at `rb` for the output gradient's product) against
// 16 columns of the other side (`ca`, `cb`: the column tile's rows), in
// f32 accumulators: s = A_a · C_aᵀ and dp = A_b · C_bᵀ. Fragments of the
// warp's rows come from `af`/`bf` when AREG, else from shared memory.
template <int DP>
__device__ __forceinline__ void mma_scores(
    float (&s)[2][4], float (&dp)[2][4], uint32_t ra, uint32_t rb,
    uint32_t ca, uint32_t cb, const uint32_t (*af)[4],
    const uint32_t (*bf)[4]) {
  using C = MmaCfg<DP>;
  const int lane = threadIdx.x % 32;
  // ldmatrix lane addresses: A rows lane % 16, columns (lane / 16)·8; the
  // column side's rows (lane / 16)·8 + lane % 8, columns ((lane / 8) % 2)·8
  const uint32_t a_off = ((lane % 16) * C::LD + (lane / 16) * 8) * 2;
  const uint32_t c_off =
      (((lane / 16) * 8 + (lane % 8)) * C::LD + ((lane / 8) % 2) * 8) * 2;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < C::KT; ++kt) {
    uint32_t aa[4], ab[4], xa[4], xb[4];
    if constexpr (C::AREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        aa[e] = af[kt][e];
        ab[e] = bf[kt][e];
      }
    } else {
      tc::ldmatrix_x4(aa, ra + a_off + kt * 32);
      tc::ldmatrix_x4(ab, rb + a_off + kt * 32);
    }
    tc::ldmatrix_x4(xa, ca + c_off + kt * 32);
    tc::ldmatrix_x4(xb, cb + c_off + kt * 32);
    tc::mma_16816(s[0], aa, xa[0], xa[1]);
    tc::mma_16816(s[1], aa, xa[2], xa[3]);
    tc::mma_16816(dp[0], ab, xb[0], xb[1]);
    tc::mma_16816(dp[1], ab, xb[2], xb[3]);
  }
}

// acc (16 x DP) += a (16 x 16, an A fragment) · X (16 x DP): X's 16 rows
// at `x` (row-major, D contiguous: ldmatrix.trans)
template <int DP>
__device__ __forceinline__ void mma_accumulate(float (&acc)[DP / 8][4],
                                               const uint32_t (&a)[4],
                                               uint32_t x) {
  using C = MmaCfg<DP>;
  const int lane = threadIdx.x % 32;
  const uint32_t t_off =
      ((((lane / 8) % 2) * 8 + (lane % 8)) * C::LD + (lane / 16) * 8) * 2;
#pragma unroll
  for (int np = 0; np < C::NB / 2; ++np) {
    uint32_t b[4];
    tc::ldmatrix_x4_trans(b, x + t_off + np * 32);
    tc::mma_16816(acc[2 * np], a, b[0], b[1]);
    tc::mma_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// The warp's A fragments of a 16-row slice of D (registers, AREG)
template <int DP>
__device__ __forceinline__ void mma_frags(uint32_t (*f)[4], uint32_t rows) {
  using C = MmaCfg<DP>;
  const int lane = threadIdx.x % 32;
  const uint32_t a_off = ((lane % 16) * C::LD + (lane / 16) * 8) * 2;
#pragma unroll
  for (int kt = 0; kt < C::KT; ++kt) tc::ldmatrix_x4(f[kt], rows + a_off + kt * 32);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (2 ulp; p is rounded to bf16 for its product)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p and dS·scale of the step's eight accumulator elements (block n,
// element e): s the raw scores, dp the dO·v products, lse2 (the row's
// lse in log2 units) and dl (δ) of element (n, e) by lse2(n, e),
// dl(n, e). Off every mask edge and without a softcap (`plain`),
// p = 2^(s·scale·log2e − lse2); otherwise the scaled, softcapped score
// and the mask vis(n, e).
template <typename L, typename M, typename V>
__device__ __forceinline__ void p_ds(const BwdArgs& a, bool plain,
                                     const float (&s)[2][4],
                                     const float (&dp)[2][4], const L& lse2,
                                     const M& dl, const V& vis,
                                     float (&p)[2][4], float (&ds)[2][4]) {
  if (plain) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = fast_exp2(fmaf(s[n][e], a.sl, -lse2(n, e)));
        ds[n][e] = p[n][e] * (dp[n][e] - dl(n, e)) * a.scale;
      }
    return;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * a.scale, t = 0.0f;
      if (a.cap > 0.0f) {
        t = tanhf(x / a.cap);
        x = a.cap * t;
      }
      const float pv =
          vis(n, e) ? fast_exp2(fmaf(x, kLog2e, -lse2(n, e))) : 0.0f;
      float g = pv * (dp[n][e] - dl(n, e));
      if (a.cap > 0.0f) g *= 1.0f - t * t;
      p[n][e] = pv;
      ds[n][e] = g * a.scale;
    }
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int q, int key) {
  return q < a.S && key < a.S && (!a.causal || key <= q) &&
         (a.window <= 0 || key > q - a.window);
}

// lse (in log2 units) and δ of query rows q0 .. q0 + 63 into shared (0
// past S)
__device__ __forceinline__ void mma_load_stats(float* lse_s, float* dl_s,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int S) {
  for (int r = threadIdx.x; r < kMmaCols; r += blockDim.x) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[q0 + r] * kLog2e : 0.0f;
    dl_s[r] = in ? delta[q0 + r] : 0.0f;
  }
}

// bf16 stores of a warp's 16 x DP f32 accumulator: rows row0 + g and
// row0 + g + 8 (those below S) at `dst` with row stride ld, columns < D
template <int DP>
__device__ __forceinline__ void mma_store(__nv_bfloat16* dst, long long ld,
                                          int row0, int S, int D, int vec2,
                                          const float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* rp = dst + (long long)row * ld;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int c = nb * 8 + 2 * tq;
      const float v0 = acc[nb][2 * h], v1 = acc[nb][2 * h + 1];
      if (vec2 && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(rp + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < D) rp[c] = __float2bfloat16_rn(v0);
        if (c + 1 < D) rp[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// One 16-query step of a dK/dV warp: Sᵀ and dPᵀ of its 16 keys against
// queries q0 + 16j .. + 15 of the stage's tiles (qs, dos; their lse and δ
// at lse_s, dl_s), Pᵀ and dSᵀ rounded to bf16, dV += Pᵀ·dO, dK += dSᵀ·Q.
template <int DP>
__device__ __forceinline__ void dkdv_step(
    const BwdArgs& a, int j, int q0, int kw0, uint32_t kw_a, uint32_t vw_a,
    uint32_t qs, uint32_t dos, const float* lse_s, const float* dl_s,
    const uint32_t (*kf)[4], const uint32_t (*vf)[4],
    float (&dk)[DP / 8][4], float (&dv)[DP / 8][4]) {
  using C = MmaCfg<DP>;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const uint32_t crow = 16 * j * C::LD * 2;
  float s[2][4], dp[2][4];
  mma_scores<DP>(s, dp, kw_a, vw_a, qs + crow, dos + crow, kf, vf);
  // element e of block n: key kw0 + g (+8 for e >= 2), query
  // q0 + 16j + 8n + 2tq + (e & 1); the masks matter on a step that
  // crosses the diagonal, the window's edge or S
  const int qj = q0 + 16 * j, c0 = 16 * j + 2 * tq;
  const bool plain = a.cap <= 0.0f && !(a.causal && kw0 + 15 > qj) &&
                     !(a.window > 0 && kw0 <= qj + 15 - a.window) &&
                     qj + 15 < a.S && kw0 + 15 < a.S;
  float p[2][4], ds[2][4];
  p_ds(
      a, plain, s, dp,
      [&](int n, int e) { return lse_s[c0 + 8 * n + (e & 1)]; },
      [&](int n, int e) { return dl_s[c0 + 8 * n + (e & 1)]; },
      [&](int n, int e) {
        return visible(a, q0 + c0 + 8 * n + (e & 1), kw0 + g + (e >> 1) * 8);
      },
      p, ds);
  const uint32_t pa[4] = {tc::pack_bf16(p[0][0], p[0][1]),
                          tc::pack_bf16(p[0][2], p[0][3]),
                          tc::pack_bf16(p[1][0], p[1][1]),
                          tc::pack_bf16(p[1][2], p[1][3])};
  const uint32_t sa[4] = {tc::pack_bf16(ds[0][0], ds[0][1]),
                          tc::pack_bf16(ds[0][2], ds[0][3]),
                          tc::pack_bf16(ds[1][0], ds[1][1]),
                          tc::pack_bf16(ds[1][2], ds[1][3])};
  mma_accumulate<DP>(dv, pa, dos + crow);
  mma_accumulate<DP>(dk, sa, qs + crow);
}

// One 16-key step of a dQ warp: S and dP of its 16 query rows (lse and δ
// of rows g and g + 8 in lse_r, dl_r) against keys kr + 16j .. + 15 of
// the stage's tiles (kk, vv), dS rounded to bf16, dQ += dS·K.
template <int DP>
__device__ __forceinline__ void dq_step(
    const BwdArgs& a, int j, int kr, int qw0, uint32_t qw_a, uint32_t ow_a,
    uint32_t kk, uint32_t vv, const float (&lse_r)[2], const float (&dl_r)[2],
    const uint32_t (*qf)[4], const uint32_t (*of)[4],
    float (&dq)[DP / 8][4]) {
  using C = MmaCfg<DP>;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const uint32_t crow = 16 * j * C::LD * 2;
  float s[2][4], dp[2][4];
  mma_scores<DP>(s, dp, qw_a, ow_a, kk + crow, vv + crow, qf, of);
  // element e of block n: query qw0 + g (+8 for e >= 2), key
  // kr + 16j + 8n + 2tq + (e & 1); the masks matter on a step that
  // crosses the diagonal, the window's edge or S
  const int kj = kr + 16 * j;
  const bool plain = a.cap <= 0.0f && !(a.causal && kj + 15 > qw0) &&
                     !(a.window > 0 && kj <= qw0 + 15 - a.window) &&
                     kj + 15 < a.S && qw0 + 15 < a.S;
  float p[2][4], ds[2][4];
  p_ds(
      a, plain, s, dp, [&](int, int e) { return lse_r[e >> 1]; },
      [&](int, int e) { return dl_r[e >> 1]; },
      [&](int n, int e) {
        return visible(a, qw0 + g + 8 * (e >> 1), kj + 8 * n + 2 * tq +
                                                      (e & 1));
      },
      p, ds);
  const uint32_t sa[4] = {tc::pack_bf16(ds[0][0], ds[0][1]),
                          tc::pack_bf16(ds[0][2], ds[0][3]),
                          tc::pack_bf16(ds[1][0], ds[1][1]),
                          tc::pack_bf16(ds[1][2], ds[1][3])};
  mma_accumulate<DP>(dq, sa, kk + crow);
}

// ceil(x / 16) for any x, floored at 0
__device__ __forceinline__ int steps_to(int x) {
  return x > 0 ? (x + 15) / 16 : 0;
}

// dK and dV of 64 keys of one kv head: warp w of each of NS warp groups
// owns keys k0 + 16(w mod 4) .. + 15. The block walks (query head of the
// group, query tile) items in order, NS at a time (group g takes item
// t·NS + g of stage t), through a 2-deep ring of q, dO, lse and δ; each
// 16-query step recomputes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, forms Pᵀ and dSᵀ in
// registers, rounds them once to bf16 as A fragments, and adds Pᵀ·dO to dV
// and dSᵀ·Q to dK in f32 registers: the GQA sum stays in registers. With
// NS > 1 the groups' sums meet at the end through shared memory, added in
// group order (no atomics): twice the warps on a causal grid whose
// heaviest blocks (the first key tiles) set its time.
template <int DP, int NS>
__global__ void __launch_bounds__(kMmaThreads * NS)
    fab_mma_dkdv_kernel(const BwdArgs a, int vec) {
  using C = MmaCfg<DP>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t ks_a = tc::smem_addr(mma_smem);
  const uint32_t vs_a = ks_a + C::TILE;
  const uint32_t ring = vs_a + C::TILE;  // stage, item: q, then dO
  float* stats =
      reinterpret_cast<float*>(mma_smem + (2 + 4 * NS) * C::TILE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, grp = warp / 4;
  const int k0 = blockIdx.x * kMmaRows, kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, rep = H / a.KV;
  const long long qld = (long long)H * D, kvld = (long long)a.KV * D;
  const long long kv_off = (long long)b * S * kvld + (long long)kvh * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
  const int kw0 = k0 + 16 * wr;  // the warp's first key

  // the query tiles whose rows see some key of this tile
  const int qt0 = a.causal ? k0 / kMmaCols : 0;
  const int q_end = a.window > 0 ? min(S, k0 + kMmaRows - 1 + a.window) : S;
  const int nq = (q_end + kMmaCols - 1) / kMmaCols - qt0;
  const int items = rep * nq;
  const int stages = (items + NS - 1) / NS;

  // item i into item slot j of ring stage `slot`
  auto slot_q = [&](int slot, int j) {
    return ring + (slot * NS + j) * 2 * C::TILE;
  };
  auto slot_stats = [&](int slot, int j) {
    return stats + (slot * NS + j) * 2 * kMmaCols;
  };
  auto load_stage = [&](int t, int slot) {
    for (int j = 0; j < NS; ++j) {
      const int i = t * NS + j;
      if (i >= items) break;
      const int h = kvh * rep + i / nq, q0 = (qt0 + i % nq) * kMmaCols;
      const long long q_off = (long long)b * S * qld + (long long)h * D;
      const uint32_t qs = slot_q(slot, j);
      mma_load_tile<DP>(qs, q + q_off, qld, q0, S, D, vec);
      mma_load_tile<DP>(qs + C::TILE, dout + q_off, qld, q0, S, D, vec);
      const long long st_off = ((long long)b * H + h) * S;
      mma_load_stats(slot_stats(slot, j), slot_stats(slot, j) + kMmaCols,
                     a.lse + st_off, a.delta + st_off, q0, S);
    }
  };

  mma_load_tile<DP>(ks_a, static_cast<const __nv_bfloat16*>(a.k) + kv_off,
                    kvld, k0, S, D, vec);
  mma_load_tile<DP>(vs_a, static_cast<const __nv_bfloat16*>(a.v) + kv_off,
                    kvld, k0, S, D, vec);
  if (stages > 0) load_stage(0, 0);
  tc::cp_async_commit();

  float dk[C::NB][4], dv[C::NB][4];
#pragma unroll
  for (int n = 0; n < C::NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  uint32_t kf[C::AREG ? C::KT : 1][4], vf[C::AREG ? C::KT : 1][4];
  const uint32_t kw_a = ks_a + 16 * wr * C::LD * 2;
  const uint32_t vw_a = vs_a + 16 * wr * C::LD * 2;

  for (int t = 0; t < stages; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // stage t landed; slot (t + 1) % 2 is no longer read
    if (t + 1 < stages) load_stage(t + 1, (t + 1) % 2);
    tc::cp_async_commit();
    if constexpr (C::AREG) {
      if (t == 0) {
        mma_frags<DP>(kf, kw_a);
        mma_frags<DP>(vf, vw_a);
      }
    }
    const int i = t * NS + grp;
    if (kw0 >= S || i >= items) continue;
    const int q0 = (qt0 + i % nq) * kMmaCols;
    const uint32_t qs = slot_q(t % 2, grp), dos = qs + C::TILE;
    const float* lse_s = slot_stats(t % 2, grp);
    const float* dl_s = lse_s + kMmaCols;
    // the steps whose queries see some of the warp's keys: causal, from
    // the first query >= kw0 - 15; window, below kw0 + 15 + window; S
    const int jlo = a.causal ? steps_to(kw0 - 15 - q0) : 0;
    int jhi = min(kMmaCols / 16, steps_to(S - q0));
    if (a.window > 0) jhi = min(jhi, steps_to(kw0 + 15 + a.window - q0));
#pragma unroll 1
    for (int j = jlo; j < jhi; ++j)
      dkdv_step<DP>(a, j, q0, kw0, kw_a, vw_a, qs, dos, lse_s, dl_s, kf, vf,
                    dk, dv);
  }
  tc::cp_async_wait<0>();

  if constexpr (NS > 1) {
    // groups 1.. hand their sums to group 0 through the ring, which group
    // 0 adds in group order: the same bits every launch
    __syncthreads();  // every warp is done with the ring
    float* mb = reinterpret_cast<float*>(mma_smem + 2 * C::TILE);
    constexpr int PER = 8 * C::NB;  // floats a lane: dk, dv
    const int slot = wr * 32 + lane;
    if (grp > 0) {
      float* dst = mb + ((size_t)(grp - 1) * 128 + slot) * PER;
#pragma unroll
      for (int n = 0; n < C::NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[n * 4 + e] = dk[n][e];
          dst[4 * C::NB + n * 4 + e] = dv[n][e];
        }
    }
    __syncthreads();
    if (grp > 0) return;
    for (int gi = 1; gi < NS; ++gi) {
      const float* src = mb + ((size_t)(gi - 1) * 128 + slot) * PER;
#pragma unroll
      for (int n = 0; n < C::NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[n][e] += src[n * 4 + e];
          dv[n][e] += src[4 * C::NB + n * 4 + e];
        }
    }
  }

  mma_store<DP>(static_cast<__nv_bfloat16*>(a.dk) + kv_off, kvld, kw0, S, D,
                vec, dk);
  mma_store<DP>(static_cast<__nv_bfloat16*>(a.dv) + kv_off, kvld, kw0, S, D,
                vec, dv);
}

// dQ of 64 query rows of one head: warp w owns rows q0 + 16w .. + 15.
// The block walks the key tiles its rows see through a 2-deep ring of K
// and V; each 16-key step recomputes S = Q·Kᵀ and dP = dO·Vᵀ, forms dS in
// registers, rounds it once to bf16 as an A fragment and adds dS·K to dQ.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    fab_mma_dq_kernel(const BwdArgs a, int vec) {
  using C = MmaCfg<DP>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t qs_a = tc::smem_addr(mma_smem);
  const uint32_t dos_a = qs_a + C::TILE;
  const uint32_t ring = dos_a + C::TILE;          // slot j: K, then V

  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, kvh = h / (H / a.KV);
  const long long qld = (long long)H * D, kvld = (long long)a.KV * D;
  const long long q_off = (long long)b * S * qld + (long long)h * D;
  const long long kv_off = (long long)b * S * kvld + (long long)kvh * D;
  const long long st_off = ((long long)b * H + h) * S;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + kv_off;
  const int qw0 = q0 + 16 * warp;  // the warp's first query row

  // the key tiles some row of this query tile sees (the forward's range)
  const int q_last = min(q0 + kMmaRows, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;  // exclusive
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_begin / kMmaCols;
  const int nk = (k_end + kMmaCols - 1) / kMmaCols - kt0;

  auto load_item = [&](int i, int slot) {
    const uint32_t kk = ring + slot * 2 * C::TILE;
    const int kr = (kt0 + i) * kMmaCols;
    mma_load_tile<DP>(kk, k, kvld, kr, S, D, vec);
    mma_load_tile<DP>(kk + C::TILE, v, kvld, kr, S, D, vec);
  };

  mma_load_tile<DP>(qs_a, static_cast<const __nv_bfloat16*>(a.q) + q_off,
                    qld, q0, S, D, vec);
  mma_load_tile<DP>(dos_a, static_cast<const __nv_bfloat16*>(a.dout) + q_off,
                    qld, q0, S, D, vec);
  if (nk > 0) load_item(0, 0);
  tc::cp_async_commit();

  // the rows' lse and δ (rows g and g + 8 of the warp)
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + g + 8 * r;
    lse_r[r] = row < S ? a.lse[st_off + row] * kLog2e : 0.0f;
    dl_r[r] = row < S ? a.delta[st_off + row] : 0.0f;
  }

  float dq[C::NB][4];
#pragma unroll
  for (int n = 0; n < C::NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  uint32_t qf[C::AREG ? C::KT : 1][4], of[C::AREG ? C::KT : 1][4];
  const uint32_t qw_a = qs_a + 16 * warp * C::LD * 2;
  const uint32_t ow_a = dos_a + 16 * warp * C::LD * 2;

  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile i landed; slot (i + 1) % 2 is no longer read
    if (i + 1 < nk) load_item(i + 1, (i + 1) % 2);
    tc::cp_async_commit();
    if constexpr (C::AREG) {
      if (i == 0) {
        mma_frags<DP>(qf, qw_a);
        mma_frags<DP>(of, ow_a);
      }
    }
    if (qw0 >= S) continue;
    const int kr = (kt0 + i) * kMmaCols;
    const uint32_t kk = ring + (i % 2) * 2 * C::TILE, vv = kk + C::TILE;
    // the steps whose keys the warp's rows see: causal, up to key
    // qw0 + 15; window, from the first key > qw0 - window - 15; S
    int jhi = min(kMmaCols / 16, steps_to(S - kr));
    if (a.causal) jhi = min(jhi, steps_to(qw0 + 16 - kr));
    const int jlo =
        a.window > 0 ? steps_to(qw0 - a.window - 15 - kr + 1) : 0;
#pragma unroll 1
    for (int j = jlo; j < jhi; ++j)
      dq_step<DP>(a, j, kr, qw0, qw_a, ow_a, kk, vv, lse_r, dl_r, qf, of,
                  dq);
  }
  tc::cp_async_wait<0>();
  mma_store<DP>(static_cast<__nv_bfloat16*>(a.dq) + q_off, qld, qw0, S, D,
                vec, dq);
}

template <int DP, int NS>
int launch_mma(const BwdArgs& a, int vec, cudaStream_t st) {
  using C = MmaCfg<DP>;
  constexpr int kv_smem = C::template smem<NS>(), q_smem = C::smem();
  cudaError_t err = cudaFuncSetAttribute(
      fab_mma_dkdv_kernel<DP, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fab_mma_dq_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)a.B * a.S * a.H;
  const int warps = kThreads / 32;
  fab_delta_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g_kv((a.S + kMmaRows - 1) / kMmaRows, a.KV, a.B);
  fab_mma_dkdv_kernel<DP, NS>
      <<<g_kv, kMmaThreads * NS, kv_smem, st>>>(a, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g_q((a.S + kMmaRows - 1) / kMmaRows, a.H, a.B);
  fab_mma_dq_kernel<DP><<<g_q, kMmaThreads, q_smem, st>>>(a, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch(const BwdArgs& a, cudaStream_t st) {
  using C = BwdCfg<DP>;
  const size_t kv_smem = dkdv_smem_floats<DP>() * sizeof(float);
  const size_t q_smem = dq_smem_floats<DP>() * sizeof(float);
  // set before every launch: libraries built from one header share its
  // templates' statics, so no flag caches it
  cudaError_t err = cudaFuncSetAttribute(
      fab_dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fab_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)a.B * a.S * a.H;
  const int warps = kThreads / 32;
  fab_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                        st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g_kv((a.S + C::BK - 1) / C::BK, a.KV, a.B);
  fab_dkdv_kernel<T, DP><<<g_kv, kThreads, kv_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g_q((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  fab_dq_kernel<T, DP><<<g_q, kThreads, q_smem, st>>>(a);
  return (int)cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int B, int S, int H, int KV, int D,
                  int causal, int window, float softcap) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  a.cap = softcap > 0.0f ? softcap : 0.0f;
  a.sl = a.scale * 1.4426950408889634f;
  return a;
}

inline int check_args(int B, int S, int H, int KV, int D, int dp) {
  if (B > 65535 || KV <= 0 || H % KV != 0 || H > 65535 || D <= 0 ||
      D > 256 || dp < D)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// q, o, dout, dq (B,S,H,D); k, v, dk, dv (B,S,KV,D); lse and the delta
// scratch (B,H,S) f32. window <= 0: no sliding window; softcap <= 0: none.
// dp: D padded to a compiled width, and (bf16) route and split, as
// plan_flash_bwd decided: f32 on the CUDA cores at the forward's f32
// widths; bf16 route 1 on the tensor cores at a multiple of 16 up to 128,
// the dK/dV blocks' query items split over `split` (1 or 2) warp groups,
// route 0 on the CUDA cores at 192 or 256.
int repro_flash_attention_bwd_f32(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* dout, const float* lse,
                                  float* delta, float* dq, float* dk,
                                  float* dv, int B, int S, int H, int KV,
                                  int D, int causal, int window,
                                  float softcap, int dp, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (int err = check_args(B, S, H, KV, D, dp)) return err;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              H, KV, D, causal, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FAB_F32(W) \
  case W:                \
    return launch<float, W>(a, st);
  switch (dp) {
    REPRO_FAB_F32(32)
    REPRO_FAB_F32(64)
    REPRO_FAB_F32(96)
    REPRO_FAB_F32(128)
    REPRO_FAB_F32(192)
    REPRO_FAB_F32(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FAB_F32
}

int repro_flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
    float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    int B, int S, int H, int KV, int D, int causal, int window, float softcap,
    int dp, int route, int split, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (int err = check_args(B, S, H, KV, D, dp)) return err;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              H, KV, D, causal, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {  // the tensor cores: dp a multiple of 16 up to 128
    if (split != 1 && split != 2) return (int)cudaErrorInvalidValue;
    const uintptr_t any =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
        reinterpret_cast<uintptr_t>(dv);
    const int vec = D % 8 == 0 && (any & 15) == 0;
#define REPRO_FAB_MMA(W)                                  \
  case W:                                                 \
    return split == 2 ? launch_mma<W, 2>(a, vec, st)      \
                      : launch_mma<W, 1>(a, vec, st);
    switch (dp) {
      REPRO_FAB_MMA(16)
      REPRO_FAB_MMA(32)
      REPRO_FAB_MMA(48)
      REPRO_FAB_MMA(64)
      REPRO_FAB_MMA(80)
      REPRO_FAB_MMA(96)
      REPRO_FAB_MMA(112)
      REPRO_FAB_MMA(128)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef REPRO_FAB_MMA
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  // the CUDA cores, D > 128
#define REPRO_FAB_BF16(W) \
  case W:                 \
    return launch<__nv_bfloat16, W>(a, st);
  switch (dp) {
    REPRO_FAB_BF16(192)
    REPRO_FAB_BF16(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FAB_BF16
}

}  // extern "C"
