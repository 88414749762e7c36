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
// dK and dV summed over the H/KV query heads of each kv head (GQA). All
// arithmetic is f32 (IEEE, CUDA cores), bf16 inputs widened as they are
// loaded and the gradients rounded once to the inputs' dtype.
//
// The FA2 split, three kernels on one stream:
//   1. fab_delta_kernel: δ, one warp a (b, s, h) row, into an f32 scratch
//      (B,H,S) the wrapper allocates;
//   2. fab_dkdv_kernel: one block per (key tile, kv head, b). It holds its
//      K and V tiles, loops over the query heads of its group and over the
//      query tiles that see its key tile (causal: from the tile's own rows
//      on; window: up to its last key + window), recomputes P and dS tile by
//      tile, accumulates dV = Pᵀ dO and dK = dSᵀ q in registers and writes
//      each once: the GQA sum needs no atomics;
//   3. fab_dq_kernel: one block per (query tile, query head, b), looping over
//      the key tiles its rows see (the forward's range), dQ = dS k written
//      once.
// No float atomics anywhere and a fixed order of every sum: two launches on
// the same inputs give the same bits.
//
// Tiles: 256 threads as 16 x 16; thread (ty, tx) owns score rows ty + 16·i
// and key columns tx + 16·j of a tile, and of an output tile the rows
// ty + 16·i and the columns tx + 16·j. The q, dO, K and V tiles lie in
// shared memory as f32 rows of DP + 1 floats (an odd stride: the 16 rows a
// half-warp reads at one column fall in 16 banks); P and dS rows of BK + 1.
// DP <= 128: 64-row query and key tiles (166 KB of shared memory at DP
// 128); DP > 128: 32-row tiles (140 KB at DP 256). D is zero-padded to DP
// in shared memory only; gradient columns >= D are not stored.
//
// Bound on an H100 SXM: smollm-360m's training attention (4, 512, 15/5, 64)
// in bf16 does 7 products of 2·S·S·D/2 (causal) a head: the dK/dV kernel
// recomputes q kᵀ and dO vᵀ, and forms Pᵀ dO and dSᵀ q; the dQ kernel
// recomputes both score products and forms dS k: ~7.0 GFLOP, 7 µs at the
// bf16 tensor-core peak, against ~21 MB of q, k, v, o, dO, lse and the
// gradients (6.3 µs): operations. This simple kernel runs them on the CUDA
// cores (67 TFLOP/s f32 peak): the tensor cores (mma.sync or wgmma) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
// dp: D padded to a compiled width (the forward's widths for the dtype).
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
    int dp, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (int err = check_args(B, S, H, KV, D, dp)) return err;
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              H, KV, D, causal, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FAB_BF16(W) \
  case W:                 \
    return launch<__nv_bfloat16, W>(a, st);
  switch (dp) {
    REPRO_FAB_BF16(32)
    REPRO_FAB_BF16(64)
    REPRO_FAB_BF16(80)
    REPRO_FAB_BF16(96)
    REPRO_FAB_BF16(112)
    REPRO_FAB_BF16(128)
    REPRO_FAB_BF16(192)
    REPRO_FAB_BF16(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FAB_BF16
}

}  // extern "C"
