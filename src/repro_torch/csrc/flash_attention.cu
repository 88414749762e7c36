// flash_attention: the Hopper (sm_90a) port of the Pallas prefill kernel in
// repro/kernels/attention.py (_fa_kernel, flash_attention). Plain C entry
// points, loaded with ctypes by repro_torch/kernels/_native.py.
//
// out(B,S,H,D) = softmax(mask(softcap(q k^T / sqrt(D)))) v, with q (B,S,H,D)
// and k, v (B,S,KV,D), all contiguous; query head h reads kv head
// h / (H/KV) (GQA). Masks: causal (col <= row), sliding window
// (col > row - window) and the ragged end of S (col < S), all applied in
// the kernel: nothing is padded in device memory.
//
// The TPU kernel walks the key blocks on a sequential grid axis and keeps
// m, l and acc in VMEM scratch across it. Hopper's blocks run in no order,
// so here one block owns one (b, h, 64-row query tile) and walks the key
// tiles in a loop, with m, l and acc in f32 registers (online softmax).
// Key tiles that the causal and window masks cover completely are skipped.
//
// One block: 256 threads, tiles in shared memory as f32 (converted on load):
//   Qt [D][64+4]   the query tile, transposed, loaded once;
//   Kt [D][64+4]   the key tile, transposed;
//   Vs [64][D]     the value tile;
//   Pt [64][64+4]  the probabilities of the tile, transposed.
// Thread (ty, tx) = (tid / 16, tid % 16) owns score rows ty*4..+3 and
// columns tx*4..+3 (two float4 shared loads per 16 FMAs), and output rows
// ty*4..+3, columns tx*D/16..+D/16-1. The 16 threads of a row group are
// one half-warp, so row max and row sum reduce with four shuffles.
// For bf16 inputs p is rounded to bf16 before P·V, as the Pallas kernel
// casts p to v's dtype; l sums the unrounded p, as there.
//
// Bound on an H100 SXM: at the cold-LLM prefill (B=1, S=64, 15 heads,
// 5 kv heads, D=64, bf16) one launch moves 0.33 MB and its causal half is
// 7.9 MFLOP: 0.1 µs of bytes at 3.35 TB/s, so launch latency bounds it.
// At S=2048 the causal half is 2·2·15·64·2048²/2 ≈ 8 GFLOP, 8 µs at the
// 989 TFLOP/s bf16 tensor-core peak: operations bound it. This first
// kernel runs its products on the CUDA cores in f32 (no mma), so it
// cannot reach that bound; mma/wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks
constexpr int kLdQ = kBQ + kPad;
constexpr int kLdK = kBK + kPad;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p as the P·V product of the Pallas kernel sees it: cast to v's dtype
__device__ __forceinline__ float as_input(float v, const float*) { return v; }
__device__ __forceinline__ float as_input(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)D * kLdQ + (size_t)D * kLdK + (size_t)kBK * D +
         (size_t)kBK * kLdQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int H,
                  int KV, float scale, int causal, int window, float softcap) {
  constexpr int CN = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * kLdQ;
  float* Vs = Kt + D * kLdK;
  float* Pt = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  T* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qt[d * kLdQ + r] = s < S ? load_f32(qb + (size_t)s * q_row + d) : 0.0f;
  }

  // the key tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                 // exclusive
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool in = s < S;
      Kt[d * kLdK + r] = in ? load_f32(kb + (size_t)s * kv_row + d) : 0.0f;
      Vs[r * D + d] = in ? load_f32(vb + (size_t)s * kv_row + d) : 0.0f;
    }
    __syncthreads();

    // scores: (64 x D) · (D x 64)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLdQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kLdK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

    // scale, softcap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float s = sc[i][j] * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        const bool ok = col < S && (!causal || col <= row) &&
                        (window <= 0 || col > row - window);
        sc[i][j] = ok ? s : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no visible key yet keeps m = -inf, l = 0
      const float corr = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            sc[i][j] == -INFINITY ? 0.0f : expf(sc[i][j] - m_new);
        rs += p;
        Pt[(tx * 4 + j) * kLdQ + ty * 4 + i] = as_input(p, q);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P (64 x 64) · V (64 x D)
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * kLdQ + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CN];
#pragma unroll
      for (int c = 0; c < CN; ++c) vv[c] = Vs[kk * D + tx * CN + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < CN; ++c)
      store_f32(ob + (size_t)row * q_row + tx * CN + c, acc[i][c] * inv_l);
  }
}

template <typename T, int D>
int launch_fa(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
              int KV, int causal, int window, float softcap,
              cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, H, KV, 1.0f / sqrtf((float)D), causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fa(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
                int KV, int D, int causal, int window, float softcap,
                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_fa<T, 32>(q, k, v, o, B, S, H, KV, causal, window,
                              softcap, st);
    case 64:
      return launch_fa<T, 64>(q, k, v, o, B, S, H, KV, causal, window,
                              softcap, st);
    case 128:
      return launch_fa<T, 128>(q, k, v, o, B, S, H, KV, causal, window,
                               softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// window <= 0: no sliding window; softcap <= 0: no softcap.
int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                              float* o, int B, int S, int H, int KV, int D,
                              int causal, int window, float softcap,
                              void* stream) {
  return dispatch_fa<float>(q, k, v, o, B, S, H, KV, D, causal, window,
                            softcap, stream);
}

int repro_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               int B, int S, int H, int KV, int D, int causal,
                               int window, float softcap, void* stream) {
  return dispatch_fa<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal,
                                    window, softcap, stream);
}

}  // extern "C"
