// ssd_scan: the Hopper port of the Pallas kernel in repro/kernels/ssd.py
// (_ssd_kernel), the Mamba2 SSD chunked scan, extended to what the model's
// ssd_chunked computes: an optional initial state and the final state.
//
//   x (B,S,H,P) and Bm, Cm (B,S,N) in float or bf16 (G = 1: B and C shared
//   by every head); dt (B,S,H), A (H), D (H) and the states f32.
//   Per chunk of Q tokens, with cum the within-chunk cumulative sum of dt·A:
//     y_i   = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i·state + D x_i
//     state = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
//   y in x's dtype; state (P,N) per (b, h), as ssd_chunked returns it.
//
// The Pallas kernel walks a sequential grid axis over the chunks and holds
// two (Q,N) tiles, a (Q,Q) tile and the state in VMEM: at Q 256, N 128 that
// is about 0.5 MB, while a Hopper block has at most 227 KB of shared memory.
// Here one block per (h, b) loops over the chunks itself and keeps the
// (N,P) state in shared memory across them; inside a chunk it works on
// 64-row sub-tiles: for each row tile i, C_i against the state, then C_i
// against B_j for the column tiles j <= i only (the tiles above the
// diagonal are all masked and never computed), the decay applied where
// i >= j only (above the diagonal cum_i - cum_j > 0 and exp may overflow;
// inf·0 would be NaN), then (C_i B_j^T ∘ L dt) x_j. The state update is a
// last pass over the column tiles. Every product is an IEEE f32 FMA on the
// CUDA cores (no TF32: the reference's einsums are f32); each thread holds
// a 4x4 (8x4 for the state) tile of outputs and reads its operands from
// shared memory as float4. P <= 64 and N <= 128; ragged P, N and Q are
// masked in the kernel; a larger P or N is refused (cudaErrorInvalidValue).
//
// Bound on an H100 SXM: the f32 operations. mamba2-2.7b (H 80, P 64, N 128,
// Q 256) at S 1024 needs 4.07 GFLOP over the lower triangle of each chunk,
// C·B^T once per (b, chunk) since G = 1 (0.061 ms at 67 TFLOP/s), against
// about 24 MB of traffic (0.007 ms). This kernel recomputes C·B^T in every
// head's block, 6.7 GFLOP in all. One block per (b, h) gives 80 blocks at
// B 1 on 132 SMs, one block an SM (138 KB of shared memory); sharing C·B^T
// across heads and tensor-core tiles are later work.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kT = 64;         // rows of a sub-tile of a chunk (i and j)
constexpr int kPMax = 64;      // largest head dim P
constexpr int kNMax = 128;     // largest state dim N
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 outputs each
constexpr int kLd = kT + 4;    // padded row of a transposed tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

inline size_t smem_floats(int N, int Q) {
  return 2 * (size_t)N * kLd + (size_t)N * kPMax + (size_t)kT * kPMax +
         (size_t)kT * kLd + 2 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ init, T* __restrict__ y,
                    float* __restrict__ final_state, int S, int H, int P,
                    int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* CsT = smem;              // [N][kLd]   C of row tile i, transposed
  float* BsT = CsT + N * kLd;     // [N][kLd]   B of column tile j, transposed
  float* St = BsT + N * kLd;      // [N][kPMax] the state, (N,P)
  float* Xs = St + N * kPMax;     // [kT][kPMax] x of column tile j
  float* GT = Xs + kT * kPMax;    // [kT][kLd]  (C B^T ∘ L dt) transposed
  float* cum = GT + kT * kLd;     // [Q] within-chunk cumulative dt·A
  float* dts = cum + Q;           // [Q] dt of the chunk

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a_h = A[h], d_h = Dv[h];
  const size_t row = (size_t)H * P;  // x, y: stride from token to token
  const T* xb = x + (size_t)b * S * row + (size_t)h * P;
  T* yb = y + (size_t)b * S * row + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  const size_t st_off = ((size_t)b * H + h) * P * N;  // (B,H,P,N)

  for (int idx = tid; idx < N * kPMax; idx += kThreads) {
    const int n = idx / kPMax, p = idx % kPMax;
    St[idx] = (init != nullptr && p < P) ? init[st_off + (size_t)p * N + n]
                                         : 0.0f;
  }
  const int ntiles = (Q + kT - 1) / kT;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the last chunk's readers of cum, dts and St are done
    for (int q = tid; q < Q; q += kThreads) dts[q] = dtb[(size_t)(c0 + q) * H];
    __syncthreads();
    if (tid < 32) {  // cum: per-lane runs of the chunk, then a warp scan
      const int seg = (Q + 31) / 32;
      const int q0 = min(tid * seg, Q), q1 = min(q0 + seg, Q);
      float run = 0.0f;
      for (int q = q0; q < q1; ++q) {
        run += dts[q] * a_h;
        cum[q] = run;
      }
      float inc = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += v;
      }
      const float base = inc - run;
      for (int q = q0; q < q1; ++q) cum[q] += base;
    }

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // cum is written; earlier readers of CsT are done
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int i = idx / N, n = idx % N, q = i0 + i;
        CsT[n * kLd + i] = q < Q ? to_f32(Cb[(size_t)(c0 + q) * N + n]) : 0.0f;
      }
      __syncthreads();

      // y_i = exp(cum_i) C_i · state
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&CsT[n * kLd + ty * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&St[n * kPMax + tx * 4]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(c4[r], s4[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = i0 + ty * 4 + r;
        const float e = q < Q ? expf(cum[q]) : 0.0f;
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] *= e;
      }

      // + sum over column tiles j <= i of (C_i B_j^T ∘ L dt_j) x_j
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // earlier readers of BsT, Xs and GT are done
        for (int idx = tid; idx < kT * N; idx += kThreads) {
          const int j = idx / N, n = idx % N, q = j0 + j;
          BsT[n * kLd + j] =
              q < Q ? to_f32(Bb[(size_t)(c0 + q) * N + n]) : 0.0f;
        }
        for (int idx = tid; idx < kT * kPMax; idx += kThreads) {
          const int j = idx / kPMax, p = idx % kPMax, q = j0 + j;
          Xs[idx] = (q < Q && p < P) ? to_f32(xb[(size_t)(c0 + q) * row + p])
                                     : 0.0f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) g[r][s] = 0.0f;
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&CsT[n * kLd + ty * 4]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&BsT[n * kLd + tx * 4]);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) g[r][s] = fmaf(c4[r], b4[s], g[r][s]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = i0 + ty * 4 + r;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int qj = j0 + tx * 4 + s;
            // exp only on and below the diagonal (qj <= qi < Q)
            const float v = (qj <= qi && qi < Q)
                                ? g[r][s] * expf(cum[qi] - cum[qj]) * dts[qj]
                                : 0.0f;
            GT[(tx * 4 + s) * kLd + ty * 4 + r] = v;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          const float4 gv = *reinterpret_cast<const float4*>(&GT[j * kLd + ty * 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * kPMax + tx * 4]);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
          const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(g4[r], x4[s], acc[r][s]);
        }
      }

      // + D x_i; y in x's dtype
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = i0 + ty * 4 + r;
        if (q >= Q) continue;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int p = tx * 4 + s;
          if (p >= P) continue;
          const size_t off = (size_t)(c0 + q) * row + p;
          store(&yb[off], acc[r][s] + d_h * to_f32(xb[off]));
        }
      }
    }

    // state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    __syncthreads();  // every row tile has read the old state
    const float last = cum[Q - 1];
    const float keep = expf(last);
    float sacc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = ty * 8 + a;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sacc[a][s] = n < N ? St[n * kPMax + tx * 4 + s] * keep : 0.0f;
    }
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // earlier readers of BsT and Xs are done
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int j = idx / N, n = idx % N, q = j0 + j;
        BsT[n * kLd + j] =
            q < Q ? to_f32(Bb[(size_t)(c0 + q) * N + n]) *
                        (expf(last - cum[q]) * dts[q])
                  : 0.0f;
      }
      for (int idx = tid; idx < kT * kPMax; idx += kThreads) {
        const int j = idx / kPMax, p = idx % kPMax, q = j0 + j;
        Xs[idx] = (q < Q && p < P) ? to_f32(xb[(size_t)(c0 + q) * row + p])
                                   : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * kPMax + tx * 4]);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int n = ty * 8 + a;
          if (n >= N) break;
          const float bv = BsT[n * kLd + j];
#pragma unroll
          for (int s = 0; s < 4; ++s) sacc[a][s] = fmaf(bv, x4[s], sacc[a][s]);
        }
      }
    }
    __syncthreads();  // every reader of St for this chunk is done
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = ty * 8 + a;
      if (n >= N) break;
#pragma unroll
      for (int s = 0; s < 4; ++s) St[n * kPMax + tx * 4 + s] = sacc[a][s];
    }
  }

  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    final_state[st_off + idx] = St[n * kPMax + p];
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* D, const float* init, T* y,
           float* final_state, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  if (P < 1 || P > kPMax || N < 1 || N > kNMax || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  // The shared-memory limit is a per-device attribute of the function: set
  // it to the device's opt-in maximum at the first launch on each device,
  // not at every layer. A chunk whose tiles need more than that is refused
  // by the launch itself (cudaErrorInvalidValue).
  static std::atomic<unsigned long long> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set.load(std::memory_order_acquire) & bit)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(
      x, dt, A, Bm, Cm, D, init, y, final_state, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// init may be null (a zero initial state); every other pointer is a
// contiguous tensor of the shape in the header comment.
int repro_ssd_scan_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* init, float* y, float* final_state, int B,
                       int S, int H, int P, int N, int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, init, y, final_state, B, S, H, P, N, Q,
                static_cast<cudaStream_t>(stream));
}

int repro_ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                        const float* A, const __nv_bfloat16* Bm,
                        const __nv_bfloat16* Cm, const float* D,
                        const float* init, __nv_bfloat16* y,
                        float* final_state, int B, int S, int H, int P, int N,
                        int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, init, y, final_state, B, S, H, P, N, Q,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
