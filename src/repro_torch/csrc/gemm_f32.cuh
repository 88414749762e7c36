// Shared-memory tiled GEMM for Hopper (sm_90a) with an f32 accumulator,
// IEEE f32 FMA on the CUDA cores. A is float or __nv_bfloat16, converted to
// f32 on load into shared memory; C is float or __nv_bfloat16, rounded to
// nearest-even on store (no TF32 — the lossless cold-inference path must
// match the f32 reference, and the tensor cores have no plain-f32 mode).
// How B is read is the BMode parameter, also converted to f32 on load:
//   kRowMajor  B(K,N) row-major, float or bf16;
//   kInt8      B(K,N) int8 (exact in f32).
// With SCALE, the finished accumulator of column n is multiplied once by
// col_scale[n] before the store — the per-output-channel scale of the
// fused dequant-matmul, factored out of the K loop.
//
// It carries the two GEMMs that have not moved to the f32 path template
// (gemm_f32_paths.cuh):
//   * gmm_blocks' f32 entry  kRowMajor, batched over the experts on
//                            blockIdx.z with batch strides and row_limit;
//   * matmul_dequant_int8    kInt8 with SCALE.
//
// Block tile 64x64, K step 16, 256 threads, 4x4 outputs per thread. A is
// staged transposed in shared memory (As[k][m]) so that each thread reads
// its 4 rows and 4 columns of a K step as two float4 loads. The ragged M,
// N and K edges are masked in the loads and the store: nothing is padded
// in device memory (A is never read past column K).
//
// With row_limit (one int per batch entry, read on the device), rows
// r >= row_limit[z] of batch entry z are written as zeros and never read
// from A, and a block whose rows all lie past the limit loads nothing
// (gmm_blocks' group_sizes: an expert with no rows reads none of its
// weights).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

enum class BMode { kRowMajor, kInt8 };

// element (k, n) of the logical (K, N) matrix B, as f32
template <BMode MODE, typename TB>
__device__ __forceinline__ float load_b(const TB* __restrict__ B, int k,
                                        int n, int N) {
  if constexpr (MODE == BMode::kRowMajor)
    return to_f32(B[(size_t)k * N + n]);
  else
    return (float)B[(size_t)k * N + n];
}

template <BMode MODE, bool SCALE, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                    TC* __restrict__ C, const float* __restrict__ col_scale,
                    int M, int N, int K, long long batch_a,
                    long long batch_b, long long batch_c,
                    const int* __restrict__ row_limit) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output column group
  const int ty = tid / 16;  // output row group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  A += (size_t)blockIdx.z * batch_a;
  B += (size_t)blockIdx.z * batch_b;
  C += (size_t)blockIdx.z * batch_c;
  int Mz = M;  // rows of this batch entry that hold data
  if (row_limit != nullptr) {
    const int r = row_limit[blockIdx.z];
    Mz = r < 0 ? 0 : (r < M ? r : M);
  }

  // load assignment: A tile (64 rows x 16 k), 4 consecutive k per thread;
  // B tile (16 k x 64 cols), 4 consecutive columns per thread
  const int a_row = tid / 4;
  const int a_k = (tid % 4) * 4;
  const int b_k = tid / 16;
  const int b_col = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; m0 < Mz && k0 < K; k0 += kBK) {
    const int am = m0 + a_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_k + j;
      As[a_k + j][a_row] =
          (am < Mz && k < K) ? to_f32(A[(size_t)am * K + k]) : 0.0f;
    }
    const int bk = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_col + j;
      Bs[b_k][b_col + j] =
          (bk < K && n < N) ? load_b<MODE>(B, bk, n, N) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = m < Mz ? acc[i][j] : 0.0f;
      if constexpr (SCALE) v *= col_scale[n];
      store_f32(&C[(size_t)m * N + n], v);
    }
  }
}

// Enqueue one (batched) GEMM on `stream`; returns cudaGetLastError() so a
// refused launch is reported to the caller instead of passing unseen.
template <BMode MODE, bool SCALE = false, typename TA, typename TB,
          typename TC>
inline int launch_gemm_f32(const TA* A, const TB* B, TC* C,
                           const float* col_scale, int M, int N, int K,
                           int batch, long long batch_a, long long batch_b,
                           long long batch_c, cudaStream_t stream,
                           const int* row_limit = nullptr) {
  if (M <= 0 || N <= 0 || batch <= 0) return (int)cudaGetLastError();
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, batch);
  gemm_f32_kernel<MODE, SCALE, TA, TB, TC><<<grid, kThreads, 0, stream>>>(
      A, B, C, col_scale, M, N, K, batch_a, batch_b, batch_c, row_limit);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
