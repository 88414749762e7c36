// Shared-memory tiled f32 GEMM for Hopper (sm_90a), IEEE f32 FMA on the
// CUDA cores: f32 in, f32 accumulated, f32 out. No TF32 — the lossless
// cold-inference path must match the f32 reference, and the tensor cores
// have no plain-f32 mode.
//
// One template serves the three ported Pallas kernels:
//   * matmul                 C(M,N) = A(M,K) · B(K,N), row-major B;
//   * matmul_packed          B in LinearPacked's (N/128, K/128, 128, 128)
//                            layout, read in place (PACKED = true);
//   * winograd_tile_matmul   the same GEMM batched over the 16 Winograd
//                            positions on blockIdx.z, with batch strides.
//
// Block tile 64x64, K step 16, 256 threads, 4x4 outputs per thread. A is
// staged transposed in shared memory (As[k][m]) so that each thread reads
// its 4 rows and 4 columns of a K step as two float4 loads. The ragged M,
// N and K edges are masked in the loads and the store: nothing is padded
// in device memory.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace repro_torch {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPackTile = 128;  // LinearPacked's bk = bn = 128

template <bool PACKED>
__device__ __forceinline__ size_t b_offset(int k, int n, int N, int nK) {
  if (PACKED) {
    // element (k, n) of the logical (Kp, Np) matrix inside the packed
    // (nN, nK, 128, 128) array: one contiguous 64 KB tile per (n/128, k/128)
    return ((size_t)(n / kPackTile) * nK + (size_t)(k / kPackTile)) *
               (kPackTile * kPackTile) +
           (size_t)(k % kPackTile) * kPackTile + (size_t)(n % kPackTile);
  }
  return (size_t)k * N + n;
}

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, int M, int N, int K,
                    long long batch_a, long long batch_b, long long batch_c,
                    int nK) {
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

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int am = m0 + a_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_k + j;
      As[a_k + j][a_row] =
          (am < M && k < K) ? A[(size_t)am * K + k] : 0.0f;
    }
    const int bk = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_col + j;
      Bs[b_k][b_col + j] =
          (bk < K && n < N) ? B[b_offset<PACKED>(bk, n, N, nK)] : 0.0f;
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
      if (n < N) C[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// Enqueue one (batched) GEMM on `stream`; returns cudaGetLastError() so a
// refused launch is reported to the caller instead of passing unseen.
template <bool PACKED>
inline int launch_gemm_f32(const float* A, const float* B, float* C, int M,
                           int N, int K, int batch, long long batch_a,
                           long long batch_b, long long batch_c, int nK,
                           cudaStream_t stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return (int)cudaGetLastError();
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, batch);
  gemm_f32_kernel<PACKED><<<grid, kThreads, 0, stream>>>(
      A, B, C, M, N, K, batch_a, batch_b, batch_c, nK);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
