// matmul and matmul_packed: the Hopper ports of the Pallas kernels in
// repro/kernels/matmul.py (_mm_kernel, _mm_packed_kernel). Plain C entry
// points, loaded with ctypes by repro_torch/kernels/_native.py.
#include "gemm_f32.cuh"

extern "C" {

// out(M,N) = x(M,K) · w(K,N); all row-major f32, contiguous.
int repro_matmul_f32(const float* x, const float* w, float* out, int M, int N,
                     int K, void* stream) {
  return repro_torch::launch_gemm_f32<false>(
      x, w, out, M, N, K, 1, 0, 0, 0, 0, static_cast<cudaStream_t>(stream));
}

// out(M,N) = x(M,K) · W[:K, :N], where W is stored packed as
// (N/128, nK, 128, 128) by LinearPacked. x is NOT padded to nK*128: the
// K edge is masked in the kernel.
int repro_matmul_packed_f32(const float* x, const float* w_packed, float* out,
                            int M, int N, int K, int nK, void* stream) {
  return repro_torch::launch_gemm_f32<true>(
      x, w_packed, out, M, N, K, 1, 0, 0, 0, nK,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
