// matmul and matmul_packed: the Hopper ports of the Pallas kernels in
// repro/kernels/matmul.py (_mm_kernel, _mm_packed_kernel); matmul in f32,
// in bf16 (f32 accumulate, bf16 out) and bf16 in with f32 out. Plain C
// entry points, loaded with ctypes by repro_torch/kernels/_native.py.
#include "gemm_f32.cuh"

using repro_torch::BMode;

extern "C" {

// out(M,N) = x(M,K) · w(K,N); all row-major f32, contiguous.
int repro_matmul_f32(const float* x, const float* w, float* out, int M, int N,
                     int K, void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, M, N, K, 1, 0, 0, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// out(M,N) = x(M,K) · w(K,N); all row-major bf16, contiguous; f32
// accumulator, each output rounded to bf16 once.
int repro_matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      __nv_bfloat16* out, int M, int N, int K, void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, M, N, K, 1, 0, 0, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// out(M,N) = x(M,K) · w(K,N); x and w bf16, out f32 (the f32 accumulator
// stored as it is: jnp.dot(bf16, bf16, preferred_element_type=f32)).
int repro_matmul_bf16_f32out(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             float* out, int M, int N, int K, void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, M, N, K, 1, 0, 0, 0, 0,
      static_cast<cudaStream_t>(stream));
}

// out(M,N) = x(M,K) · W[:K, :N], where W is stored packed as
// (N/128, nK, 128, 128) by LinearPacked. x is NOT padded to nK*128: the
// K edge is masked in the kernel.
int repro_matmul_packed_f32(const float* x, const float* w_packed, float* out,
                            int M, int N, int K, int nK, void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kPacked>(
      x, w_packed, out, nullptr, M, N, K, 1, 0, 0, 0, nK,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
