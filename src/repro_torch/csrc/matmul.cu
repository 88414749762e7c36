// matmul and matmul_packed: the Hopper ports of the Pallas kernels in
// repro/kernels/matmul.py (_mm_kernel, _mm_packed_kernel). matmul in f32
// runs on the f32 path template (gemm_f32_paths.cuh, IEEE FMA, no TF32),
// in bf16 (bf16 out, or f32 out) on the tensor-core template
// (gemm_bf16_tc.cuh), each along the path, block tile, K split and B
// layout that its host planner (kernels/matmul.py plan_f32_gemm,
// plan_bf16_gemm) passes in; matmul_packed on the f32 template
// (gemm_f32.cuh). Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
#include "gemm_bf16_tc.cuh"
#include "gemm_f32.cuh"
#include "gemm_f32_paths.cuh"

using repro_torch::BMode;

extern "C" {

// out(M,N) = x(M,K) · w(K,N), f32. x and out row-major, contiguous; w
// row-major (K,N) with leading dimension ldb, or with b_kmajor an (N,K)
// matrix with leading dimension ldb read as its transpose (w.T
// contiguous). path, bm, bn and split as plan_f32_gemm decided; split > 1
// needs split·M·N floats of scratch.
int repro_matmul_f32(const float* x, const float* w, float* out, int M, int N,
                     int K, int ldb, int b_kmajor, int path, int bm, int bn,
                     int split, float* scratch, void* stream) {
  return repro_torch::f32::launch_gemm_f32_planned(
      x, w, out, M, N, K, ldb, b_kmajor != 0, path, bm, bn, split, scratch,
      static_cast<cudaStream_t>(stream));
}

// out(M,N) = x(M,K) · w(K,N), bf16, f32 accumulator, each output rounded
// to bf16 once. x and out row-major, contiguous; w row-major (K,N) with
// leading dimension ldb, or with b_kmajor an (N,K) matrix with leading
// dimension ldb read as its transpose (w.T contiguous). path, bm and split
// as plan_bf16_gemm decided; split > 1 needs split·M·N floats of scratch.
int repro_matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      __nv_bfloat16* out, int M, int N, int K, int ldb,
                      int b_kmajor, int path, int bm, int split,
                      float* scratch, void* stream) {
  return repro_torch::tc::launch_gemm_bf16_tc(
      x, w, out, nullptr, M, N, K, ldb, b_kmajor != 0, 1, 0, 0, 0, path, bm,
      split, scratch, static_cast<cudaStream_t>(stream));
}

// The same with f32 out: the accumulator stored as it is
// (jnp.dot(bf16, bf16, preferred_element_type=f32)).
int repro_matmul_bf16_f32out(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             float* out, int M, int N, int K, int ldb,
                             int b_kmajor, int path, int bm, int split,
                             float* scratch, void* stream) {
  return repro_torch::tc::launch_gemm_bf16_tc(
      x, w, out, nullptr, M, N, K, ldb, b_kmajor != 0, 1, 0, 0, 0, path, bm,
      split, scratch, static_cast<cudaStream_t>(stream));
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
