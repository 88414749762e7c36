// matmul and matmul_packed: the Hopper ports of the Pallas kernels in
// repro/kernels/matmul.py (_mm_kernel, _mm_packed_kernel). matmul in f32
// runs on the f32 path template (gemm_f32_paths.cuh, IEEE FMA, no TF32),
// in bf16 (bf16 out, or f32 out) on the tensor-core template
// (gemm_bf16_tc.cuh), each along the path, block tile, K split and B
// layout that its host planner (kernels/matmul.py plan_f32_gemm,
// plan_bf16_gemm) passes in; matmul_packed (f32 or bf16 x) on the f32
// path template too, reading LinearPacked's panels in place, along
// plan_f32_gemm's path for the logical (M,K)x(K,N). Plain C entry points,
// loaded with ctypes by repro_torch/kernels/_native.py.
#include "gemm_bf16_tc.cuh"
#include "gemm_f32_paths.cuh"

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
// (ceil(N/128), nK, 128, 128) by LinearPacked and read in place. x is NOT
// padded to nK*128: the K edge is masked in the kernel. path, bm, bn and
// split as plan_f32_gemm(M, N, K) decided; split > 1 needs split·M·N
// floats of scratch.
int repro_matmul_packed_f32(const float* x, const float* w_packed, float* out,
                            int M, int N, int K, int nK, int path, int bm,
                            int bn, int split, float* scratch, void* stream) {
  return repro_torch::f32::launch_gemm_packed(
      x, w_packed, out, M, N, K, nK, path, bm, bn, split, scratch,
      static_cast<cudaStream_t>(stream));
}

// The same with x and out bf16: x widened to f32 where it is read back,
// f32 FMA, each output rounded to bf16 once.
int repro_matmul_packed_bf16(const __nv_bfloat16* x, const float* w_packed,
                             __nv_bfloat16* out, int M, int N, int K, int nK,
                             int path, int bm, int bn, int split,
                             float* scratch, void* stream) {
  return repro_torch::f32::launch_gemm_packed(
      x, w_packed, out, M, N, K, nK, path, bm, bn, split, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
