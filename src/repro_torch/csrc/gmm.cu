// gmm_blocks: the Hopper port of the Pallas kernel in repro/kernels/gmm.py
// (_gmm_kernel), the MoE expert-block GEMM. out(E,C,n) = x(E,C,d) · w(E,d,n),
// one GEMM per expert with an f32 accumulator, out in x's dtype. The expert
// index is blockIdx.z of the shared tiled GEMM (gemm_f32.cuh), with the
// per-expert strides of x, w and out; ragged C, d and n are masked in the
// kernel, nothing is padded in device memory. Plain C entry points, loaded
// with ctypes by repro_torch/kernels/_native.py.
#include "gemm_f32.cuh"

using repro_torch::BMode;

extern "C" {

// x (E,C,d), w (E,d,n), out (E,C,n); all row-major f32, contiguous.
int repro_gmm_blocks_f32(const float* x, const float* w, float* out, int E,
                         int C, int d, int n, void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, C, n, d, E, (long long)C * d, (long long)d * n,
      (long long)C * n, 0, static_cast<cudaStream_t>(stream));
}

// The same in bf16: f32 accumulator, each output rounded to bf16 once.
int repro_gmm_blocks_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          __nv_bfloat16* out, int E, int C, int d, int n,
                          void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, C, n, d, E, (long long)C * d, (long long)d * n,
      (long long)C * n, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
