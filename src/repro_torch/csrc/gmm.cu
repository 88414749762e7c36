// gmm_blocks: the Hopper port of the Pallas kernel in repro/kernels/gmm.py
// (_gmm_kernel), the MoE expert-block GEMM. out(E,C,n) = x(E,C,d) · w(E,d,n),
// one GEMM per expert with an f32 accumulator, out in x's dtype; the
// expert is blockIdx.z, with the per-expert strides of x, w and out.
// group_sizes (E int32 on the device, or null): rows r >= group_sizes[e]
// of expert e are zero in out, and a tile whose rows all lie past it reads
// no weights. bf16 runs on the tensor-core template (gemm_bf16_tc.cuh)
// along the host planner's path and split; f32 on the f32 template
// (gemm_f32.cuh, IEEE FMA). Ragged C, d and n are masked in the kernels;
// nothing is padded in device memory. Plain C entry points, loaded with
// ctypes by repro_torch/kernels/_native.py.
#include "gemm_bf16_tc.cuh"
#include "gemm_f32.cuh"

using repro_torch::BMode;

extern "C" {

// x (E,C,d), w (E,d,n), out (E,C,n); all row-major f32, contiguous.
int repro_gmm_blocks_f32(const float* x, const float* w, float* out,
                         const int* group_sizes, int E, int C, int d, int n,
                         void* stream) {
  return repro_torch::launch_gemm_f32<BMode::kRowMajor>(
      x, w, out, nullptr, C, n, d, E, (long long)C * d, (long long)d * n,
      (long long)C * n, static_cast<cudaStream_t>(stream), group_sizes);
}

// The same in bf16: f32 accumulator, each output rounded to bf16 once;
// path, bm and split as plan_bf16_gemm decided for (C, n, d, E); split > 1
// needs split·E·C·n floats of scratch.
int repro_gmm_blocks_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          __nv_bfloat16* out, const int* group_sizes, int E,
                          int C, int d, int n, int path, int bm, int split,
                          float* scratch, void* stream) {
  return repro_torch::tc::launch_gemm_bf16_tc(
      x, w, out, group_sizes, C, n, d, n, false, E, (long long)C * d,
      (long long)d * n, (long long)C * n, path, bm, split, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
