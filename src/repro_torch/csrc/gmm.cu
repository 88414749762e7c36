// gmm_blocks: the Hopper port of the Pallas kernel in repro/kernels/gmm.py
// (_gmm_kernel), the MoE expert-block GEMM. out(E,C,n) = x(E,C,d) · w(E,d,n),
// one GEMM per expert with an f32 accumulator, out in x's dtype, with the
// per-expert strides of x, w and out. w is read in place row-major (each
// expert's (d, n) contiguous) or K-major (each expert's (n, d) contiguous:
// the backward's dx = dy · wᵀ reads a forward weight as it is stored).
// group_sizes (E int32 on the device, or null): rows r >= group_sizes[e] of
// expert e are zero in out, and a block whose rows all lie past it reads
// no weights. bf16 runs on the tensor-core template (gemm_bf16_tc.cuh)
// along plan_bf16_gemm's path and split; f32 on the f32 path template
// (gemm_f32_paths.cuh, IEEE FMA, no TF32) along plan_f32_gemm(C, n, d,
// kmajor, batch=E, row_limit=True): the batched skinny path at decode (C
// <= 16, row-major w; the expert on blockIdx.z, each block streaming its
// 128 columns of w once), the batched tile path above (and for a K-major
// w at any C), group_sizes as the row limit on both. Ragged C, d and n are
// masked in the kernels; nothing is padded in device memory.
//
// gmm_blocks_dw, the weight gradient of the same GEMM, is gmm_dw.cu.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
#include "gemm_bf16_tc.cuh"
#include "gemm_f32_paths.cuh"

extern "C" {

// x (E,C,d), out (E,C,n) row-major f32, contiguous; w (E,d,n) row-major,
// or K-major (kmajor: each expert's (n,d) contiguous). path, bm, bn and
// split as plan_f32_gemm decided for (C, n, d, kmajor, E) with row
// limits; split > 1 needs split·E·C·n floats of scratch.
int repro_gmm_blocks_f32(const float* x, const float* w, float* out,
                         const int* group_sizes, int E, int C, int d, int n,
                         int kmajor, int path, int bm, int bn, int split,
                         float* scratch, void* stream) {
  using namespace repro_torch::f32;
  return launch_gemm_f32_batched<kRowLimit>(
      x, w, out, E, (long long)C * d, (long long)d * n, (long long)C * n, C,
      n, d, kmajor ? d : n, kmajor != 0, path, bm, bn, split, 1, scratch,
      static_cast<cudaStream_t>(stream), group_sizes);
}

// The same in bf16: f32 accumulator, each output rounded to bf16 once;
// path, bm and split as plan_bf16_gemm decided for (C, n, d, E); split > 1
// needs split·E·C·n floats of scratch.
int repro_gmm_blocks_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          __nv_bfloat16* out, const int* group_sizes, int E,
                          int C, int d, int n, int kmajor, int path, int bm,
                          int split, float* scratch, void* stream) {
  return repro_torch::tc::launch_gemm_bf16_tc(
      x, w, out, group_sizes, C, n, d, kmajor ? d : n, kmajor != 0, E,
      (long long)C * d, (long long)d * n, (long long)C * n, path, bm, split,
      scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
