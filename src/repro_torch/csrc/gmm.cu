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
// gmm_blocks_dw: the weight gradient of the same GEMM, which the reference
// computes with jnp in its custom VJP (repro/models/moe.py,
// _grouped_ffn_bwd: dwg = blk.T @ dg; no Pallas twin). out(E,d,n) =
// x(E,C,d)ᵀ · dy(E,C,n) per expert, contracted over the expert's first
// group_sizes[e] rows only (the same templates, group_sizes as each
// batch entry's K limit): rows past the group are never read, whatever
// they hold (the next expert's tokens), an expert with no rows writes
// zeros and reads nothing, and a K split wholly past the group writes
// zero partials. The A operand is xᵀ (E,d,C), copied contiguous by the
// wrapper. Bound at granite-moe-3b-a800m's training microbatch (E 40, C
// 824, d 1536, n 512, ~410 rows an expert): by operations at the
// tensor-core rate in bf16, on the CUDA cores in f32.
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

// xt (E,d,C) (x's blocks transposed), dy (E,C,n), out (E,d,n); all
// row-major f32, contiguous; expert e contracts over k < group_sizes[e]
// (all C where group_sizes is null). path, bm, bn and split as
// plan_f32_gemm decided for (d, n, C, batch=E, row_limit=True); split > 1
// needs split·E·d·n floats of scratch.
int repro_gmm_blocks_dw_f32(const float* xt, const float* dy, float* out,
                            const int* group_sizes, int E, int C, int d,
                            int n, int path, int bm, int bn, int split,
                            float* scratch, void* stream) {
  using namespace repro_torch::f32;
  return launch_gemm_f32_batched<kRowLimit>(
      xt, dy, out, E, (long long)d * C, (long long)C * n, (long long)d * n,
      d, n, C, n, false, path, bm, bn, split, 1, scratch,
      static_cast<cudaStream_t>(stream), nullptr, group_sizes);
}

// The same in bf16: f32 accumulator, each output rounded to bf16 once;
// path, bm and split as plan_bf16_gemm decided for (d, n, C, E).
int repro_gmm_blocks_dw_bf16(const __nv_bfloat16* xt,
                             const __nv_bfloat16* dy, __nv_bfloat16* out,
                             const int* group_sizes, int E, int C, int d,
                             int n, int path, int bm, int split,
                             float* scratch, void* stream) {
  return repro_torch::tc::launch_gemm_bf16_tc<true>(
      xt, dy, out, nullptr, d, n, C, n, false, E, (long long)d * C,
      (long long)C * n, (long long)d * n, path, bm, split, scratch,
      static_cast<cudaStream_t>(stream), group_sizes);
}

}  // extern "C"
