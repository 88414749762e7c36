// winograd_tile_matmul: the Hopper port of the Pallas kernel in
// repro/kernels/conv_winograd.py (_wino_mm_kernel). The 16 independent
// (T,C)x(C,O) GEMMs of Winograd F(2x2,3x3) run as one launch of the f32
// path template (gemm_f32_paths.cuh, IEEE FMA, no TF32), batched over the
// 16 positions, along the path plan_f32_gemm(T, O, C, batch=16) chooses
// (kernels/matmul.py): the persistent stream path where C <= 64
// (resnet50's stem and stage 0: bound by reading V and writing the
// output, each V element read once), the batched tile path otherwise
// (stages 1 and 2: bound by operations). Plain C entry point, loaded with
// ctypes by repro_torch/kernels/_native.py.
#include "gemm_f32_paths.cuh"

extern "C" {

// out(P,T,O)[p] = V(P,T,C)[p] · U(P,C,O)[p]; all f32, contiguous. path,
// bm, bn, split and blocks as plan_f32_gemm decided; split > 1 needs
// split·P·T·O floats of scratch.
int repro_winograd_tile_matmul_f32(const float* V, const float* U, float* out,
                                   int P, int T, int C, int O, int path,
                                   int bm, int bn, int split, int blocks,
                                   float* scratch, void* stream) {
  return repro_torch::f32::launch_gemm_f32_batched<repro_torch::f32::kStreamPath>(
      V, U, out, P, (long long)T * C, (long long)C * O, (long long)T * O, T,
      O, C, O, false, path, bm, bn, split, blocks, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
