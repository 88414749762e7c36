// winograd_tile_matmul: the Hopper port of the Pallas kernel in
// repro/kernels/conv_winograd.py (_wino_mm_kernel). The 16 independent
// (T,C)x(C,O) GEMMs of Winograd F(2x2,3x3) run as one launch, one GEMM per
// blockIdx.z. Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_native.py.
#include "gemm_f32.cuh"

extern "C" {

// out(P,T,O)[p] = V(P,T,C)[p] · U(P,C,O)[p]; all f32, contiguous.
int repro_winograd_tile_matmul_f32(const float* V, const float* U, float* out,
                                   int P, int T, int C, int O, void* stream) {
  return repro_torch::launch_gemm_f32<repro_torch::BMode::kRowMajor>(
      V, U, out, nullptr, T, O, C, P, (long long)T * C, (long long)C * O,
      (long long)T * O, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
