// The quantized-cache kernels: the Hopper ports of the Pallas kernels in
// repro/kernels/quant.py. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
//
//   dequant_int8          (_dq8_kernel)    out(K,N) f32 = q(K,N) int8 · s(N)
//   dequant_int4          (_dq4_kernel)    the same from packed nibbles
//   matmul_dequant_int8   (_mm_dq8_kernel) out = (x · q) · s, s applied once
//                                          to the finished f32 accumulator
//   matmul_dequant_int4   (_mm_dq4_kernel) the same with packed nibbles
//
// The dequant kernels are one f32 multiply of exact values per element, so
// they equal the plain version bit for bit. They are bound by bytes: 1 B
// (int8) or 0.5 B (int4) read and 4 B written per weight, so the design is
// about coalescing. The vector path (N a multiple of 4, 16-byte aligned
// base pointers) gives each thread 4 columns: one 4-byte load of q (4 int8
// or 4 packed bytes) and one float4 store per output row, so a warp reads
// 128 and writes 512 contiguous bytes; the thread loads its 4 scales once
// and walks kRowsPerThread rows with them. Other shapes take a scalar
// kernel, one thread per element (per packed byte for int4). Nothing is
// padded in device memory: an odd K writes only the low-nibble row of the
// last byte.
//
// matmul_dequant_int8 and matmul_dequant_int4 run on the f32 path
// template (gemm_f32_paths.cuh) along plan_f32_gemm's path and K split for
// the logical (M,K)x(K,N): the int8 bytes or packed nibbles are streamed
// (skinny) or copied into shared memory (tile) at their byte count and
// sign-extended on chip (exact in f32); the column scale multiplies the
// finished sum once, in the store or in the kernel that sums a split's
// partials. x is f32 or bf16; the output is in x's type, as in the Pallas
// kernels, rounded once after the scale.
#include "gemm_f32_paths.cuh"

namespace {

constexpr int kVec = 4;            // columns per thread on the vector path
constexpr int kDqX = 64;           // threads per block across columns
constexpr int kDqY = 4;            // threads per block across rows
constexpr int kRowsPerThread = 4;  // rows each thread walks, one scale load

// byte b of w as a signed int8 value
__device__ __forceinline__ int s8(unsigned w, int b) {
  return ((int)(w << (24 - 8 * b))) >> 24;
}
// nibble b (0..7) of w, sign-extended
__device__ __forceinline__ int s4(unsigned w, int b) {
  return ((int)(w << (28 - 4 * b))) >> 28;
}

// the vector path: 4 columns a thread, q read as one 32-bit word (4 int8
// or 4 packed bytes; a warp reads 128 contiguous bytes), each output row
// written as one float4 (a warp writes 512 contiguous bytes)
__global__ void __launch_bounds__(kDqX* kDqY)
    dequant_int8_vec(const int8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int K, int N) {
  const int c0 = (blockIdx.x * kDqX + threadIdx.x) * kVec;
  if (c0 >= N) return;
  const float4 s = *reinterpret_cast<const float4*>(scale + c0);
  for (int r = blockIdx.y * kDqY + threadIdx.y; r < K;
       r += gridDim.y * kDqY) {
    const unsigned w =
        *reinterpret_cast<const unsigned*>(q + (size_t)r * N + c0);
    *reinterpret_cast<float4*>(out + (size_t)r * N + c0) =
        make_float4((float)s8(w, 0) * s.x, (float)s8(w, 1) * s.y,
                    (float)s8(w, 2) * s.z, (float)s8(w, 3) * s.w);
  }
}

__global__ void dequant_int8_scalar(const int8_t* __restrict__ q,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, int K, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const float s = scale[c];
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < K;
       r += gridDim.y * blockDim.y) {
    const size_t i = (size_t)r * N + c;
    out[i] = (float)q[i] * s;
  }
}

// packed (Kp2, N) with Kp2 = (K+1)/2: byte (i, c) gives rows 2i (low
// nibble) and 2i+1 (high nibble; absent when 2i+1 == K). Byte j of the
// word holds nibbles 2j (low) and 2j+1 (high).
__global__ void __launch_bounds__(kDqX* kDqY)
    dequant_int4_vec(const uint8_t* __restrict__ packed,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int K, int N) {
  const int c0 = (blockIdx.x * kDqX + threadIdx.x) * kVec;
  if (c0 >= N) return;
  const int Kp2 = (K + 1) / 2;
  const float4 s = *reinterpret_cast<const float4*>(scale + c0);
  for (int i = blockIdx.y * kDqY + threadIdx.y; i < Kp2;
       i += gridDim.y * kDqY) {
    const unsigned w =
        *reinterpret_cast<const unsigned*>(packed + (size_t)i * N + c0);
    *reinterpret_cast<float4*>(out + (size_t)(2 * i) * N + c0) =
        make_float4((float)s4(w, 0) * s.x, (float)s4(w, 2) * s.y,
                    (float)s4(w, 4) * s.z, (float)s4(w, 6) * s.w);
    if (2 * i + 1 < K)
      *reinterpret_cast<float4*>(out + (size_t)(2 * i + 1) * N + c0) =
          make_float4((float)s4(w, 1) * s.x, (float)s4(w, 3) * s.y,
                      (float)s4(w, 5) * s.z, (float)s4(w, 7) * s.w);
  }
}

__global__ void dequant_int4_scalar(const uint8_t* __restrict__ packed,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, int K, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const int Kp2 = (K + 1) / 2;
  const float s = scale[c];
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < Kp2;
       i += gridDim.y * blockDim.y) {
    const unsigned b = packed[(size_t)i * N + c];
    out[(size_t)(2 * i) * N + c] = (float)s4(b, 0) * s;
    if (2 * i + 1 < K) out[(size_t)(2 * i + 1) * N + c] = (float)s4(b, 1) * s;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline int row_blocks(int rows, int per_block) {
  const int b = (rows + per_block - 1) / per_block;
  return b < 1 ? 1 : (b > 65535 ? 65535 : b);
}

// INT4: q is packed ((K+1)/2, N) uint8, else (K, N) int8
template <bool INT4, typename TQ>
int launch_dequant(const TQ* q, const float* scale, float* out, int K, int N,
                   cudaStream_t stream) {
  if (K <= 0 || N <= 0) return (int)cudaGetLastError();
  const int rows = INT4 ? (K + 1) / 2 : K;
  // N % 4 == 0 keeps every row's first column 4-byte (q) and 16-byte
  // (scale, out) aligned once the base pointers are
  if (N % kVec == 0 && aligned16(q) && aligned16(scale) && aligned16(out)) {
    dim3 block(kDqX, kDqY);
    dim3 grid((N / kVec + kDqX - 1) / kDqX,
              row_blocks(rows, kDqY * kRowsPerThread));
    if constexpr (INT4)
      dequant_int4_vec<<<grid, block, 0, stream>>>(q, scale, out, K, N);
    else
      dequant_int8_vec<<<grid, block, 0, stream>>>(q, scale, out, K, N);
  } else {
    dim3 block(64, 4);
    dim3 grid((N + 63) / 64, row_blocks(rows, 4 * kRowsPerThread));
    if constexpr (INT4)
      dequant_int4_scalar<<<grid, block, 0, stream>>>(q, scale, out, K, N);
    else
      dequant_int8_scalar<<<grid, block, 0, stream>>>(q, scale, out, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

using repro_torch::f32::launch_gemm_q;

extern "C" {

// out(K,N) f32 = q(K,N) int8 · scale(N) f32; all contiguous.
int repro_dequant_int8(const int8_t* q, const float* scale, float* out, int K,
                       int N, void* stream) {
  return launch_dequant<false>(q, scale, out, K, N,
                               static_cast<cudaStream_t>(stream));
}

// out(K,N) f32 = unpack(packed((K+1)/2, N) uint8) · scale(N) f32.
int repro_dequant_int4(const uint8_t* packed, const float* scale, float* out,
                       int K, int N, void* stream) {
  return launch_dequant<true>(packed, scale, out, K, N,
                              static_cast<cudaStream_t>(stream));
}

// out(M,N) = (x(M,K) · q(K,N)) · scale(N); x and out f32. path, bm, bn
// and split as plan_f32_gemm(M, N, K) decided; split > 1 needs split·M·N
// floats of scratch.
int repro_matmul_dequant_int8_f32(const float* x, const int8_t* q,
                                  const float* scale, float* out, int M,
                                  int N, int K, int path, int bm, int bn,
                                  int split, float* scratch, void* stream) {
  return launch_gemm_q<8>(x, q, scale, out, M, N, K, path, bm, bn, split,
                          scratch, static_cast<cudaStream_t>(stream));
}

// the same with x and out bf16 (f32 FMA, one rounding after the scale)
int repro_matmul_dequant_int8_bf16(const __nv_bfloat16* x, const int8_t* q,
                                   const float* scale, __nv_bfloat16* out,
                                   int M, int N, int K, int path, int bm,
                                   int bn, int split, float* scratch,
                                   void* stream) {
  return launch_gemm_q<8>(x, q, scale, out, M, N, K, path, bm, bn, split,
                          scratch, static_cast<cudaStream_t>(stream));
}

// out(M,N) = (x(M,K) · unpack(packed((K+1)/2, N))) · scale(N); x and out
// f32. x is not padded: its columns >= K are never read. path, bm, bn and
// split as plan_f32_gemm(M, N, K) decided; split > 1 needs split·M·N
// floats of scratch.
int repro_matmul_dequant_int4_f32(const float* x, const uint8_t* packed,
                                  const float* scale, float* out, int M,
                                  int N, int K, int path, int bm, int bn,
                                  int split, float* scratch, void* stream) {
  return launch_gemm_q<4>(x, packed, scale, out, M, N, K, path, bm, bn,
                          split, scratch, static_cast<cudaStream_t>(stream));
}

// the same with x and out bf16 (f32 FMA, one rounding after the scale)
int repro_matmul_dequant_int4_bf16(const __nv_bfloat16* x,
                                   const uint8_t* packed, const float* scale,
                                   __nv_bfloat16* out, int M, int N, int K,
                                   int path, int bm, int bn, int split,
                                   float* scratch, void* stream) {
  return launch_gemm_q<4>(x, packed, scale, out, M, N, K, path, bm, bn,
                          split, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
