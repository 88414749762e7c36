// gmm_blocks_dw: the weight gradient of the MoE expert-block GEMM
// (gmm.cu's gmm_blocks), which the reference computes with jnp in its
// custom VJP (repro/models/moe.py, _grouped_ffn_bwd: dwg = blk.T @ dg; no
// Pallas twin). out(E,d,n) = x(E,C,d)ᵀ · dy(E,C,n) per expert, contracted
// over the expert's first group_sizes[e] rows only (all C where
// group_sizes is null), with an f32 accumulator, out in x's dtype. Rows
// past a group hold the next expert's tokens (or anything at all): they
// never reach the result. Both operands are read in place: the
// contraction runs over the token rows, so x is the product's A operand
// M-major (d contiguous) and dy its B operand N-major (n contiguous).
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py; the host planner is
// kernels/matmul.py plan_gmm_dw.
//
// Bound on an H100 SXM at granite-moe-3b-a800m's training microbatch (E
// 40, C 824, d 1536, n 512; 16,384 rows of a top-8 routing of 2048
// tokens): in bf16 the rows within the groups of x and dy read once and
// the (E, d, n) output written once, 130 MB at 3.35 TB/s (0.0388 ms),
// against 25.8 GFLOP at 989 TFLOP/s (0.026 ms): bytes. In f32 the
// operations bound it (0.38 ms at 67 TFLOP/s on the CUDA cores).
//
// bf16, d and n multiples of 8 and 16-byte aligned bases (the "tma" plan):
// one persistent block an SM walks the (expert, 128-row d tile, 128-column
// n tile) tiles in a fixed order, n tile fastest (a block's neighbours
// share its x tile in L2), through a 5-deep ring.
//   * One producer warp keeps the ring of stages full with TMA: a stage is
//     x's [64 rows x 128 of d] and dy's [64 rows x 128 of n], boxes of 64
//     rows x 64 columns (128 bytes) through 3-D tensor maps over (E, C, ·)
//     with the 128-byte swizzle, each stage's completion tracked by a full
//     mbarrier (expect_tx) and its release by an empty one. The ring runs
//     across tiles, so the next tile's loads are in flight while the
//     consumers store the current tile. The experts' depths are read into
//     shared memory once, so a tile's start waits on no load.
//   * Two consumer warpgroups each own 64 rows of d: wgmma.mma_async
//     m64n128k16 with A (x) and B (dy) both from shared memory, both
//     transposed (MN-major: bf16 is the type wgmma takes so), one group
//     of products in flight behind the next stage's wait. An expert's K
//     steps stop at its group size: a step wholly past it is not taken,
//     and in the last one the rows at or past it in both operands' boxes
//     are zeroed in shared memory (fence.proxy.async, then the
//     warpgroup's barrier) before the products read them; rows past C are
//     zero-filled by TMA. An expert with no rows loads nothing and stores
//     zeros.
//   * Each warpgroup stages its 64 output rows in shared memory as bf16
//     and stores them 16 bytes a thread along whole rows: stored from the
//     registers as 4-byte pairs (8 half-used sectors a warp instruction),
//     granite's dwg routed took 0.1019 ms of device time against 0.0721
//     staged (a 4-deep ring, an H100 SXM).
// Each output is one block's fixed-order sum: no atomics, and two
// launches give the same bits. The CUtensorMaps are encoded on the host
// for each call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint:
// the library is not linked against libcuda) and passed as
// __grid_constant__ parameters, so a launch can be captured in a CUDA
// graph.
//
// bf16, any other shape (the "tile" plan, plan_bf16_gemm's tiles and
// split): the cp.async tile path of gemm_bf16_tc.cuh with its A read
// M-major in place, group sizes as K limits (rows past them zero-filled
// in the copies, never read).
//
// f32 (IEEE FMA on the CUDA cores, no TF32): the batched tile path of
// gemm_f32_paths.cuh with its A read M-major in place (kAMajorM), group
// sizes as K limits, along plan_f32_gemm's tile plan for (d, n, C, E).
#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16_tc.cuh"
#include "gemm_f32_paths.cuh"

namespace {

namespace tc = repro_torch::tc;

constexpr int kBM = 128;          // rows of d a tile (two warpgroups)
constexpr int kBK = 64;           // token rows a stage
constexpr int kBox = kBK * 128;   // one TMA box: 64 rows of 64 bf16, 8 KB
constexpr int kConsumerWarps = 8;       // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;   // + the producer warp

constexpr int kMaxExperts = 1024;  // group sizes held in shared memory

// A tile of 128 rows of d by 128 columns of n through a ring of kStages
// stages: a stage holds x's two boxes and dy's two. Beside the ring, the
// output tile staged for the stores (bf16 rows of 128 + 8: a quad's four
// pairs of eight rows fall in 32 distinct banks), the experts' group sizes
// and the barriers.
constexpr int kBN = 128;
constexpr int kStages = 5;
constexpr int kStage = 4 * kBox;
constexpr int kOutLd = kBN + 8;            // staged row, elements
constexpr int kOut = kBM * kOutLd * 2;
constexpr int kGs = kMaxExperts * 4;
constexpr int kSmem = kStages * kStage + kOut + kGs + 1024 + 2 * kStages * 8;

struct DwArgs {
  const int* gs;         // (E,) group sizes, or null (every row)
  __nv_bfloat16* out;    // (E, d, n)
  int E, C, d, n, tiles_m, tiles_n;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// box (c0 columns, c1 rows, c2 expert) of `map` into shared `dst`,
// completing bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// tile t: expert, first row of d, first column of n, and the expert's
// depth (its group size within C, from shared memory)
__device__ __forceinline__ void tile_of(const DwArgs& a, const int* kdeps,
                                        int t, int* e, int* m0, int* n0,
                                        int* kdep) {
  const int nt = t % a.tiles_n, r = t / a.tiles_n;
  *e = r / a.tiles_m;
  *m0 = (r % a.tiles_m) * kBM;
  *n0 = nt * kBN;
  *kdep = kdeps[*e];
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_dw_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmdy,
                       const DwArgs a) {
  extern __shared__ __align__(16) uint8_t dw_smem[];
  const uint32_t base = tc::smem_addr(dw_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* ring_ptr = dw_smem + (ring - base);
  __nv_bfloat16* stage_out =
      reinterpret_cast<__nv_bfloat16*>(ring_ptr + kStages * kStage);
  int* kdeps = reinterpret_cast<int*>(ring_ptr + kStages * kStage + kOut);
  const uint32_t full0 = ring + kStages * kStage + kOut + kGs;
  const uint32_t empty0 = full0 + kStages * 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = a.E * a.tiles_m * a.tiles_n;

  // each expert's depth, read once (a tile's start then waits on no load)
  for (int e = tid; e < a.E; e += kThreads) {
    const int g = a.gs == nullptr ? a.C : a.gs[e];
    kdeps[e] = g < 0 ? 0 : (g < a.C ? g : a.C);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: one thread issues every stage's boxes
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int e, m0, n0, kdep;
        tile_of(a, kdeps, t, &e, &m0, &n0, &kdep);
        const int nks = (kdep + kBK - 1) / kBK;
        for (int ks = 0; ks < nks; ++ks) {
          // a fresh barrier's "previous phase" counts as complete, so the
          // first pass over the ring does not wait
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t st = ring + stage * kStage;
          // boxes partly or wholly past d, n or C still count their whole
          // bytes (TMA fills the rest with zeros)
          mbar_expect_tx(full, kStage);
          tma_load_3d(st, &tmx, full, m0, ks * kBK, e);
          tma_load_3d(st + kBox, &tmx, full, m0 + 64, ks * kBK, e);
          tma_load_3d(st + 2 * kBox, &tmdy, full, n0, ks * kBK, e);
          tma_load_3d(st + 3 * kBox, &tmdy, full, n0 + 64, ks * kBK, e);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns d rows m0 + 64·wg .. + 63
  const int wg = warp / 4, wtid = tid % 128;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int e, m0, n0, kdep;
    tile_of(a, kdeps, t, &e, &m0, &n0, &kdep);
    const int nks = (kdep + kBK - 1) / kBK;
    float acc[2][32];  // columns 64h .. 64h + 63 in acc[h]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;

    for (int ks = 0; ks < nks; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t st = ring + stage * kStage;
      const int valid = kdep - ks * kBK;
      if (valid < kBK) {
        // rows valid .. 63 of this warpgroup's x box and of both dy boxes
        // hold the next expert's tokens: zero them (a row is 128 bytes
        // whatever the swizzle). Both warpgroups write the same zeros
        // into the dy boxes.
        uint8_t* sp = ring_ptr + stage * kStage;
        const int chunks = (kBK - valid) * 8;
        for (int q = wtid; q < 3 * chunks; q += 128) {
          const int box = q / chunks, c = q % chunks;
          const int off = (box == 0 ? wg : box + 1) * kBox + valid * 128 +
                          c * 16;
          *reinterpret_cast<uint4*>(sp + off) = make_uint4(0, 0, 0, 0);
        }
        tc::fence_proxy_async();
        wg_barrier(wg);
      }
      tc::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        // 16 rows of k a product: two 8-row atoms down; x's box is one
        // 64-column atom across, dy's 128 columns two atoms kBox apart
        tc::wgmma_m64n128k16<1, 1>(
            acc[0], acc[1],
            tc::wgmma_desc(st + wg * kBox + s * (16 * 128), kBox),
            tc::wgmma_desc(st + 2 * kBox + s * (16 * 128), kBox));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the previous stage's products are done
      if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    tc::wgmma_wait<0>();
    if (nks > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);

    // the warpgroup's 64 rows staged in shared memory as bf16, then
    // stored 16 bytes a thread along whole rows. Accumulator layout of
    // m64nNk16: warp w of the warpgroup holds rows 16w..16w+15; register
    // 4j+{0,1} is (lane/4, 8j + 2(lane%4) + {0,1}), 4j+{2,3} the same 8
    // rows below.
    wg_barrier(wg);  // the last tile's rows are stored
    __nv_bfloat16* so = stage_out + (size_t)wg * 64 * kOutLd;
    const int r0 = (warp % 4) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = h * 64 + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(so + r0 * kOutLd + c) =
            __floats2bfloat162_rn(acc[h][4 * j], acc[h][4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(so + (r0 + 8) * kOutLd + c) =
            __floats2bfloat162_rn(acc[h][4 * j + 2], acc[h][4 * j + 3]);
      }
    wg_barrier(wg);
    __nv_bfloat16* out = a.out + (size_t)e * a.d * a.n;
    constexpr int CH = kBN / 8;  // 16-byte chunks a row
    for (int q = wtid; q < 64 * CH; q += 128) {
      const int r = q / CH, c = (q % CH) * 8;
      const int row = m0 + wg * 64 + r, col = n0 + c;
      if (row < a.d && col < a.n)  // n % 8 == 0: a chunk is whole
        *reinterpret_cast<uint4*>(out + (size_t)row * a.n + col) =
            *reinterpret_cast<const uint4*>(so + r * kOutLd + c);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once by name (this
// library's own static: no shared header holds it)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (E, C, inner) bf16 tensor as 64 x 64 boxes with the 128-byte swizzle;
// rows past C read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int E, int C,
                int inner) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)C,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)C * inner * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// x (E,C,d), dy (E,C,n), out (E,d,n) bf16, contiguous, with d and n
// multiples of 8 and 16-byte aligned bases (TMA's strides and addresses);
// group_sizes (E <= 1024,) int32 on the device or null. `blocks`
// persistent blocks, as plan_gmm_dw decided.
int repro_gmm_blocks_dw_tma_bf16(const __nv_bfloat16* x,
                                 const __nv_bfloat16* dy,
                                 __nv_bfloat16* out, const int* group_sizes,
                                 int E, int C, int d, int n, int blocks,
                                 void* stream) {
  if (E <= 0 || d <= 0 || n <= 0) return (int)cudaGetLastError();
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(dy) |
                        reinterpret_cast<uintptr_t>(out);
  if (C < 0 || d % 8 || n % 8 || (any & 15) || blocks <= 0 ||
      E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.gs = group_sizes;
  a.out = out;
  a.E = E;
  a.C = C;
  a.d = d;
  a.n = n;
  a.tiles_m = (d + kBM - 1) / kBM;
  a.tiles_n = (n + kBN - 1) / kBN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) {  // nothing to contract: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)E * d * n * 2, st);
  }
  CUtensorMap mx, mdy;
  if (!encode_map(&mx, x, E, C, d) || !encode_map(&mdy, dy, E, C, n))
    return (int)cudaErrorInvalidValue;
  // set before every launch: no static remembers it
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_dw_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  gemm_dw_tma_kernel<<<blocks, kThreads, kSmem, st>>>(mx, mdy, a);
  return (int)cudaGetLastError();
}

// The same on the cp.async tile path (any d, n and alignment): x read
// M-major in place as the A operand; path (the tile path), bm and split
// as plan_gmm_dw decided (plan_bf16_gemm's tiles and split for (d, n, C,
// E)); split > 1 needs split·E·d·n floats of scratch.
int repro_gmm_blocks_dw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                             __nv_bfloat16* out, const int* group_sizes,
                             int E, int C, int d, int n, int path, int bm,
                             int split, float* scratch, void* stream) {
  return tc::launch_gemm_bf16_tc<true>(
      x, dy, out, nullptr, d, n, C, n, false, E, (long long)C * d,
      (long long)C * n, (long long)d * n, path, bm, split, scratch,
      static_cast<cudaStream_t>(stream), group_sizes);
}

// x (E,C,d), dy (E,C,n), out (E,d,n) f32, contiguous; expert e contracts
// over its first group_sizes[e] rows (all C where null), x read M-major
// in place on the batched tile path. path (the tile path), bm, bn and
// split as plan_gmm_dw decided; split > 1 needs split·E·d·n floats of
// scratch.
int repro_gmm_blocks_dw_f32(const float* x, const float* dy, float* out,
                            const int* group_sizes, int E, int C, int d,
                            int n, int path, int bm, int bn, int split,
                            float* scratch, void* stream) {
  using namespace repro_torch::f32;
  Problem p = make_problem(x, dy, out, nullptr, d, n, C, n);
  p.batch = E;
  p.bsa = (long long)C * d;
  p.bsb = (long long)C * n;
  p.bsc = (long long)d * n;
  p.k_limit = group_sizes;
  p.a_vec = aligned16(x) && d % 4 == 0 && p.bsa % 4 == 0;
  p.b_vec = aligned16(dy) && n % 4 == 0 && p.bsb % 4 == 0;
  return launch_planned<float, kRowLimit | kAMajorM>(
      p, false, path, bm, bn, split, 1, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
