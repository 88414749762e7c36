// decode_attention: the Hopper (sm_90a) port of the Pallas decode kernel in
// repro/kernels/attention.py (_dec_kernel, decode_attention), widened to
// what the decode path of repro/models/layers.py (attn_decode_step, the
// unsharded read) computes. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
//
// One new token per row against a KV cache that is a ring buffer:
//   q (B,H,D); k, v (B,W,KV,D) in q's type, or int8 with per-entry scales
//   k_scale, v_scale (B,W,KV) f32; pos (B,) int32, the new token's position.
// Cache slot w holds position e = pos - ((pos - w) mod W); it is visible
// when e >= 0 and, with a window, e > pos - window. With pos = length - 1
// and W = S this is the Pallas kernel's prefix rule (col < length).
// out(b,h) = softmax(mask(softcap(q k^T / sqrt(D)))) v, query head h reading
// kv head h / (H/KV) (GQA).
//
// The TPU kernel walks the cache on a sequential grid axis and carries m, l
// and acc in VMEM scratch; here one block owns one (b, kv head) with up to
// kGMax query heads of its group folded in (a larger group is split over
// grid.y) and walks the cache in tiles of kTK entries, with an online
// softmax whose m, l and acc are f32. A tile whose entries are all masked is
// skipped before any of its bytes are read, and masked entries inside a
// tile are not read either.
//
// int8 cache: dequantized on load the way the reference rounds it,
// cache.astype(q) * scale.astype(q), i.e. for bf16 q the product
// float(k8) * float(bf16(scale)) rounded to bf16; the dot products are f32.
// For bf16 q the unnormalized p is rounded to bf16 before P·V, as the
// Pallas kernel casts p to v's dtype; l sums the unrounded p.
//
// One block: 128 threads; shared memory (f32, converted on load):
//   Vs [kTK][D]      the value tile;
//   Qs [kGMax][D]    the group's query rows, loaded once;
//   Ks [kTK][D+1]    the key tile, rows padded so that a warp reading one
//                    column of 32 rows hits 32 banks;
//   Ps [kGMax][kTK]  scores, then probabilities, of the tile.
// Scores: thread -> (head, entry) pairs, a D-long dot product each. Softmax:
// one warp a head, two entries a lane, shuffle reductions. P·V: thread ->
// (head, d) pairs, held in registers across tiles.
//
// Bound on an H100 SXM: bytes. A step reads the cache once, 2·B·W·KV·D
// elements (plus 2·B·W·KV f32 scales for int8), and does 4·B·H·W·D flops:
// at smollm-360m (H 15, KV 5, D 64) that is 1.5 flops a byte in bf16, far
// below the ~295 at which the tensor cores would bound it. B=4, W=4096 in
// bf16 moves 20,971,520 B: 6.26 us at 3.35 TB/s. At batch 1 a model with
// KV=5 gives this kernel 5 blocks on 132 SMs, so one block's load rate
// sets its time: a split over W with a combining pass is the remedy, later.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 64;     // cache entries per tile
constexpr int kGMax = 8;    // query heads per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a value rounded to the type T that the reference computes in
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive elements as f32 (the row offsets are multiples of 4
// elements, so each load is aligned)
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(b); out[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const int8_t* p, float out[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  out[0] = (float)c.x; out[1] = (float)c.y;
  out[2] = (float)c.z; out[3] = (float)c.w;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kTK * D + (size_t)kGMax * D + (size_t)kTK * (D + 1) +
         (size_t)kGMax * kTK + 3 * kGMax + kTK;
}

// T: q's (and the output's) type; C: the cache's element type (T or int8)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                  const C* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ pos, T* __restrict__ o, int W,
                  int H, int KV, float scale, int window, float softcap) {
  constexpr int LDK = D + 1;
  constexpr int CH = D / 4;                      // 4-element chunks a row
  constexpr int R = (kGMax * D + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem;
  float* Qs = Vs + kTK * D;
  float* Ks = Qs + kGMax * D;
  float* Ps = Ks + kTK * LDK;
  float* Ms = Ps + kGMax * kTK;
  float* Ls = Ms + kGMax;
  float* Cs = Ls + kGMax;
  int* Valid = reinterpret_cast<int*>(Cs + kGMax);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int g = H / KV;
  const int h0 = kvh * g + blockIdx.y * kGMax;   // first query head here
  const int gn = min(kGMax, g - (int)blockIdx.y * kGMax);
  const int p = pos[b];
  const bool quant = k_scale != nullptr;

  for (int i = tid; i < gn * D; i += kThreads)
    Qs[i] = to_f32(q[((size_t)b * H + h0) * D + i]);
  if (tid < kGMax) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.0f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  const size_t row_stride = (size_t)KV * D;      // between cache slots
  const C* kb = k + (size_t)b * W * row_stride + (size_t)kvh * D;
  const C* vb = v + (size_t)b * W * row_stride + (size_t)kvh * D;
  const size_t sc_off = (size_t)b * W * KV + kvh;

  for (int t0 = 0; t0 < W; t0 += kTK) {
    // which entries of the tile are visible (the ring/window rule)
    int mine = 0;
    if (tid < kTK) {
      const int w = t0 + tid;
      if (w < W) {
        int back = (p - w) % W;
        if (back < 0) back += W;
        const int e = p - back;
        mine = e >= 0 && (window <= 0 || e > p - window);
      }
      Valid[tid] = mine;
    }
    // also the barrier after the previous tile's P·V
    if (!__syncthreads_or(mine)) continue;

    for (int i = tid; i < kTK * CH; i += kThreads) {
      const int j = i / CH, c = (i % CH) * 4;
      float kv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float vv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (Valid[j]) {
        const size_t off = (size_t)(t0 + j) * row_stride + c;
        load4(kb + off, kv4);
        load4(vb + off, vv4);
        if (quant) {
          const size_t s = sc_off + (size_t)(t0 + j) * KV;
          const float ks = round_as(k_scale[s], q);
          const float vs = round_as(v_scale[s], q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kv4[e] = round_as(kv4[e] * ks, q);
            vv4[e] = round_as(vv4[e] * vs, q);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) Ks[j * LDK + c + e] = kv4[e];
      *reinterpret_cast<float4*>(&Vs[j * D + c]) =
          make_float4(vv4[0], vv4[1], vv4[2], vv4[3]);
    }
    __syncthreads();

    // scores of (head, entry): scale, softcap, mask
    for (int i = tid; i < gn * kTK; i += kThreads) {
      const int h = i / kTK, j = i % kTK;
      const float* qr = Qs + h * D;
      const float* kr = Ks + j * LDK;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      Ps[h * kTK + j] = Valid[j] ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp a head
    for (int h = warp; h < gn; h += kWarps) {
      float s0 = Ps[h * kTK + lane], s1 = Ps[h * kTK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[h];
      const float m_new = fmaxf(m_old, mx);
      // a head that has seen no visible entry keeps m = -inf, l = 0
      const float corr = m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
      const float p0 = s0 == -INFINITY ? 0.0f : expf(s0 - m_new);
      const float p1 = s1 == -INFINITY ? 0.0f : expf(s1 - m_new);
      Ps[h * kTK + lane] = round_as(p0, q);
      Ps[h * kTK + lane + 32] = round_as(p1, q);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (lane == 0) {
        Ls[h] = Ls[h] * corr + rs;
        Ms[h] = m_new;
        Cs[h] = corr;
      }
    }
    __syncthreads();

    // acc(h, d) = acc * corr + P(h, :) · V(:, d)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * kThreads;
      if (i < gn * D) {
        const int h = i / D, d = i % D;
        const float* pr = Ps + h * kTK;
        float a = acc[r] * Cs[h];
#pragma unroll 8
        for (int j = 0; j < kTK; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * kThreads;
    if (i < gn * D) {
      const int h = i / D;
      store_f32(o + ((size_t)b * H + h0) * D + i,
                acc[r] / fmaxf(Ls[h], 1e-37f));
    }
  }
}

template <typename T, typename C, int D>
int launch_dec(const T* q, const C* k, const C* v, const float* ks,
               const float* vs, const int* pos, T* o, int B, int W, int H,
               int KV, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  // The shared-memory limit is a per-device attribute of the function:
  // set it at the first launch on each device, not at every decode step.
  static std::atomic<unsigned long long> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(decode_kernel<T, C, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const int g = H / KV;
  dim3 grid(B * KV, (g + kGMax - 1) / kGMax);
  decode_kernel<T, C, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, ks, vs, pos, o, W, H, KV, 1.0f / sqrtf((float)D), window,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int dispatch_dec(const T* q, const C* k, const C* v, const float* ks,
                 const float* vs, const int* pos, T* o, int B, int W, int H,
                 int KV, int D, int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (W <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dec<T, C, 32>(q, k, v, ks, vs, pos, o, B, W, H, KV,
                                  window, softcap, st);
    case 64:
      return launch_dec<T, C, 64>(q, k, v, ks, vs, pos, o, B, W, H, KV,
                                  window, softcap, st);
    case 128:
      return launch_dec<T, C, 128>(q, k, v, ks, vs, pos, o, B, W, H, KV,
                                   window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const T* q, const void* k, const void* v, const float* ks,
          const float* vs, const int* pos, T* o, int B, int W, int H, int KV,
          int D, int window, float softcap, void* stream) {
  if ((ks == nullptr) != (vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (ks != nullptr)
    return dispatch_dec<T, int8_t>(q, static_cast<const int8_t*>(k),
                                   static_cast<const int8_t*>(v), ks, vs, pos,
                                   o, B, W, H, KV, D, window, softcap, stream);
  return dispatch_dec<T, T>(q, static_cast<const T*>(k),
                            static_cast<const T*>(v), nullptr, nullptr, pos,
                            o, B, W, H, KV, D, window, softcap, stream);
}

}  // namespace

extern "C" {

// k, v: q's type when k_scale and v_scale are NULL, else int8 with them.
// window <= 0: no sliding window; softcap <= 0: no softcap.
int repro_decode_attention_f32(const float* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* pos, float* o, int B, int W, int H,
                               int KV, int D, int window, float softcap,
                               void* stream) {
  return entry<float>(q, k, v, k_scale, v_scale, pos, o, B, W, H, KV, D,
                      window, softcap, stream);
}

int repro_decode_attention_bf16(const __nv_bfloat16* q, const void* k,
                                const void* v, const float* k_scale,
                                const float* v_scale, const int* pos,
                                __nv_bfloat16* o, int B, int W, int H, int KV,
                                int D, int window, float softcap,
                                void* stream) {
  return entry<__nv_bfloat16>(q, k, v, k_scale, v_scale, pos, o, B, W, H, KV,
                              D, window, softcap, stream);
}

}  // extern "C"
