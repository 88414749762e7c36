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
// kv head h / (H/KV) (GQA). Any D up to 256.
//
// Bound on an H100 SXM: bytes. A step reads the cache once, 2·B·W·KV·D
// elements (plus 2·B·W·KV f32 scales for int8), and does 4·B·H·W·D flops:
// at smollm-360m (H 15, KV 5, D 64) that is 1.5 flops a byte in bf16, far
// below the ~295 at which the tensor cores would bound it, so the products
// stay on the CUDA cores and the design is about the loads. B=4, W=4096 in
// bf16 moves 20,971,520 B: 6.26 us at 3.35 TB/s.
//
// The TPU kernel walks the cache on a sequential grid axis and carries m,
// l and acc in VMEM scratch. Here the cache is split over W, flash-decoding
// style, so that a batch of 1 with 5 kv heads still fills the 132 SMs:
//   * grid (B·KV·head groups, split): block (b, kv head, group of up to HG
//     query heads, split s) takes cache slots [s·chunk, (s+1)·chunk). The
//     host planner (kernels/attention.py plan_decode) picks chunk and split
//     from the shapes alone, never from pos, so a decode step stays
//     capturable in a CUDA graph.
//   * Four warps a block, each on its own slice of every 4-warp tile, with
//     no barrier inside the loop. A lane owns 8 consecutive elements of D;
//     LPR lanes (4, 8, 16 or 32: the fewest that cover D) hold one cache
//     row, so a warp reads 32/LPR rows at once and a row's dot product is
//     reduced over its LPR lanes by shuffles.
//   * Loads: each lane copies its own 8 elements of k and v (16 bytes for
//     bf16, 2x16 for f32, 8 for int8, plus the two scales) with cp.async
//     into a 3-deep ring of its warp's shared memory, the rows in their own
//     dtype, two stages ahead of the one whose scores run. A lane reads
//     back only what it copied, so the ring needs no barrier. Rows that
//     the ring/window rule hides are zero-filled (src-size 0) and never
//     read from device memory; a warp stage with no visible row is skipped.
//     Rows that are not 16-byte aligned (D·sizeof not a multiple of 16, or
//     an unaligned base) take element loads instead.
//   * Softmax: every lane group keeps its own running (m, l, acc) per
//     head, rescaled once per stage of 4 rows; at the end the groups of a
//     warp merge by shuffles, the warps in a fixed order in shared memory.
//   * split > 1: each block writes its chunk's (m, l, acc) in f32 to the
//     caller's scratch; a second kernel merges the splits in split order.
//     A chunk with no visible entry writes m = -inf, l = 0, acc = 0, and
//     every merge gives such a part weight 0 (no exp(-inf - -inf) NaN).
//     No atomics: a shape gives the same bits on every launch.
//
// int8 cache: dequantized on load the way the reference rounds it,
// cache.astype(q) * scale.astype(q), i.e. for bf16 q the product
// float(k8) * float(bf16(scale)) rounded to bf16; the dot products are f32.
// For bf16 q the unnormalized p is rounded to bf16 before P·V, as the
// Pallas kernel casts p to v's dtype; l sums the unrounded p.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRPS = 4;      // rows a lane group takes per stage
constexpr int kStages = 3;   // cp.async ring depth per warp
constexpr int kEPL = 8;      // head-dim elements a lane owns
constexpr int kMaxD = 256;   // 32 lanes x 8
constexpr int kCombineThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;   // int8 scales, or nullptr
  const float* vs;
  const int* pos;
  void* o;
  float* part;       // split > 1: (acc [split,B,H,D], m [split,B,H], l)
  int B, W, H, KV, D, window;
  float softcap, scale;
  int lpr, hgroups, chunk, split, vec;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a value rounded to the type T that the reference computes in
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes a lane copies for one row of k (or v): 8 elements of C.
template <typename C>
__host__ __device__ constexpr int lane_bytes() {
  return kEPL * (int)sizeof(C);
}
// One warp stage: k rows, v rows, then (int8) the (k, v) scale pairs, each
// laid out [rps][lane] so that a warp's copies and reads are contiguous.
template <typename C>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kRPS * 32 * lane_bytes<C>() +
         (sizeof(C) == 1 ? kRPS * 32 * 8 : 0);
}

// Copy a lane's 8 elements of one cache row into shared memory: `n` of
// them are inside the row (0 when the row is hidden or past D); the rest
// are zero. vec: 16-byte (8-byte for int8) copies, whole or zero-filled.
template <typename C>
__device__ __forceinline__ void copy_row(uint32_t dst, C* dst_ptr,
                                         const C* src, int n, int vec) {
  if (vec) {
    if constexpr (sizeof(C) == 1) {
      cp_async8(dst, src, n > 0 ? 8 : 0);
    } else {
      constexpr int PER = 16 / (int)sizeof(C);  // elements a 16-byte piece
#pragma unroll
      for (int j = 0; j < kEPL / PER; ++j)
        cp_async16(dst + 16 * j, n > j * PER ? (const void*)(src + j * PER)
                                             : (const void*)src,
                   n > j * PER ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kEPL; ++e)
      dst_ptr[e] = e < n ? src[e] : C{};
  }
}

// 8 elements of C from shared memory as f32
__device__ __forceinline__ void read_row(const float* p, float (&out)[kEPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void read_row(const __nv_bfloat16* p,
                                         float (&out)[kEPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    out[2 * j] = __low2float(h);
    out[2 * j + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void read_row(const int8_t* p, float (&out)[kEPL]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// the weight of a part with running max m under the merged max mm
__device__ __forceinline__ float part_weight(float m, float mm) {
  return m == -INFINITY ? 0.0f : expf(m - mm);
}

// T: q's (and the output's) type; C: the cache's element type (T or int8);
// HG: query heads a block (1 to 4; a group of gn < HG heads masks the
// rest)
template <typename T, typename C, int HG>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  constexpr bool QUANT = sizeof(C) == 1;
  constexpr int LB = lane_bytes<C>();
  constexpr int SB = stage_bytes<C>();
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int LPR = a.lpr, RPW = 32 / LPR;
  const int grp = lane / LPR, li = lane % LPR;
  int bx = blockIdx.x;
  const int hgi = bx % a.hgroups;
  bx /= a.hgroups;
  const int kvh = bx % a.KV, b = bx / a.KV;
  const int g = a.H / a.KV;
  const int h0 = kvh * g + hgi * HG;
  const int gn = min(HG, g - hgi * HG);
  const int sp = blockIdx.y;
  const int c0 = sp * a.chunk, c1 = min(a.W, c0 + a.chunk);
  const int D = a.D, d0 = li * kEPL;
  const int nd = max(0, min(kEPL, D - d0));  // elements of D this lane owns

  const T* q = static_cast<const T*>(a.q);
  float qv[HG][kEPL];
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int e = 0; e < kEPL; ++e)
      qv[h][e] = (h < gn && e < nd)
                     ? to_f32(q[((size_t)b * a.H + h0 + h) * D + d0 + e])
                     : 0.0f;

  // the ring/window rule: slot w is visible when (p - w) mod W < nvis
  const int p = a.pos[b];
  int nvis = p < 0 ? 0 : min(p, a.W - 1) + 1;
  if (a.window > 0) nvis = min(nvis, a.window);
  const int W = a.W;
  // which of a lane's kRPS rows from w0 on (RPW apart) are visible, as a
  // bit mask: one modulo a stage
  auto visible = [&](int w0) {
    int back = (p - w0) % W;
    if (back < 0) back += W;
    unsigned mask = 0;
#pragma unroll
    for (int rp = 0; rp < kRPS; ++rp) {
      if (w0 + rp * RPW < c1 && back < nvis) mask |= 1u << rp;
      back -= RPW;
      if (back < 0) back = ((back % W) + W) % W;
    }
    return mask;
  };

  const size_t rs = (size_t)a.KV * D;  // elements between cache slots
  const size_t off0 = (size_t)b * W * rs + (size_t)kvh * D + d0;
  const C* kb = static_cast<const C*>(a.k) + off0;
  const C* vb = static_cast<const C*>(a.v) + off0;
  const size_t soff = (size_t)b * W * a.KV + kvh;

  const int TROWS = RPW * kRPS;       // rows a warp takes per stage
  const int TILE = kWarps * TROWS;    // rows a block takes per stage
  const int nst = (c1 - c0 + TILE - 1) / TILE;
  uint8_t* ring = smem + (size_t)warp * kStages * SB;
  const uint32_t ring_s = smem_addr(ring);
  auto row_of = [&](int t, int rp) {
    return c0 + t * TILE + warp * TROWS + rp * RPW + grp;
  };

  // issue stage t's copies; returns its visibility mask
  auto issue = [&](int t) {
    unsigned mask = 0;
    if (t < nst) {
      const int slot = t % kStages;
      mask = visible(row_of(t, 0));
#pragma unroll
      for (int rp = 0; rp < kRPS; ++rp) {
        const int w = row_of(t, rp);
        const bool vis = (mask >> rp) & 1u;
        const int n = vis ? nd : 0;
        const size_t o = vis ? (size_t)w * rs : 0;
        const int ko = slot * SB + (rp * 32 + lane) * LB;
        const int vo = ko + kRPS * 32 * LB;
        copy_row<C>(ring_s + ko, reinterpret_cast<C*>(ring + ko), kb + o, n,
                    a.vec);
        copy_row<C>(ring_s + vo, reinterpret_cast<C*>(ring + vo), vb + o, n,
                    a.vec);
        if constexpr (QUANT) {
          const int so = slot * SB + 2 * kRPS * 32 * LB + (rp * 32 + lane) * 8;
          const size_t si = vis ? soff + (size_t)w * a.KV : 0;
          cp_async4(ring_s + so, a.ks + si, vis ? 4 : 0);
          cp_async4(ring_s + so + 4, a.vs + si, vis ? 4 : 0);
        }
      }
    }
    cp_async_commit();
    return mask;
  };

  float m[HG], l[HG], acc[HG][kEPL];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) acc[h][e] = 0.0f;
  }

  // the masks of the stages in flight, kRPS bits each, stage t lowest
  unsigned masks = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) masks |= issue(s) << (s * kRPS);
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kStages - 2>();  // this lane's copies of stage t landed
    // into the slot read at step t - 1
    masks |= issue(t + kStages - 1) << ((kStages - 1) * kRPS);
    const unsigned vis_mask = masks & ((1u << kRPS) - 1);
    masks >>= kRPS;
    if (!__any_sync(0xffffffffu, vis_mask)) continue;

    const uint8_t* st = ring + (t % kStages) * SB;
    float s[kRPS][HG];
#pragma unroll
    for (int rp = 0; rp < kRPS; ++rp) {
      float kf[kEPL];
      read_row(reinterpret_cast<const C*>(st + (rp * 32 + lane) * LB), kf);
      if constexpr (QUANT) {
        const float sc = round_as<T>(*reinterpret_cast<const float*>(
            st + 2 * kRPS * 32 * LB + (rp * 32 + lane) * 8));
#pragma unroll
        for (int e = 0; e < kEPL; ++e) kf[e] = round_as<T>(kf[e] * sc);
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < kEPL; ++e) d = fmaf(qv[h][e], kf[e], d);
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        d *= a.scale;
        if (a.softcap > 0.0f) d = tanhf(d / a.softcap) * a.softcap;
        s[rp][h] = (vis_mask >> rp) & 1u ? d : -INFINITY;
      }
    }
    // online softmax, once for the stage's rows; s becomes p
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float mx = s[0][h];
#pragma unroll
      for (int rp = 1; rp < kRPS; ++rp) mx = fmaxf(mx, s[rp][h]);
      const float mn = fmaxf(m[h], mx);
      if (mn == -INFINITY) {  // nothing visible yet: p = 0, state kept
#pragma unroll
        for (int rp = 0; rp < kRPS; ++rp) s[rp][h] = 0.0f;
        continue;
      }
      const float corr = expf(m[h] - mn);  // 0 while m was -inf
      float ps = 0.0f;
#pragma unroll
      for (int rp = 0; rp < kRPS; ++rp) {
        const float pr = s[rp][h] == -INFINITY ? 0.0f : expf(s[rp][h] - mn);
        ps += pr;
        s[rp][h] = round_as<T>(pr);
      }
      l[h] = l[h] * corr + ps;
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) acc[h][e] *= corr;
    }
    // acc += p · v (hidden rows were zero-filled and have p = 0)
#pragma unroll
    for (int rp = 0; rp < kRPS; ++rp) {
      float vf[kEPL];
      read_row(reinterpret_cast<const C*>(st + (kRPS + rp) * 32 * LB +
                                          lane * LB),
               vf);
      if constexpr (QUANT) {
        const float sc = round_as<T>(*reinterpret_cast<const float*>(
            st + 2 * kRPS * 32 * LB + (rp * 32 + lane) * 8 + 4));
#pragma unroll
        for (int e = 0; e < kEPL; ++e) vf[e] = round_as<T>(vf[e] * sc);
      }
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int e = 0; e < kEPL; ++e)
          acc[h][e] = fmaf(s[rp][h], vf[e], acc[h][e]);
    }
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (lane ^ off holds the same d range)
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mm = fmaxf(m[h], mo);
      const float wa = part_weight(m[h], mm), wb = part_weight(mo, mm);
      l[h] = l[h] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
        acc[h][e] = acc[h][e] * wa + ao * wb;
      }
      m[h] = mm;
    }
  }

  // merge the warps, in warp order, through shared memory (the rings are
  // done: every lane waited out its copies before the barrier)
  __syncthreads();
  const int DP = LPR * kEPL;
  float* red_m = reinterpret_cast<float*>(smem);   // [kWarps][HG]
  float* red_l = red_m + kWarps * HG;              // [kWarps][HG]
  float* red_a = red_l + kWarps * HG;              // [kWarps][HG][DP]
  if (lane < LPR) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int e = 0; e < kEPL; ++e)
        red_a[(warp * HG + h) * DP + d0 + e] = acc[h][e];
      if (lane == 0) {
        red_m[warp * HG + h] = m[h];
        red_l[warp * HG + h] = l[h];
      }
    }
  }
  __syncthreads();
  const size_t BH = (size_t)a.B * a.H;
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * HG + h]);
    float A = 0.0f, L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = part_weight(red_m[w * HG + h], mm);
      A += wt * red_a[(w * HG + h) * DP + d];
      L += wt * red_l[w * HG + h];
    }
    const size_t row = (size_t)b * a.H + h0 + h;
    if (a.split == 1) {
      store_f32(static_cast<T*>(a.o) + row * D + d, A / fmaxf(L, 1e-37f));
    } else {
      a.part[((size_t)sp * BH + row) * D + d] = A;
      if (d == 0) {
        float* pm = a.part + (size_t)a.split * BH * D;
        pm[(size_t)sp * BH + row] = mm;
        pm[(size_t)a.split * BH + (size_t)sp * BH + row] = L;
      }
    }
  }
}

// Merge the splits' parts of one (b, h) in split order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                          int BH, int D, int split) {
  constexpr int U = 8;  // parts loaded before they are summed, in order
  const size_t bh = blockIdx.x;
  const float* pm = part + (size_t)split * BH * D;
  const float* pl = pm + (size_t)split * BH;
  float mm = -INFINITY;
  int s = 0;
  for (; s + U <= split; s += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = pm[(size_t)(s + u) * BH + bh];
#pragma unroll
    for (int u = 0; u < U; ++u) mm = fmaxf(mm, v[u]);
  }
  for (; s < split; ++s) mm = fmaxf(mm, pm[(size_t)s * BH + bh]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float A = 0.0f, L = 0.0f;
    for (s = 0; s + U <= split; s += U) {
      float mv[U], lv[U], av[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t i = (size_t)(s + u) * BH + bh;
        mv[u] = pm[i];
        lv[u] = pl[i];
        av[u] = part[i * D + d];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wt = part_weight(mv[u], mm);
        A += wt * av[u];
        L += wt * lv[u];
      }
    }
    for (; s < split; ++s) {
      const size_t i = (size_t)s * BH + bh;
      const float wt = part_weight(pm[i], mm);
      A += wt * part[i * D + d];
      L += wt * pl[i];
    }
    store_f32(o + bh * D + d, A / fmaxf(L, 1e-37f));
  }
}

template <typename C>
constexpr size_t smem_bytes() {
  return (size_t)kWarps * kStages * stage_bytes<C>();
}

template <typename T, typename C, int HG>
int launch(const Args& a, cudaStream_t stream) {
  // the merge buffer reuses the rings: check that it fits
  static_assert(sizeof(float) * kWarps * HG * (2 + kMaxD) <= smem_bytes<C>(),
                "merge buffer larger than the rings");
  auto kernel = decode_split_kernel<T, C, HG>;
  constexpr size_t bytes = smem_bytes<C>();
  // The shared-memory limit is a per-device attribute of the function: set
  // it at the first launch on each device, not at every decode step (this
  // source is the only one that instantiates the kernel).
  static std::atomic<unsigned long long> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  dim3 grid(a.B * a.KV * a.hgroups, a.split);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return (int)err;
  decode_combine_kernel<T><<<a.B * a.H, kCombineThreads, 0, stream>>>(
      a.part, static_cast<T*>(a.o), a.B * a.H, a.D, a.split);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int dispatch(Args& a, int hg, cudaStream_t stream) {
  // 16-byte copies (8 for int8) need every row on such a boundary
  constexpr int G = sizeof(C) == 1 ? 8 : 16;
  a.vec = reinterpret_cast<uintptr_t>(a.k) % G == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % G == 0 &&
          a.D % (G / (int)sizeof(C)) == 0;
  switch (hg) {
    case 1: return launch<T, C, 1>(a, stream);
    case 2: return launch<T, C, 2>(a, stream);
    case 3: return launch<T, C, 3>(a, stream);
    case 4: return launch<T, C, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const T* q, const void* k, const void* v, const float* ks,
          const float* vs, const int* pos, T* o, float* scratch, int B, int W,
          int H, int KV, int D, int window, float softcap, int hg,
          int hgroups, int lpr, int chunk, int split, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const bool lpr_ok = lpr == 4 || lpr == 8 || lpr == 16 || lpr == 32;
  if ((ks == nullptr) != (vs == nullptr) || W <= 0 || KV <= 0 ||
      H % KV != 0 || D <= 0 || D > kMaxD || !lpr_ok || lpr * kEPL < D ||
      hgroups <= 0 || hg * hgroups < H / KV ||
      hg * (hgroups - 1) >= H / KV || chunk <= 0 || split <= 0 ||
      (long long)split * chunk < W || (long long)(split - 1) * chunk >= W ||
      (split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = ks;
  a.vs = vs;
  a.pos = pos;
  a.o = o;
  a.part = scratch;
  a.B = B;
  a.W = W;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.window = window;
  a.softcap = softcap;
  a.scale = 1.0f / sqrtf((float)D);
  a.lpr = lpr;
  a.hgroups = hgroups;
  a.chunk = chunk;
  a.split = split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks != nullptr) return dispatch<T, int8_t>(a, hg, st);
  return dispatch<T, T>(a, hg, st);
}

}  // namespace

extern "C" {

// k, v: q's type when k_scale and v_scale are NULL, else int8 with them.
// window <= 0: no sliding window; softcap <= 0: no softcap. hg, hgroups,
// lpr, chunk and split as plan_decode decided; split > 1 needs
// split·B·H·(D+2) floats of scratch.
int repro_decode_attention_f32(const float* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* pos, float* o, float* scratch,
                               int B, int W, int H, int KV, int D, int window,
                               float softcap, int hg, int hgroups, int lpr,
                               int chunk, int split, void* stream) {
  return entry<float>(q, k, v, k_scale, v_scale, pos, o, scratch, B, W, H, KV,
                      D, window, softcap, hg, hgroups, lpr, chunk, split,
                      stream);
}

int repro_decode_attention_bf16(const __nv_bfloat16* q, const void* k,
                                const void* v, const float* k_scale,
                                const float* v_scale, const int* pos,
                                __nv_bfloat16* o, float* scratch, int B,
                                int W, int H, int KV, int D, int window,
                                float softcap, int hg, int hgroups, int lpr,
                                int chunk, int split, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, k_scale, v_scale, pos, o, scratch, B,
                              W, H, KV, D, window, softcap, hg, hgroups, lpr,
                              chunk, split, stream);
}

}  // extern "C"
