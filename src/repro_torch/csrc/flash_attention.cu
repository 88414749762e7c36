// flash_attention: the Hopper (sm_90a) port of the Pallas prefill kernel in
// repro/kernels/attention.py (_fa_kernel, flash_attention). Plain C entry
// points, loaded with ctypes by repro_torch/kernels/_native.py.
//
// out(B,S,H,D) = softmax(mask(softcap(q k^T / sqrt(D)))) v, with q (B,S,H,D)
// and k, v (B,S,KV,D), all contiguous, any D up to 256; query head h reads
// kv head h / (H/KV) (GQA). Masks: causal (col <= row), sliding window
// (col > row - window) and the ragged end of S (col < S), all applied in
// the kernel: nothing is padded in device memory. D is zero-padded to DP
// (a compiled width >= D) in shared memory only, and output columns >= D
// are not stored.
//
// The TPU kernel walks the key blocks on a sequential grid axis and keeps
// m, l and acc in VMEM scratch across it. Hopper's blocks run in no order,
// so here a block owns a query tile and walks the key tiles in a loop,
// with m, l and acc in f32 registers (online softmax). Key tiles that the
// causal and window masks cover completely are skipped, by the block and,
// inside a tile the block takes, by each warp whose rows see none of it.
// No atomics: two launches on the same inputs give the same bits.
//
// Where the caller passes an `lse` buffer (B, H, S) f32 (the training
// path: flash_attention_bwd.cu recomputes P = exp(s - lse) from it), each
// query row's log-sum-exp m + log l of its scaled, softcapped scores is
// written there; with a key split, group 0 writes it after the merge. The
// inference path passes null and writes nothing more.
//
// bf16: tensor cores (FA2-style), one block per (b, `hb` query heads of
// one kv head, `bq` query rows), chosen on the host by plan_flash
// (kernels/attention.py). Each warp owns 16 query rows of one head.
//   * q·kᵀ and P·V are mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by
//     ldmatrix (ldmatrix.trans for V) from shared rows of DP + 8 elements:
//     the 16-byte pad puts the 8 rows of each ldmatrix phase in 8
//     distinct bank groups. A step's K or V fragments are loaded ahead of
//     its mma. The query fragments stay in registers where they fit.
//   * The score accumulator of a key tile is the A fragment of P·V: p is
//     rounded to bf16 in registers (as the Pallas kernel casts p to v's
//     dtype before P·V), and l sums the unrounded p. P never goes through
//     shared memory.
//   * A block's key tiles form a chain of dependent products and softmax
//     steps that a few warps cannot hide, so `ks` = 2 warp groups may
//     split each key stage (two tiles): group g takes tile g of every
//     stage with its own (m, l, acc), and group 0 merges the others' in
//     group order at the end, through the ring's shared memory. Twice the
//     warps, half the chain; no atomics, so two launches on the same
//     inputs give the same bits.
//   * K and V tiles (64 keys; 32 for DP > 128) arrive through a ring of
//     16-byte cp.async copies, 3 stages deep (2 with a key split or DP >
//     128); the copies of the stage NST - 1 ahead start before the
//     current stage's products, behind the one barrier a stage. The hb
//     heads of a block share each K/V tile. Rows that are not on a
//     16-byte boundary (D % 8 != 0, or an unaligned base) take element
//     loads and stores.
//   * Under causal masking the query tile is blockIdx.y reversed, so the
//     heaviest tiles of every head start first and light ones fill the
//     tail. Registers are capped at 128 for DP <= 96 (two 8-warp blocks
//     an SM).
//   * The output is staged in the warp's own query rows of shared memory
//     and stored 16 bytes at a time.
//
// f32: CUDA cores in IEEE f32 (no TF32: the lossless path matches the f32
// reference). One block per (b, h, 64-row query tile), 256 threads, tiles
// in shared memory as f32:
//   Qt [DP][64+4]   the query tile, transposed, loaded once;
//   Kt [DP][64+4]   the key tile, transposed;
//   Vs [64][DP]     the value tile;
//   Pt [64][64+4]   the probabilities of the tile, transposed.
// Thread (ty, tx) = (tid / 16, tid % 16) owns score rows ty*4..+3 and
// columns tx*4..+3 (two float4 shared loads per 16 FMAs), and output rows
// ty*4..+3, columns tx*DP/16..+DP/16-1. The 16 threads of a row group are
// one half-warp, so row max and row sum reduce with four shuffles.
//
// Bound on an H100 SXM: at the cold-LLM prefill (B=1, S=64, 15 heads,
// 5 kv heads, D=64, bf16) one launch moves 0.33 MB and its causal half is
// 7.9 MFLOP: 0.1 µs of bytes at 3.35 TB/s, so launch latency bounds it.
// granite's (1, 512, 24/8, 64) moves 4.19 MB (1.25 µs) against 0.81 GFLOP
// (0.82 µs at 989 TFLOP/s): bytes. At S=2048, 15/5 heads the causal half
// is 2·2·15·64·2048²/2 ≈ 8 GFLOP, 8 µs at the bf16 tensor-core peak:
// operations, which is why the bf16 products run on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_bf16_tc.cuh"  // smem_addr, cp.async, load_chunk, ldmatrix, mma

namespace {

namespace tc = repro_torch::tc;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// Per padded width DP (kernels/attention.py _bf16_cfg mirrors this): keys a
// tile, ring depth of an unsplit block, whether the query fragments stay in
// registers, and the blocks an SM the register cap is set for (2: at most
// 128 registers a thread at 256 threads).
template <int DP>
struct Bf16Cfg {
  static constexpr int BK = DP > 128 ? 32 : 64;
  static constexpr int NST = DP > 128 ? 2 : 3;
  static constexpr bool QREG = DP <= 64 || (DP > 96 && DP <= 128);
  static constexpr int MINB = DP <= 96 ? 2 : 1;
  static constexpr int LD = DP + 8;        // shared row stride, elements
};
constexpr int kMaxWarps = 8;

// The ring: nst stages of ks K sub-tiles then ks V sub-tiles; after the
// loop it holds the split groups' (acc, m, l) for the merge. Ahead of it,
// the query tile of every head.
template <int DP>
int bf16_stages(int ks) {
  return ks > 1 ? 2 : Bf16Cfg<DP>::NST;
}
template <int DP>
size_t bf16_smem_bytes(int bq, int hb, int ks) {
  using C = Bf16Cfg<DP>;
  const size_t q = (size_t)2 * C::LD * hb * bq;
  const size_t ring =
      (size_t)2 * C::LD * bf16_stages<DP>(ks) * 2 * ks * C::BK;
  const size_t merge = (size_t)(ks - 1) * hb * bq / 16 * 32 * (DP / 2 + 4) * 4;
  return q + (ring > merge ? ring : merge);
}

// 2^x in one MUFU instruction (2 ulp; p is rounded to bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The kernel's arguments: shapes, the plan, and the softmax constants
// (scores become log2 units: s·sl, or tanh(s·ci)·co with a softcap).
struct FaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B, H, S) f32 log-sum-exp a query row, or null
  int S, H, KV, D, bq, hb, ks, nst, causal, window, vec;
  float sl, ci, co;  // scale·log2e; scale/softcap, softcap·log2e (0: none)
};

template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32, Bf16Cfg<DP>::MINB)
    fa_bf16_kernel(const FaArgs a) {
  using Cfg = Bf16Cfg<DP>;
  constexpr int BK = Cfg::BK, LD = Cfg::LD;
  constexpr int KT = DP / 16;  // 16-deep steps of q·kᵀ
  constexpr int NT = DP / 8;   // 8-wide column blocks of the output
  constexpr int SN = BK / 8;   // 8-wide key blocks of a sub-tile
  constexpr int CH = DP / 8;   // 16-byte chunks of a shared row
  constexpr uint32_t kSubBytes = BK * LD * 2;  // one K or V sub-tile
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const int S = a.S, D = a.D, bq = a.bq, hb = a.hb, ks = a.ks, nst = a.nst;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  const uint32_t qs_a = tc::smem_addr(Qs);
  const uint32_t kv_a = qs_a + (uint32_t)hb * bq * LD * 2;
  const uint32_t stage_bytes = 2 * ks * kSubBytes;
  const int BKS = ks * BK;     // keys a stage

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wph = bq / 16;               // warps a head
  const int gw = hb * wph;               // warps a split group
  const int grp = warp / gw;             // the warp's split group
  const int hh = (warp % gw) / wph;      // its head in the block
  const int wrow = (warp % wph) * 16;    // its first row in the query tile
  // blocks start in the order of blockIdx.x (head groups) fastest: with
  // the query tile on y, reversed under causal, the heaviest tiles of
  // every head start first and the light ones fill the tail
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * bq;
  const int rep = a.H / a.KV, groups = rep / hb;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * rep + (blockIdx.x % groups) * hb;
  const int b = blockIdx.z;
  const long long qld = (long long)a.H * D, kvld = (long long)a.KV * D;
  const __nv_bfloat16* qb = a.q + (long long)b * S * qld + (long long)h0 * D;
  const __nv_bfloat16* kb =
      a.k + (long long)b * S * kvld + (long long)kvh * D;
  const __nv_bfloat16* vb =
      a.v + (long long)b * S * kvld + (long long)kvh * D;

  // the key stages some row of this block can see
  const int q_last = min(q0 + bq, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;  // exclusive
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / BKS;
  const int ntiles = (k_end + BKS - 1) / BKS - t_begin;

  // stage `t` (keys t·BKS ..) into ring slot `slot`: K rows then V rows
  auto load_stage = [&](int t, int slot) {
    const uint32_t ks_s = kv_a + slot * stage_bytes;
    const uint32_t vs_s = ks_s + ks * kSubBytes;
    const int k0 = t * BKS;
    if (a.vec) {
      const __nv_bfloat16* kt = kb + (long long)k0 * kvld;
      const __nv_bfloat16* vt = vb + (long long)k0 * kvld;
      for (int i = tid; i < BKS * CH; i += nthr) {
        const int r = i / CH, c = i - r * CH;
        const uint32_t off = (r * LD + c * 8) * 2;
        // a chunk past S or D is zero-filled from the head's own row 0
        const bool ok = k0 + r < S && c * 8 < D;
        const int src = r * (int)kvld + c * 8;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         ks_s + off),
                     "l"(ok ? kt + src : kb), "r"(ok ? 16 : 0));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         vs_s + off),
                     "l"(ok ? vt + src : vb), "r"(ok ? 16 : 0));
      }
    } else {
      for (int i = tid; i < BKS * CH; i += nthr) {
        const int r = i / CH, c = i - r * CH;
        const uint32_t off = (r * LD + c * 8) * 2;
        tc::load_chunk(ks_s + off, kb, kvld, k0 + r, S, c * 8, D, 0);
        tc::load_chunk(vs_s + off, vb, kvld, k0 + r, S, c * 8, D, 0);
      }
    }
  };

  // the query tile of every head (first copy group, with stage 0)
  for (int i = tid; i < hb * bq * CH; i += nthr) {
    const int r = i / CH, c = i - r * CH, hq = r / bq;
    tc::load_chunk(qs_a + (r * LD + c * 8) * 2, qb + hq * D, qld,
                   q0 + (r - hq * bq), S, c * 8, D, a.vec);
  }
  for (int s = 0; s < nst - 1; ++s) {
    if (s < ntiles) load_stage(t_begin + s, s);
    tc::cp_async_commit();
  }

  const int g = lane / 4, tq = lane % 4;
  const int wfirst = q0 + wrow, wlast = wfirst + 15;
  const int rowA = wfirst + g, rowB = rowA + 8;
  const bool warp_live = wfirst < S;
  // ldmatrix lane addresses: q rows (lane % 16), columns (lane / 16)·8;
  // K rows (lane / 16)·8 + lane % 8, columns ((lane / 8) % 2)·8; V (.trans)
  // rows ((lane / 8) % 2)·8 + lane % 8, columns (lane / 16)·8
  const uint32_t q_frag =
      qs_a + ((hh * bq + wrow + (lane % 16)) * LD + (lane / 16) * 8) * 2;
  const uint32_t k_off = grp * kSubBytes +
      (((lane / 16) * 8 + (lane % 8)) * LD + ((lane / 8) % 2) * 8) * 2;
  const uint32_t v_off = ks * kSubBytes + grp * kSubBytes +
      ((((lane / 8) % 2) * 8 + (lane % 8)) * LD + (lane / 16) * 8) * 2;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  uint32_t qf[Cfg::QREG ? KT : 1][4];

  for (int i = 0; i < ntiles; ++i) {
    // stage i landed (the ring's last nst - 2 stages may be in flight);
    // the slot of stage i - 1 is free
    if (nst == 3)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncthreads();
    if (i + nst - 1 < ntiles)
      load_stage(t_begin + i + nst - 1, (i + nst - 1) % nst);
    tc::cp_async_commit();
    if constexpr (Cfg::QREG) {
      if (i == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          tc::ldmatrix_x4(qf[kt], q_frag + kt * 32);
      }
    }
    const int k0 = (t_begin + i) * BKS + grp * BK;
    // a warp whose rows see none of its sub-tile skips its products
    if (!warp_live || k0 >= k_end || (a.causal && k0 > wlast) ||
        (a.window > 0 && k0 + BK - 1 <= wfirst - a.window))
      continue;
    const uint32_t st = kv_a + (i % nst) * stage_bytes;

    // scores: (16 x DP) · (DP x BK), f32 accumulators
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t af[4];
      if constexpr (Cfg::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kt][e];
      } else {
        tc::ldmatrix_x4(af, q_frag + kt * 32);
      }
      uint32_t bf[SN / 2][4];  // a step's K fragments ahead of its mma
#pragma unroll
      for (int nb = 0; nb < SN / 2; ++nb)
        tc::ldmatrix_x4(bf[nb], st + k_off + (nb * 16 * LD + kt * 16) * 2);
#pragma unroll
      for (int nb = 0; nb < SN / 2; ++nb) {
        tc::mma_16816(s[2 * nb], af, bf[nb][0], bf[nb][1]);
        tc::mma_16816(s[2 * nb + 1], af, bf[nb][2], bf[nb][3]);
      }
    }

    // scale, softcap, masks (only on a sub-tile that crosses an edge), in
    // log2 units; accumulator e holds row g (e < 2) or g + 8, column
    // 2·tq + (e & 1) of its 8-key block. Row maxima in two chains.
    const bool edge = k0 + BK > S || (a.causal && k0 + BK - 1 > wfirst) ||
                      (a.window > 0 && k0 <= wlast - a.window);
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int nb = 0; nb < SN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = a.co > 0.0f ? tanhf(s[nb][e] * a.ci) * a.co
                              : s[nb][e] * a.sl;
        if (edge) {
          const int row = e < 2 ? rowA : rowB;
          const int col = k0 + nb * 8 + 2 * tq + (e & 1);
          if (!(col < S && (!a.causal || col <= row) &&
                (a.window <= 0 || col > row - a.window)))
            x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1][nb & 1] = fmaxf(mx[e >> 1][nb & 1], x);
      }
    // online softmax: the 4 lanes of a quad share a row
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(mx[r][0], mx[r][1]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float mn = fmaxf(m_r[r], m);
      // a row that has seen no visible key yet keeps m = -inf, l = 0
      corr[r] = mn == -INFINITY ? 1.0f : fast_exp2(m_r[r] - mn);
      m_r[r] = mn;
    }
    uint32_t pf[SN][2];  // p rounded to bf16: rows g, g + 8
    float rs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int nb = 0; nb < SN; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = s[nb][2 * r], x1 = s[nb][2 * r + 1];
        const float p0 = x0 == -INFINITY ? 0.0f : fast_exp2(x0 - m_r[r]);
        const float p1 = x1 == -INFINITY ? 0.0f : fast_exp2(x1 - m_r[r]);
        rs[r][nb & 1] += p0 + p1;  // l sums p unrounded
        pf[nb][r] = tc::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_r[r] = l_r[r] * corr[r] + (rs[r][0] + rs[r][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P (16 x BK) · V (BK x DP): the score fragments of two 8-key
    // blocks are the A fragment of one 16-deep step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                              pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
      // V fragments four at a time ahead of their mma
#pragma unroll
      for (int n0 = 0; n0 < NT / 2; n0 += 4) {
        constexpr int kGroup = NT / 2 < 4 ? NT / 2 : 4;
        uint32_t bf[kGroup][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (n0 + j < NT / 2)
            tc::ldmatrix_x4_trans(
                bf[j], st + v_off + (kk * 16 * LD + (n0 + j) * 16) * 2);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (n0 + j >= NT / 2) continue;
          tc::mma_16816(acc[2 * (n0 + j)], pa, bf[j][0], bf[j][1]);
          tc::mma_16816(acc[2 * (n0 + j) + 1], pa, bf[j][2], bf[j][3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // l over the quad (each lane summed its own columns)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (ks > 1) {
    // split groups 1.. hand their (acc, m, l) to group 0 through the ring,
    // which group 0 merges in group order: the same bits every launch
    __syncthreads();  // every warp is done with the ring
    float* mb = reinterpret_cast<float*>(fa_smem + (size_t)hb * bq * LD * 2);
    constexpr int PER = DP / 2 + 4;  // floats a lane: acc, m, l
    const int slot = (warp % gw) * 32 + lane;
    if (grp > 0) {
      float* dst = mb + ((size_t)(grp - 1) * gw * 32 + slot) * PER;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[n * 4 + e] = acc[n][e];
      dst[NT * 4] = m_r[0];
      dst[NT * 4 + 1] = m_r[1];
      dst[NT * 4 + 2] = l_r[0];
      dst[NT * 4 + 3] = l_r[1];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int gi = 1; gi < ks; ++gi) {
      const float* src = mb + ((size_t)(gi - 1) * gw * 32 + slot) * PER;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mo = src[NT * 4 + r];
        const float mn = fmaxf(m_r[r], mo);
        const float fa = m_r[r] == -INFINITY ? 0.0f : exp2f(m_r[r] - mn);
        const float fb = mo == -INFINITY ? 0.0f : exp2f(mo - mn);
        l_r[r] = l_r[r] * fa + src[NT * 4 + 2 + r] * fb;
        m_r[r] = mn;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * r] = acc[n][2 * r] * fa + src[n * 4 + 2 * r] * fb;
          acc[n][2 * r + 1] =
              acc[n][2 * r + 1] * fa + src[n * 4 + 2 * r + 1] * fb;
        }
      }
    }
  }
  if (!warp_live) return;

  // m is in log2 units of the scaled (softcapped) scores
  if (a.lse != nullptr && tq == 0) {
    float* lr = a.lse + ((long long)b * a.H + h0 + hh) * S;
    if (rowA < S) lr[rowA] = m_r[0] * kLn2 + logf(l_r[0]);
    if (rowB < S) lr[rowB] = m_r[1] * kLn2 + logf(l_r[1]);
  }

  // the output staged in the warp's own query rows (no other warp reads
  // them now) and stored 16 bytes at a time
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.0f / fmaxf(l_r[r], 1e-37f);
  __nv_bfloat16* stg = Qs + (size_t)(hh * bq + wrow) * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(stg + g * LD + c) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(stg + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* out =
      a.o + (long long)b * S * qld + (long long)(h0 + hh) * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, col = (i - r * CH) * 8, row = wfirst + r;
    if (row >= S || col >= D) continue;
    __nv_bfloat16* dst = out + (long long)row * qld + col;
    const __nv_bfloat16* src = stg + r * LD + col;
    if (a.vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int n = min(8, D - col);
      for (int j = 0; j < n; ++j) dst[j] = src[j];
    }
  }
}

template <int DP>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B,
                int S, int H,
                int KV, int D, int causal, int window, float softcap, int bq,
                int hb, int ks, cudaStream_t stream) {
  const int rep = H / KV;
  const int warps = hb * bq / 16 * ks;
  if ((bq != 64 && bq != 128) || hb < 1 || rep % hb != 0 || ks < 1 ||
      ks > 2 || warps > kMaxWarps || (S + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes<DP>(bq, hb, ks);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  const float scale = 1.0f / sqrtf((float)D);
  FaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.bq = bq;
  a.hb = hb;
  a.ks = ks;
  a.nst = bf16_stages<DP>(ks);
  a.causal = causal;
  a.window = window;
  a.vec = D % 8 == 0 && (any & 15) == 0;
  a.sl = scale * kLog2e;
  a.ci = softcap > 0.0f ? scale / softcap : 0.0f;
  a.co = softcap > 0.0f ? softcap * kLog2e : 0.0f;
  dim3 grid(KV * (rep / hb), (S + bq - 1) / bq, B);
  fa_bf16_kernel<DP><<<grid, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks
constexpr int kLdQ = kBQ + kPad;
constexpr int kLdK = kBK + kPad;

template <int DP>
constexpr size_t f32_smem_floats() {
  return (size_t)DP * kLdQ + (size_t)DP * kLdK + (size_t)kBK * DP +
         (size_t)kBK * kLdQ;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, int H, int KV, int D,
                  float scale, int causal, int window, float softcap) {
  constexpr int CN = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + DP * kLdQ;
  float* Vs = Kt + DP * kLdK;
  float* Pt = Vs + kBK * DP;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  float* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  // columns D..DP-1 are zero: they add nothing to q·kᵀ and P·V
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, s = q0 + r;
    Qt[d * kLdQ + r] = s < S && d < D ? qb[(size_t)s * q_row + d] : 0.0f;
  }

  // the key tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                 // exclusive
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, s = k0 + r;
      const bool in = s < S && d < D;
      Kt[d * kLdK + r] = in ? kb[(size_t)s * kv_row + d] : 0.0f;
      Vs[r * DP + d] = in ? vb[(size_t)s * kv_row + d] : 0.0f;
    }
    __syncthreads();

    // scores: (64 x DP) · (DP x 64)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLdQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kLdK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

    // scale, softcap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float s = sc[i][j] * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        const bool ok = col < S && (!causal || col <= row) &&
                        (window <= 0 || col > row - window);
        sc[i][j] = ok ? s : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no visible key yet keeps m = -inf, l = 0
      const float corr = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            sc[i][j] == -INFINITY ? 0.0f : expf(sc[i][j] - m_new);
        rs += p;
        Pt[(tx * 4 + j) * kLdQ + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P (64 x 64) · V (64 x DP)
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * kLdQ + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CN];
#pragma unroll
      for (int c = 0; c < CN; ++c) vv[c] = Vs[kk * DP + tx * CN + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-37f);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int col = tx * CN + c;
      if (col < D) ob[(size_t)row * q_row + col] = acc[i][c] * inv_l;
    }
  }
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int S, int H, int KV, int D, int causal,
               int window, float softcap, int bq, int hb, cudaStream_t stream) {
  if (bq != kBQ || hb != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fa_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, S, H, KV, D, 1.0f / sqrtf((float)D), causal, window,
      softcap);
  return (int)cudaGetLastError();
}

// the shared checks of both entries: shapes, and dp a compiled width that
// holds D (the planner's choice)
inline int check_args(int H, int KV, int D, int dp) {
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || dp < D)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// window <= 0: no sliding window; softcap <= 0: no softcap. bq (query rows
// a head in a block), heads (query heads a block), ksplit (warp groups that
// split each key stage, 1 or 2; f32: 1) and dp (D padded in shared memory)
// as plan_flash decided. lse: (B, H, S) f32, or null (inference).
int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                              float* o, float* lse, int B, int S, int H,
                              int KV, int D, int causal, int window,
                              float softcap, int bq, int heads, int ksplit,
                              int dp, void* stream) {
  if (ksplit != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (int err = check_args(H, KV, D, dp)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_F32(W)                                                    \
  case W:                                                                  \
    return launch_f32<W>(q, k, v, o, lse, B, S, H, KV, D, causal, window,  \
                         softcap, bq, heads, st);
  switch (dp) {
    REPRO_FA_F32(32)
    REPRO_FA_F32(64)
    REPRO_FA_F32(96)
    REPRO_FA_F32(128)
    REPRO_FA_F32(192)
    REPRO_FA_F32(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_F32
}

int repro_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               float* lse, int B, int S, int H, int KV, int D,
                               int causal,
                               int window, float softcap, int bq, int heads,
                               int ksplit, int dp, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (int err = check_args(H, KV, D, dp)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_BF16(W)                                                   \
  case W:                                                                  \
    return launch_bf16<W>(q, k, v, o, lse, B, S, H, KV, D, causal, window, \
                          softcap, bq, heads, ksplit, st);
  switch (dp) {
    REPRO_FA_BF16(32)
    REPRO_FA_BF16(64)
    REPRO_FA_BF16(80)
    REPRO_FA_BF16(96)
    REPRO_FA_BF16(112)
    REPRO_FA_BF16(128)
    REPRO_FA_BF16(192)
    REPRO_FA_BF16(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_BF16
}

}  // extern "C"
