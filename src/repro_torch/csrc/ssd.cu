// ssd_scan: the Hopper (sm_90a) port of the Pallas kernel in
// repro/kernels/ssd.py (_ssd_kernel, ssd_scan), the Mamba2 SSD chunked scan,
// extended to what the model's ssd_chunked computes: an optional initial
// state and the final state. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/_native.py.
//
//   x (B,S,H,P) and Bm, Cm (B,S,N) in float or bf16 (G = 1: B and C shared
//   by every head); dt (B,S,H), A (H), D (H) and the states f32. Per chunk
//   of Q tokens, with cum the within-chunk cumulative sum of dt·A:
//     y_i   = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i·state + D x_i
//     state = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
//   y in x's dtype; the final state (P,N) per (b, h), as ssd_chunked
//   returns it.
//
// The Pallas kernel walks a sequential grid axis over the chunks with the
// state in VMEM. Hopper's blocks run in no order, so the scan is split as
// Mamba2's own GPU implementation splits it (arXiv:2405.21060, "SSD
// algorithm"; mamba_ssm's _chunk_cumsum/_bmm_chunk, _chunk_state,
// _state_passing and _chunk_scan), in four kernels on one stream, each
// parallel over chunks wherever the algebra allows:
//
//   1. cum_cb, per (b, chunk): cum (B,nc,H,Q), one warp a head (lane runs,
//      then a shuffle scan of their sums), and CB = C·B^T (B,nc,Q,Q) f32 for
//      the 64x64 tiles on and below the diagonal only, once for all heads
//      (G = 1). bf16: mma.sync m16n8k16 from ldmatrix, f32 accumulators
//      (the products of bf16 values are exact in f32); f32: CUDA cores.
//   2. state, per (b, chunk, h, 64 state rows): the chunk's own state s_c
//      (N,P) = sum_j B_j^T (w_j x_j), w_j = exp(cum_last - cum_j) dt_j,
//      into a scratch (B,nc,H,N,P).
//   3. pass, per (b, h, 32 state rows): in_0 = init (or zero), in_{c+1} =
//      fmaf(in_c, exp(cum_last,c), s_c) in chunk order, written over s_c
//      in place; the final state in_nc is written as (P,N). A kernel of
//      its own: folding it into phase 4's fill of the state (each block
//      walking the chunks before its own) was slower at 2 and 4 chunks.
//   4. out, per (b, chunk, h, 64-row tile): acc =
//      C_i·in_c over 64-deep N stages, scaled by exp(cum_i); then for the
//      64-wide column stages j0 <= the tile's last row, G_ij = CB_ij ·
//      exp(cum_i - cum_j) dt_j where j <= i (exp is taken nowhere else:
//      above the diagonal it may overflow), acc += G·x_j; y = acc + D x_i.
//      The row tiles are launched heaviest first (blockIdx.z reversed:
//      tile i walks i + 1 column stages).
//
// f32 (the lossless path): every product is an IEEE f32 FMA on the CUDA
// cores (no TF32). A thread holds an 8x4 tile of outputs, rows ty + 8r
// (phase 4) or ty*8 + r (phase 2) and columns tx*4 + s, and reads its
// operands from shared memory as float4 rows of pitch 68 floats.
//
// bf16: phases 2 and 4 run on the tensor cores too. Their products with an
// f32 operand v (w·x, the carried state, G) take v = hi + lo, hi = bf16(v),
// lo = bf16(v - hi): two mma.sync into one f32 accumulator carry v·b to
// about 2^-17 of it, while the bf16 operand (x, B, C) is exact. The state
// itself is stored in f32 only; the split lives in shared memory.
//
// Stages are filled two ways: bf16 rows that go in unchanged (x, B, C on
// the tensor-core path) by 16-byte cp.async; everything else through
// registers, each thread issuing a group of loads before it transforms or
// stores any of them (their latencies overlap; the group is small where
// the transform takes exp, to keep the registers). 16-byte loads where
// P, N and Q allow (and the pointers are aligned), else element loads;
// ragged P, N and Q are zero-filled and masked in the stores. No atomics;
// every sum runs in a fixed order: two launches on the same inputs give
// the same bits.
//
// Bound on an H100 SXM: mamba2-2.7b (H 80, P 64, N 128, Q 256) at S 1024
// needs 4.07 GFLOP over the lower triangle of each chunk, C·B^T counted
// once per (b, chunk), against about 24 MB of traffic: in f32 the
// operations bound it (0.061 ms at 67 TFLOP/s), in bf16 the bytes (0.0072
// ms at 3.35 TB/s). Phases 2 and 4 carry 99 % of the multiply-adds; at B 1
// they launch 640 and 1280 blocks (the old kernel: 80, one a (b, h), with
// C·B^T recomputed in every head, 6.7 GFLOP). What holds the bf16 path
// above its bound is the traffic through L2 (each head's block rereads the
// chunk's f32 C·B^T tiles and the carried state) and the fills' latency;
// left for later: TMA rings that overlap a stage's fill with the last
// stage's products, and CB read once for several heads.
#include "ssd_common.cuh"  // stages, fills, the hi + lo split, phase 2

namespace {

constexpr int kCumHeads = 4;   // phase 1: heads of a cum block (a warp each)
constexpr int kPassRows = 32;  // phase 3: state rows (n) of a block

// G_ij = CB_ij exp(cum_i - cum_j) dt_j for columns j..j+3 of row i, zero
// above the diagonal (where exp is not taken)
__device__ __forceinline__ float4 g4(float4 cbv, int i, int j,
                                     const float* cum_s, const float* dt_s) {
  const float ci = cum_s[i];
  float o[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    o[u] = j + u <= i ? comp(cbv, u) * expf(ci - cum_s[j + u]) * dt_s[j + u]
                      : 0.0f;
  return make_float4(o[0], o[1], o[2], o[3]);
}

// The chunk's cum and dt of head h into shared memory (cum_s, dt_s: Q each)
template <int THREADS>
__device__ __forceinline__ void chunk_cum_dt(const float* cum,
                                             const float* dt, const Dims& d,
                                             int b, int c, int h,
                                             float* cum_s, float* dt_s) {
  const float* cumh = cum + (((size_t)b * d.nc + c) * d.H + h) * d.Q;
  const float* dth = dt + ((size_t)b * d.S + (size_t)c * d.Q) * d.H + h;
  for (int q = threadIdx.x; q < d.Q; q += THREADS) {
    cum_s[q] = cumh[q];
    dt_s[q] = dth[(size_t)q * d.H];
  }
}

// ---------------------------------------------------------------------------
// phase 1: cum and C·B^T
// ---------------------------------------------------------------------------
__device__ void cum_heads(const float* __restrict__ dt,
                          const float* __restrict__ A, float* __restrict__ cum,
                          const Dims& d, int b, int c, int h0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = h0 + warp;
  if (h >= d.H) return;
  const float a = A[h];
  const float* dth = dt + ((size_t)b * d.S + (size_t)c * d.Q) * d.H + h;
  float* out = cum + (((size_t)b * d.nc + c) * d.H + h) * d.Q;
  const int seg = (d.Q + 31) / 32;
  const int q0 = min(lane * seg, d.Q), q1 = min(q0 + seg, d.Q);
  float run = 0.0f;
  for (int q = q0; q < q1; ++q) {
    run += dth[(size_t)q * d.H] * a;
    out[q] = run;
  }
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  const float base = inc - run;
  for (int q = q0; q < q1; ++q) out[q] += base;
}

// f32: CB tile (i0, j0) on the CUDA cores. Thread (tx, ty) owns rows
// ty + 8r and columns tx + 16s, both read along N as float4 rows.
__device__ void cb_tile_f32(const float* __restrict__ Bm,
                            const float* __restrict__ Cm,
                            float* __restrict__ cb, const Dims& d, int b,
                            int c, int i0, int j0) {
  __shared__ __align__(16) float Cs[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* Cc = Cm + ((size_t)b * d.S + (size_t)c * d.Q) * d.N;
  const float* Bc = Bm + ((size_t)b * d.S + (size_t)c * d.Q) * d.N;
  float acc[8][4] = {};
  for (int n0 = 0; n0 < d.N; n0 += kT) {
    __syncthreads();
    // rows 0..63 of the fill: C's tile rows; 64..127: B's
    fill<16, 128, 16, 4>(
        [&](int r, int k4) {
          const int q = (r < kT ? i0 : j0 - kT) + r;
          return q < d.Q ? load4((r < kT ? Cc : Bc) + (size_t)q * d.N,
                                 n0 + k4, d.N, d.vec)
                         : zero4();
        },
        [&](int r, int k4, float4 v) {
          st4(r < kT ? &Cs[r * kLd + k4] : &Bs[(r - kT) * kLd + k4], v);
        });
    __syncthreads();
    const int kend = min(kT, d.N - n0);
    for (int k4 = 0; k4 < kend; k4 += 4) {
      float4 a[8], bv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = ld4(&Cs[(ty + 8 * r) * kLd + k4]);
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = ld4(&Bs[(tx + 16 * s) * kLd + k4]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc[r][s] = fmaf(a[r].x, bv[s].x, acc[r][s]);
          acc[r][s] = fmaf(a[r].y, bv[s].y, acc[r][s]);
          acc[r][s] = fmaf(a[r].z, bv[s].z, acc[r][s]);
          acc[r][s] = fmaf(a[r].w, bv[s].w, acc[r][s]);
        }
    }
  }
  float* out = cb + ((size_t)b * d.nc + c) * d.Q * d.Q;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty + 8 * r;
    if (i >= d.Q) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j < d.Q) out[(size_t)i * d.Q + j] = acc[r][s];
    }
  }
}

// bf16: CB tile (i0, j0) on the tensor cores. Warp w owns rows 16w..16w+15
// and all 64 columns; C and B rows of the tile sit in shared memory as
// bf16, N padded to 16 plus an 8-element pad (an odd number of 16-byte
// chunks a row).
__device__ void cb_tile_bf16(const __nv_bfloat16* __restrict__ Bm,
                             const __nv_bfloat16* __restrict__ Cm,
                             float* __restrict__ cb, const Dims& d, int b,
                             int c, int i0, int j0) {
  constexpr int kLdMax = kNMax + 8;
  __shared__ __align__(16) __nv_bfloat16 Cs[kT * kLdMax];
  __shared__ __align__(16) __nv_bfloat16 Bs[kT * kLdMax];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int npad = (d.N + 15) / 16 * 16, ld = npad + 8, chunks = npad / 8;
  const __nv_bfloat16* Cc = Cm + ((size_t)b * d.S + (size_t)c * d.Q) * d.N;
  const __nv_bfloat16* Bc = Bm + ((size_t)b * d.S + (size_t)c * d.Q) * d.N;
  const uint32_t cs = tc::smem_addr(Cs), bs = tc::smem_addr(Bs);
  for (int e = tid; e < kT * chunks; e += 128) {
    const int r = e / chunks, ch = e % chunks;
    const uint32_t off = (uint32_t)(r * ld + ch * 8) * 2;
    tc::load_chunk(cs + off, Cc, d.N, i0 + r, d.Q, ch * 8, d.N, d.vec);
    tc::load_chunk(bs + off, Bc, d.N, j0 + r, d.Q, ch * 8, d.N, d.vec);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  float acc[8][4] = {};
  // ldmatrix lane addresses: A rows (lane % 16), columns (lane / 16)·8; B
  // rows (lane / 16)·8 + lane % 8 of each 16-row pair, columns
  // ((lane / 8) % 2)·8
  const uint32_t a_addr =
      cs + (uint32_t)((16 * warp + lane % 16) * ld + (lane / 16) * 8) * 2;
  const uint32_t b_addr =
      bs + (uint32_t)(((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8) *
               2;
  for (int kt = 0; kt < npad / 16; ++kt) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, a_addr + kt * 32);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, b_addr + (uint32_t)(nb * 16 * ld) * 2 + kt * 32);
      tc::mma_16816(acc[2 * nb], af, bf[0], bf[1]);
      tc::mma_16816(acc[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
  // accumulator e of n-block nt: row g (e < 2) or g + 8, column
  // 8·nt + 2·tq + (e & 1)
  float* out = cb + ((size_t)b * d.nc + c) * d.Q * d.Q;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 16 * warp + g + (e >= 2 ? 8 : 0);
      const int j = j0 + 8 * nt + 2 * tq + (e & 1);
      if (i < d.Q && j < d.Q) out[(size_t)i * d.Q + j] = acc[nt][e];
    }
}

// grid (ntri + ceil(H / kCumHeads), nc, B), 128 threads: blocks below
// ntri take CB tile pair blockIdx.x (row tile ti >= column tile tj), the
// rest the cum of kCumHeads heads
template <typename T>
__global__ void __launch_bounds__(128)
    ssd_cum_cb_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, float* __restrict__ cum,
                      float* __restrict__ cb, Dims d, int ntri) {
  const int c = blockIdx.y, b = blockIdx.z;
  if ((int)blockIdx.x >= ntri) {
    cum_heads(dt, A, cum, d, b, c, ((int)blockIdx.x - ntri) * kCumHeads);
    return;
  }
  int t = blockIdx.x, ti = 0;
  while (t > ti) t -= ++ti;
  if constexpr (sizeof(T) == 2)
    cb_tile_bf16(Bm, Cm, cb, d, b, c, ti * kT, t * kT);
  else
    cb_tile_f32(Bm, Cm, cb, d, b, c, ti * kT, t * kT);
}

// ---------------------------------------------------------------------------
// phase 2: each chunk's own state
// ---------------------------------------------------------------------------
// f32: grid (H, B * nc, ceil(N / 64)), 128 threads (ssd_common.cuh)
__global__ void __launch_bounds__(128, 4)
    ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Bm,
                     const float* __restrict__ cum,
                     float* __restrict__ states, Dims d) {
  state_f32<false>(x, dt, Bm, cum, states, d);
}

// bf16: grid (H, B * nc, ceil(N / 64)), 128 threads (ssd_common.cuh)
__global__ void __launch_bounds__(128)
    ssd_state_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const __nv_bfloat16* __restrict__ Bm,
                        const float* __restrict__ cum,
                        float* __restrict__ states, Dims d) {
  state_tc<false>(x, dt, Bm, cum, states, d);
}

// ---------------------------------------------------------------------------
// phase 3: state passing
// ---------------------------------------------------------------------------
// grid (ceil(N / kPassRows), B * H), 256 threads: state rows n0 .. n0 +
// 31 of one (b, h); init and the final state go through a shared tile
// [P][33] so that both their (P,N) rows and the scratch's (N,P) rows are
// read and written along contiguous addresses. The chunks' decays are
// taken once into shared memory (dec_s: nc), and a thread's elements walk
// the chunks together: the loads of a chunk are all in flight before its
// stores.
__global__ void __launch_bounds__(256)
    ssd_pass_kernel(const float* __restrict__ cum,
                    const float* __restrict__ init, float* __restrict__ states,
                    float* __restrict__ final_state, Dims d) {
  constexpr int kPer = kPMax * kPassRows / 256;  // elements a thread
  __shared__ float T[kPMax * (kPassRows + 1)];
  extern __shared__ float dec_s[];
  const int n0 = blockIdx.x * kPassRows, bh = blockIdx.y;
  const int b = bh / d.H, h = bh % d.H, tid = threadIdx.x;
  const int rows = min(kPassRows, d.N - n0);
  const float* ini = init + (size_t)bh * d.P * d.N;
  float* fin = final_state + (size_t)bh * d.P * d.N;
  for (int c = tid; c < d.nc; c += 256)
    dec_s[c] = expf(cum[(((size_t)b * d.nc + c) * d.H + h) * d.Q + d.Q - 1]);
  for (int e = tid; e < d.P * kPassRows; e += 256) {
    const int p = e / kPassRows, nn = e % kPassRows;
    T[p * (kPassRows + 1) + nn] =
        (init != nullptr && nn < rows) ? ini[(size_t)p * d.N + n0 + nn] : 0.0f;
  }
  __syncthreads();
  float v[kPer];
  int slot[kPer];  // T index of the element, -1 past the block's rows
  size_t off[kPer];
  const size_t cstride = (size_t)d.H * d.N * d.P;
  float* s0 = states + (((size_t)b * d.nc * d.H + h) * d.N + n0) * d.P;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + 256 * k, nn = e / d.P, p = e % d.P;
    slot[k] = nn < rows ? p * (kPassRows + 1) + nn : -1;
    off[k] = (size_t)nn * d.P + p;
    v[k] = slot[k] >= 0 ? T[slot[k]] : 0.0f;
  }
  for (int c = 0; c < d.nc; ++c) {
    const float dec = dec_s[c];
    float* sc = s0 + c * cstride;
    float sv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) sv[k] = slot[k] >= 0 ? sc[off[k]] : 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (slot[k] < 0) continue;
      sc[off[k]] = v[k];
      v[k] = fmaf(v[k], dec, sv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (slot[k] >= 0) T[slot[k]] = v[k];
  __syncthreads();
  for (int e = tid; e < d.P * rows; e += 256) {
    const int p = e / rows, nn = e % rows;
    fin[(size_t)p * d.N + n0 + nn] = T[p * (kPassRows + 1) + nn];
  }
}

// ---------------------------------------------------------------------------
// phase 4: the output
// ---------------------------------------------------------------------------
// f32: grid (H, B * nc, tiles), 128 threads. Thread (tx, ty) owns rows
// i0 + ty + 8r (r < 8) and columns tx*4 .. +3 of y. Each stage holds an A
// tile [64][k] (C_i's N slice, then G_ij) and a B tile [k][p] (the
// state's N slice, then x_j), k 64 deep.
__global__ void __launch_bounds__(128, 4)
    ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Cm, const float* __restrict__ Dv,
                   const float* __restrict__ cum, const float* __restrict__ cb,
                   const float* __restrict__ states, float* __restrict__ y,
                   Dims d, int tiles) {
  constexpr int kThreads = 128, BM = kT, RM = 8;
  constexpr int kItems = 16 * kT / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [BM][kLd]
  float* Bs = As + BM * kLd;     // [kT][kLd]
  float* cum_s = Bs + kT * kLd;  // [Q] cum of this (b, chunk, h)
  float* dt_s = cum_s + d.Q;     // [Q] dt of this (b, chunk, h)
  const int h = blockIdx.x, b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int i0 = (tiles - 1 - (int)blockIdx.z) * BM;  // heaviest first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t xrow = (size_t)d.H * d.P;
  const float* xh = x + tok0 * xrow + (size_t)h * d.P;
  chunk_cum_dt<kThreads>(cum, dt, d, b, c, h, cum_s, dt_s);

  float acc[RM][4] = {};
  auto product = [&](int kend) {
    for (int k4 = 0; k4 < kend; k4 += 4) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = ld4(&As[(ty + 8 * r) * kLd + k4]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 bv = ld4(&Bs[(k4 + u) * kLd + tx * 4]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float av = comp(a[r], u);
          acc[r][0] = fmaf(av, bv.x, acc[r][0]);
          acc[r][1] = fmaf(av, bv.y, acc[r][1]);
          acc[r][2] = fmaf(av, bv.z, acc[r][2]);
          acc[r][3] = fmaf(av, bv.w, acc[r][3]);
        }
      }
    }
  };

  // exp(cum_i) C_i · in_c, skipped where in_c is zero (first chunk, no init)
  if (c > 0 || d.has_init) {
    const float* Cc = Cm + tok0 * d.N;
    const float* in_c =
        states + (((size_t)b * d.nc + c) * d.H + h) * d.N * d.P;
    for (int n0 = 0; n0 < d.N; n0 += kT) {
      __syncthreads();
      fill<kItems, kThreads, 16, 4>(
          [&](int r, int k4) {
            return i0 + r < d.Q
                       ? load4(Cc + (size_t)(i0 + r) * d.N, n0 + k4, d.N, d.vec)
                       : zero4();
          },
          [&](int r, int k4, float4 v) { st4(&As[r * kLd + k4], v); });
      fill<kItems, kThreads, 16, 4>(
          [&](int k, int p4) {
            return n0 + k < d.N
                       ? load4(in_c + (size_t)(n0 + k) * d.P, p4, d.P, d.vec)
                       : zero4();
          },
          [&](int k, int p4, float4 v) { st4(&Bs[k * kLd + p4], v); });
      __syncthreads();
      product(min(kT, d.N - n0));
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = i0 + ty + 8 * r;
      const float e = i < d.Q ? expf(cum_s[i]) : 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] *= e;
    }
  }

  // + sum over column stages j0 <= the tile's last row of G_ij x_j
  const float* cbc = cb + ((size_t)b * d.nc + c) * d.Q * d.Q;
  const int jend = min(i0 + BM, d.Q);
  for (int j0 = 0; j0 < jend; j0 += kT) {
    __syncthreads();
    fill<kItems, kThreads, 16, 2>(
        [&](int r, int k4) {
          const int i = i0 + r;
          return i < d.Q && j0 + k4 <= i
                     ? load4(cbc + (size_t)i * d.Q, j0 + k4, d.Q, d.vec)
                     : zero4();
        },
        [&](int r, int k4, float4 v) {
          const int i = i0 + r;
          st4(&As[r * kLd + k4], i < d.Q ? g4(v, i, j0 + k4, cum_s, dt_s)
                                         : zero4());
        });
    fill<kItems, kThreads, 16, 4>(
        [&](int k, int p4) {
          return j0 + k < d.Q ? load4(xh + (j0 + k) * xrow, p4, d.P, d.vec)
                              : zero4();
        },
        [&](int k, int p4, float4 v) { st4(&Bs[k * kLd + p4], v); });
    __syncthreads();
    product(min(kT, jend - j0));
  }

  // y = acc + D x_i
  const float dh = Dv[h];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + ty + 8 * r;
    if (i >= d.Q) continue;
    const float4 xv = load4(xh + (size_t)i * xrow, tx * 4, d.P, d.vec);
    float* yo = y + (tok0 + i) * xrow + (size_t)h * d.P;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tx * 4 + s;
      if (p < d.P) yo[p] = fmaf(dh, comp(xv, s), acc[r][s]);
    }
  }
}

// bf16: grid (H, B * nc, tiles), 128 threads (4 warps). Stage tiles A0,
// A1, B0, B1 [64][kLdh]: a state stage holds C_i (A0)
// and in_c as hi + lo (B0, B1); a column stage G_ij as hi + lo (A0, A1)
// and x_j (B0).
__global__ void __launch_bounds__(128)
    ssd_out_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ dt,
                      const __nv_bfloat16* __restrict__ Cm,
                      const float* __restrict__ Dv,
                      const float* __restrict__ cum,
                      const float* __restrict__ cb,
                      const float* __restrict__ states,
                      __nv_bfloat16* __restrict__ y, Dims d, int tiles) {
  constexpr int kThreads = 128, BM = kT;
  constexpr int kItems = 16 * kT / kThreads;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* A0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* A1 = A0 + BM * kLdh;
  __nv_bfloat16* B0 = A1 + BM * kLdh;
  __nv_bfloat16* B1 = B0 + kT * kLdh;
  float* cum_s = reinterpret_cast<float*>(B1 + kT * kLdh);
  float* dt_s = cum_s + d.Q;
  const int h = blockIdx.x, b = blockIdx.y / d.nc, c = blockIdx.y % d.nc;
  const int i0 = (tiles - 1 - (int)blockIdx.z) * BM;  // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tok0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t xrow = (size_t)d.H * d.P;
  const __nv_bfloat16* xh = x + tok0 * xrow + (size_t)h * d.P;
  chunk_cum_dt<kThreads>(cum, dt, d, b, c, h, cum_s, dt_s);
  const uint32_t sa0 = tc::smem_addr(A0), sb0 = tc::smem_addr(B0);
  const uint32_t fa0 = sa0 + a_rows(warp, lane);
  const uint32_t fa1 = tc::smem_addr(A1) + a_rows(warp, lane);
  const uint32_t fb0 = sb0 + b_rows(lane);
  const uint32_t fb1 = tc::smem_addr(B1) + b_rows(lane);
  const int g = lane / 4, tq = lane % 4;
  const int row0 = i0 + 16 * warp + g, row1 = row0 + 8;
  float acc[8][4] = {};

  // exp(cum_i) C_i · in_c, skipped where in_c is zero (first chunk, no init)
  if (c > 0 || d.has_init) {
    const __nv_bfloat16* Cc = Cm + tok0 * d.N;
    const float* in_c =
        states + (((size_t)b * d.nc + c) * d.H + h) * d.N * d.P;
    for (int n0 = 0; n0 < d.N; n0 += kT) {
      __syncthreads();
      copy_rows<kThreads>(sa0, Cc, d.N, i0, BM, d.Q, n0, d.N, d.vec);
      tc::cp_async_commit();
      fill<kItems, kThreads, 16, 4>(
          [&](int k, int p4) {
            return n0 + k < d.N
                       ? load4(in_c + (size_t)(n0 + k) * d.P, p4, d.P, d.vec)
                       : zero4();
          },
          [&](int k, int p4, float4 v) {
            st_split4(B0, B1, k * kLdh + p4, v);
          });
      tc::cp_async_wait<0>();
      __syncthreads();
      mma_stage<false, false, true>(acc, fa0, 0, fb0, fb1,
                                    (min(kT, d.N - n0) + 15) / 16);
    }
    const float e0 = row0 < d.Q ? expf(cum_s[row0]) : 0.0f;
    const float e1 = row1 < d.Q ? expf(cum_s[row1]) : 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }

  // + sum over column stages j0 <= the tile's last row of G_ij x_j
  const float* cbc = cb + ((size_t)b * d.nc + c) * d.Q * d.Q;
  const int jend = min(i0 + BM, d.Q);
  for (int j0 = 0; j0 < jend; j0 += kT) {
    __syncthreads();
    copy_rows<kThreads>(sb0, xh, (long long)xrow, j0, kT, d.Q, 0, d.P, d.vec);
    tc::cp_async_commit();
    fill<kItems, kThreads, 16, 2>(
        [&](int r, int k4) {
          const int i = i0 + r;
          return i < d.Q && j0 + k4 <= i
                     ? load4(cbc + (size_t)i * d.Q, j0 + k4, d.Q, d.vec)
                     : zero4();
        },
        [&](int r, int k4, float4 v) {
          const int i = i0 + r;
          st_split4(A0, A1, r * kLdh + k4,
                    i < d.Q ? g4(v, i, j0 + k4, cum_s, dt_s) : zero4());
        });
    tc::cp_async_wait<0>();
    __syncthreads();
    mma_stage<false, true, false>(acc, fa0, fa1, fb0, 0,
                                  (min(kT, jend - j0) + 15) / 16);
  }

  // y = acc + D x_i, in bf16
  const float dh = Dv[h];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? row1 : row0;
    if (i >= d.Q) continue;
    const __nv_bfloat16* xi = xh + (size_t)i * xrow;
    __nv_bfloat16* yo = y + (tok0 + i) * xrow + (size_t)h * d.P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * nt + 2 * tq + e;
        if (p < d.P)
          yo[p] = __float2bfloat16_rn(
              fmaf(dh, __bfloat162float(xi[p]), acc[nt][2 * half + e]));
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename T>
cudaError_t launch_out(const T* x, const float* dt, const T* Cm,
                       const float* D, const float* cum, const float* cb,
                       const float* states, T* y, const Dims& d, int B,
                       cudaStream_t stream) {
  const int tiles = (d.Q + kT - 1) / kT;
  const dim3 grid(d.H, B * d.nc, tiles);
  const size_t q_bytes = 2 * (size_t)d.Q * 4;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t bytes = (size_t)4 * kT * kLdh * 2 + q_bytes;
    auto* kern = ssd_out_tc_kernel;
    if ((err = allow_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, 128, bytes, stream>>>(x, dt, Cm, D, cum, cb, states, y, d,
                                       tiles);
  } else {
    const size_t bytes = (size_t)2 * kT * kLd * 4 + q_bytes;
    auto* kern = ssd_out_kernel;
    if ((err = allow_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, 128, bytes, stream>>>(x, dt, Cm, D, cum, cb, states, y, d,
                                       tiles);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_state(const T* x, const float* dt, const T* Bm,
                         const float* cum, float* states, const Dims& d,
                         int B, cudaStream_t stream) {
  const size_t w_bytes = (size_t)d.Q * 4;  // the chunk's weights w_s
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t bytes = (size_t)3 * kT * kLdh * 2 + w_bytes;
    auto* kern = ssd_state_tc_kernel;
    if ((err = allow_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<dim3(d.H, B * d.nc, (d.N + kT - 1) / kT), 128, bytes, stream>>>(
        x, dt, Bm, cum, states, d);
  } else {
    const size_t bytes = (size_t)2 * kT * kLd * 4 + w_bytes;
    auto* kern = ssd_state_kernel;
    if ((err = allow_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<dim3(d.H, B * d.nc, (d.N + kT - 1) / kT), 128, bytes, stream>>>(
        x, dt, Bm, cum, states, d);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* D, const float* init, T* y,
           float* final_state, float* cum, float* cb, float* states, int B,
           int S, int H, int P, int N, int Q, cudaStream_t stream) {
  if (P < 1 || P > kPMax || N < 1 || N > kNMax || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  Dims d{S, H, P, N, Q, S / Q, 0, init != nullptr};
  d.vec = P % 8 == 0 && N % 8 == 0 && Q % 4 == 0 && aligned16(x) &&
          aligned16(Bm) && aligned16(Cm) && aligned16(y) &&
          aligned16(states) && aligned16(cb);
  const int t = (Q + kT - 1) / kT, ntri = t * (t + 1) / 2;

  ssd_cum_cb_kernel<T><<<dim3(ntri + (H + kCumHeads - 1) / kCumHeads, d.nc,
                              B), 128, 0, stream>>>(dt, A, Bm, Cm, cum, cb, d,
                                                    ntri);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_state(x, dt, Bm, cum, states, d, B, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t dec_bytes = (size_t)d.nc * 4;
  if ((err = allow_smem(ssd_pass_kernel, dec_bytes)) != cudaSuccess)
    return (int)err;
  ssd_pass_kernel<<<dim3((N + kPassRows - 1) / kPassRows, B * H), 256,
                    dec_bytes, stream>>>(cum, init, states, final_state, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_out(x, dt, Cm, D, cum, cb, states, y, d, B, stream);
  return (int)err;
}

}  // namespace

extern "C" {

// init may be null (a zero initial state); cum (B,nc,H,Q), cb (B,nc,Q,Q)
// and states (B,nc,H,N,P) are f32 scratch of the caller; every other
// pointer is a contiguous tensor of the shape in the header comment.
int repro_ssd_scan_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* init, float* y, float* final_state,
                       float* cum, float* cb, float* states, int B, int S,
                       int H, int P, int N, int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, init, y, final_state, cum, cb, states, B,
                S, H, P, N, Q,
                static_cast<cudaStream_t>(stream));
}

int repro_ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                        const float* A, const __nv_bfloat16* Bm,
                        const __nv_bfloat16* Cm, const float* D,
                        const float* init, __nv_bfloat16* y,
                        float* final_state, float* cum, float* cb,
                        float* states, int B, int S, int H, int P, int N,
                        int Q, void* stream) {
  return launch(x, dt, A, Bm, Cm, D, init, y, final_state, cum, cb, states, B,
                S, H, P, N, Q,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
