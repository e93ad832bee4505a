// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++
// behind a C interface.
//
// Replaces the reference's autodiff of repro/models/ssm.py:_ssd_chunked (the
// scan's Pallas kernel, repro/kernels/ssd_scan.py:_ssd_kernel, has no VJP,
// so the reference trains through autodiff of the jnp form). For each
// (batch b, head h), from the forward recurrence
//   h_t = a_t h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t,  a_t = exp(dt_t A)
// and the cotangent dy of y, with the adjoint state
//   g_t = a_{t+1} g_{t+1} + dy_t C_t^T,
// it computes
//   dx_t = dt_t g_t B_t,
//   ddt_t = x_t . (g_t B_t) + A a_t <g_t, h_{t-1}>,
//   dA_h = sum_{b,t} dt_t a_t <g_t, h_{t-1}>,
//   dB_t = sum_h dt_t g_t^T x_t,  dC_t = sum_h h_t^T dy_t.
//
// Chunked form. In a chunk of Q positions with csum the inclusive prefix sum
// of dt * A (in double: it reaches ~-100 over 128 positions), S = C B^T,
// L[k][j] = exp(csum_k - csum_j) for j <= k, e_i = exp(total - csum_i), h_in
// the state entering the chunk and carry the adjoint leaving it:
//   dx~_i = sum_{k>=i} S[k][i] L[k][i] dy_k + e_i carry B_i          (dx = dt dx~)
//   W[k][j] = (dy_k . x_j) L[k][j] dt_j                              (j <= k)
//   dC_k = sum_j Wsum[k][j] B_j + sum_h exp(csum_k) h_in^T dy_k
//   dB_j = sum_k Wsum[k][j] C_k + sum_h dt_j e_j carry^T x_j
// with Wsum = sum_h W over the heads, which share B and C: the intra-chunk
// parts of dB and dC are one product a group of heads, not one a head. And
// d(log decay) dl_i = a_i <g_i, h_{i-1}> is the reverse prefix sum of
//   r_m = rowsum_m(W o S) - colsum_m(W o S) + exp(csum_m) dy_m . (C h_in^T)_m
//         - dt_m e_m x_m . (B carry^T)_m + [m last] <carry, h_out>,
// the derivative of the loss by csum_m; then ddt_i = x_i . dx~_i + A dl_i
// and dA_h += sum_i dt_i dl_i. The carries walk the chunks in reverse as the
// forward's states walk them forwards: carry[c] = R[c+1] + exp(total[c+1])
// carry[c+1], with R[c] = sum_k exp(csum_k) dy_k C_k^T the chunk's own part.
//
// Passes, on the caller's stream (the wrapper first runs the forward's
// passes (a) and (b), csrc/ssd_scan.cu, for the states entering each chunk):
//  (1) ssd_bwd_scores_kernel, a block per (b, chunk): S over the causal
//      16 x 16 tiles, to a scratch [B, nc, Qp, Qp];
//  (2) ssd_bwd_rev_kernel, a block per (b, chunk, group of G2 heads): C is
//      loaded once, then R[c] [P, N] a head, as the forward's pass (a);
//  (3) ssd_bwd_carry_kernel, per (b, h) and float4 of the state: the reverse
//      walk, carry[c] written over R[c] in place;
//  (4) ssd_bwd_chunk_kernel, a block per (b, chunk, group of G heads): S is
//      loaded once and each head's csum taken, a warp a head; per head dy
//      x^T on the causal tiles gives W, its row and column sums with S and
//      the group's Wsum (in registers, in head order), and (S o L)^T dy the
//      intra part of dx~; writes that to dx, rowsum - colsum of W o S and
//      x . dx~intra to a scratch rq [R, B, H, S], and Wsum and its
//      transpose to a scratch [B, nc, H/G, 2, Qp, Qp];
//  (5) ssd_bwd_dbc_kernel, a block per (b, chunk, group, dB or dC, 64 state
//      columns): [Wsum | dy_h ...] [B; h_in ...] for dC and [Wsum^T | x_h ...]
//      [C; carry ...] for dB, streamed in 16-wide slices of the contraction
//      through a three-stage cp.async ring; each head's product sums in its
//      own accumulator before it is scaled and added, in head order, and
//      leaves its row sums with C (dy . (C h_in^T)) or B (x . (B carry^T))
//      in rq: the terms of r and x . dx~ that need no product of their own;
//  (6) ssd_bwd_inter_kernel, a block per (b, chunk, head): B carry^T over N
//      in slices of 32 and <carry, h_out>; then dx, r from its parts in rq,
//      its reverse prefix sum dl across a warp in double, ddt and the
//      block's part of dA;
//  (7) ssd_bwd_sum_kernel and ssd_bwd_dA_kernel: dB, dC summed over the
//      H/G groups and dA over batch and chunks, each in a fixed order.
// No atomics and every sum in a fixed order, so two calls give the same
// bits.
//
// What bounds it. At mamba2-370m's training shape (B=4, S=1024, H=32, P=64,
// N=128, Q=128) the function needs ~12 GFLOP (chip_smoke.py's ssd_bwd_bound
// counts them, dB's and dC's intra parts once for all heads): 0.071 ms as
// 3xTF32 on the tensor cores, 0.18 ms on the f32 CUDA cores; the bytes
// ~0.033 ms. So operations bound it. The first design ran every product as
// f32 FMAs from shared memory, one block an SM (2.31 ms, 32x the bound, on
// an H100 at 700 W). This one runs every product on
// mma.sync m16n8k8 TF32 split in three (3xTF32: hi*lo' + lo*hi' + hi*hi';
// one TF32 product misses the 1e-4), skips the 16 x 16 tiles above the
// diagonal in the four causal products, pairs each warp's 16-row tiles (it
// with MT - 1 - it) so that every warp has the same causal work, takes the
// decay as a row factor times a column factor (both <= 1) with an exp per
// element only on the diagonal tile, shares S, B and C over a group of
// heads, sums the group's W once for dB and dC, takes two of r's terms as
// row sums of products pass (5) makes anyway, and scans dl across a warp.
// Fragment loads read shared-memory rows padded to 4 mod 8 words (read
// along a row) or 8 mod 32 (read down a column, or along a row as float2
// pairs of the contraction, whose order the two operands permute alike).
// Shared memory at Q = 128: pass (4) holds S (40 KB packed), x and dy of a
// head (36 KB each), every head's csum and the decay tables, ~137 KB, one
// block an SM (two would need it under 113 KB, and x, dy and S alone take
// 112 KB); passes (2), (5) and (6) fit two an SM. G is chosen on the host
// from the grid and the number of SMs (pick_group, as the forward's). On
// an H100 at 700 W it takes 0.59 ms at mamba2-370m's shape and 1.23 ms at
// zamba2-7b's (4, 1024, 112, 64, 64, 128), ~8x the bound; pass (4) and
// pass (5) take the most, and the forward's state passes it reruns ~0.08
// and ~0.15 ms.
//
// Padding: positions past S in the last chunk and Q up to a multiple of 16
// load as zeros (dt = x = dy = B = C = 0); they add nothing and are not
// written. C interface (bound with ctypes): repro_ssd_scan_bwd returns the
// cudaError_t of the launches (0 on success); repro_ssd_scan_bwd_groups
// gives the G of passes (2) and (4)/(5) that it will use and the rows R of
// rq.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int QMAX = 128;
constexpr int MAX_GROUP = 8;
constexpr int KC = 16;   // contraction slice of pass (5)
constexpr int NST = 3;   // its ring stages
constexpr int NU = 5;    // pass (4): causal 16 x 16 tiles of dy x^T a warp, at most

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// Row strides in floats: 4 mod 8 for fragments read along rows, 8 mod 32
// for fragments read down columns or as float2 pairs along rows. Both keep
// rows 16-byte aligned.
__host__ __device__ constexpr int ld_row(int n) { return n + 4; }
__host__ __device__ constexpr int ld_col(int n) { return round_up(n, 32) + 8; }
// pass (5): state columns a block, and the row sums a head's inter product
// leaves (a block and a warp of each pair each)
__host__ __device__ constexpr int dbc_cols(int N) { return N < 64 ? N : 64; }
__host__ __device__ constexpr int q_parts(int N) { return N / dbc_cols(N) * (N >= 16 ? 2 : 1); }
// rows of the rq scratch: rowsum - colsum of W o S; x . dx~intra of each half
// of P; then the q_parts(N) parts of C . (dy_h h_in^T) and of B . (x_h carry)
constexpr int RQ_W = 0, RQ_X = 1, RQ_C = 3;

struct Params {
  const float *x, *dt, *A, *Bm, *Cm, *dy;  // [B,S,H,P] [B,S,H] [H] [B,S,N] [B,S,N] [B,S,H,P]
  const float* states;  // [B,H,nc,P,N]: the state entering chunk c (c >= 1)
  const float* totals;  // [B,H,nc]: each chunk's total log decay
  float* rev;           // [B,H,nc,P,N]: R[c], then carry[c]
  float* scores;        // [B,nc,Qp,Qp]: C_k . B_j on the causal tiles
  float* wsum;          // [B,nc,H/G,2,Qp,Qp]: the group's W summed over heads, its transpose
  float* rq;            // [3 + 2 q_parts(N), B,H,S]: per-position parts of r and x . dx~
  float *dB_part, *dC_part;  // [B,H/G,S,N]
  float* dA_part;            // [B,nc,H]
  float *dx, *ddt, *dA, *dB, *dC;
  int Bsz, S, H, Q, Qp, nc;
};

// ---- 3xTF32 mma (as csrc/ssd_scan.cu) -----------------------------------------

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds, in two integer operations), lo = v - hi is exact
// in f32 and the mma reads its top 10 mantissa bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, col): b0 (k = t, n = g), b1 (k = t + 4, n = g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D (16 x 8): d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, 2t + {0, 1}).
// The small terms first, so that they are not lost against hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int M, int NT>
__device__ __forceinline__ void zero(float (&a)[M][NT][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[m][n][e] = 0.f;
}

// ---- loads -------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* s, const float* g, bool valid) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sa), "l"(g), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, nrows) of W floats (W a multiple of 4; every row 16-byte aligned)
// into s (row stride ld); row r < nv comes from g + r * gs, the others are
// zero.
__device__ __forceinline__ void load_rows(float* s, int ld, const float* g, size_t gs,
                                          int nrows, int nv, int W) {
  const int w4 = W / 4;
  for (int i = threadIdx.x; i < nrows * w4; i += NTHREADS) {
    const int r = i / w4, c = (i % w4) * 4;
    const bool ok = r < nv;
    cp_async16(s + r * ld + c, ok ? g + r * gs + c : g, ok);
  }
}

// One warp, one head's chunk: dt (0 past nv) and the inclusive prefix sum
// csum of dt * a in double, over Qp <= 128 positions; lane l holds
// positions l * per + e, e < per.
struct ChunkScan {
  int per;
  float dt[4];
  double csum[4];
  double total;  // csum at the chunk's end
};

__device__ __forceinline__ ChunkScan chunk_scan(const float* dt, int dt_ss, int nv, int Qp,
                                                float a) {
  const int lane = threadIdx.x & 31;
  ChunkScan r;
  r.per = (Qp + 31) / 32;
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * r.per + e;
    r.dt[e] = e < r.per && j < nv ? dt[size_t(j) * dt_ss] : 0.f;
    run += double(r.dt[e]) * double(a);
    r.csum[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) r.csum[e] += incl - run;
  r.total = __shfl_sync(0xffffffffu, incl, 31);
  return r;
}

// One warp: a head's dt into sDt and csum into sCs (Qp positions).
__device__ __forceinline__ void chunk_csum(const float* dt, int dt_ss, int nv, int Qp,
                                           float a, float* sDt, double* sCs) {
  const ChunkScan r = chunk_scan(dt, dt_ss, nv, Qp, a);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * r.per + e;
    if (e < r.per && j < Qp) {
      sDt[j] = r.dt[e];
      sCs[j] = r.csum[e];
    }
  }
}

// One warp: a head's per-position weights into sF (Qp positions): exp(csum_j)
// (rev: R's weights; dbc: dC's inter rows) or, with decay_to_end, dt_j
// exp(total - csum_j) (dbc: dB's inter rows).
__device__ __forceinline__ void chunk_weights(const float* dt, int dt_ss, int nv, int Qp,
                                              float a, bool decay_to_end, float* sF) {
  const ChunkScan r = chunk_scan(dt, dt_ss, nv, Qp, a);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * r.per + e;
    if (e < r.per && j < Qp)
      sF[j] = decay_to_end ? r.dt[e] * expf(float(r.total - r.csum[e])) : expf(float(r.csum[e]));
  }
}

__device__ __forceinline__ float quad_sum(float v) {  // over t, the 4 lanes of a row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- (1) scores C_k . B_j of a chunk, causal tiles -----------------------------

template <int N>
__global__ void __launch_bounds__(NTHREADS) ssd_bwd_scores_kernel(const Params p) {
  constexpr int LD = ld_row(N), KN = N / 8;
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);
  const int Qp = p.Qp, MT = Qp / 16;
  float* sB = sC + Qp * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  load_rows(sC, LD, p.Cm + row * N, N, Qp, nv, N);
  load_rows(sB, LD, p.Bm + row * N, N, Qp, nv, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = p.scores + (size_t(b) * p.nc + c) * Qp * Qp;
  for (int task = warp; task < MT * (MT + 1) / 2; task += NWARPS) {
    int it = 0, jp = task;
    while (jp > it) jp -= ++it;
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KN; ++ks) {
      const float* cr = sC + (16 * it + g) * LD + 8 * ks + t;
      const FragA a = frag_a(cr[0], cr[8 * LD], cr[4], cr[8 * LD + 4]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* br = sB + (16 * jp + 8 * n + g) * LD + 8 * ks + t;
        mma3(acc[n], a, frag_b(br[0], br[4]));
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * jp + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(out + (16 * it + g) * Qp + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (16 * it + g + 8) * Qp + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---- (2) each chunk's own reverse state R = sum_k exp(csum_k) dy_k C_k^T ------

template <int P, int N>
struct RevSmem {
  static constexpr int LDC = ld_col(N), LDY = ld_col(P);
  __host__ __device__ static size_t bytes(int Qp, int G) {
    return size_t(Qp) * (LDC + LDY + G) * sizeof(float);
  }
};

// A block per (b, chunk c >= 1, group of G heads): R[p][n] = sum_k (dy[k][p]
// f_k) C[k][n], f_k = exp(csum_k); M = P, N = N, K = Qp, as the forward's
// pass (a) computes a chunk's own state.
template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_bwd_rev_kernel(const Params p, const int G) {
  using L = RevSmem<P, N>;
  constexpr int LDC = L::LDC, LDY = L::LDY;
  constexpr int WM = P / 16 < 2 ? P / 16 : 2;  // m16 tiles of a warp
  constexpr int WN = N / 8 < 4 ? N / 8 : 4;    // n8 tiles of a warp
  constexpr int TM = P / 16 / WM, TN = N / 8 / WN;
  const int Qp = p.Qp;
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);
  float* sY = sC + Qp * LDC;
  float* sF = sY + Qp * LDY;  // [G][Qp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y + 1, b = blockIdx.z;  // R[0] feeds no carry
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  const int h_first = blockIdx.x * G;

  load_rows(sC, LDC, p.Cm + row * N, N, Qp, nv, N);
  if (warp < G) {
    const int h = h_first + warp;
    chunk_weights(p.dt + row * p.H + h, p.H, nv, Qp, p.A[h], false, sF + warp * Qp);
  }
  for (int hh = 0; hh < G; ++hh) {
    const int h = h_first + hh;
    load_rows(sY, LDY, p.dy + (row * p.H + h) * P, size_t(p.H) * P, Qp, nv, P);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* fh = sF + hh * Qp;
    float* out = p.rev + ((size_t(b) * p.H + h) * p.nc + c) * (P * N);
    for (int task = warp; task < TM * TN; task += NWARPS) {
      const int m0 = (task / TN) * WM * 16, n0 = (task % TN) * WN * 8;
      float acc[WM][WN][4];
      zero(acc);
      for (int k0 = 0; k0 < Qp; k0 += 8) {
        const int j0 = k0 + t, j1 = k0 + t + 4;
        const float f0 = fh[j0], f1 = fh[j1];
        FragA a[WM];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const int r = m0 + 16 * m + g;
          a[m] = frag_a(sY[j0 * LDY + r] * f0, sY[j0 * LDY + r + 8] * f0,
                        sY[j1 * LDY + r] * f1, sY[j1 * LDY + r + 8] * f1);
        }
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          const int col = n0 + 8 * n + g;
          const FragB fb = frag_b(sC[j0 * LDC + col], sC[j1 * LDC + col]);
#pragma unroll
          for (int m = 0; m < WM; ++m) mma3(acc[m][n], a[m], fb);
        }
      }
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          const int r = m0 + 16 * m + g, col = n0 + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(out + r * N + col) = make_float2(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<float2*>(out + (r + 8) * N + col) =
              make_float2(acc[m][n][2], acc[m][n][3]);
        }
    }
    __syncthreads();  // sY is rewritten for the next head
  }
}

// ---- (3) the reverse walk of the adjoint over the chunks -----------------------

// One thread per float4 of a (b, h)'s state: rev[b, h, c] holds R[c] on entry
// and carry[c] on exit; carry[nc-1] = 0, carry[c] = R[c+1] + exp(total[c+1])
// carry[c+1].
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_carry_kernel(float* __restrict__ rev, const float* __restrict__ totals, int nc, int pn4) {
  const int e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= pn4) return;
  const size_t bh = blockIdx.y;
  float4* st = reinterpret_cast<float4*>(rev) + bh * nc * pn4 + e;
  const float* tot = totals + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d = st[size_t(nc - 1) * pn4];
  for (int c = nc - 1; c >= 0; --c) {  // R[c - 1] is on its way while carry[c] is stored
    const float4 next = c > 0 ? st[size_t(c - 1) * pn4] : d;
    st[size_t(c) * pn4] = s;
    const float k = expf(tot[c]);
    s = make_float4(fmaf(k, s.x, d.x), fmaf(k, s.y, d.y), fmaf(k, s.z, d.z), fmaf(k, s.w, d.w));
    d = next;
  }
}

// ---- (4) the chunk's Q x Q products, a group of heads --------------------------

template <int P>
struct ChunkSmem {
  static constexpr int LDX = ld_col(P);
  // S packed lower-triangular: 16-row tile it holds 16 (it + 1) columns,
  // row stride 8 mod 16 (8 or 24 mod 32: column reads hit 32 banks)
  __host__ __device__ static int ld_s(int it) { return 16 * (it + 1) + 8; }
  __host__ __device__ static int off_s(int it) { return 128 * it * (it + 2); }
  // column partials packed the same way, without padding
  __host__ __device__ static int off_c(int it) { return 8 * it * (it + 1); }
  // offsets in floats; each head's csum (double) first
  __host__ __device__ static int s(int Qp) { return 2 * MAX_GROUP * Qp; }
  __host__ __device__ static int x(int Qp) { return s(Qp) + off_s(Qp / 16); }
  __host__ __device__ static int y(int Qp) { return x(Qp) + Qp * LDX; }
  // each head's dt, then E1, E2, rows x 2
  __host__ __device__ static int vec(int Qp) { return y(Qp) + Qp * LDX; }
  __host__ __device__ static int tab(int Qp) {  // Fd, G2: [MT][Qp]
    return vec(Qp) + (MAX_GROUP + 4) * Qp;
  }
  __host__ __device__ static int col(int Qp) { return tab(Qp) + 2 * (Qp / 16) * Qp; }
  __host__ __device__ static size_t bytes(int Qp) {
    return size_t(col(Qp) + off_c(Qp / 16)) * sizeof(float);
  }
};

// A block per (b, chunk, group of G heads). Warps in pairs: pair q holds the
// 16-row tiles rt0 = q and rt1 = MT - 1 - q (their causal work sums to the
// same for every pair). For dy x^T the pair's MT + 1 causal tiles alternate
// between its two warps (NU at most a warp); for (S o L)^T dy each warp of
// the pair takes half of P.
template <int P>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_bwd_chunk_kernel(const Params p, const int G) {
  using L = ChunkSmem<P>;
  constexpr int LDX = L::LDX, KP = P / 8;
  constexpr int NG = P / 16;  // n8 tiles of dx~ a warp
  const int Qp = p.Qp, MT = Qp / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  double* sCsAll = reinterpret_cast<double*>(smem);  // [MAX_GROUP][Qp]
  float* sS = smem + L::s(Qp);
  float* sX = smem + L::x(Qp);
  float* sY = smem + L::y(Qp);
  float* sDtAll = smem + L::vec(Qp);     // [MAX_GROUP][Qp]
  float* sE1 = sDtAll + MAX_GROUP * Qp;  // exp(csum_i - csum_{16 it})
  float* sE2 = sE1 + Qp;   // exp(csum_{16 it + 15} - csum_i)
  float* sRow = sE2 + Qp;  // [2][Qp] row sums of W o S, a warp of the pair each
  float* sFd = smem + L::tab(Qp);  // [MT][Qp]: exp(csum_{16 rt} - csum_j) dt_j, j < 16 rt
  float* sG2 = sFd + MT * Qp;      // [MT][Qp]: exp(csum_k - csum_{16 it + 15}), k >= 16 (it + 1)
  float* sCol = smem + L::col(Qp);  // packed: column sums of each (rt, jt) tile of W o S

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  const int hg = blockIdx.x, h_first = hg * G;

  const int pair = warp >> 1, half = warp & 1;
  const bool active = pair < (MT + 1) / 2;
  const int rt[2] = {pair, MT - 1 - pair};
  const bool two = rt[1] != rt[0];
  const int units = two ? MT + 1 : rt[0] + 1;
  const int n0 = half * NG * 8;  // this warp's columns of dx~

  {  // S's causal tiles
    const float* sc = p.scores + (size_t(b) * p.nc + c) * Qp * Qp;
    for (int i = threadIdx.x; i < Qp * (Qp / 4); i += NTHREADS) {
      const int k = i / (Qp / 4), c4 = (i % (Qp / 4)) * 4, kt = k >> 4;
      if (c4 < 16 * (kt + 1))
        cp_async16(sS + L::off_s(kt) + (k & 15) * L::ld_s(kt) + c4, sc + k * Qp + c4, true);
    }
  }
  if (warp < G)  // each head's dt and csum, a warp a head
    chunk_csum(p.dt + row * p.H + h_first + warp, p.H, nv, Qp, p.A[h_first + warp],
               sDtAll + warp * Qp, sCsAll + warp * Qp);
  float wacc[NU][2][4];  // the group's W on this warp's tiles, summed in head order
  zero(wacc);

  for (int hh = 0; hh < G; ++hh) {
    const int h = h_first + hh;
    const double* sCs = sCsAll + hh * Qp;
    const float* sDt = sDtAll + hh * Qp;
    load_rows(sX, LDX, p.x + (row * p.H + h) * P, size_t(p.H) * P, Qp, nv, P);
    load_rows(sY, LDX, p.dy + (row * p.H + h) * P, size_t(p.H) * P, Qp, nv, P);
    cp_async_commit();
    __syncthreads();  // csum; the previous head's tables are read
    for (int i = threadIdx.x; i < Qp; i += NTHREADS) {
      sE1[i] = expf(float(sCs[i] - sCs[i & ~15]));
      sE2[i] = expf(float(sCs[i | 15] - sCs[i]));
    }
    for (int i = threadIdx.x; i < MT * Qp; i += NTHREADS) {
      const int it = i / Qp, j = i % Qp;
      if (j < 16 * it) sFd[i] = expf(float(sCs[16 * it] - sCs[j])) * sDt[j];
      if (j >= 16 * (it + 1)) sG2[i] = expf(float(sCs[j] - sCs[16 * it + 15]));
    }
    cp_async_wait<0>();
    __syncthreads();  // x, dy, S and the tables

    // W = (dy x^T) o L o dt on this warp's causal tiles; its row and column
    // sums with S; wacc += W. The contraction over P is read as float2
    // pairs (k = t <-> p = 2t, k = t + 4 <-> p = 2t + 1) in both operands.
    if (active) {
      float rs[2][2] = {};  // row sums: tile k of the pair, rows g and g + 8
#pragma unroll
      for (int uu = 0; uu < NU; ++uu) {
        const int u = half + 2 * uu;
        if (u >= units) break;
        const int k = u <= rt[0] ? 0 : 1;
        const int r = rt[k], jt = k == 0 ? u : u - rt[0] - 1;
        float m[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) {
          const float2 y0 = *reinterpret_cast<const float2*>(sY + (16 * r + g) * LDX + 8 * ks + 2 * t);
          const float2 y1 =
              *reinterpret_cast<const float2*>(sY + (16 * r + g + 8) * LDX + 8 * ks + 2 * t);
          const FragA fa = frag_a(y0.x, y1.x, y0.y, y1.y);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float2 xv =
                *reinterpret_cast<const float2*>(sX + (16 * jt + 8 * n + g) * LDX + 8 * ks + 2 * t);
            mma3(m[n], fa, frag_b(xv.x, xv.y));
          }
        }
        const float* srow = sS + L::off_s(r);
        const int lds = L::ld_s(r);
        float cs[2][2] = {};  // column sums: n8 tile, column 2t + e
        float ru[2] = {};     // row sums: rows g, g + 8
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = g + 8 * (e >> 1), kk = 16 * r + kr;
            const int j = 16 * jt + 8 * n + 2 * t + (e & 1);
            float l;
            if (jt < r) l = sE1[kk] * sFd[r * Qp + j];
            else l = j <= kk ? expf(float(sCs[kk] - sCs[j])) * sDt[j] : 0.f;
            const float w = m[n][e] * l;
            const float sv = w * srow[kr * lds + j];
            wacc[uu][n][e] += w;
            ru[e >> 1] += sv;
            cs[n][e & 1] += sv;
          }
        if (k == 0) {
          rs[0][0] += ru[0];
          rs[0][1] += ru[1];
        } else {
          rs[1][0] += ru[0];
          rs[1][1] += ru[1];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cs[n][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) sCol[L::off_c(r) + 16 * jt + 8 * n + 2 * t + e] = v;
          }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = quad_sum(rs[k][e]);
          if (t == 0) sRow[half * Qp + 16 * rt[k] + g + 8 * e] = v;
        }
      }
    }
    __syncthreads();  // the sums are in
    float* rq = p.rq + (size_t(b) * p.H + h) * p.S + t0;  // row RQ_W of (b, h)'s positions
    const size_t rq_row = size_t(p.Bsz) * p.H * p.S;
    for (int i = threadIdx.x; i < nv; i += NTHREADS) {
      float col = 0.f;
      for (int r = i >> 4; r < MT; ++r) col += sCol[L::off_c(r) + i];
      rq[RQ_W * rq_row + i] = sRow[i] + sRow[Qp + i] - col;
    }

    // dx~ (intra) = (S o L)^T dy: rows i of tile rt, K = k >= 16 rt. After
    // the diagonal tile L[k][i] = exp(csum_k - csum_e) exp(csum_e - csum_i)
    // (e = 16 rt + 15), both <= 1: the column factors scale A, the row
    // factors the accumulators before the diagonal tile, where each element
    // takes its own exp. In stretches: both tiles after their diagonals;
    // tile 1 on its diagonal (tile 0 after); tile 0 after; tile 0 on its.
    if (active) {
      float acc[2][NG][4];
      zero(acc);
      auto dy_frags = [&](int k0, FragB (&fb)[NG]) {
        const float* y0 = sY + (k0 + t) * LDX + n0 + g;
#pragma unroll
        for (int n = 0; n < NG; ++n) fb[n] = frag_b(y0[8 * n], y0[4 * LDX + 8 * n]);
      };
      // rows k0 + t and k0 + t + 4 of S (one 16-row tile), from column 0
      auto s_rows = [&](int k0, int& ld) {
        const int kt = k0 >> 4;
        ld = L::ld_s(kt);
        return sS + L::off_s(kt) + ((k0 & 15) + t) * ld;
      };
      auto after = [&](int k, int k0) {
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8, j0 = k0 + t, j1 = j0 + 4;
        const float f0 = sG2[rt[k] * Qp + j0], f1 = sG2[rt[k] * Qp + j1];
        int ld;
        const float* sr = s_rows(k0, ld);
        return frag_a(sr[i0] * f0, sr[i1] * f0, sr[4 * ld + i0] * f1, sr[4 * ld + i1] * f1);
      };
      auto on = [&](int k, int k0) {
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8, j0 = k0 + t, j1 = j0 + 4;
        const double c0 = sCs[i0], c1 = sCs[i1], cj0 = sCs[j0], cj1 = sCs[j1];
        int ld;
        const float* sr = s_rows(k0, ld);
        return frag_a(j0 >= i0 ? sr[i0] * expf(float(cj0 - c0)) : 0.f,
                      j0 >= i1 ? sr[i1] * expf(float(cj0 - c1)) : 0.f,
                      j1 >= i0 ? sr[4 * ld + i0] * expf(float(cj1 - c0)) : 0.f,
                      j1 >= i1 ? sr[4 * ld + i1] * expf(float(cj1 - c1)) : 0.f);
      };
      auto scale_rows = [&](float (&v)[NG][4], int r0) {
        const float e0 = sE2[r0 + g], e1 = sE2[r0 + g + 8];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          v[n][0] *= e0;
          v[n][1] *= e0;
          v[n][2] *= e1;
          v[n][3] *= e1;
        }
      };
      const int r0 = 16 * rt[0], r1 = 16 * rt[1];
      FragB fb[NG];
#pragma unroll 2
      for (int k0 = r1 + 16; k0 < Qp; k0 += 8) {
        dy_frags(k0, fb);
        const FragA a0 = after(0, k0);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
        if (two) {
          const FragA a1 = after(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
      }
      if (two) {
        scale_rows(acc[1], r1);
#pragma unroll
        for (int k0 = r1; k0 < r1 + 16; k0 += 8) {
          dy_frags(k0, fb);
          const FragA a0 = after(0, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
          const FragA a1 = on(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
#pragma unroll 2
        for (int k0 = r0 + 16; k0 < r1; k0 += 8) {
          dy_frags(k0, fb);
          const FragA a0 = after(0, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
        }
      }
      scale_rows(acc[0], r0);
#pragma unroll
      for (int k0 = r0; k0 < r0 + 16; k0 += 8) {
        dy_frags(k0, fb);
        const FragA a0 = on(0, k0);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
      }
      float* dxb = p.dx + (row * p.H + h) * P;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8;
        float q0 = 0.f, q1 = 0.f;  // x . dx~intra over this warp's columns
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = n0 + 8 * n + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(sX + i0 * LDX + col);
          const float2 x1 = *reinterpret_cast<const float2*>(sX + i1 * LDX + col);
          q0 = fmaf(x0.x, acc[k][n][0], fmaf(x0.y, acc[k][n][1], q0));
          q1 = fmaf(x1.x, acc[k][n][2], fmaf(x1.y, acc[k][n][3], q1));
          if (i0 < nv)
            *reinterpret_cast<float2*>(dxb + size_t(i0) * p.H * P + col) =
                make_float2(acc[k][n][0], acc[k][n][1]);
          if (i1 < nv)
            *reinterpret_cast<float2*>(dxb + size_t(i1) * p.H * P + col) =
                make_float2(acc[k][n][2], acc[k][n][3]);
        }
        q0 = quad_sum(q0);
        q1 = quad_sum(q1);
        if (t == 0) {
          if (i0 < nv) rq[(RQ_X + half) * rq_row + i0] = q0;
          if (i1 < nv) rq[(RQ_X + half) * rq_row + i1] = q1;
        }
      }
    }
    __syncthreads();  // dy, the tables and the sums are read
  }

  // the group's W and its transpose
  if (active) {
    float* w = p.wsum + ((size_t(b) * p.nc + c) * (p.H / G) + hg) * 2 * Qp * Qp;
    float* wt = w + Qp * Qp;
#pragma unroll
    for (int uu = 0; uu < NU; ++uu) {
      const int u = half + 2 * uu;
      if (u >= units) break;
      const int k = u <= rt[0] ? 0 : 1;
      const int r = rt[k], jt = k == 0 ? u : u - rt[0] - 1;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i0 = 16 * r + g, j = 16 * jt + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(w + i0 * Qp + j) = make_float2(wacc[uu][n][0], wacc[uu][n][1]);
        *reinterpret_cast<float2*>(w + (i0 + 8) * Qp + j) =
            make_float2(wacc[uu][n][2], wacc[uu][n][3]);
        wt[j * Qp + i0] = wacc[uu][n][0];
        wt[(j + 1) * Qp + i0] = wacc[uu][n][1];
        wt[j * Qp + i0 + 8] = wacc[uu][n][2];
        wt[(j + 1) * Qp + i0 + 8] = wacc[uu][n][3];
      }
    }
  }
}

// ---- (5) dB and dC of a group ---------------------------------------------------

template <int P, int N>
struct DbcSmem {
  static constexpr int NB = dbc_cols(N);  // state columns a block
  static constexpr int LDA = ld_row(KC), LDB = ld_col(NB);
  __host__ __device__ static int stage(int Qp) { return Qp * LDA + KC * LDB; }
  // the ring, the other of B and C [Qp][LDB] (the heads' row sums), the
  // heads' row weights [G][Qp]
  __host__ __device__ static size_t bytes(int Qp, int G) {
    return (size_t(NST) * stage(Qp) + size_t(Qp) * LDB + size_t(G) * Qp) * sizeof(float);
  }
};

// A block per (b, chunk, group of G heads, dB or dC, NB state columns):
//   dC[k] = sum_j Wsum[k][j] B_j + sum_h exp(csum_k) (dy_h h_in^T)[k]
//   dB[j] = sum_k Wsum^T[j][k] C_k + sum_h dt_j e_j (x_h carry_h)[j]
// as one walk over 16-wide slices of the contraction (the Wsum part on the
// causal tiles alone, then P / 16 slices a head) through a ring of NST
// stages with one barrier a slice. Warps in pairs of 16-row tiles (rt0 = q,
// rt1 = MT - 1 - q), each warp of the pair half of the NB columns.
template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_bwd_dbc_kernel(const Params p, const int G) {
  using L = DbcSmem<P, N>;
  constexpr int NB = L::NB, LDA = L::LDA, LDB = L::LDB;
  constexpr int NG = NB >= 16 ? NB / 16 : 1;  // n8 tiles a warp
  constexpr int PS = P / KC;                  // slices a head
  const int Qp = p.Qp, MT = Qp / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sO = smem + NST * L::stage(Qp);  // C (dC) or B (dB), these columns
  float* sF = sO + Qp * LDB;              // [G][Qp]: each head's row weights

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nblk = N / NB;
  const int nb = blockIdx.z % nblk, which = (blockIdx.z / nblk) % 2, b = blockIdx.z / nblk / 2;
  const int c = blockIdx.y, hg = blockIdx.x, h_first = hg * G;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  const bool dB = which == 1;
  const bool inter = dB ? c + 1 < p.nc : c > 0;  // carry = 0 after the last chunk, h_in before the first
  const int nchunks = MT + (inter ? G * PS : 0);
  const int ncol = nb * NB;

  const float* wmat = p.wsum + (((size_t(b) * p.nc + c) * (p.H / G) + hg) * 2 + which) * Qp * Qp;
  const float* bc = (dB ? p.Cm : p.Bm) + row * N + ncol;
  const float* xs = dB ? p.x : p.dy;               // the heads' rows
  const float* ys = dB ? p.rev : p.states;         // carry or h_in

  if (inter && warp < G) {
    const int h = h_first + warp;
    chunk_weights(p.dt + row * p.H + h, p.H, nv, Qp, p.A[h], dB, sF + warp * Qp);
  }

  auto issue = [&](int s) {
    float* sa = smem + (s % NST) * L::stage(Qp);
    float* sb = sa + Qp * LDA;
    if (s < MT) {
      load_rows(sa, LDA, wmat + KC * s, Qp, Qp, Qp, KC);
      load_rows(sb, LDB, bc + size_t(KC) * s * N, N, KC, nv - KC * s, NB);
    } else {
      const int hh = (s - MT) / PS, pc = (s - MT) % PS, h = h_first + hh;
      load_rows(sa, LDA, xs + (row * p.H + h) * P + KC * pc, size_t(p.H) * P, Qp, nv, KC);
      load_rows(sb, LDB, ys + ((size_t(b) * p.H + h) * p.nc + c) * (P * N) + size_t(KC) * pc * N +
                             ncol, N, KC, KC, NB);
    }
  };

  const int pair = warp >> 1, half = warp & 1;
  const int n0 = half * NG * 8;
  const bool active = pair < (MT + 1) / 2 && n0 < NB;
  const int rt[2] = {pair, MT - 1 - pair};
  const bool two = rt[1] != rt[0];

  float acc[2][NG][4], tmp[2][NG][4];
  zero(acc);
  zero(tmp);

  if (inter) load_rows(sO, LDB, (dB ? p.Bm : p.Cm) + row * N + ncol, N, Qp, nv, NB);
  cp_async_commit();

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nchunks; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // slice s is in; slice s - 1's stage is read
    if (s + NST - 1 < nchunks) issue(s + NST - 1);
    cp_async_commit();
    if (!active) continue;
    const float* sa = smem + (s % NST) * L::stage(Qp);
    const float* sb = sa + Qp * LDA;
    const bool wpart = s < MT;
    bool on[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      on[k] = (k == 0 || two) && (!wpart || (dB ? s >= rt[k] : s <= rt[k]));
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      FragB fb[NG];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const float* br = sb + (8 * ks + t) * LDB + n0 + 8 * n + g;
        fb[n] = frag_b(br[0], br[4 * LDB]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!on[k]) continue;
        const float* ar = sa + (16 * rt[k] + g) * LDA + 8 * ks + t;
        const FragA fa = frag_a(ar[0], ar[8 * LDA], ar[4], ar[8 * LDA + 4]);
        if (wpart) {
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[k][n], fa, fb[n]);
        } else {
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(tmp[k][n], fa, fb[n]);
        }
      }
    }
    if (!wpart && (s - MT) % PS == PS - 1) {  // a head's product is complete
      const int hh = (s - MT) / PS;
      const float* f = sF + hh * Qp;
      // its row sums over these columns with C (dC: dy . (C h_in^T)) or B
      // (dB: x . (B carry^T)), for r and x . dx~ (pass (6))
      float* q = p.rq + (size_t(RQ_C + which * q_parts(N) + nb * (NB >= 16 ? 2 : 1) + half) *
                             p.Bsz * p.H + size_t(b) * p.H + h_first + hh) * p.S + t0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!on[k]) continue;
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8;
        float q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = n0 + 8 * n + 2 * t;
          const float2 o0 = *reinterpret_cast<const float2*>(sO + i0 * LDB + col);
          const float2 o1 = *reinterpret_cast<const float2*>(sO + i1 * LDB + col);
          q0 = fmaf(o0.x, tmp[k][n][0], fmaf(o0.y, tmp[k][n][1], q0));
          q1 = fmaf(o1.x, tmp[k][n][2], fmaf(o1.y, tmp[k][n][3], q1));
        }
        q0 = quad_sum(q0);
        q1 = quad_sum(q1);
        if (t == 0) {
          if (i0 < nv) q[i0] = q0;
          if (i1 < nv) q[i1] = q1;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!on[k]) continue;
        const float f0 = f[16 * rt[k] + g], f1 = f[16 * rt[k] + g + 8];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          acc[k][n][0] = fmaf(f0, tmp[k][n][0], acc[k][n][0]);
          acc[k][n][1] = fmaf(f0, tmp[k][n][1], acc[k][n][1]);
          acc[k][n][2] = fmaf(f1, tmp[k][n][2], acc[k][n][2]);
          acc[k][n][3] = fmaf(f1, tmp[k][n][3], acc[k][n][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[k][n][e] = 0.f;
        }
      }
    }
  }
  if (!active) return;
  float* out = (dB ? p.dB_part : p.dC_part) + ((size_t(b) * (p.H / G) + hg) * p.S + t0) * N + ncol;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k == 1 && !two) break;
    const int i0 = 16 * rt[k] + g, i1 = i0 + 8;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      if (i0 < nv)
        *reinterpret_cast<float2*>(out + size_t(i0) * N + col) = make_float2(acc[k][n][0], acc[k][n][1]);
      if (i1 < nv)
        *reinterpret_cast<float2*>(out + size_t(i1) * N + col) = make_float2(acc[k][n][2], acc[k][n][3]);
    }
  }
}

// ---- (6) the carry's product, dx, ddt and dA --------------------------------------

template <int P, int N>
struct InterSmem {
  static constexpr int NC = N < 32 ? N : 32;  // state columns a slice
  static constexpr int LD = ld_row(NC);
  // offsets in floats; csum (double) first
  __host__ __device__ static int b(int Qp) { return 2 * Qp; }
  __host__ __device__ static int car(int Qp) { return b(Qp) + Qp * LD; }   // carry, h_out
  __host__ __device__ static int vec(int Qp) { return car(Qp) + 2 * P * LD; }  // dt, r, q1
  __host__ __device__ static size_t bytes(int Qp) {
    return size_t(vec(Qp) + 3 * Qp + NWARPS) * sizeof(float);
  }
};

// A block per (b, chunk, head); warp w < MT holds rows [16 w, 16 w + 16) and
// all of P for B carry^T, contracted over N in slices of NC. Then dx = dt
// (dx~intra + e B carry^T), and per position, from the parts that passes (4)
// and (5) left in rq,
//   x . dx~ = x . dx~intra + e x . (B carry^T),
//   r = rowsum - colsum of W o S + exp(csum) dy . (C h_in^T)
//       - dt e x . (B carry^T) + [last] <carry, h_out>,
// dl its reverse prefix sum across a warp in double, ddt and dA's part.
template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 2) ssd_bwd_inter_kernel(const Params p) {
  using L = InterSmem<P, N>;
  constexpr int NC = L::NC, LD = L::LD, NT = P / 8, QP = q_parts(N);
  const int Qp = p.Qp, MT = Qp / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  double* sCs = reinterpret_cast<double*>(smem);
  float* sB = smem + L::b(Qp);
  float* sCar = smem + L::car(Qp);
  float* sHout = sCar + P * LD;
  float* sDt = smem + L::vec(Qp);
  float* sR = sDt + Qp;
  float* sQ1 = sR + Qp;
  float* sRed = sQ1 + Qp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  const bool has_in = c > 0, has_carry = c + 1 < p.nc;
  const float a = p.A[h];
  const size_t bhc = (size_t(b) * p.H + h) * p.nc + c;
  const float* h_out = p.states + (bhc + 1) * (P * N);  // the state entering chunk c + 1
  const float* carry = p.rev + bhc * (P * N);

  if (warp == 0) chunk_csum(p.dt + row * p.H + h, p.H, nv, Qp, a, sDt, sCs);

  float dxe[NT][4];  // B carry^T, rows 16 warp + {g, g + 8}
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxe[n][e] = 0.f;
  float hdot = 0.f;  // this thread's part of <carry, h_out>
  if (has_carry) {
    for (int c0 = 0; c0 < N; c0 += NC) {
      __syncthreads();  // the previous slice is read
      load_rows(sB, LD, p.Bm + row * N + c0, N, Qp, nv, NC);
      load_rows(sCar, LD, carry + c0, N, P, P, NC);
      load_rows(sHout, LD, h_out + c0, N, P, P, NC);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int i = threadIdx.x; i < P * NC; i += NTHREADS) {
        const int q = i / NC, n = i % NC;
        hdot = fmaf(sCar[q * LD + n], sHout[q * LD + n], hdot);
      }
      if (warp < MT) {
#pragma unroll
        for (int ks = 0; ks < NC / 8; ++ks) {
          const int k = 8 * ks + t;
          const float* ar = sB + (16 * warp + g) * LD + k;
          const FragA fa = frag_a(ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* br = sCar + (8 * n + g) * LD + k;
            mma3(dxe[n], fa, frag_b(br[0], br[4]));
          }
        }
      }
    }
  }
  // <carry, h_out>: over the warp, then over the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) hdot += __shfl_xor_sync(0xffffffffu, hdot, off);
  if (lane == 0) sRed[warp] = hdot;
  __syncthreads();
  float hsum = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) hsum += sRed[w];

  const double total = sCs[Qp - 1];
  if (warp < MT) {  // dx = dt (dx~intra + e B carry^T)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * warp + g + 8 * half;
      if (i >= nv) continue;
      const float de = sDt[i] * expf(float(total - sCs[i])), d = sDt[i];
      float* dxr = p.dx + ((row + i) * p.H + h) * P;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float2* v = reinterpret_cast<float2*>(dxr + 8 * n + 2 * t);
        const float2 intra = *v;
        *v = make_float2(fmaf(de, dxe[n][2 * half], d * intra.x),
                         fmaf(de, dxe[n][2 * half + 1], d * intra.y));
      }
    }
  }
  {  // r and x . dx~ per position, each part in a fixed order
    const size_t rq_row = size_t(p.Bsz) * p.H * p.S;
    const float* rq = p.rq + (size_t(b) * p.H + h) * p.S + t0;
    for (int i = threadIdx.x; i < Qp; i += NTHREADS) {
      float r = 0.f, q1 = 0.f;
      if (i < nv) {
        float qc = 0.f, qb = 0.f;
#pragma unroll
        for (int k = 0; k < QP; ++k) {
          if (has_in) qc += rq[(RQ_C + k) * rq_row + i];
          if (has_carry) qb += rq[(RQ_C + QP + k) * rq_row + i];
        }
        const float e = expf(float(total - sCs[i]));
        r = rq[RQ_W * rq_row + i] + expf(float(sCs[i])) * qc - sDt[i] * e * qb;
        if (i == nv - 1 && has_carry) r += hsum;
        q1 = rq[RQ_X * rq_row + i] + rq[(RQ_X + 1) * rq_row + i] + e * qb;
      }
      sR[i] = r;
      sQ1[i] = q1;
    }
  }
  __syncthreads();

  // dl_i = sum_{m >= i} r_m across warp 0 in double (lane l: positions
  // l * per + e), ddt and this block's part of dA
  if (warp == 0) {
    const int per = (Qp + 31) / 32;
    double suf[4], run = 0.0;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int j = lane * per + e;
      if (e < per && j < Qp) run += double(sR[j]);
      suf[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    const double later = incl - run;
    double da = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * per + e;
      if (e < per && j < nv) {
        const double dl = suf[e] + later;
        p.ddt[(row + j) * p.H + h] = sQ1[j] + a * float(dl);
        da += double(sDt[j]) * dl;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
    if (lane == 0) p.dA_part[(size_t(b) * p.nc + c) * p.H + h] = float(da);
  }
}

// ---- (7) sums over groups and over batch and chunks, in a fixed order -----------

// dB or dC (blockIdx.y) [B, S, N] = sum_g part[B, g, S, N]
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                   float* __restrict__ dB, float* __restrict__ dC, int groups, long long SN,
                   long long total) {
  const long long e = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  if (e >= total) return;
  const long long b = e / SN, r = e % SN;
  const float* src = (blockIdx.y == 0 ? dB_part : dC_part) + b * groups * SN + r;
  float s = 0.f;
  for (int i = 0; i < groups; ++i) s += src[i * SN];
  (blockIdx.y == 0 ? dB : dC)[e] = s;
}

// dA[h] = sum_{b, c} dA_part[b, c, h]
__global__ void ssd_bwd_dA_kernel(const float* __restrict__ dA_part, float* __restrict__ dA,
                                  int BC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += dA_part[size_t(i) * H + h];
  dA[h] = s;
}

// ---- host ------------------------------------------------------------------------

// Heads a block: a divisor of H up to MAX_GROUP, by a cost model of waves
// of blocks times (heads + the block's fixed work, in heads), as the
// forward's (csrc/ssd_scan.cu).
int pick_group(int blocks_per_head_group, int H, int slots, float fixed) {
  int best = 1;
  float best_cost = 1e30f;
  for (int G = 1; G <= MAX_GROUP && G <= H; ++G) {
    if (H % G) continue;
    const long long blocks = (long long)blocks_per_head_group * (H / G);
    const long long waves = (blocks + slots - 1) / slots;
    const float cost = waves * (G + fixed);
    if (cost <= best_cost) best = G, best_cost = cost;
  }
  return best;
}

// Lets the kernel take smem bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// The blocks of the kernel that the device holds at once, at smem bytes.
template <typename K>
cudaError_t slots_of(K kernel, size_t smem, int* slots) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  return cudaSuccess;
}

// The groups of pass (2) and of passes (4) and (5) (one G: pass (5) reads
// pass (4)'s Wsum of the same heads), from their blocks an SM, and the rows
// of the rq scratch.
template <int P, int N>
cudaError_t groups(int B, int H, int Qp, int nc, int (&G)[3]) {
  cudaError_t err;
  int slots = 0;
  if ((err = slots_of(ssd_bwd_rev_kernel<P, N>, RevSmem<P, N>::bytes(Qp, MAX_GROUP), &slots)) !=
      cudaSuccess)
    return err;
  G[0] = pick_group(B * (nc - 1 > 0 ? nc - 1 : 1), H, slots, 0.1f);
  if ((err = slots_of(ssd_bwd_chunk_kernel<P>, ChunkSmem<P>::bytes(Qp), &slots)) !=
      cudaSuccess)
    return err;
  G[1] = pick_group(B * nc, H, slots, 0.5f);
  G[2] = RQ_C + 2 * q_parts(N);
  return cudaSuccess;
}

template <int P, int N>
cudaError_t launch(const Params& p, const int (&G)[3], cudaStream_t stream) {
  cudaError_t err;
  const int B = p.Bsz, Qp = p.Qp;
  {
    const size_t smem = size_t(2) * Qp * ld_row(N) * sizeof(float);
    if ((err = allow_smem(ssd_bwd_scores_kernel<N>, smem)) != cudaSuccess) return err;
    ssd_bwd_scores_kernel<N><<<dim3(p.nc, B), NTHREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.nc > 1) {
    const size_t smem = RevSmem<P, N>::bytes(Qp, G[0]);
    if ((err = allow_smem(ssd_bwd_rev_kernel<P, N>, smem)) != cudaSuccess) return err;
    ssd_bwd_rev_kernel<P, N><<<dim3(p.H / G[0], p.nc - 1, B), NTHREADS, smem, stream>>>(p, G[0]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int pn4 = P * N / 4;
    ssd_bwd_carry_kernel<<<dim3((pn4 + NTHREADS - 1) / NTHREADS, B * p.H), NTHREADS, 0,
                           stream>>>(p.rev, p.totals, p.nc, pn4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const size_t smem = ChunkSmem<P>::bytes(Qp);
    if ((err = allow_smem(ssd_bwd_chunk_kernel<P>, smem)) != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<P><<<dim3(p.H / G[1], p.nc, B), NTHREADS, smem, stream>>>(p, G[1]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const size_t smem = DbcSmem<P, N>::bytes(Qp, G[1]);
    if ((err = allow_smem(ssd_bwd_dbc_kernel<P, N>, smem)) != cudaSuccess) return err;
    const int nblk = N / DbcSmem<P, N>::NB;
    ssd_bwd_dbc_kernel<P, N><<<dim3(p.H / G[1], p.nc, B * 2 * nblk), NTHREADS, smem, stream>>>(
        p, G[1]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const size_t smem = InterSmem<P, N>::bytes(Qp);
    if ((err = allow_smem(ssd_bwd_inter_kernel<P, N>, smem)) != cudaSuccess) return err;
    ssd_bwd_inter_kernel<P, N><<<dim3(p.H, p.nc, B), NTHREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long SN = (long long)p.S * N, total = (long long)B * SN;
  ssd_bwd_sum_kernel<<<dim3(unsigned((total + NTHREADS - 1) / NTHREADS), 2), NTHREADS, 0,
                       stream>>>(p.dB_part, p.dC_part, p.dB, p.dC, p.H / G[1], SN, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA_kernel<<<(p.H + 127) / 128, 128, 0, stream>>>(p.dA_part, p.dA, B * p.nc, p.H);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const Params* p, int B, int H, int Qp, int nc, int (&G)[3],
                       cudaStream_t stream) {
  switch (N) {
#define REPRO_CASE(n) \
    case n: return p ? launch<P, n>(*p, G, stream) : groups<P, n>(B, H, Qp, nc, G);
    REPRO_CASE(8)
    REPRO_CASE(16)
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(128)
#undef REPRO_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The pass (p null: the groups into G) at P, N.
cudaError_t dispatch(int P, int N, const Params* p, int B, int H, int Qp, int nc, int (&G)[3],
                     cudaStream_t stream) {
  switch (P) {
    case 16: return dispatch_n<16>(N, p, B, H, Qp, nc, G, stream);
    case 32: return dispatch_n<32>(N, p, B, H, Qp, nc, G, stream);
    case 64: return dispatch_n<64>(N, p, B, H, Qp, nc, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int S, int H, int chunk) {
  return B > 0 && S > 0 && H > 0 && chunk >= 1 && chunk <= QMAX;
}

}  // namespace

extern "C" {

// The heads a block of pass (2) (groups[0]) and of passes (4) and (5)
// (groups[1]) at this shape on the current device, and the rows of the rq
// scratch (groups[2]); repro_ssd_scan_bwd takes the first two, and its
// scratch is sized by all three.
int repro_ssd_scan_bwd_groups(int B, int S, int H, int P, int N, int chunk, int* groups) {
  if (!valid_shape(B, S, H, chunk)) return int(cudaErrorInvalidValue);
  int G[3] = {1, 1, 1};
  const int err = int(dispatch(P, N, nullptr, B, H, round_up(chunk, 16), (S + chunk - 1) / chunk,
                               G, nullptr));
  for (int i = 0; i < 3; ++i) groups[i] = G[i];
  return err;
}

// Every tensor f32 and contiguous: x, dy, dx [B,S,H,P]; dt, ddt [B,S,H]; A,
// dA [H]; Bm, Cm, dB, dC [B,S,N]. states [B,H,nc,P,N] and totals [B,H,nc]
// as the forward's passes (a) and (b) leave them (read only when nc > 1);
// scratch: rev [B,H,nc,P,N], scores [B,nc,Qp,Qp], wsum [B,nc,H/G1,2,Qp,Qp],
// rq [R,B,H,S], dB_part and dC_part [B,H/G1,S,N], dA_part [B,nc,H]; nc =
// ceil(S / chunk), Qp = chunk rounded up to a multiple of 16; G0, G1 and R
// from repro_ssd_scan_bwd_groups.
int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* states, const void* totals,
                       void* rev, void* scores, void* wsum, void* rq, void* dB_part,
                       void* dC_part, void* dA_part, void* dx, void* ddt, void* dA, void* dB,
                       void* dC, int B, int S, int H, int P, int N, int chunk, int G0, int G1,
                       void* stream) {
  if (!valid_shape(B, S, H, chunk) || G0 < 1 || G0 > MAX_GROUP || H % G0 || G1 < 1 ||
      G1 > MAX_GROUP || H % G1)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.dy = static_cast<const float*>(dy);
  p.states = static_cast<const float*>(states);
  p.totals = static_cast<const float*>(totals);
  p.rev = static_cast<float*>(rev);
  p.scores = static_cast<float*>(scores);
  p.wsum = static_cast<float*>(wsum);
  p.rq = static_cast<float*>(rq);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.dx = static_cast<float*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.Bsz = B;
  p.S = S;
  p.H = H;
  p.Q = chunk;
  p.Qp = round_up(chunk, 16);
  p.nc = (S + chunk - 1) / chunk;
  int G[3] = {G0, G1, 0};
  return int(dispatch(P, N, &p, B, H, p.Qp, p.nc, G, static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
