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
// of dt * A (in double: it reaches ~-100 over 128 positions), L[k][j] =
// exp(csum_k - csum_j) for j <= k, e_i = exp(total - csum_i), h_in the state
// entering the chunk and carry the adjoint leaving it (a_{next} g_{next}):
//   dx~_i = sum_{k>=i} (C_k . B_i) L[k][i] dy_k + e_i carry B_i     (dx = dt dx~)
//   W[k][j] = (dy_k . x_j) L[k][j] dt_j                              (j <= k)
//   dC_k += sum_j W[k][j] B_j + exp(csum_k) h_in^T dy_k
//   dB_j += sum_k W[k][j] C_k + dt_j e_j carry^T x_j
// and d(log decay) dl_i = a_i <g_i, h_{i-1}> as the reverse prefix sum of
//   r_m = rowsum_m(W o CB^T) - colsum_m(W o CB^T) + C_m . (exp(csum_m) h_in^T dy_m)
//         - dt_m x_m . (e_m carry B_m) + [m last] <carry, h_out>,
// the derivative of the loss by csum_m; then ddt_i = x_i . dx~_i + A dl_i
// and dA_h += sum_i dt_i dl_i. The carries walk the chunks in reverse as the
// forward's states walk them forwards: carry[c] = R[c+1] + exp(total[c+1])
// carry[c+1], with R[c] = sum_k exp(csum_k) dy_k C_k^T the chunk's own part.
//
// Passes, on the caller's stream (the wrapper first runs the forward's
// passes (a) and (b), csrc/ssd_scan.cu, for the states entering each chunk):
//  (1) ssd_bwd_scores_kernel, a block per (b, chunk): C B^T of the chunk
//      (shared by every head) to a scratch [B, nc, Qp, Qp];
//  (2) ssd_bwd_rev_kernel, a block per (b, chunk, h): R[c] [P, N];
//  (3) ssd_bwd_carry_kernel, per (b, h) and float4 of the state: the reverse
//      walk, carry[c] written over R[c] in place;
//  (4) ssd_bwd_chunk_kernel, a block per (b, chunk, h): everything above for
//      the chunk, writing dx and ddt, the head's dB and dC to [B, H, S, N]
//      scratch and its dA part to [B, nc, H];
//  (5) ssd_bwd_sum_kernel and ssd_bwd_dA_kernel: dB, dC summed over heads
//      and dA over batch and chunks, each in a fixed order. No atomics, so
//      two calls give the same bits.
//
// What bounds it. At mamba2-370m's training shape (B=4, S=1024, H=32, P=64,
// N=128, Q=128) the products are ~17 GFLOP (chip_smoke.py's ssd_bwd_bound
// counts them): 0.26 ms on the f32 CUDA cores, 0.10 ms as 3xTF32 on the
// tensor cores; the bytes (x, dy, dx 33.6 MB each, B, C, dB, dC, dt, ddt)
// ~0.04 ms. So operations bound it. This first design runs every product on
// the f32 CUDA cores (fmaf from shared memory, register tiles of 4 x 8 or
// 8 x 8, rows of a tile contiguous and its columns interleaved across
// threads, odd row strides so that a warp's reads hit distinct banks), one
// 256-thread block an SM in pass (4) (~219 KB of shared memory at Q = 128),
// and makes the per-head dB and dC a round trip through device memory
// (~270 MB at mamba2's shape) to keep their sums over heads deterministic.
// The tensor cores (3xTF32 as in the forward) and fewer round trips are the
// next steps.
//
// Padding: positions past S in the last chunk and Q up to a multiple of 16
// load as zeros (dt = x = dy = B = C = 0); they add nothing and are not
// written. C interface (bound with ctypes): repro_ssd_scan_bwd returns the
// cudaError_t of the launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int QMAX = 128;
constexpr int NCH = 32;  // state columns a step of pass (4) streams

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Params {
  const float *x, *dt, *A, *Bm, *Cm, *dy;  // [B,S,H,P] [B,S,H] [H] [B,S,N] [B,S,N] [B,S,H,P]
  const float* states;  // [B,H,nc,P,N]: the state entering chunk c (c >= 1)
  const float* totals;  // [B,H,nc]: each chunk's total log decay
  float* rev;           // [B,H,nc,P,N]: R[c], then carry[c]
  float* scores;        // [B,nc,Qp,Qp]: C_k . B_j
  float *dB_part, *dC_part;  // [B,H,S,N]
  float* dA_part;            // [B,nc,H]
  float *dx, *ddt, *dA, *dB, *dC;
  int Bsz, S, H, Q, Qp, nc;
};

// One warp: a head's dt over a chunk (0 past nv) and the inclusive prefix
// sum of dt * a in double, into sDt and sCs (Qp <= 128 positions; lane l
// holds positions l * per + e). Returns the chunk's total.
__device__ double chunk_csum(const float* dt, int stride, int nv, int Qp, float a, float* sDt,
                             double* sCs) {
  const int lane = threadIdx.x & 31;
  const int per = (Qp + 31) / 32;
  float d[4];
  double cs[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * per + e;
    d[e] = e < per && j < nv ? dt[size_t(j) * stride] : 0.f;
    run += double(d[e]) * double(a);
    cs[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * per + e;
    if (e < per && j < Qp) {
      sDt[j] = d[e];
      sCs[j] = cs[e] + incl - run;
    }
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Rows [0, rows) of W floats into s (row stride ld) from g (row stride gs);
// row r >= nv is zero.
__device__ __forceinline__ void load_rows(float* s, int ld, const float* g, size_t gs,
                                          int rows, int nv, int W) {
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int r = i / W, c = i % W;
    s[r * ld + c] = r < nv ? g[r * gs + c] : 0.f;
  }
}

// A thread's register tile of a block product: rows tm * TM + i
// (contiguous), columns tn + j * NT (interleaved across the NT column
// threads). acc[i][j] += sum_{k in [k0, k1)} a(row, k) b(k, col).
template <int TM, int TN, typename FA, typename FB>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], int tm, int tn, int NT, int k0,
                                        int k1, FA a, FB b) {
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(tm * TM + i, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(k, tn + j * NT);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// ---- (1) scores C_k . B_j of a chunk ------------------------------------------

template <int N>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_bwd_scores_kernel(const Params p) {
  constexpr int LN = N + 1;
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + p.Qp * LN;
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  load_rows(sC, LN, p.Cm + (size_t(b) * p.S + t0) * N, N, p.Qp, nv, N);
  load_rows(sB, LN, p.Bm + (size_t(b) * p.S + t0) * N, N, p.Qp, nv, N);
  __syncthreads();
  constexpr int TM = 8, TN = 8;
  const int NT = p.Qp / TN, MT = p.Qp / TM;
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
  if (tm >= MT) return;
  float acc[TM][TN];
  zero(acc);
  tile_mm(acc, tm, tn, NT, 0, N, [&](int k, int n) { return sC[k * LN + n]; },
          [&](int n, int j) { return sB[j * LN + n]; });
  float* out = p.scores + (size_t(b) * p.nc + c) * p.Qp * p.Qp;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) out[(tm * TM + i) * p.Qp + tn + j * NT] = acc[i][j];
}

// ---- (2) each chunk's own reverse state R = sum_k exp(csum_k) dy_k C_k^T ------

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS) ssd_bwd_rev_kernel(const Params p) {
  constexpr int LN = N + 1, LP = P + 1;
  extern __shared__ float smem[];
  float* sC = smem;
  float* sDy = sC + p.Qp * LN;
  float* sDt = sDy + p.Qp * LP;
  double* sCs = reinterpret_cast<double*>(sDt + round_up(p.Qp, 2));
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (c == 0) return;  // R[0] feeds no carry
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  load_rows(sC, LN, p.Cm + row * N, N, p.Qp, nv, N);
  load_rows(sDy, LP, p.dy + (row * p.H + h) * P, size_t(p.H) * P, p.Qp, nv, P);
  if (threadIdx.x < 32)
    chunk_csum(p.dt + row * p.H + h, p.H, nv, p.Qp, p.A[h], sDt, sCs);
  __syncthreads();
  for (int i = threadIdx.x; i < p.Qp * P; i += blockDim.x) {
    const int k = i / P, q = i % P;
    sDy[k * LP + q] *= expf(float(sCs[k]));
  }
  __syncthreads();
  constexpr int TM = 4, TN = 8;  // P >= 16, N >= 8
  constexpr int NT = N / TN, MT = P / TM;
  const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
  if (tm >= MT) return;
  float acc[TM][TN];
  zero(acc);
  tile_mm(acc, tm, tn, NT, 0, p.Qp, [&](int q, int k) { return sDy[k * LP + q]; },
          [&](int k, int n) { return sC[k * LN + n]; });
  float* out = p.rev + ((size_t(b) * p.H + h) * p.nc + c) * (P * N);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) out[(tm * TM + i) * N + tn + j * NT] = acc[i][j];
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
  for (int c = nc - 1; c >= 0; --c) {
    const float4 d = st[size_t(c) * pn4];
    st[size_t(c) * pn4] = s;
    const float k = expf(tot[c]);
    s = make_float4(fmaf(k, s.x, d.x), fmaf(k, s.y, d.y), fmaf(k, s.z, d.z), fmaf(k, s.w, d.w));
  }
}

// ---- (4) the chunk-parallel pass -----------------------------------------------

template <int P, int N>
struct ChunkSmem {
  static constexpr int LP = P + 1;
  static constexpr int NC = N < NCH ? N : NCH;  // state columns a step
  static constexpr int LC = NC + 1;
  __host__ __device__ static int lq(int Qp) { return Qp + 1; }
  // offsets in floats
  __host__ __device__ static int x(int) { return 0; }
  __host__ __device__ static int dy(int Qp) { return Qp * LP; }
  __host__ __device__ static int w(int Qp) { return 2 * Qp * LP; }
  __host__ __device__ static int s(int Qp) { return w(Qp) + Qp * lq(Qp); }  // scores, then tiles
  __host__ __device__ static int region(int Qp) {
    const int a = Qp * lq(Qp), b = 2 * Qp * LC + 3 * P * LC;
    return a > b ? a : b;
  }
  __host__ __device__ static int cs(int Qp) { return round_up(s(Qp) + region(Qp), 2); }
  __host__ __device__ static int vec(int Qp) { return cs(Qp) + 2 * Qp; }  // dt, e, es, r
  __host__ __device__ static int part(int Qp) { return vec(Qp) + 4 * Qp; }
  __host__ __device__ static int red(int Qp) { return part(Qp) + 32 * Qp; }
  __host__ __device__ static size_t bytes(int Qp) {
    return size_t(red(Qp) + NTHREADS + 8) * sizeof(float);
  }
};

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_bwd_chunk_kernel(const Params p) {
  using L = ChunkSmem<P, N>;
  constexpr int LP = L::LP, NC = L::NC, LC = L::LC;
  const int Qp = p.Qp, LQ = L::lq(Qp);
  extern __shared__ float smem[];
  float* sX = smem + L::x(Qp);
  float* sDy = smem + L::dy(Qp);
  float* sW = smem + L::w(Qp);
  float* sS = smem + L::s(Qp);
  double* sCs = reinterpret_cast<double*>(smem + L::cs(Qp));
  float* sDt = smem + L::vec(Qp);
  float* sE = sDt + Qp;   // exp(total - csum_i)
  float* sEs = sE + Qp;   // exp(csum_i)
  float* sR = sEs + Qp;   // r_i
  float* sPart = smem + L::part(Qp);  // [16][Qp] row and [16][Qp] column partials
  float* sRed = smem + L::red(Qp);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const size_t row = size_t(b) * p.S + t0;
  const bool has_in = c > 0, has_carry = c + 1 < p.nc;
  const float a = p.A[h];
  const float* h_in = p.states + ((size_t(b) * p.H + h) * p.nc + c) * (P * N);
  const float* h_out = h_in + P * N;  // the state entering chunk c + 1
  const float* carry = p.rev + ((size_t(b) * p.H + h) * p.nc + c) * (P * N);

  load_rows(sX, LP, p.x + (row * p.H + h) * P, size_t(p.H) * P, Qp, nv, P);
  load_rows(sDy, LP, p.dy + (row * p.H + h) * P, size_t(p.H) * P, Qp, nv, P);
  {
    const float* sc = p.scores + (size_t(b) * p.nc + c) * Qp * Qp;
    for (int i = threadIdx.x; i < Qp * Qp; i += blockDim.x) sS[(i / Qp) * LQ + i % Qp] = sc[i];
  }
  if (threadIdx.x < 32) {
    const double total = chunk_csum(p.dt + row * p.H + h, p.H, nv, Qp, a, sDt, sCs);
    __syncwarp();
    for (int i = threadIdx.x; i < Qp; i += 32) {
      sE[i] = expf(float(total - sCs[i]));
      sEs[i] = expf(float(sCs[i]));
    }
  }
  __syncthreads();

  // W[k][j] = (dy_k . x_j) L[k][j] dt_j; the scores become A2 = CB^T o L in
  // place; the row and column sums of W o CB^T go to the partials
  {
    constexpr int TM = 8, TN = 8;
    const int NT = Qp / TN, MT = Qp / TM;
    const int tm = threadIdx.x / NT, tn = threadIdx.x % NT;
    if (tm < MT) {
      float acc[TM][TN];
      zero(acc);
      tile_mm(acc, tm, tn, NT, 0, P, [&](int k, int q) { return sDy[k * LP + q]; },
              [&](int q, int j) { return sX[j * LP + q]; });
      float cols[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) cols[j] = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int k = tm * TM + i;
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int jj = tn + j * NT;
          const float l = jj <= k ? expf(float(sCs[k] - sCs[jj])) : 0.f;
          const float w = acc[i][j] * l * sDt[jj];
          const float sc = sS[k * LQ + jj];
          const float sv = w * sc;
          sW[k * LQ + jj] = w;
          sS[k * LQ + jj] = sc * l;
          rsum += sv;
          cols[j] += sv;
        }
        sPart[tn * Qp + k] = rsum;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) sPart[(16 + tm) * Qp + tn + j * NT] = cols[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Qp; i += blockDim.x) {
    float rs = 0.f, cs = 0.f;
    for (int t = 0; t < Qp / 8; ++t) {
      rs += sPart[t * Qp + i];
      cs += sPart[(16 + t) * Qp + i];
    }
    sR[i] = rs - cs;
  }
  __syncthreads();

  // dx~ = A2^T dy (intra) + e_i B carry^T (inter): rows i, columns p
  constexpr int TMX = 4, TNX = 8;
  constexpr int NTX = P / TNX;
  const int MTX = Qp / TMX;
  const int tmx = threadIdx.x / NTX, tnx = threadIdx.x % NTX;
  const bool actx = tmx < MTX;
  float dxi[TMX][TNX], dxe[TMX][TNX];
  zero(dxi);
  zero(dxe);
  if (actx)
    tile_mm(dxi, tmx, tnx, NTX, tmx * TMX, Qp, [&](int i, int k) { return sS[k * LQ + i]; },
            [&](int k, int q) { return sDy[k * LP + q]; });
  float* sBt = sS;                // [Qp][LC]
  float* sCt = sBt + Qp * LC;     // [Qp][LC]
  float* sHin = sCt + Qp * LC;    // [P][LC]
  float* sCar = sHin + P * LC;    // [P][LC]
  float* sHout = sCar + P * LC;   // [P][LC]
  if (has_carry) {
    for (int n0 = 0; n0 < N; n0 += NC) {
      __syncthreads();  // A2 or the previous step's tiles are read
      load_rows(sBt, LC, p.Bm + row * N + n0, N, Qp, nv, NC);
      load_rows(sCar, LC, carry + n0, N, P, P, NC);
      __syncthreads();
      if (actx)
        tile_mm(dxe, tmx, tnx, NTX, 0, NC, [&](int i, int n) { return sBt[i * LC + n]; },
                [&](int n, int q) { return sCar[q * LC + n]; });
    }
  }
  // dx, and the per-row sums x . dx~ and dt x . dx~(inter)
  float* sQ1 = sPart;             // [NTX][Qp]
  float* sQ2 = sPart + 8 * Qp;    // [NTX][Qp]
  float* sQ3 = sPart + 16 * Qp;   // [NT5][Qp]
  __syncthreads();  // B and carry are read before pass (4)'s tiles reload them
  if (actx) {
#pragma unroll
    for (int i = 0; i < TMX; ++i) {
      const int r = tmx * TMX + i;
      const float e = sE[r], d = sDt[r];
      float q1 = 0.f, q2 = 0.f;
#pragma unroll
      for (int j = 0; j < TNX; ++j) {
        const int q = tnx + j * NTX;
        const float ex = e * dxe[i][j];
        const float tot = dxi[i][j] + ex;
        const float xv = sX[r * LP + q];
        q1 = fmaf(xv, tot, q1);
        q2 = fmaf(xv, ex, q2);
        if (r < nv) p.dx[((row + r) * p.H + h) * P + q] = d * tot;
      }
      sQ1[tnx * Qp + r] = q1;
      sQ2[tnx * Qp + r] = d * q2;
    }
  }

  // dC and dB, NC state columns a step: intra from W, inter from h_in and
  // carry; C . dC(inter) per row; <carry, h_out>
  constexpr int TM5 = 4, TN5 = 4;
  constexpr int NT5 = NC / TN5;
  const int MT5 = Qp / TM5;
  const int tm5 = threadIdx.x / NT5, tn5 = threadIdx.x % NT5;
  const bool act5 = tm5 < MT5;
  float q3[TM5];
#pragma unroll
  for (int i = 0; i < TM5; ++i) q3[i] = 0.f;
  float dot = 0.f;  // this thread's part of <carry, h_out>
  for (int n0 = 0; n0 < N; n0 += NC) {
    __syncthreads();  // the previous tiles are read
    load_rows(sBt, LC, p.Bm + row * N + n0, N, Qp, nv, NC);
    load_rows(sCt, LC, p.Cm + row * N + n0, N, Qp, nv, NC);
    if (has_in) load_rows(sHin, LC, h_in + n0, N, P, P, NC);
    if (has_carry) {
      load_rows(sCar, LC, carry + n0, N, P, P, NC);
      load_rows(sHout, LC, h_out + n0, N, P, P, NC);
    }
    __syncthreads();
    if (has_carry)
      for (int i = threadIdx.x; i < P * NC; i += blockDim.x) {
        const int q = i / NC, n = i % NC;
        dot = fmaf(sCar[q * LC + n], sHout[q * LC + n], dot);
      }
    if (!act5) continue;
    const int k0 = tm5 * TM5;
    float acc[TM5][TN5], inter[TM5][TN5];
    // dC: sum_{j <= k} W[k][j] B_j
    zero(acc);
    tile_mm(acc, tm5, tn5, NT5, 0, k0 + TM5, [&](int k, int j) { return sW[k * LQ + j]; },
            [&](int j, int n) { return sBt[j * LC + n]; });
    zero(inter);
    if (has_in)
      tile_mm(inter, tm5, tn5, NT5, 0, P, [&](int k, int q) { return sDy[k * LP + q]; },
              [&](int q, int n) { return sHin[q * LC + n]; });
#pragma unroll
    for (int i = 0; i < TM5; ++i) {
      const int k = k0 + i;
      const float es = sEs[k];
#pragma unroll
      for (int j = 0; j < TN5; ++j) {
        const int n = tn5 + j * NT5;
        const float ci = es * inter[i][j];
        q3[i] = fmaf(sCt[k * LC + n], ci, q3[i]);
        if (k < nv)
          p.dC_part[((size_t(b) * p.H + h) * p.S + t0 + k) * N + n0 + n] = acc[i][j] + ci;
      }
    }
    // dB: sum_{k >= j} W[k][j] C_k
    zero(acc);
    tile_mm(acc, tm5, tn5, NT5, k0, Qp, [&](int j, int k) { return sW[k * LQ + j]; },
            [&](int k, int n) { return sCt[k * LC + n]; });
    zero(inter);
    if (has_carry)
      tile_mm(inter, tm5, tn5, NT5, 0, P, [&](int j, int q) { return sX[j * LP + q]; },
              [&](int q, int n) { return sCar[q * LC + n]; });
#pragma unroll
    for (int i = 0; i < TM5; ++i) {
      const int j0 = k0 + i;
      const float f = sDt[j0] * sE[j0];
#pragma unroll
      for (int j = 0; j < TN5; ++j) {
        const int n = tn5 + j * NT5;
        if (j0 < nv)
          p.dB_part[((size_t(b) * p.H + h) * p.S + t0 + j0) * N + n0 + n] =
              acc[i][j] + f * inter[i][j];
      }
    }
  }
  if (act5) {
#pragma unroll
    for (int i = 0; i < TM5; ++i) sQ3[tn5 * Qp + tm5 * TM5 + i] = q3[i];
  }
  sRed[threadIdx.x] = dot;
  __syncthreads();

  // r, its reverse prefix sum dl, ddt and this block's part of dA (thread 0,
  // in order)
  if (threadIdx.x == 0) {
    float hdot = 0.f;
    for (int t = 0; t < blockDim.x; ++t) hdot += sRed[t];
    double dl = 0.0, da = 0.0;
    for (int i = Qp - 1; i >= 0; --i) {
      float q1 = 0.f, q2 = 0.f, q3s = 0.f;
      for (int t = 0; t < NTX; ++t) {
        q1 += sQ1[t * Qp + i];
        q2 += sQ2[t * Qp + i];
      }
      for (int t = 0; t < NT5; ++t) q3s += sQ3[t * Qp + i];
      float r = sR[i] + q3s - q2;
      if (i == nv - 1 && has_carry) r += hdot;
      dl += double(r);
      if (i < nv) {
        p.ddt[(row + i) * p.H + h] = q1 + a * float(dl);
        da += double(sDt[i]) * dl;
      }
    }
    p.dA_part[(size_t(b) * p.nc + c) * p.H + h] = float(da);
  }
}

// ---- (5) sums over heads and over batch and chunks, in a fixed order -----------

// dB or dC (blockIdx.y) [B, S, N] = sum_h part[B, h, S, N]
__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                   float* __restrict__ dB, float* __restrict__ dC, int H, long long SN,
                   long long total) {
  const long long e = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  if (e >= total) return;
  const long long b = e / SN, r = e % SN;
  const float* src = (blockIdx.y == 0 ? dB_part : dC_part) + b * H * SN + r;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[h * SN];
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

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  const int B = p.Bsz, Qp = p.Qp;
  {
    const size_t smem = size_t(2) * Qp * (N + 1) * sizeof(float);
    if ((err = set_smem(ssd_bwd_scores_kernel<N>, smem)) != cudaSuccess) return err;
    ssd_bwd_scores_kernel<N><<<dim3(p.nc, B), NTHREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.nc > 1) {
    const size_t smem =
        (size_t(Qp) * (N + 1) + size_t(Qp) * (P + 1) + round_up(Qp, 2) + 2 * Qp) * sizeof(float);
    if ((err = set_smem(ssd_bwd_rev_kernel<P, N>, smem)) != cudaSuccess) return err;
    ssd_bwd_rev_kernel<P, N><<<dim3(p.H, p.nc, B), NTHREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int pn4 = P * N / 4;
    ssd_bwd_carry_kernel<<<dim3((pn4 + NTHREADS - 1) / NTHREADS, B * p.H), NTHREADS, 0,
                           stream>>>(p.rev, p.totals, p.nc, pn4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const size_t smem = ChunkSmem<P, N>::bytes(Qp);
    if ((err = set_smem(ssd_bwd_chunk_kernel<P, N>, smem)) != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<P, N><<<dim3(p.H, p.nc, B), NTHREADS, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long SN = (long long)p.S * N, total = (long long)B * SN;
  ssd_bwd_sum_kernel<<<dim3(unsigned((total + NTHREADS - 1) / NTHREADS), 2), NTHREADS, 0,
                       stream>>>(p.dB_part, p.dC_part, p.dB, p.dC, p.H, SN, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA_kernel<<<(p.H + 127) / 128, 128, 0, stream>>>(p.dA_part, p.dA, B * p.nc, p.H);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const Params& p, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<P, 8>(p, stream);
    case 16: return launch<P, 16>(p, stream);
    case 32: return launch<P, 32>(p, stream);
    case 64: return launch<P, 64>(p, stream);
    case 128: return launch<P, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every tensor f32 and contiguous: x, dy, dx [B,S,H,P]; dt, ddt [B,S,H]; A,
// dA [H]; Bm, Cm, dB, dC [B,S,N]. states [B,H,nc,P,N] and totals [B,H,nc]
// as the forward's passes (a) and (b) leave them (read only when nc > 1);
// scratch: rev [B,H,nc,P,N], scores [B,nc,Qp,Qp], dB_part and dC_part
// [B,H,S,N], dA_part [B,nc,H]; nc = ceil(S / chunk), Qp = chunk rounded up
// to a multiple of 16.
int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* states, const void* totals,
                       void* rev, void* scores, void* dB_part, void* dC_part, void* dA_part,
                       void* dx, void* ddt, void* dA, void* dB, void* dC,
                       int B, int S, int H, int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX) return int(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return int(dispatch_n<16>(N, p, st));
    case 32: return int(dispatch_n<32>(N, p, st));
    case 64: return int(dispatch_n<64>(N, p, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
