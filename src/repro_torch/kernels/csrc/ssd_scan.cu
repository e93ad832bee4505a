// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++ behind a C interface.
//
// Replaces repro/kernels/ssd_scan.py:_ssd_kernel (the Pallas TPU kernel under
// `ssd_scan`, pallas_call at line 90). Same function: for each (batch b,
// head h) and chunk of Q positions, with dA = dt * A and csum its inclusive
// prefix sum inside the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) x_j dt_j      (intra)
//         + exp(csum_i) C_i . state^T                                  (inter)
//   state <- exp(total) state + sum_j exp(total - csum_j) (x_j dt_j) B_j^T
// (total = csum of the chunk's last position) with an f32 [P, N] state
// carried across chunks from zero. B and C are shared by all heads (one
// group). Inputs and outputs are f32.
//
// What bounds it. At the serving slice (mamba2-370m prefill: B=4, S=1024,
// H=32, P=64, N=128, Q=128, with the final state) the work is 5.44 GFLOP:
// C.B^T over the causal pairs once per (b, chunk), then per (b, h, chunk)
// the masked scores times x*dt, C.state^T and the chunk's state. The bytes
// are ~76 MB (x and y 33.6 MB each, B and C 2.1 MB each, dt, the final
// state), 0.023 ms at 3.35 TB/s. On the f32 CUDA cores (67 TFLOP/s) the
// operations take 0.081 ms. The tensor cores take f32 only as TF32 (10-bit
// mantissa), which misses the 1e-4 the scan is held to by ~270x; split into
// hi + lo TF32 halves and summed as hi*lo' + lo*hi' + hi*hi' ("3xTF32") the
// products keep ~f32 accuracy at three times the operations: 16.3 GFLOP at
// 495 TFLOP/s = 0.033 ms. So the bound is 0.033 ms, by operations on the
// tensor cores. What this design pays on top: mma.sync, unlike wgmma, does
// not reach that rate; the chunk states make a round trip through device
// memory (written by (a), read and rewritten by (b), read by (c)) and x is
// read twice, ~230 MB in all; and each block alternates loads and
// products, which its other warps only partly overlap.
//
// Design: three launches on the caller's stream, each parallel over chunks.
//  (a) ssd_chunk_state_kernel, a block per (b, chunk, group of G heads), two
//      blocks an SM: B of the chunk is loaded once; each head's decay
//      weights exp(total - csum_j) dt_j come first, a warp a head, with the
//      chunk's prefix sum of dt * A in double (it reaches ~-100 over 128
//      positions, where an f32 sum put 4.5e-4 into y); then per head x is
//      loaded and the chunk's own state dstate = sum_j exp(total - csum_j)
//      (x_j dt_j) B_j^T [P, N] is one tensor-core product over the chunk's
//      positions, written to a scratch [B, H, nc, P, N] with the chunk's
//      total.
//  (b) ssd_state_pass_kernel, parallel over (b, h) and the P*N state: walks
//      the chunks in order, state_in[c] = exp(total[c-1]) state_in[c-1] +
//      dstate[c-1], written over dstate[c] in place (the same scratch), and
//      the state after the last chunk to state_out.
//  (c) ssd_chunk_out_kernel, a block per (b, chunk, group of G heads): C and
//      B of the chunk are loaded and every head's prefix sum taken; C.B^T
//      over the causal 16 x 16 tiles is computed once into shared memory
//      for all heads of the group; per head, y = exp(csum_i) C state_in^T +
//      (scores o L_h)(x dt) goes into one set of accumulators and is
//      stored. A warp holds two 16-row tiles, it and MT - 1 - it, so that
//      every warp has the same causal work, and the two share the x and
//      state fragments. While the intra product runs, the next head's
//      state_in is on its way (cp.async), and while the next head's inter
//      product runs, its x is.
// Every product is mma.sync m16n8k8 TF32 in 3xTF32; the operands are split
// at fragment load, hi rounded by integer operations (cvt.rna.tf32.f32 made
// the kernel slower) and lo left for the mma to truncate. Shared-memory rows
// are padded so that the fragment loads of a warp hit 32 different banks: a
// row stride of 4 mod 8 words for fragments read along a row, 8 mod 32 for
// fragments read down a column. The decay L_h[i][j] = exp(csum_i - csum_j)
// of a 16-row tile starting at r is exp(csum_i - csum_r) exp(csum_r -
// csum_j) below the diagonal tile, both factors <= 1, so the column factors
// are taken once per head and the row factor scales the accumulators; only
// the diagonal tile takes an exp per element. G (heads a block) is chosen
// on the host from the grid and the number of SMs. A ragged last chunk and
// the padding of Q up to a multiple of 16 are loaded as zeros (dt = x = B =
// C = 0), add nothing, and their rows of y are not written. No block waits
// on another, so nothing can hang across blocks.
//
// C interface (bound with ctypes): repro_ssd_scan_fwd returns the
// cudaError_t of the launches (0 on success); repro_ssd_scan_states runs
// passes (a) and (b) alone, for the backward.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int NTHREADS = 256;  // passes (a) and (b)
constexpr int NWARPS = NTHREADS / 32;
constexpr int OUT_WARPS = 8;  // pass (c)
constexpr int OUT_THREADS = 32 * OUT_WARPS;
constexpr int QMAX = 128;
constexpr int MAX_GROUP = 8;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// Row strides in floats: 4 mod 8 for fragments read along rows, 8 mod 32
// for fragments read down columns. Both keep rows 16-byte aligned.
__host__ __device__ constexpr int ld_row(int n) { return n + 4; }
__host__ __device__ constexpr int ld_col(int n) { return round_up(n, 32) + 8; }

struct Params {
  const float *x, *dt, *A, *Bm, *Cm;
  float *y, *state_out, *states, *totals;
  int S, H, Q, nc, vec;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh;
};

// ---- 3xTF32 mma ------------------------------------------------------------

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

// ---- loads -------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* s, const float* g, bool valid) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sa), "l"(g), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g, bool valid) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(sa), "l"(g), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, nrows) of W floats into s (row stride ld); row r < nv comes from
// g + r * gs, the others are zero. vec: 16-byte copies (every row address
// 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void load_rows(float* s, int ld, const float* g, long long gs,
                                          int nrows, int nv, int W, bool vec) {
  if (vec) {
    const int w4 = W / 4;
    for (int i = threadIdx.x; i < nrows * w4; i += blockDim.x) {
      const int r = i / w4, c = (i % w4) * 4;
      const bool ok = r < nv;
      cp_async16(s + r * ld + c, ok ? g + r * gs + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * W; i += blockDim.x) {
      const int r = i / W, c = i % W;
      const bool ok = r < nv;
      cp_async4(s + r * ld + c, ok ? g + r * gs + c : g, ok);
    }
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

__device__ __forceinline__ ChunkScan chunk_scan(const float* dt, long long dt_ss, int nv,
                                                int Qp, float a) {
  const int lane = threadIdx.x & 31;
  ChunkScan r;
  r.per = (Qp + 31) / 32;
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * r.per + e;
    r.dt[e] = e < r.per && j < nv ? dt[j * dt_ss] : 0.f;
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
__device__ __forceinline__ void chunk_csum(const float* dt, long long dt_ss, int nv,
                                           int Qp, float a, float* sDt, double* sCs) {
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

// One warp: a head's decay weights f_j = dt_j exp(total - csum_j) into sF
// (Qp positions); returns total.
__device__ __forceinline__ double chunk_decay(const float* dt, long long dt_ss, int nv,
                                              int Qp, float a, float* sF) {
  const ChunkScan r = chunk_scan(dt, dt_ss, nv, Qp, a);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * r.per + e;
    if (e < r.per && j < Qp) sF[j] = r.dt[e] * expf(float(r.total - r.csum[e]));
  }
  return r.total;
}

// ---- (a) chunk states --------------------------------------------------------

template <int P, int N>
struct StateSmem {
  static constexpr int LDB = ld_col(N), LDX = ld_col(P);
  __host__ __device__ static size_t bytes(int Qp, int G) {
    return (size_t(Qp) * (LDB + LDX + G)) * sizeof(float);
  }
};

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_chunk_state_kernel(const Params p, const int G) {
  using L = StateSmem<P, N>;
  constexpr int LDB = L::LDB, LDX = L::LDX;
  constexpr int WM = P / 16 < 2 ? P / 16 : 2;  // m16 tiles of a warp
  constexpr int WN = N / 8 < 4 ? N / 8 : 4;    // n8 tiles of a warp
  constexpr int TM = P / 16 / WM, TN = N / 8 / WN;
  const int Qp = round_up(p.Q, 16);

  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);
  float* sX = sB + Qp * LDB;
  float* sF = sX + Qp * LDX;  // [G][Qp]: dt_j exp(total - csum_j) of each head

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const int h_first = blockIdx.x * G;

  load_rows(sB, LDB, p.Bm + b * p.b_sb + t0 * p.b_ss, p.b_ss, Qp, nv, N, p.vec);
  if (warp < G) {  // each head's decay weights, a warp a head
    const int h = h_first + warp;
    const double total = chunk_decay(p.dt + b * p.dt_sb + t0 * p.dt_ss + h, p.dt_ss, nv,
                                     Qp, p.A[h], sF + warp * Qp);
    if (lane == 0) p.totals[(size_t(b) * p.H + h) * p.nc + c] = float(total);
  }
  for (int hh = 0; hh < G; ++hh) {
    const int h = h_first + hh;
    load_rows(sX, LDX, p.x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh, p.x_ss, Qp, nv, P,
              p.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* fh = sF + hh * Qp;

    // dstate[p][n] = sum_j (x[j][p] f_j) B[j][n]: M = P, N = N, K = Qp
    float* out = p.states + ((size_t(b) * p.H + h) * p.nc + c) * (P * N);
    for (int task = warp; task < TM * TN; task += NWARPS) {
      const int m0 = (task / TN) * WM * 16, n0 = (task % TN) * WN * 8;
      float acc[WM][WN][4];
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      for (int k0 = 0; k0 < Qp; k0 += 8) {
        const int j0 = k0 + t, j1 = k0 + t + 4;
        const float f0 = fh[j0], f1 = fh[j1];
        FragA a[WM];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const int r = m0 + 16 * m + g;
          a[m] = frag_a(sX[j0 * LDX + r] * f0, sX[j0 * LDX + r + 8] * f0,
                        sX[j1 * LDX + r] * f1, sX[j1 * LDX + r + 8] * f1);
        }
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          const int col = n0 + 8 * n + g;
          const FragB fb = frag_b(sB[j0 * LDB + col], sB[j1 * LDB + col]);
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
    __syncthreads();  // sX is rewritten for the next head
  }
}

// ---- (b) state passing -------------------------------------------------------

// One thread per float4 of a (b, h)'s state. states[b, h, c] holds dstate of
// chunk c on entry and the state entering chunk c on exit (c >= 1).
__global__ void __launch_bounds__(NTHREADS)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ totals,
                      float* __restrict__ state_out, int nc, int pn4) {
  const int e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= pn4) return;
  const size_t bh = blockIdx.y;
  float4* st = reinterpret_cast<float4*>(states) + bh * nc * pn4 + e;
  const float* tot = totals + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d = st[0];
  for (int c = 0; c < nc; ++c) {
    const float4 next = c + 1 < nc ? st[size_t(c + 1) * pn4] : d;
    if (c > 0) st[size_t(c) * pn4] = s;
    const float k = expf(tot[c]);
    s = make_float4(fmaf(k, s.x, d.x), fmaf(k, s.y, d.y), fmaf(k, s.z, d.z),
                    fmaf(k, s.w, d.w));
    d = next;
  }
  if (state_out != nullptr) reinterpret_cast<float4*>(state_out)[bh * pn4 + e] = s;
}

// ---- (c) chunk outputs -------------------------------------------------------

template <int P, int N>
struct OutSmem {
  static constexpr int LDC = ld_row(N), LDX = ld_col(P);
  // packed lower-triangular scores: 16-row tile it holds 16 (it + 1) columns
  __host__ __device__ static int ld_s(int it) { return 16 * (it + 1) + 4; }
  __host__ __device__ static int off_s(int it) { return 128 * it * (it + 1) + 64 * it; }
  __host__ __device__ static int region(int Qp) {  // B, or x and the state
    const int a = Qp * LDC, b = Qp * LDX + P * LDC;
    return a > b ? a : b;
  }
  __host__ __device__ static size_t floats(int Qp) {
    const int MT = Qp / 16;
    return size_t(Qp) * LDC + off_s(MT) + region(Qp)
         + 3 * size_t(Qp) * MAX_GROUP  // csum (double) and dt of each head
         + size_t(Qp)                  // row factors
         + size_t(MT) * Qp + 8;        // column factors, tile factors
  }
};

template <int P, int N>
__global__ void __launch_bounds__(OUT_THREADS, 1)
ssd_chunk_out_kernel(const Params p, const int G) {
  using L = OutSmem<P, N>;
  constexpr int LDC = L::LDC, LDX = L::LDX;
  // warps side by side along P, each with NG n8 tiles of y
  constexpr int NGR = OUT_WARPS / 4 < P / 8 ? OUT_WARPS / 4 : P / 8;
  constexpr int NG = P / 8 / NGR;
  constexpr int KN = N / 8;
  const int Qp = round_up(p.Q, 16), MT = Qp / 16;

  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);
  float* sS = sC + Qp * LDC;
  float* sU = sS + L::off_s(MT);
  float* sB = sU;
  float* sX = sU;
  float* sSt = sU + Qp * LDX;
  double* sCsAll = reinterpret_cast<double*>(sU + L::region(Qp));  // offsets are even
  float* sDtAll = reinterpret_cast<float*>(sCsAll + MAX_GROUP * Qp);
  float* sE = sDtAll + MAX_GROUP * Qp;
  float* sFd = sE + Qp;
  float* sEr = sFd + MT * Qp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.Q, nv = min(p.Q, p.S - t0);
  const int h_first = blockIdx.x * G;

  load_rows(sC, LDC, p.Cm + b * p.c_sb + t0 * p.c_ss, p.c_ss, Qp, nv, N, p.vec);
  load_rows(sB, LDC, p.Bm + b * p.b_sb + t0 * p.b_ss, p.b_ss, Qp, nv, N, p.vec);
  cp_async_commit();
  if (warp < G)  // each head's dt and prefix sum, a warp a head
    chunk_csum(p.dt + b * p.dt_sb + t0 * p.dt_ss + h_first + warp, p.dt_ss, nv, Qp,
               p.A[h_first + warp], sDtAll + warp * Qp, sCsAll + warp * Qp);
  cp_async_wait<0>();
  __syncthreads();

  // scores[i][j] = C_i . B_j over the causal 16 x 16 tiles (it, jp <= it)
  for (int task = warp; task < MT * (MT + 1) / 2; task += OUT_WARPS) {
    int it = 0, jp = task;
    while (jp > it) jp -= ++it;
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KN; ++ks) {
      const int k0 = 8 * ks;
      const float* cr = sC + (16 * it + g) * LDC + k0 + t;
      const FragA a = frag_a(cr[0], cr[8 * LDC], cr[4], cr[8 * LDC + 4]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* br = sB + (16 * jp + 8 * n + g) * LDC + k0 + t;
        mma3(acc[n], a, frag_b(br[0], br[4]));
      }
    }
    float* sr = sS + L::off_s(it);
    const int ld = L::ld_s(it);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * jp + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(sr + g * ld + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(sr + (g + 8) * ld + col) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();  // B is no longer needed: its room takes x and the state

  // this warp's work: n8 tiles [n0, n0 + 8 NG) of y in two 16-row tiles,
  // rt[0] and rt[1] = MT - 1 - rt[0], whose causal work sums to the same
  // for every warp; both tiles share the B fragments (state, x)
  const int pair = warp / NGR, n0 = (warp % NGR) * NG * 8;
  const bool active = pair < (MT + 1) / 2;
  const int rt[2] = {pair, MT - 1 - pair};
  const bool two = rt[1] != rt[0];

  const float* states_bc = p.states + size_t(c) * P * N;
  const size_t state_stride = size_t(p.nc) * P * N;  // from one head to the next
  const size_t bh0 = size_t(b) * p.H + h_first;
  if (c > 0) load_rows(sSt, LDC, states_bc + bh0 * state_stride, N, P, P, N, true);
  cp_async_commit();
  load_rows(sX, LDX, p.x + b * p.x_sb + t0 * p.x_ss + h_first * p.x_sh, p.x_ss, Qp, nv, P,
            p.vec);
  cp_async_commit();

  for (int hh = 0; hh < G; ++hh) {
    const int h = h_first + hh;
    const double* sCs = sCsAll + hh * Qp;
    const float* sDt = sDtAll + hh * Qp;
    // row factors exp(csum_i - csum_r), tile factors exp(csum_r), column
    // factors exp(csum_r - csum_j) dt_j below the diagonal tile (r = 16 it)
    for (int i = threadIdx.x; i < Qp; i += OUT_THREADS)
      sE[i] = expf(float(sCs[i] - sCs[i & ~15]));
    if (threadIdx.x < MT) sEr[threadIdx.x] = expf(float(sCs[16 * threadIdx.x]));
    for (int it = 1 + warp; it < MT; it += OUT_WARPS)
      for (int j = lane; j < 16 * it; j += 32)
        sFd[it * Qp + j] = expf(float(sCs[16 * it] - sCs[j])) * sDt[j];
    cp_async_wait<1>();  // the state entering this chunk
    __syncthreads();

    float acc[2][NG][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][n][e] = 0.f;

    // inter: acc = exp(csum_r) C state^T, M = 16 rows, N = 8 NG, K = N
    if (c > 0 && active) {
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        const int k0 = 8 * ks;
        FragB fb[NG];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float* sr = sSt + (n0 + 8 * n + g) * LDC + k0 + t;
          fb[n] = frag_b(sr[0], sr[4]);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == 1 && !two) break;
          const float* cr = sC + (16 * rt[k] + g) * LDC + k0 + t;
          const FragA a = frag_a(cr[0], cr[8 * LDC], cr[4], cr[8 * LDC + 4]);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[k][n], a, fb[n]);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float er = sEr[rt[k]];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][n][e] *= er;
      }
    }
    __syncthreads();  // the state is read: fetch the next head's
    if (c > 0 && hh + 1 < G)
      load_rows(sSt, LDC, states_bc + (bh0 + hh + 1) * state_stride, N, P, P, N, true);
    cp_async_commit();
    cp_async_wait<1>();  // x of this head
    __syncthreads();

    // intra: acc += (scores o L) (x dt), M = 16 rows, N = 8 NG, K = 16 (rt + 1).
    // Below a tile's diagonal tile the A operand is scores * column factors
    // and the row factors scale acc on reaching the diagonal tile, where
    // each element takes its own exp. The k-steps run in four stretches,
    // so that each loop body is the same for all its steps: both tiles
    // below their diagonals; tile 0 on its diagonal; tile 1 below its
    // diagonal; tile 1 on its diagonal.
    if (active) {
      const float* srow[2];
      const float* fd[2];
      int lds8[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        srow[k] = sS + L::off_s(rt[k]) + g * L::ld_s(rt[k]);
        lds8[k] = 8 * L::ld_s(rt[k]);
        fd[k] = sFd + rt[k] * Qp;
      }
      auto x_frags = [&](int k0, FragB (&fb)[NG]) {
        const float* x0 = sX + (k0 + t) * LDX + n0 + g;
#pragma unroll
        for (int n = 0; n < NG; ++n) fb[n] = frag_b(x0[8 * n], x0[4 * LDX + 8 * n]);
      };
      auto below = [&](int k, int k0) {
        const int j0 = k0 + t, j1 = j0 + 4;
        const float f0 = fd[k][j0], f1 = fd[k][j1];
        const float* sr = srow[k];
        return frag_a(sr[j0] * f0, sr[lds8[k] + j0] * f0, sr[j1] * f1, sr[lds8[k] + j1] * f1);
      };
      auto on = [&](int k, int k0) {
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8, j0 = k0 + t, j1 = j0 + 4;
        const double c0 = sCs[i0], c1 = sCs[i1], cj0 = sCs[j0], cj1 = sCs[j1];
        const float d0 = sDt[j0], d1 = sDt[j1];
        const float* sr = srow[k];
        return frag_a(j0 <= i0 ? sr[j0] * expf(float(c0 - cj0)) * d0 : 0.f,
                      j0 <= i1 ? sr[lds8[k] + j0] * expf(float(c1 - cj0)) * d0 : 0.f,
                      j1 <= i0 ? sr[j1] * expf(float(c0 - cj1)) * d1 : 0.f,
                      j1 <= i1 ? sr[lds8[k] + j1] * expf(float(c1 - cj1)) * d1 : 0.f);
      };
      auto scale_rows = [&](float (&a)[NG][4], int r0) {
        const float e0 = sE[r0 + g], e1 = sE[r0 + g + 8];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          a[n][0] *= e0;
          a[n][1] *= e0;
          a[n][2] *= e1;
          a[n][3] *= e1;
        }
      };
      const int r0 = 16 * rt[0], r1 = 16 * rt[1];
      FragB fb[NG];
#pragma unroll 2
      for (int k0 = 0; k0 < r0; k0 += 8) {
        x_frags(k0, fb);
        const FragA a0 = below(0, k0);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
        if (two) {
          const FragA a1 = below(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
      }
      scale_rows(acc[0], r0);
#pragma unroll
      for (int k0 = r0; k0 < r0 + 16; k0 += 8) {
        x_frags(k0, fb);
        const FragA a0 = on(0, k0);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma3(acc[0][n], a0, fb[n]);
        if (two) {
          const FragA a1 = below(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
      }
      if (two) {
#pragma unroll 2
        for (int k0 = r0 + 16; k0 < r1; k0 += 8) {
          x_frags(k0, fb);
          const FragA a1 = below(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
        scale_rows(acc[1], r1);
#pragma unroll
        for (int k0 = r1; k0 < r1 + 16; k0 += 8) {
          x_frags(k0, fb);
          const FragA a1 = on(1, k0);
#pragma unroll
          for (int n = 0; n < NG; ++n) mma3(acc[1][n], a1, fb[n]);
        }
      }
      float* yb = p.y + b * p.y_sb + t0 * p.y_ss + h * p.y_sh;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const int i0 = 16 * rt[k] + g, i1 = i0 + 8;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = n0 + 8 * n + 2 * t;
          if (i0 < nv)
            *reinterpret_cast<float2*>(yb + i0 * p.y_ss + col) =
                make_float2(acc[k][n][0], acc[k][n][1]);
          if (i1 < nv)
            *reinterpret_cast<float2*>(yb + i1 * p.y_ss + col) =
                make_float2(acc[k][n][2], acc[k][n][3]);
        }
      }
    }
    __syncthreads();  // x and the head's factors are read: fetch the next x
    if (hh + 1 < G)
      load_rows(sX, LDX, p.x + b * p.x_sb + t0 * p.x_ss + (h + 1) * p.x_sh, p.x_ss, Qp, nv,
                P, p.vec);
    cp_async_commit();
  }
}

// ---- host --------------------------------------------------------------------

// Heads a block: a divisor of H up to MAX_GROUP, by a cost model of waves
// of blocks times (heads + the block's fixed work, in heads).
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

template <typename K>
cudaError_t prepare(K kernel, int threads, size_t smem, int* slots) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  return cudaSuccess;
}

template <int P, int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int Qp = round_up(p.Q, 16);
  const bool need_states = p.nc > 1 || p.state_out != nullptr;
  cudaError_t err;
  int slots = 0;
  if (need_states) {
    const size_t smem = StateSmem<P, N>::bytes(Qp, MAX_GROUP);
    if ((err = prepare(ssd_chunk_state_kernel<P, N>, NTHREADS, smem, &slots)) != cudaSuccess)
      return err;
    const int G = pick_group(B * p.nc, p.H, slots, 0.1f);
    ssd_chunk_state_kernel<P, N><<<dim3(p.H / G, p.nc, B), NTHREADS, smem, stream>>>(p, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int pn4 = P * N / 4;
    ssd_state_pass_kernel<<<dim3((pn4 + NTHREADS - 1) / NTHREADS, B * p.H), NTHREADS, 0,
                            stream>>>(p.states, p.totals, p.state_out, p.nc, pn4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.y == nullptr) return cudaSuccess;  // the states alone (the backward's)
  const size_t smem = OutSmem<P, N>::floats(Qp) * sizeof(float);
  if ((err = prepare(ssd_chunk_out_kernel<P, N>, OUT_THREADS, smem, &slots)) != cudaSuccess)
    return err;
  const int G = pick_group(B * p.nc, p.H, slots, 0.3f);
  ssd_chunk_out_kernel<P, N><<<dim3(p.H / G, p.nc, B), OUT_THREADS, smem, stream>>>(p, G);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const Params& p, int B, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<P, 8>(p, B, stream);
    case 16: return launch<P, 16>(p, B, stream);
    case 32: return launch<P, 32>(p, B, stream);
    case 64: return launch<P, 64>(p, B, stream);
    case 128: return launch<P, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// x, dt, A, Bm, Cm, y f32. strides: 12 element strides, in order x (batch,
// seq, head), dt (batch, seq), B (batch, seq), C (batch, seq), y (batch,
// seq, head); the last dimension of each is contiguous, dt's is the head.
// state_out: [B, H, P, N] contiguous, or null. states: scratch
// [B, H, nc, P, N] and totals [B, H, nc], f32 contiguous, nc =
// ceil(S / chunk).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state_out,
                       void* states, void* totals,
                       int B, int S, int H, int P, int N, int chunk,
                       const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.y = static_cast<float*>(y);
  p.state_out = static_cast<float*>(state_out);
  p.states = static_cast<float*>(states);
  p.totals = static_cast<float*>(totals);
  p.S = S;
  p.H = H;
  p.Q = chunk;
  p.nc = (S + chunk - 1) / chunk;
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4];
  p.b_sb = strides[5]; p.b_ss = strides[6];
  p.c_sb = strides[7]; p.c_ss = strides[8];
  p.y_sb = strides[9]; p.y_ss = strides[10]; p.y_sh = strides[11];
  bool vec = aligned16(x) && aligned16(Bm) && aligned16(Cm);
  for (int i : {0, 1, 2, 5, 6}) vec = vec && strides[i] % 4 == 0;
  if (y != nullptr) vec = vec && strides[7] % 4 == 0 && strides[8] % 4 == 0;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return int(dispatch_n<16>(N, p, B, st));
    case 32: return int(dispatch_n<32>(N, p, B, st));
    case 64: return int(dispatch_n<64>(N, p, B, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// Passes (a) and (b) alone, for the SSD backward (csrc/ssd_scan_bwd.cu):
// states [B, H, nc, P, N] holds the state entering chunk c (c >= 1) and
// totals [B, H, nc] each chunk's total log decay; nothing else is written.
// x, dt, A, Bm f32 with the strides of repro_ssd_scan_fwd's x, dt and B
// (7 element strides); nc = ceil(S / chunk) > 1.
int repro_ssd_scan_states(const void* x, const void* dt, const void* A, const void* Bm,
                          void* states, void* totals, int B, int S, int H, int P, int N,
                          int chunk, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX || S <= chunk)
    return int(cudaErrorInvalidValue);
  const long long full[12] = {strides[0], strides[1], strides[2], strides[3], strides[4],
                              strides[5], strides[6], 0, 0, 0, 0, 0};
  return repro_ssd_scan_fwd(x, dt, A, Bm, Bm, nullptr, nullptr, states, totals, B, S, H, P, N,
                            chunk, full, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
