// Flash attention backward (sm_90a): dQ, dK and dV of the forward that the
// three flash routes compute, from q, k, v, the forward's output o and its
// cotangent dO. CUDA C++ behind a C interface.
//
// Replaces the backward that the reference trains through: the jnp custom
// VJP `_flash_bwd_vjp` (repro/models/attention.py:227) of its blockwise
// flash core; the Pallas kernel (repro/kernels/flash_attention.py) has no
// VJP. Same function: with s = q k^T / sqrt(hd), softcapped as
// cap * tanh(s / cap) when cap > 0, the causal and sliding-window masks
// after the cap, P = softmax(s) by rows, D = rowsum(dO o),
//   dV = P^T dO,  dS = P (dO V^T - D) (1 - tanh^2) / sqrt(hd),
//   dQ = dS K,    dK = dS^T Q,
// dK and dV summed over the H / KV query heads of each kv head (GQA), rows
// with no visible key giving zero, f32 accumulation, outputs in the
// inputs' dtype (f32 or bf16).
//
// What bounds it, at llama3.2-1b's training shape (B=4, S=T=1024, H=32,
// KV=8, hd=64, causal, bf16): the five products of the backward over the
// visible (q, k) pairs, 2.5 x the forward's 17.20 GFLOP = 43.0 GFLOP, take
// 0.0435 ms at the bf16 tensor-core rate; its 117 MB of inputs and outputs
// 0.035 ms at 3.35 TB/s. This kernel is the simple one that is right first:
// every product is f32 FMAs on the CUDA cores (67 TFLOP/s, where one TF32
// product would miss the f32 tolerance of 2e-5), and it recomputes the
// scores three times and dP twice, 8 products in all (68.8 GFLOP at that
// shape), in exchange for no atomics and a result that does not depend on
// the order blocks run in.
//
// Design: three passes, each a grid of independent blocks of 256 threads
// over 64 x 64 tiles staged in shared memory as f32.
//  1. lse: a block per (b, h, 64-row q tile) walks the key tiles it can see
//     and keeps the running max and sum of each row (the forward does not
//     write its log-sum-exp), and D = rowsum(dO o); both f32 [B, H, S].
//  2. dK, dV: a block per (b, kv head, 64-key tile) holds K and V, walks the
//     group's query heads and the q tiles that can see the key tile, and
//     accumulates dK and dV in registers: P and dS of a (q tile, key tile)
//     pair go through shared memory from the threads that computed them to
//     the threads that own the key rows.
//  3. dQ: a block per (b, h, q tile) holds Q and dO and walks the key tiles
//     it can see, accumulating dQ in registers.
// Whole tiles above the causal diagonal or outside the window are skipped,
// as in the forward; the cut tiles are masked element by element. Blocks are
// ordered longest walk first. A thread computes a 4 x 4 block of a score
// tile (rows ty + 16 i, keys tx + 16 j) from 16-byte row loads; with rows
// padded to a stride of 4 mod 32 floats, the 8 threads of a quarter warp
// read 8 different bank groups. head_dim is padded with zero columns to a
// built width of 32, 64 or 128, so every hd from 1 to 128 is taken.
//
// C interface (bound with ctypes): repro_flash_attention_bwd returns the
// cudaError_t of the first launch that failed (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int BQ = 64;        // q rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int LDP = BK + 4;   // row stride of a P or dS tile in floats

// element-stride slots of Params::st: (batch, seq, head) of each tensor
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18, SDV = 21 };

template <int HD>
struct Shape {
  static constexpr int LD = HD + 4;    // row stride of a [64][HD] tile in floats
  static constexpr int DPT = HD / 16;  // head columns a thread accumulates
};

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [B, H, S]
  int B, S, Tk, H, KV, group, hd, nq, nk, causal, window;
  float softcap, scale;
  long long st[24];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __float2bfloat16(x);
}

// Rows [0, 64) x columns [0, HD) of s (row stride LD) as f32 from g (row
// stride rs elements); rows >= nv and columns >= hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long rs, int nv, int hd) {
  constexpr int LD = Shape<HD>::LD;
  for (int i = threadIdx.x; i < 64 * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD;
    s[r * LD + c] = r < nv && c < hd ? to_f(g[r * rs + c]) : 0.f;
  }
}

// acc[i][j] = sum over d of a[ty + 16 i][d] b[tx + 16 j][d]: a thread's 4 x 4
// block of a 64 x 64 product of two row-major tiles.
template <int HD>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* a, const float* b,
                                             int ty, int tx) {
  constexpr int LD = Shape<HD>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// The score of a raw product s: scaled, then softcapped; t = tanh(.) for
// the cap's derivative.
__device__ __forceinline__ float score(const Params& p, float s, float& t) {
  float x = s * p.scale;
  if (p.softcap > 0.f) {
    t = tanhf(x / p.softcap);
    x = p.softcap * t;
  }
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int r, int c) {
  return r < p.S && c < p.Tk && (!p.causal || c <= r) && (p.window <= 0 || c > r - p.window);
}

// Keys [lo, hi] that q rows [q0, q0 + 64) can see (lo > hi: none).
__device__ __forceinline__ void key_range(const Params& p, int q0, int& lo, int& hi) {
  lo = 0;
  hi = p.Tk - 1;
  if (p.causal) hi = min(hi, min(q0 + BQ, p.S) - 1);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
}

// P and dS of a thread's 4 x 4 block: s = Q K^T, dp = dO V^T of q rows
// q0 + rr, keys k0 + cc; lse and D of the tile's rows in shared memory.
__device__ __forceinline__ void probs_and_dscores(const Params& p, float (&s)[4][4],
                                                  float (&dp)[4][4], const float* sl,
                                                  const float* sd, int q0, int k0, int ty,
                                                  int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = ty + 16 * i, cc = tx + 16 * j;
      float t = 0.f;
      const float x = score(p, s[i][j], t);
      // a row with no visible key has lse = +inf, so its p is 0
      const float pr = visible(p, q0 + rr, k0 + cc) ? expf(x - sl[rr]) : 0.f;
      float ds = pr * (dp[i][j] - sd[rr]);
      if (p.softcap > 0.f) ds *= 1.f - t * t;
      s[i][j] = pr;
      dp[i][j] = ds * p.scale;
    }
}

template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* s) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 y = *reinterpret_cast<const float4*>(s + u);
      x[u] = y.x; x[u + 1] = y.y; x[u + 2] = y.z; x[u + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 y = *reinterpret_cast<const float2*>(s + u);
      x[u] = y.x; x[u + 1] = y.y;
    }
  }
}

// ---- pass 1: lse and D --------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_lse_kernel(const Params p) {
  constexpr int LD = Shape<HD>::LD;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * LD;

  const int nbh = p.B * p.H;
  const int rank = blockIdx.x / nbh, bh = blockIdx.x - rank * nbh;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;  // the last q tiles (longest causal walk) first
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  {  // D = rowsum(dO o): 4 threads a row
    const int r = tid >> 2, part = tid & 3, qpos = q0 + r;
    float acc = 0.f;
    if (qpos < p.S) {
      const T* orow = static_cast<const T*>(p.o) + b * p.st[SO] + qpos * p.st[SO + 1] +
                      h * p.st[SO + 2];
      const T* drow = static_cast<const T*>(p.dout) + b * p.st[SDO] + qpos * p.st[SDO + 1] +
                      h * p.st[SDO + 2];
      for (int c = part; c < p.hd; c += 4) acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && qpos < p.S) p.delta[(long long)bh * p.S + qpos] = acc;
  }

  const T* qb = static_cast<const T*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 2];
  const T* kb = static_cast<const T*>(p.k) + b * p.st[SK] + (h / p.group) * p.st[SK + 2];
  load_tile<T, HD>(sq, qb + q0 * p.st[SQ + 1], p.st[SQ + 1], p.S - q0, p.hd);

  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  const int kt_end = k_lo <= k_hi ? k_hi / BK : -1;
  for (int kt = k_lo / BK; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous key tile is consumed (and Q is staged)
    load_tile<T, HD>(sk, kb + k0 * p.st[SK + 1], p.st[SK + 1], p.Tk - k0, p.hd);
    __syncthreads();
    float s[4][4];
    tile_product<HD>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        const float x = score(p, s[i][j], t);
        s[i][j] = visible(p, q0 + ty + 16 * i, k0 + tx + 16 * j) ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes
#pragma unroll
      for (int w = 1; w < 16; w *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      float sum = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - mx);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (mx != -INFINITY) {
        l[i] = l[i] * expf(m[i] - mx) + sum;  // exp(-inf) = 0 for the first visible key
        m[i] = mx;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      if (qpos < p.S) p.lse[(long long)bh * p.S + qpos] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// Stage rows q0.. of lse and D of (b, h) (lse = +inf, D = 0 past S).
__device__ __forceinline__ void load_rows(const Params& p, float* sl, float* sd, long long bh, int q0) {
  if (threadIdx.x < BQ) {
    const int qpos = q0 + threadIdx.x;
    sl[threadIdx.x] = qpos < p.S ? p.lse[bh * p.S + qpos] : INFINITY;
    sd[threadIdx.x] = qpos < p.S ? p.delta[bh * p.S + qpos] : 0.f;
  }
}

// ---- pass 2: dK and dV ----------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = Shape<HD>::LD, DPT = Shape<HD>::DPT;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BQ * LD;
  float* sp = sdo + BQ * LD;
  float* sds = sp + BQ * LDP;
  float* sl = sds + BQ * LDP;
  float* sd = sl + BQ;

  const int nbk = p.B * p.KV;
  const int kt = blockIdx.x / nbk, bk = blockIdx.x - kt * nbk;  // key tile 0 (longest walk) first
  const int b = bk / p.KV, kvh = bk - b * p.KV;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int cx = tid & 15, dx = tid >> 4;  // accumulation: keys 4 cx + j, columns DPT dx + u

  load_tile<T, HD>(sk, static_cast<const T*>(p.k) + b * p.st[SK] + kvh * p.st[SK + 2] +
                           k0 * p.st[SK + 1], p.st[SK + 1], p.Tk - k0, p.hd);
  load_tile<T, HD>(sv, static_cast<const T*>(p.v) + b * p.st[SV] + kvh * p.st[SV + 2] +
                           k0 * p.st[SV + 1], p.st[SV + 1], p.Tk - k0, p.hd);

  // q rows that can see a key of [k0, k0 + BK)
  const int r_lo = p.causal ? k0 : 0;
  int r_hi = p.S - 1;
  if (p.window > 0) r_hi = min(r_hi, k0 + BK - 1 + p.window - 1);
  const int qt_end = r_lo <= r_hi ? r_hi / BQ : -1;

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < DPT; ++u) { adk[j][u] = 0.f; adv[j][u] = 0.f; }

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kvh * p.group + hh;
    const long long bh = (long long)b * p.H + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 2];
    const T* db = static_cast<const T*>(p.dout) + b * p.st[SDO] + h * p.st[SDO + 2];
    for (int qt = r_lo / BQ; qt <= qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous q tile is consumed (and K, V are staged)
      load_tile<T, HD>(sq, qb + q0 * p.st[SQ + 1], p.st[SQ + 1], p.S - q0, p.hd);
      load_tile<T, HD>(sdo, db + q0 * p.st[SDO + 1], p.st[SDO + 1], p.S - q0, p.hd);
      load_rows(p, sl, sd, bh, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_product<HD>(s, sq, sk, ty, tx);
      tile_product<HD>(dp, sdo, sv, ty, tx);
      probs_and_dscores(p, s, dp, sl, sd, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sp[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
          sds[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(sp + r * LDP + 4 * cx);
        const float4 dsv = *reinterpret_cast<const float4*>(sds + r * LDP + 4 * cx);
        const float pj[4] = {pv.x, pv.y, pv.z, pv.w}, dsj[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
        float dov[DPT], qv[DPT];
        load_row(dov, sdo + r * LD + DPT * dx);
        load_row(qv, sq + r * LD + DPT * dx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < DPT; ++u) {
            adv[j][u] = fmaf(pj[j], dov[u], adv[j][u]);
            adk[j][u] = fmaf(dsj[j], qv[u], adk[j][u]);
          }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.st[SDK] + kvh * p.st[SDK + 2];
  T* dvb = static_cast<T*>(p.dv) + b * p.st[SDV] + kvh * p.st[SDV + 2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kpos = k0 + 4 * cx + j;
    if (kpos >= p.Tk) continue;
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int d = DPT * dx + u;
      if (d < p.hd) {
        dkb[kpos * p.st[SDK + 1] + d] = from_f<T>(adk[j][u]);
        dvb[kpos * p.st[SDV + 1] + d] = from_f<T>(adv[j][u]);
      }
    }
  }
}

// ---- pass 3: dQ -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = Shape<HD>::LD, DPT = Shape<HD>::DPT;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;
  float* sl = sds + BQ * LDP;
  float* sd = sl + BQ;

  const int nbh = p.B * p.H;
  const int rank = blockIdx.x / nbh, bh = blockIdx.x - rank * nbh;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rx = tid & 15, dx = tid >> 4;  // accumulation: rows rx + 16 i, columns DPT dx + u

  load_tile<T, HD>(sq, static_cast<const T*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 2] +
                           q0 * p.st[SQ + 1], p.st[SQ + 1], p.S - q0, p.hd);
  load_tile<T, HD>(sdo, static_cast<const T*>(p.dout) + b * p.st[SDO] + h * p.st[SDO + 2] +
                            q0 * p.st[SDO + 1], p.st[SDO + 1], p.S - q0, p.hd);
  load_rows(p, sl, sd, bh, q0);
  const T* kb = static_cast<const T*>(p.k) + b * p.st[SK] + (h / p.group) * p.st[SK + 2];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[SV] + (h / p.group) * p.st[SV + 2];

  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  float adq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < DPT; ++u) adq[i][u] = 0.f;

  const int kt_end = k_lo <= k_hi ? k_hi / BK : -1;
  for (int kt = k_lo / BK; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous key tile is consumed (and Q, dO are staged)
    load_tile<T, HD>(sk, kb + k0 * p.st[SK + 1], p.st[SK + 1], p.Tk - k0, p.hd);
    load_tile<T, HD>(sv, vb + k0 * p.st[SV + 1], p.st[SV + 1], p.Tk - k0, p.hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product<HD>(s, sq, sk, ty, tx);
    tile_product<HD>(dp, sdo, sv, ty, tx);
    probs_and_dscores(p, s, dp, sl, sd, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sds[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float dsv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 y = *reinterpret_cast<const float4*>(sds + (rx + 16 * i) * LDP + c);
        dsv[i][0] = y.x; dsv[i][1] = y.y; dsv[i][2] = y.z; dsv[i][3] = y.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[DPT];
        load_row(kv, sk + (c + e) * LD + DPT * dx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < DPT; ++u) adq[i][u] = fmaf(dsv[i][e], kv[u], adq[i][u]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.st[SDQ] + h * p.st[SDQ + 2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rx + 16 * i;
    if (qpos >= p.S) continue;
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int d = DPT * dx + u;
      if (d < p.hd) dqb[qpos * p.st[SDQ + 1] + d] = from_f<T>(adq[i][u]);
    }
  }
}

// ---- host -------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T, int HD>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int LD = Shape<HD>::LD;
  constexpr size_t smem1 = sizeof(float) * size_t(BQ + BK) * LD;
  constexpr size_t smem2 = sizeof(float) * (size_t(2 * BK + 2 * BQ) * LD + 2 * BQ * LDP + 2 * BQ);
  constexpr size_t smem3 = sizeof(float) * (size_t(2 * BQ + 2 * BK) * LD + BQ * LDP + 2 * BQ);
  cudaError_t err;
  if ((err = prepare(flash_bwd_lse_kernel<T, HD>, smem1)) != cudaSuccess) return err;
  if ((err = prepare(flash_bwd_dkdv_kernel<T, HD>, smem2)) != cudaSuccess) return err;
  if ((err = prepare(flash_bwd_dq_kernel<T, HD>, smem3)) != cudaSuccess) return err;
  p.nq = (p.S + BQ - 1) / BQ;
  p.nk = (p.Tk + BK - 1) / BK;
  const long long rows = (long long)p.nq * p.B * p.H, keys = (long long)p.nk * p.B * p.KV;
  if (rows > INT_MAX || keys > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_bwd_lse_kernel<T, HD><<<unsigned(rows), NTHREADS, smem1, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<unsigned(keys), NTHREADS, smem2, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<unsigned(rows), NTHREADS, smem3, stream>>>(p);
  return cudaGetLastError();
}

// hd 1..32 pads to 32, 33..64 to 64, 65..128 to 128
template <typename T>
cudaError_t dispatch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 0) return cudaErrorInvalidValue;
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 128) return launch<T, 128>(p, stream);
  return cudaErrorInvalidValue;  // hd outside 1..128
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// seq, head) for q, k, v, o, dout, dq, dk, dv in that order; head_dim is
// contiguous. lse and delta: f32 scratch of B * H * S each.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, void* dq, void* dk, void* dv, void* lse,
                              void* delta, int dtype, int B, int S, int Tk, int H, int KV,
                              int hd, const long long* strides, int causal, int window,
                              float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse); p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.Tk = Tk; p.H = H; p.KV = KV; p.group = H / KV; p.hd = hd;
  p.nq = 0; p.nk = 0; p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dispatch_hd<float>(p, st) : dispatch_hd<__nv_bfloat16>(p, st));
}

const char* repro_bwd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
