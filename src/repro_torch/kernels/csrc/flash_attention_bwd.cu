// Flash attention backward on the tensor cores by mma.sync (sm_90a): dQ, dK
// and dV of the forward that the three flash routes compute, from q, k, v,
// the forward's output o and its cotangent dO. CUDA C++ behind a C interface.
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
// 0.0435 ms at the bf16 tensor-core rate; its 83.9 MB of inputs and outputs
// 0.025 ms at 3.35 TB/s. This design runs 8 products (68.8 GFLOP at that
// shape, a little more with the masked halves of the diagonal tiles): the
// scores once more for the lse, and S and dP in both the dK/dV and the dQ
// pass, in exchange for no atomics and a result that does not depend on the
// order blocks run in (two calls give the same bits). What it pays on top,
// as measured there: the lse pass, about a sixth of the time, exists because
// the forward kernels do not write the lse; and every pass runs its
// mma.sync products well below the rate independent mma.sync chains reach:
// a warp's step is one dependent chain (products, then P and dS, then the
// next products) with two or three warps a scheduler to hide it. The
// exponentials cost no measurable time.
//
// Design: three passes, each a grid of independent blocks of 4 warps; every
// product is an mma.sync (bf16: m16n8k16 with f32 accumulators; f32: three
// TF32 m16n8k8 products, 3xTF32, since one misses the f32 tolerance of
// 2e-5, as the forward's `mma` route). Each maps onto one of the forward's
// two fragment patterns (csrc/flash_attention.cu): "Q K^T", a contraction
// over hd of two row-major tiles, and "P V", a contraction over the columns
// of an accumulator, which becomes the A fragment directly, with the rows of
// a row-major tile (bf16: read by ldmatrix.trans).
//  1. lse and D: a block per (b, h, 64-row q tile), a warp per 16 rows,
//     walks the key tiles it can see: S = Q K^T, online max and sum of 2^x
//     per row; lse is written in the exponent's units (log2, scale folded
//     in), as f32 [B, H, S] scratch (the forward kernels do not write it).
//     D = rowsum(dO o) in the same pass.
//  2. dK, dV: a block per (b, kv head, 64-key tile), a warp per 16 keys,
//     walks the group's query heads and the q tiles that see the key tile:
//     S^T = K Q^T and dP^T = V dO^T ("Q K^T" with K or V in Q's place, keys
//     as rows), P^T and dS^T elementwise in registers, then dV += P^T dO and
//     dK += dS^T Q ("P V" with dO and Q in V's place). dK and dV stay in
//     registers for the whole walk.
//  3. dQ: a block per (b, h, 64-row q tile), a warp per 16 rows, walks the
//     key tiles it can see: S = Q K^T, dP = dO V^T, dQ += dS K ("P V" with K
//     in V's place); dQ in registers.
// The tiles a walk streams (K in pass 1; Q, dO and their rows of lse and D
// in pass 2; K and V in pass 3) go through a ring of two stages by cp.async
// in their storage type, the next tile in flight while the current one is
// used; one barrier a step. Tiles wholly above the causal diagonal or
// outside the window are never loaded; only the tiles that the diagonal,
// the window edge or the ends of S and T cut are masked. Blocks are ordered
// longest walk first. In bf16, P and dS are rounded to bf16 before the
// products that consume them, as the forward rounds P; up to hd 64 a warp
// keeps the A fragments of its rows of the block's own tile (Q; K and V;
// Q and dO) in registers for the whole walk.
//
// Tile sizes (`Tile`): pass 2 steps over 64 q rows, 32 at hd 128, where dK
// and dV of a warp's 16 keys are 128 f32 registers a thread; pass 3 over 64
// keys, 32 at hd 128. In f32, each step's products sum in accumulators of
// their own before they join dK, dV or dQ: summed straight into a whole
// walk's accumulator, the tensor cores' additions drift past 2e-5. head_dim
// is padded with zero columns to a built width of 32, 64 or 128, so every
// hd from 1 to 128 is taken. Shared-memory
// rows: bf16 an odd multiple of 16 bytes (ldmatrix, plain and transposed,
// without bank conflicts); f32 4 mod 32 floats, where both patterns read
// 16 bytes a lane without conflicts: "Q K^T" maps the contraction so that
// lane t reads columns 8t..8t+7 of a 32-column block, "P V" reads rows 2t
// and 2t + 1 (t = lane % 4).
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

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 16 * NWARPS;  // q rows a block of passes 1 and 3: 16 a warp
constexpr int BK = 16 * NWARPS;  // keys a block of pass 2: 16 a warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile shapes of one (type, padded head_dim). LD: shared-memory row
// stride in elements; BK1, BQ2, BK3: the rows a step of pass 1, 2, 3 streams.
template <typename T, int HD>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LD = F32 ? HD + 4 : HD + 8;
  // bf16 up to hd 64: a warp keeps the A fragments of the block's own tile
  // (Q in pass 1, K and V in pass 2, Q and dO in pass 3) in registers for
  // the whole walk
  static constexpr bool AREG = !F32 && HD <= 64;
  static constexpr int BK1 = 64;
  static constexpr int BQ2 = HD <= 64 ? 64 : 32;
  static constexpr int BK3 = HD <= 64 ? 64 : 32;
};

// element-stride slots of Params::st: (batch, seq, head) of each tensor
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18, SDV = 21 };

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [B, H, S]; lse in the exponent's units (log2)
  int B, S, Tk, H, KV, group, hd, nq, nk, causal, window, vec;
  // mult: exponent units per (capped) score; cap_in: raw score to tanh's argument
  float softcap, scale, mult, cap_in;
  long long st[24];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __float2bfloat16(x);
}

// The dot product of two 16-byte chunks of T.
template <typename T>
__device__ __forceinline__ float dot16(const float4 a, const float4 b) {
  if constexpr (std::is_same<T, float>::value) {
    return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
  } else {
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
      acc = fmaf(u.x, v.x, fmaf(u.y, v.y, acc));
    }
    return acc;
  }
}

// ---- 3xTF32 mma (f32) ---------------------------------------------------------

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero, in
// two integer operations), lo = v - hi is exact in f32 and the mma reads its
// top 10 mantissa bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A (16 x 8, row): a0 (g, k0), a1 (g + 8, k0), a2 (g, k1), a3 (g + 8, k1)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, col): b0 (k0, n = g), b1 (k1, n = g)
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

// D (16 x 8): d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, 2t + {0, 1})
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---- bf16 mma ---------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- loads ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* s, const void* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(s)), "l"(g), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(s)), "l"(g), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, nrows) x columns [0, HD) of s (row stride ld) from g (row
// stride gs); rows >= nv and columns >= hd are zero. vec: 16-byte copies
// (hd and every row address a multiple of 16 bytes), else element copies
// (cp.async of 4 bytes for f32, plain stores for bf16).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, long long gs,
                                          int nrows, int nv, int hd, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CH = HD / V;
    for (int i = threadIdx.x; i < nrows * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * V;
      const bool ok = r < nv && c < hd;
      cp_async16(s + r * ld + c, ok ? g + r * gs + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * HD; i += NTHREADS) {
      const int r = i / HD, c = i % HD;
      const bool ok = r < nv && c < hd;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(s + r * ld + c, ok ? g + r * gs + c : g, ok);
      else
        s[r * ld + c] = ok ? g[r * gs + c] : __float2bfloat16(0.f);
    }
  }
}

// The two-stage ring a walk of n steps streams its tiles through: step i's
// copies go to stage i & 1 as one cp.async group, started a step ahead.
// ring_start starts step 0 (after the block's own tiles, which join its
// group); ring_wait, before step i, waits for step i's group and passes one
// barrier (every thread is then past step i - 1, so its stage is free),
// then starts step i + 1's copies into that stage.
template <typename Load>
__device__ __forceinline__ void ring_start(int n, Load&& load) {
  if (n > 0) load(0);
  cp_async_commit();
}

template <typename Load>
__device__ __forceinline__ void ring_wait(int i, int n, Load&& load) {
  cp_async_wait<0>();
  __syncthreads();
  if (i + 1 < n) {
    load(i + 1);
    cp_async_commit();
  }
}

// ---- the two product patterns of one warp -----------------------------------

// "Q K^T": acc[j] (16 x 8) = A B^T over HD columns, A the warp's 16 rows at
// a, B rows 8j..8j+7 at b, both row-major with row stride Tile::LD. f32:
// over each 32-column block, k-step s maps k = t to column 8t + 2s and
// k = t + 4 to column 8t + 2s + 1, so one 16-byte load serves two k-steps.
template <typename T, int HD, int NT>
__device__ __forceinline__ void mma_qk(float (&acc)[NT][4], const T* a, const T* b, int lane) {
  constexpr int LD = Tile<T, HD>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    const float* aw = a + g * LD + 8 * t;
    const float* bw = b + g * LD + 8 * t;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 32 * c + 4 * h;
        const float4 x0 = *reinterpret_cast<const float4*>(aw + col);
        const float4 x1 = *reinterpret_cast<const float4*>(aw + 8 * LD + col);
        const FragA a0 = frag_a(x0.x, x1.x, x0.y, x1.y);
        const FragA a1 = frag_a(x0.z, x1.z, x0.w, x1.w);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 y = *reinterpret_cast<const float4*>(bw + 8 * j * LD + col);
          mma3(acc[j], a0, frag_b(y.x, y.y));
          mma3(acc[j], a1, frag_b(y.z, y.w));
        }
      }
  } else {
    const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
    const uint32_t aa = smem_addr(a + (lr + 8 * l8) * LD + 8 * l16);
    const uint32_t ba = smem_addr(b + (lr + 8 * l16) * LD + 8 * l8);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      uint32_t af[4];
      ldsm_x4(af, aa + 32 * c);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, ba + 2 * (16 * jj * LD + 16 * c));
        mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// bf16 "Q K^T" with A's fragments already in registers (a tile that a
// block keeps for its whole walk): af from a_frags.
template <int HD>
__device__ __forceinline__ void a_frags(uint32_t (&af)[HD / 16][4], const __nv_bfloat16* a,
                                        int lane) {
  constexpr int LD = Tile<__nv_bfloat16, HD>::LD;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const uint32_t aa = smem_addr(a + (lr + 8 * l8) * LD + 8 * l16);
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) ldsm_x4(af[c], aa + 32 * c);
}

template <int HD, int NT>
__device__ __forceinline__ void mma_qk_frags(float (&acc)[NT][4], const uint32_t (&af)[HD / 16][4],
                                             const __nv_bfloat16* b, int lane) {
  constexpr int LD = Tile<__nv_bfloat16, HD>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const uint32_t ba = smem_addr(b + (lr + 8 * l16) * LD + 8 * l8);
#pragma unroll
  for (int c = 0; c < HD / 16; ++c)
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bf[4];
      ldsm_x4(bf, ba + 2 * (16 * jj * LD + 16 * c));
      mma_bf16(acc[2 * jj], af[c], bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af[c], bf[2], bf[3]);
    }
}

// "P V": acc (16 x HD) += P B, P in mma_qk's accumulator layout (16 x 8 NT),
// B [8 NT rows][HD] at b, contracted over P's columns and B's rows. P's
// accumulator is the A fragment (f32: k = t and t + 4 mapped to columns 2t
// and 2t + 1 of each 8-column tile; bf16: rounded to bf16 and packed); f32
// output columns of n-tile 4m + i are 32m + 4n' + i (n' the mma's column),
// so one 16-byte load of a B row serves four n-tiles (see out_col).
template <typename T, int HD, int NT>
__device__ __forceinline__ void mma_pv(float (&acc)[HD / 8][4], const float (&p)[NT][4],
                                       const T* b, int lane) {
  constexpr int LD = Tile<T, HD>::LD;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    const float* bw = b + 2 * t * LD + 4 * g;
#pragma unroll
    for (int m = 0; m < HD / 32; ++m) {
      // this call's sum in accumulators of its own, added to acc after
      float part[4][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragA a = frag_a(p[j][0], p[j][2], p[j][1], p[j][3]);
        const float* b0 = bw + 8 * j * LD + 32 * m;
        const float4 x = *reinterpret_cast<const float4*>(b0);
        const float4 y = *reinterpret_cast<const float4*>(b0 + LD);
        mma3(part[0], a, frag_b(x.x, y.x));
        mma3(part[1], a, frag_b(x.y, y.y));
        mma3(part[2], a, frag_b(x.z, y.z));
        mma3(part[3], a, frag_b(x.w, y.w));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * m + i][e] += part[i][e];
    }
  } else {
    const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
    const uint32_t ba = smem_addr(b + (lr + 8 * l8) * LD + 8 * l16);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, ba + 2 * (16 * j * LD + 16 * n));
        mma_bf16(acc[2 * n], a, bf[0], bf[1]);
        mma_bf16(acc[2 * n + 1], a, bf[2], bf[3]);
      }
    }
  }
}

// The head column of element e of n-tile n of an mma_pv accumulator.
template <typename T>
__device__ __forceinline__ int out_col(int n, int e, int t) {
  if constexpr (std::is_same<T, float>::value) return 32 * (n >> 2) + 4 * (2 * t + (e & 1)) + (n & 3);
  else return 8 * n + 2 * t + (e & 1);
}

// Rows r0 and r0 + 8 of an mma_pv accumulator to g (row stride gs): rows
// >= nv and columns >= hd are not written.
template <typename T, int HD>
__device__ __forceinline__ void store_acc(T* g, long long gs, const float (&acc)[HD / 8][4],
                                          int r0, int nv, int hd, int t) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), d = out_col<T>(n, e, t);
      if (r < nv && d < hd) g[r * gs + d] = from_f<T>(acc[n][e]);
    }
}

// ---- masks and scores ---------------------------------------------------------

__device__ __forceinline__ bool visible(const Params& p, int r, int c) {
  return r < p.S && c < p.Tk && (!p.causal || c <= r) && (p.window <= 0 || c > r - p.window);
}

// Whether a tile of q rows [q0, q0 + nr) x keys [k0, k0 + nc) has a pair
// that the masks or the ends of S and T hide.
__device__ __forceinline__ bool edge_tile(const Params& p, int q0, int nr, int k0, int nc) {
  return q0 + nr > p.S || k0 + nc > p.Tk || (p.causal && k0 + nc - 1 > q0) ||
         (p.window > 0 && k0 < q0 + nr - p.window);
}

// Keys [lo, hi] that q rows [q0, q0 + BQ) can see (lo > hi: none).
__device__ __forceinline__ void key_range(const Params& p, int q0, int& lo, int& hi) {
  lo = 0;
  hi = p.Tk - 1;
  if (p.causal) hi = min(hi, min(q0 + BQ, p.S) - 1);
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
}

// P and dS of one score: raw s = q.k, dp = dO.v, lse2 and d of its row.
// Returns p; ds comes back scaled by 1 / sqrt(hd).
__device__ __forceinline__ float prob_and_dscore(const Params& p, float s, float dp,
                                                 float lse2, float d, bool ok, float& ds) {
  float th = 0.f;
  if (p.softcap > 0.f) {
    th = tanhf(s * p.cap_in);
    s = p.softcap * th;
  }
  const float pr = ex2(fmaf(s, p.mult, -lse2));
  ds = ok ? pr * (dp - d) * ((1.f - th * th) * p.scale) : 0.f;
  return ok ? pr : 0.f;
}

// ---- pass 1: lse and D --------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_lse_kernel(const Params p) {
  using L = Tile<T, HD>;
  constexpr int LD = L::LD, BK1 = L::BK1, NT = BK1 / 8;
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);
  T* sk = sq + BQ * LD;  // + stage * BK1 * LD

  const int nbh = p.B * p.H;
  const int rank = blockIdx.x / nbh, bh = blockIdx.x - rank * nbh;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;  // the last q tiles (longest causal walk) first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* kb = static_cast<const T*>(p.k) + b * p.st[SK] + (h / p.group) * p.st[SK + 2];
  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  const int kt0 = k_lo / BK1;
  const int ntiles = k_lo <= k_hi ? k_hi / BK1 - kt0 + 1 : 0;
  auto load_k = [&](int i) {
    const int k0 = (kt0 + i) * BK1;
    load_tile<T, HD>(sk + (i & 1) * BK1 * LD, LD, kb + k0 * p.st[SK + 1], p.st[SK + 1], BK1,
                     p.Tk - k0, p.hd, p.vec);
  };
  load_tile<T, HD>(sq, LD, static_cast<const T*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 2] +
                               q0 * p.st[SQ + 1], p.st[SQ + 1], BQ, p.S - q0, p.hd, p.vec);
  ring_start(ntiles, load_k);

  {  // D = rowsum(dO o) while the tiles are in flight: two threads a row
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1, qpos = q0 + r;
    float acc = 0.f;
    if (qpos < p.S) {
      const T* orow = static_cast<const T*>(p.o) + b * p.st[SO] + qpos * p.st[SO + 1] +
                      h * p.st[SO + 2];
      const T* drow = static_cast<const T*>(p.dout) + b * p.st[SDO] + qpos * p.st[SDO + 1] +
                      h * p.st[SDO + 2];
      if (p.vec) {  // 16-byte loads, the row's two threads on alternate ones
#pragma unroll 4
        for (int c = part * (16 / int(sizeof(T))); c < p.hd; c += 32 / int(sizeof(T)))
          acc += dot16<T>(*reinterpret_cast<const float4*>(drow + c),
                          *reinterpret_cast<const float4*>(orow + c));
      } else {
#pragma unroll 8
        for (int c = part; c < p.hd; c += 2) acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0 && qpos < p.S) p.delta[(long long)bh * p.S + qpos] = acc;
  }

  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this lane's part
  uint32_t qf[HD / 16][4];  // AREG: Q's A fragments
  const bool capped = p.softcap > 0.f;
  const int qa = q0 + 16 * warp + g;  // this lane's rows: qa, qa + 8
  for (int i = 0; i < ntiles; ++i) {
    ring_wait(i, ntiles, load_k);
    float s[NT][4];
    if constexpr (!L::AREG) {
      mma_qk<T, HD, NT>(s, sq + 16 * warp * LD, sk + (i & 1) * BK1 * LD, lane);
    } else {
      if (i == 0) a_frags<HD>(qf, sq + 16 * warp * LD, lane);
      mma_qk_frags<HD, NT>(s, qf, sk + (i & 1) * BK1 * LD, lane);
    }
    const int k0 = (kt0 + i) * BK1;
    const bool edge = edge_tile(p, q0, BQ, k0, BK1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (capped) s[j][e] = p.softcap * tanhf(s[j][e] * p.cap_in);
        if (edge && !visible(p, qa + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)))
          s[j][e] = NEG_INF;
      }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no visible key so far: every p and the correction are 0
      mc[r] = mx[r] > 0.5f * NEG_INF ? mx[r] * p.mult : __int_as_float(0x7f800000);
      l_run[r] *= ex2(m_run[r] * p.mult - mc[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l_run[e >> 1] += ex2(fmaf(s[j][e], p.mult, -mc[e >> 1]));
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = qa + 8 * r;
    if (t == 0 && qpos < p.S)
      p.lse[(long long)bh * p.S + qpos] =
          l > 0.f ? m_run[r] * p.mult + log2f(l) : __int_as_float(0x7f800000);
  }
}

// ---- pass 2: dK and dV ----------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(const Params p) {
  using L = Tile<T, HD>;
  constexpr int LD = L::LD, BQ2 = L::BQ2, NT = BQ2 / 8;
  extern __shared__ float4 smem4[];
  T* sk = reinterpret_cast<T*>(smem4);
  T* sv = sk + BK * LD;
  T* sq = sv + BK * LD;         // + stage * BQ2 * LD
  T* sdo = sq + 2 * BQ2 * LD;   // + stage * BQ2 * LD
  float* srow = reinterpret_cast<float*>(sdo + 2 * BQ2 * LD);  // + stage * 2 BQ2: lse, D

  const int nbk = p.B * p.KV;
  const int kt = blockIdx.x / nbk, bk = blockIdx.x - kt * nbk;  // key tile 0 (longest walk) first
  const int b = bk / p.KV, kvh = bk - b * p.KV;
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<T, HD>(sk, LD, static_cast<const T*>(p.k) + b * p.st[SK] + kvh * p.st[SK + 2] +
                               k0 * p.st[SK + 1], p.st[SK + 1], BK, p.Tk - k0, p.hd, p.vec);
  load_tile<T, HD>(sv, LD, static_cast<const T*>(p.v) + b * p.st[SV] + kvh * p.st[SV + 2] +
                               k0 * p.st[SV + 1], p.st[SV + 1], BK, p.Tk - k0, p.hd, p.vec);

  // q rows that can see a key of [k0, k0 + BK), in q tiles of BQ2; the walk
  // goes over the group's heads, each over those q tiles
  const int r_lo = p.causal ? k0 : 0;
  int r_hi = p.S - 1;
  if (p.window > 0) r_hi = min(r_hi, k0 + BK - 1 + p.window - 1);
  const int qt0 = r_lo / BQ2;
  const int nqt = r_lo <= r_hi ? r_hi / BQ2 - qt0 + 1 : 0;
  const int nsteps = p.group * nqt;
  auto load_q = [&](int i) {
    const int h = kvh * p.group + i / nqt, q0 = (qt0 + i % nqt) * BQ2, stage = i & 1;
    load_tile<T, HD>(sq + stage * BQ2 * LD, LD, static_cast<const T*>(p.q) + b * p.st[SQ] +
                         h * p.st[SQ + 2] + q0 * p.st[SQ + 1], p.st[SQ + 1], BQ2, p.S - q0,
                     p.hd, p.vec);
    load_tile<T, HD>(sdo + stage * BQ2 * LD, LD, static_cast<const T*>(p.dout) +
                         b * p.st[SDO] + h * p.st[SDO + 2] + q0 * p.st[SDO + 1],
                     p.st[SDO + 1], BQ2, p.S - q0, p.hd, p.vec);
    const int r = threadIdx.x % BQ2, which = threadIdx.x / BQ2;  // 0: lse, 1: D
    if (which < 2) {
      const float* src = (which == 0 ? p.lse : p.delta) + (long long)(b * p.H + h) * p.S + q0 + r;
      cp_async4(srow + stage * 2 * BQ2 + which * BQ2 + r, q0 + r < p.S ? src : p.lse,
                q0 + r < p.S);
    }
  };
  ring_start(nsteps, load_q);

  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { adk[n][e] = 0.f; adv[n][e] = 0.f; }
  const int ka = k0 + 16 * warp + g;  // this lane's keys: ka, ka + 8
  uint32_t kf[HD / 16][4], vf[HD / 16][4];  // AREG: K's and V's A fragments

  for (int i = 0; i < nsteps; ++i) {
    ring_wait(i, nsteps, load_q);
    const int stage = i & 1, q0 = (qt0 + i % nqt) * BQ2;
    const T* tq = sq + stage * BQ2 * LD;
    const T* tdo = sdo + stage * BQ2 * LD;
    const float* sl = srow + stage * 2 * BQ2;
    const float* sd = sl + BQ2;
    float sT[NT][4], dpT[NT][4];  // S^T, dP^T: keys ka, ka + 8 x q rows 8j + 2t + {0, 1}
    if constexpr (!L::AREG) {
      mma_qk<T, HD, NT>(dpT, sv + 16 * warp * LD, tdo, lane);
      mma_qk<T, HD, NT>(sT, sk + 16 * warp * LD, tq, lane);
    } else {  // the warp's rows of K and V, in registers from the first step on
      if (i == 0) {
        a_frags<HD>(kf, sk + 16 * warp * LD, lane);
        a_frags<HD>(vf, sv + 16 * warp * LD, lane);
      }
      mma_qk_frags<HD, NT>(dpT, vf, tdo, lane);
      mma_qk_frags<HD, NT>(sT, kf, tq, lane);
    }
    const bool edge = edge_tile(p, q0, BQ2, k0, BK);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const bool ok = !edge || visible(p, q0 + 8 * j + 2 * t + c, ka + 8 * (e >> 1));
        float ds;
        sT[j][e] = prob_and_dscore(p, sT[j][e], dpT[j][e], c ? l2.y : l2.x,
                                    c ? d2.y : d2.x, ok, ds);
        dpT[j][e] = ds;
      }
    }
    mma_pv<T, HD, NT>(adv, sT, tdo, lane);
    mma_pv<T, HD, NT>(adk, dpT, tq, lane);
  }
  cp_async_wait<0>();

  const int r0 = 16 * warp + g, nv = p.Tk - k0;
  store_acc<T, HD>(static_cast<T*>(p.dk) + b * p.st[SDK] + kvh * p.st[SDK + 2] +
                       k0 * p.st[SDK + 1], p.st[SDK + 1], adk, r0, nv, p.hd, t);
  store_acc<T, HD>(static_cast<T*>(p.dv) + b * p.st[SDV] + kvh * p.st[SDV + 2] +
                       k0 * p.st[SDV + 1], p.st[SDV + 1], adv, r0, nv, p.hd, t);
}

// ---- pass 3: dQ -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  using L = Tile<T, HD>;
  constexpr int LD = L::LD, BK3 = L::BK3, NT = BK3 / 8;
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);
  T* sdo = sq + BQ * LD;
  T* sk = sdo + BQ * LD;         // + stage * BK3 * LD
  T* sv = sk + 2 * BK3 * LD;     // + stage * BK3 * LD

  const int nbh = p.B * p.H;
  const int rank = blockIdx.x / nbh, bh = blockIdx.x - rank * nbh;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* kb = static_cast<const T*>(p.k) + b * p.st[SK] + (h / p.group) * p.st[SK + 2];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[SV] + (h / p.group) * p.st[SV + 2];
  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  const int kt0 = k_lo / BK3;
  const int ntiles = k_lo <= k_hi ? k_hi / BK3 - kt0 + 1 : 0;
  auto load_kv = [&](int i) {
    const int k0 = (kt0 + i) * BK3, stage = i & 1;
    load_tile<T, HD>(sk + stage * BK3 * LD, LD, kb + k0 * p.st[SK + 1], p.st[SK + 1], BK3,
                     p.Tk - k0, p.hd, p.vec);
    load_tile<T, HD>(sv + stage * BK3 * LD, LD, vb + k0 * p.st[SV + 1], p.st[SV + 1], BK3,
                     p.Tk - k0, p.hd, p.vec);
  };
  load_tile<T, HD>(sq, LD, static_cast<const T*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 2] +
                               q0 * p.st[SQ + 1], p.st[SQ + 1], BQ, p.S - q0, p.hd, p.vec);
  load_tile<T, HD>(sdo, LD, static_cast<const T*>(p.dout) + b * p.st[SDO] +
                                h * p.st[SDO + 2] + q0 * p.st[SDO + 1], p.st[SDO + 1], BQ,
                   p.S - q0, p.hd, p.vec);
  ring_start(ntiles, load_kv);

  const int qa = q0 + 16 * warp + g;  // this lane's rows: qa, qa + 8
  float lse2[2], dd[2];               // a row past S has lse = +inf, so its p is 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qa + 8 * r < p.S;
    const long long at = (long long)bh * p.S + qa + 8 * r;
    lse2[r] = in ? p.lse[at] : __int_as_float(0x7f800000);
    dd[r] = in ? p.delta[at] : 0.f;
  }
  float adq[HD / 8][4];
  uint32_t qf[HD / 16][4], df[HD / 16][4];  // AREG: Q's and dO's A fragments
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    ring_wait(i, ntiles, load_kv);
    const int stage = i & 1, k0 = (kt0 + i) * BK3;
    const T* tk = sk + stage * BK3 * LD;
    float s[NT][4], dp[NT][4];  // rows qa, qa + 8 x keys 8j + 2t + {0, 1}
    if constexpr (!L::AREG) {
      mma_qk<T, HD, NT>(s, sq + 16 * warp * LD, tk, lane);
      mma_qk<T, HD, NT>(dp, sdo + 16 * warp * LD, sv + stage * BK3 * LD, lane);
    } else {  // the warp's rows of Q and dO, in registers from the first step on
      if (i == 0) {
        a_frags<HD>(qf, sq + 16 * warp * LD, lane);
        a_frags<HD>(df, sdo + 16 * warp * LD, lane);
      }
      mma_qk_frags<HD, NT>(s, qf, tk, lane);
      mma_qk_frags<HD, NT>(dp, df, sv + stage * BK3 * LD, lane);
    }
    const bool edge = edge_tile(p, q0, BQ, k0, BK3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = !edge || visible(p, qa + 8 * r, k0 + 8 * j + 2 * t + (e & 1));
        float ds;
        prob_and_dscore(p, s[j][e], dp[j][e], lse2[r], dd[r], ok, ds);
        dp[j][e] = ds;
      }
    mma_pv<T, HD, NT>(adq, dp, tk, lane);
  }
  cp_async_wait<0>();

  store_acc<T, HD>(static_cast<T*>(p.dq) + b * p.st[SDQ] + h * p.st[SDQ + 2] +
                       q0 * p.st[SDQ + 1], p.st[SDQ + 1], adq, 16 * warp + g, p.S - q0, p.hd, t);
}

// ---- host -------------------------------------------------------------------

// Whether a [B, L, N, hd] view can be read in 16-byte rows: the base and
// every stride of a dim longer than 1 a multiple of 16 bytes.
bool rows16(const void* ptr, int esize, const long long* st, int n0, int n1, int n2) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const int n[3] = {n0, n1, n2};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] * esize) % 16) return false;
  return true;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T, int HD>
cudaError_t launch(Params p, cudaStream_t stream) {
  using L = Tile<T, HD>;
  constexpr size_t smem1 = sizeof(T) * size_t(BQ + 2 * L::BK1) * L::LD;
  constexpr size_t smem2 = sizeof(T) * size_t(2 * BK + 4 * L::BQ2) * L::LD +
                           sizeof(float) * 4 * L::BQ2;
  constexpr size_t smem3 = sizeof(T) * size_t(2 * BQ + 4 * L::BK3) * L::LD;
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
  const int esize = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse); p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.Tk = Tk; p.H = H; p.KV = KV; p.group = H / KV; p.hd = hd;
  p.nq = 0; p.nk = 0; p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  p.mult = softcap > 0.f ? LOG2E : scale * LOG2E;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.vec = (hd * esize) % 16 == 0 && rows16(q, esize, strides, B, S, H) &&
          rows16(k, esize, strides + 3, B, Tk, KV) && rows16(v, esize, strides + 6, B, Tk, KV) &&
          rows16(o, esize, strides + 9, B, S, H) && rows16(dout, esize, strides + 12, B, S, H);
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dispatch_hd<float>(p, st) : dispatch_hd<__nv_bfloat16>(p, st));
}

const char* repro_bwd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
