// Flash-attention forward at head_dims above 256 (the `wide` route) on the
// tensor cores by mma.sync, CUDA C++ for Hopper (sm_90a) behind a C
// interface.
//
// Replaces src/repro/kernels/flash_attention.py:29 (`_flash_kernel`, the
// Pallas TPU kernel under `flash_attention`, pallas_call at line 136) for
// the head dims that the other two routes do not take: the Pallas kernel's
// block is (1, bq, hd), so it takes any head_dim. Same function: GQA
// attention [B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd], kv head h / (H / KV),
// scale 1/sqrt(hd), tanh softcap before the causal / sliding-window masks,
// f32 scores, online softmax and accumulators, output in q's type; a row
// with no visible key gives 0.
//
// What bounds it, at (B, S, H, KV, hd) = (2, 1024, 8, 2, 512) causal: 17.20
// GFLOP of visible (q, k) pairs. In f32 the CUDA cores (67 TFLOP/s) take
// 0.2567 ms and the TF32 tensor cores at three products each (3xTF32)
// 0.1042 ms; bf16 on the tensor cores 0.01739 ms; the 83.9 MB (f32) of q,
// k, v and o take 0.025 ms. So it is bound by operations on the tensor
// cores, 0.1042 ms in f32 and 0.0174 ms in bf16.
//
// What the design does about it. Both products run on the tensor cores,
// with the fragment layouts of csrc/flash_attention.cu (copied here): f32
// split into three TF32 products (v = hi + lo, hi rounded by two integer
// operations; lo a * hi b + hi a * lo b + hi a * hi b), as one TF32 product
// misses the f32 tolerance; bf16 by m16n8k16 with f32 accumulators and P
// rounded to bf16 before P V. Registers cap a warp at 16 rows x 256 f32
// output columns (128 accumulators a thread), so a block of two groups of
// 4 warps owns 64 q rows and up to 512 output columns: each group owns
// half of the columns, and each contracts every other 16-column chunk of
// Q K^T; the two partial score tiles are summed through shared memory once
// a key tile (group 0 adds s0 + s1, group 1 s1 + s0: the same bits), so up
// to 512 columns nothing is computed twice. Wider head dims split over the
// grid in slices of 512 output columns, each block summing Q K^T over the
// whole of hd. Shared memory does not grow with hd: Q and K stream through
// a cp.async ring of NST stages of head_dim slices (SW columns), the next
// NST - 1 slices in flight while the current one is used; V of a key tile,
// the block's columns, is loaded once a tile while the scores are summed.
// Loads are 16-byte copies where the rows' bytes and strides allow,
// element copies otherwise (strided views of a fused projection). Blocks
// go longest causal walk first; key tiles that no row of the block can see
// (causal, window) are never loaded, and only tiles that the diagonal, the
// window edge or the end of T cut are masked. One block of 256 threads at
// ~250 registers fills an SM.
//
// What it pays on top of the bound: mma.sync below wgmma's rate; Q read
// again from L2 for every key tile; a barrier a ring stage and one a tile;
// the masked halves of diagonal tiles (~6% more pairs at S = 1024);
// above 512 columns, Q K^T once more for each further slice of 512. f32
// skips the chunks and output columns past hd; bf16 computes them on the
// zeros loaded there (hd 257 to 511 pay up to 2x the P V products), since
// the uniform guards in its unrolled loops kept ptxas from hoisting the
// next fragment loads, and it ran slower with them at hd 512 (PERF.md).
// f32 gained little without them, and spilled.
//
// Precision. The tensor cores' accumulation over a long chain of mma
// steps into one accumulator loses more than f32 rounding to nearest: with
// one chain a key tile (1,536 steps a group at hd 4096 in 3xTF32) the
// output's error grew with hd and missed the f32 tolerance (2e-5) at hd
// 4096. So in f32 each ring stage's part of the scores (SW / 2
// columns a group, 24 steps) is summed in an accumulator of its own and
// added to the tile's by an f32 add; bf16 (tolerance 2e-2) keeps one chain.
//
// Masked scores are -1e30; a row with no visible key so far keeps p = 0,
// and a row with l = 0 is written as 0.
//
// C interface (bound with ctypes): repro_flash_attention_wide_fwd returns
// the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NGROUPS = 2;              // groups of 4 warps sharing a row tile
constexpr int NWARPS = 4 * NGROUPS;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 64;                  // q rows a block: 16 a warp of a group
constexpr int DV = 256;                 // output columns a group at most
constexpr int DB = NGROUPS * DV;        // output columns a block at most
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// BKV: keys a tile; SW: head_dim columns of Q and K a ring stage; NST:
// stages of the ring; GUARD: skip the 16-column chunks of Q K^T and the
// output columns that lie past hd (else they are computed on the zeros
// loaded there); LDQK, LDV: shared-memory row strides in elements (f32: 16
// mod 32 and 4 mod 32 floats; bf16: rows an odd multiple of 16 bytes), as
// csrc/flash_attention.cu picks them, so that every fragment load of a
// warp is free of bank conflicts; LDX: the partial scores' row stride in
// floats. The sizes are the fastest of those tried on the card (PERF.md
// §6); f32 stays at BKV 32, as 64 would add 16 score registers to its
// ~242.
template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int BKV = 32;
  static constexpr int SW = 128;
  static constexpr int NST = 2;
  static constexpr bool GUARD = true;
  static constexpr int LDQK = SW + 16;
  static constexpr int LDV = DB + 4;
  static constexpr int LDX = BKV + 8;
};

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BKV = 64;
  static constexpr int SW = 128;
  static constexpr int NST = 3;
  static constexpr bool GUARD = false;
  static constexpr int LDQK = SW + 8;
  static constexpr int LDV = DB + 8;
  static constexpr int LDX = BKV + 8;
};

// NST ring stages of Q [BQ][LDQK] and K [BKV][LDQK], V [BKV][LDV], and the
// groups' partial scores [NGROUPS][BQ][LDX] in f32
template <typename T>
constexpr size_t smem_bytes() {
  using L = Tile<T>;
  return sizeof(T) * (L::NST * size_t(BQ + L::BKV) * L::LDQK + size_t(L::BKV) * L::LDV) +
         sizeof(float) * size_t(NGROUPS) * BQ * L::LDX;
}

struct Params {
  const void *q, *k, *v;
  void* o;
  int B, S, Tk, H, group, hd, nq, nz, causal, window, vec;
  float softcap, scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
};

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

// wait until at most n of this thread's cp.async groups are pending (at
// most 3: a larger n waits for more than it needs)
__device__ __forceinline__ void cp_async_wait_newer(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Rows [0, nrows) x columns [0, ncols) of s (row stride ld) from g (row
// stride gs); rows >= nv and columns >= nc are zero. ncols is a multiple of
// 32. vec: 16-byte copies (hd and every row address a multiple of 16
// bytes), else element copies (cp.async of 4 bytes for f32, plain stores
// for bf16). The bf16 kernel copies without unrolling: unrolled, the copy
// of its full-width V tile took it past 255 registers into spills, and it
// ran slower; f32 runs faster unrolled.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, long long gs, int nrows,
                                          int ncols, int nv, int nc, bool vec) {
  constexpr int UNROLL = std::is_same<T, float>::value ? 4 : 1;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int ch = ncols / V;
#pragma unroll(UNROLL)
    for (int i = threadIdx.x; i < nrows * ch; i += NTHREADS) {
      const int r = i / ch, c = (i - r * ch) * V;
      const bool ok = r < nv && c < nc;
      cp_async16(s + r * ld + c, ok ? g + r * gs + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += NTHREADS) {
      const int r = i / ncols, c = i - r * ncols;
      const bool ok = r < nv && c < nc;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(s + r * ld + c, ok ? g + r * gs + c : g, ok);
      else
        s[r * ld + c] = ok ? g[r * gs + c] : __float2bfloat16(0.f);
    }
  }
}

// ---- the two products of one warp -------------------------------------------

// s[j] (16 x 8, keys 8j..8j+7 of the tile) += Q[the warp's 16 rows] K^T over
// this group's 16-column chunks of one ring stage (chunks grp, grp + 2, ...);
// with GUARD only those below nc, the stage's columns that lie inside hd.
template <typename T>
__device__ __forceinline__ void add_scores(float (&s)[Tile<T>::BKV / 8][4], const T* sq,
                                           const T* sk, int wq, int grp, int nc, int lane) {
  using L = Tile<T>;
  constexpr int NT = L::BKV / 8;
  if constexpr (std::is_same<T, float>::value) {
    // k-step 2c reads columns 4t, 4t+1 of the chunk and 2c+1 columns 4t+2,
    // 4t+3, so one 16-byte load of a row serves both
    const int g = lane >> 2, t = lane & 3;
    const float* qw = sq + (16 * wq + g) * L::LDQK + 4 * t;
    const float* kw = sk + g * L::LDQK + 4 * t;
#pragma unroll
    for (int cc = 0; cc < L::SW / 32; ++cc) {
      const int c = 16 * (2 * cc + grp);
      if (!L::GUARD || c < nc) {
        const float4 x0 = *reinterpret_cast<const float4*>(qw + c);
        const float4 x1 = *reinterpret_cast<const float4*>(qw + 8 * L::LDQK + c);
        const FragA a0 = frag_a(x0.x, x1.x, x0.y, x1.y);
        const FragA a1 = frag_a(x0.z, x1.z, x0.w, x1.w);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 y = *reinterpret_cast<const float4*>(kw + 8 * j * L::LDQK + c);
          mma3(s[j], a0, frag_b(y.x, y.y));
          mma3(s[j], a1, frag_b(y.z, y.w));
        }
      }
    }
  } else {
    const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
    const uint32_t qa = smem_addr(sq + (16 * wq + lr + 8 * l8) * L::LDQK + 8 * l16);
    const uint32_t ka = smem_addr(sk + (lr + 8 * l16) * L::LDQK + 8 * l8);
#pragma unroll
    for (int cc = 0; cc < L::SW / 32; ++cc) {
      const int c = 16 * (2 * cc + grp);
      if (!L::GUARD || c < nc) {
        uint32_t a[4];
        ldsm_x4(a, qa + 2 * c);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t b[4];
          ldsm_x4(b, ka + 2 * (16 * jj * L::LDQK + c));
          mma_bf16(s[2 * jj], a, b[0], b[1]);
          mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// o += P V over this group's columns of sv (with GUARD the first nw, a
// multiple of 32; else all DV), P the probabilities in s (the accumulator
// layout of add_scores)
template <typename T>
__device__ __forceinline__ void add_pv(float (&o)[DV / 8][4],
                                       const float (&s)[Tile<T>::BKV / 8][4], const T* sv,
                                       int nw, int lane) {
  using L = Tile<T>;
  constexpr int NT = L::BKV / 8;
  if constexpr (std::is_same<T, float>::value) {
    // the output columns of n-tile i of a group of 4 are 4g + i, so one
    // float4 load of a V row serves 4 n-tiles; store_row undoes the order
    const int g = lane >> 2, t = lane & 3;
    const float* vw = sv + 2 * t * L::LDV + 4 * g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // k = t -> key 8j + 2t, k = t + 4 -> key 8j + 2t + 1
      const FragA a = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* v0 = vw + 8 * j * L::LDV;
#pragma unroll
      for (int m = 0; m < DV / 32; ++m) {
        if (!L::GUARD || 32 * m < nw) {
          // b0 from key 8j + 2t, b1 from key 8j + 2t + 1
          const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * m);
          const float4 y = *reinterpret_cast<const float4*>(v0 + L::LDV + 32 * m);
          mma3(o[4 * m], a, frag_b(x.x, y.x));
          mma3(o[4 * m + 1], a, frag_b(x.y, y.y));
          mma3(o[4 * m + 2], a, frag_b(x.z, y.z));
          mma3(o[4 * m + 3], a, frag_b(x.w, y.w));
        }
      }
    }
  } else {
    const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
    const uint32_t va = smem_addr(sv + (lr + 8 * l8) * L::LDV + 8 * l16);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        if (!L::GUARD || 16 * n < nw) {
          uint32_t b[4];
          ldsm_x4_trans(b, va + 2 * (16 * j * L::LDV + 16 * n));
          mma_bf16(o[2 * n], a, b[0], b[1]);
          mma_bf16(o[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// One row of the warp's output (r = 0: row g, r = 1: row g + 8), times inv,
// the group's columns below nc, undoing the f32 column order of add_pv.
template <typename T>
__device__ __forceinline__ void store_row(T* orow, const float (&o)[DV / 8][4], int r,
                                          float inv, int nc, int t) {
  constexpr int VG = std::is_same<T, float>::value ? 4 : 1;
#pragma unroll
  for (int m = 0; m < DV / (8 * VG); ++m)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < VG; ++i) {
        const int d = 8 * VG * m + VG * (2 * t + c) + i;
        const float x = o[VG * m + i][2 * r + c] * inv;
        if (d < nc) {
          if constexpr (std::is_same<T, float>::value) orow[d] = x;
          else orow[d] = __float2bfloat16(x);
        }
      }
}

// ---- the kernel -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wide_kernel(const Params p) {
  using L = Tile<T>;
  constexpr int BKV = L::BKV, NT = BKV / 8, SW = L::SW, NST = L::NST;
  constexpr int STAGE = (BQ + BKV) * L::LDQK;
  extern __shared__ float4 smem4[];
  T* sqk = reinterpret_cast<T*>(smem4);                     // + stage * STAGE
  T* sv = sqk + NST * STAGE;
  float* sx = reinterpret_cast<float*>(sv + BKV * L::LDV);  // + group * BQ * LDX

  // the last q tiles (longest causal walk) first; then (b, h), then the
  // slice of output columns
  const int per_rank = p.B * p.H * p.nz;
  const int rank = blockIdx.x / per_rank;
  const int rest = blockIdx.x - rank * per_rank;
  const int bh = rest / p.nz, z = rest - bh * p.nz;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2, wq = warp & 3;  // the warp's group; its rows 16 wq..
  const int g = lane >> 2, t = lane & 3;

  // output columns: the block's [c0, c0 + cw); each group's hw of them (a
  // multiple of 32; DV without GUARD), of which the group stores gw and,
  // with GUARD, computes nw
  const int c0 = z * DB, cw = min(DB, p.hd - c0);
  const int hw = L::GUARD ? ((cw + 1) / 2 + 31) / 32 * 32 : DV;
  const int gc = grp * hw;
  const int gw = min(hw, cw - gc);
  const int nw = gw > 0 ? (gw + 31) / 32 * 32 : 0;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh + c0;

  // keys this q tile can see: [k_lo, k_hi]
  int k_lo = 0, k_hi = p.Tk - 1;
  if (p.causal) k_hi = min(k_hi, min(q0 + BQ, p.S) - 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / BKV;
  const int ntiles = k_lo <= k_hi ? k_hi / BKV - kt0 + 1 : 0;
  const int ns = (p.hd + SW - 1) / SW;  // ring stages a key tile
  const int nsteps = ntiles * ns;

  // step i * ns + sl: head_dim columns [sl SW, sl SW + SW) of Q and of key
  // tile i's K, into ring stage step % NST
  auto load_qk = [&](int step) {
    const int i = step / ns, sl = step - i * ns;
    const int k0 = (kt0 + i) * BKV, d0 = sl * SW;
    T* st = sqk + (step % NST) * STAGE;
    load_tile<T>(st, L::LDQK, qb + d0, p.q_ss, BQ, SW, p.S - q0, p.hd - d0, p.vec);
    load_tile<T>(st + BQ * L::LDQK, L::LDQK, kb + k0 * p.k_ss + d0, p.k_ss, BKV, SW,
                 p.Tk - k0, p.hd - d0, p.vec);
  };
#pragma unroll
  for (int step = 0; step < NST - 1; ++step) {
    if (step < nsteps) load_qk(step);
    cp_async_commit();
  }

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this lane's part
  const bool capped = p.softcap > 0.f;
  const float mult = capped ? LOG2E : p.scale * LOG2E;  // exponent units per score
  const float cap_in = p.scale / p.softcap;
  const int qa = q0 + 16 * wq + g;  // this lane's rows: qa, qa + 8

  for (int i = 0; i < ntiles; ++i) {
    const int k0 = (kt0 + i) * BKV;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // cp.async groups in commit order: QK(0) .. QK(NST - 2), then at each
    // step QK(step + NST - 1) and, at a tile's first step, its V. So the
    // groups newer than QK(step) are the NST - 2 later QK steps and the V
    // tiles issued in the last NST - 1 steps.
    for (int sl = 0; sl < ns; ++sl) {
      const int step = i * ns + sl;
      int newer = NST - 2;
      for (int d = sl == 0 ? ns : sl; d < NST && d <= step; d += ns) ++newer;
      cp_async_wait_newer(newer);
      __syncthreads();  // this stage is visible; the previous one and V are free
      if (step + NST - 1 < nsteps) load_qk(step + NST - 1);
      cp_async_commit();
      if (sl == 0) {
        load_tile<T>(sv, L::LDV, vb + k0 * p.v_ss, p.v_ss, BKV, 2 * hw, p.Tk - k0, cw, p.vec);
        cp_async_commit();
      }
      const T* st = sqk + (step % NST) * STAGE;
      if constexpr (std::is_same<T, float>::value) {
        // the stage's sum in its own accumulator, added to the tile's in
        // f32 (see the note on precision at the top)
        float ss[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ss[j][e] = 0.f;
        add_scores<T>(ss, st, st + BQ * L::LDQK, wq, grp, p.hd - sl * SW, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += ss[j][e];
      } else {
        add_scores<T>(s, st, st + BQ * L::LDQK, wq, grp, p.hd - sl * SW, lane);
      }
    }

    // the groups' partial scores: each writes its own and adds the other's
    float* xw = sx + (grp * BQ + 16 * wq + g) * L::LDX + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(xw + 8 * r * L::LDX + 8 * j) =
            make_float2(s[j][2 * r], s[j][2 * r + 1]);
    cp_async_wait_newer(ns - 1);  // V_i; the QK steps issued after it may be in flight
    __syncthreads();
    const float* xo = sx + ((grp ^ 1) * BQ + 16 * wq + g) * L::LDX + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 y = *reinterpret_cast<const float2*>(xo + 8 * r * L::LDX + 8 * j);
        s[j][2 * r] += y.x;
        s[j][2 * r + 1] += y.y;
      }

    if (capped) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.softcap * tanhf(s[j][e] * cap_in);
    }
    const bool edge = k0 + BKV > p.Tk || (p.causal && k0 + BKV - 1 > q0) ||
                      (p.window > 0 && k0 < q0 + BQ - p.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = qa + 8 * (e >> 1);
          const bool ok = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
          if (!ok) s[j][e] = NEG_INF;
        }
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
      mc[r] = mx[r] > 0.5f * NEG_INF ? mx[r] * mult : __int_as_float(0x7f800000);
      const float corr = ex2(m_run[r] * mult - mc[r]);
      m_run[r] = mx[r];
      l_run[r] *= corr;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], mult, -mc[e >> 1]));
        l_run[e >> 1] += s[j][e];
      }

    add_pv<T>(o, s, sv + gc, nw, lane);
    // the next tile's first barrier frees V and the partial scores
  }
  cp_async_wait<0>();

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + c0 + gc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = qa + 8 * r;
    if (qpos < p.S && gw > 0)
      store_row<T>(ob + qpos * p.o_ss, o, r, l > 0.f ? 1.f / l : 0.f, gw, t);
  }
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

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  p.nq = (p.S + BQ - 1) / BQ;
  p.nz = (p.hd + DB - 1) / DB;
  const long long blocks = (long long)p.nq * p.B * p.H * p.nz;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_fwd_wide_kernel<T><<<unsigned(blocks), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// seq, head) for q, k, v, o in that order; head_dim is contiguous.
int repro_flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int S, int Tk, int H,
                                   int KV, int hd, const long long* strides,
                                   int causal, int window, float softcap,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || hd <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.S = S; p.Tk = Tk; p.H = H; p.group = H / KV; p.hd = hd; p.nq = 0; p.nz = 0;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.vec = (hd * esize) % 16 == 0 && rows16(q, esize, strides, B, S, H) &&
          rows16(k, esize, strides + 3, B, Tk, KV) && rows16(v, esize, strides + 6, B, Tk, KV);
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch<float>(p, st) : launch<__nv_bfloat16>(p, st));
}

const char* repro_wide_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
