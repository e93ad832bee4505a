// Flash attention forward on the tensor cores by mma.sync (sm_90a), for
// every (dtype, head_dim) that the wgmma kernel (csrc/flash_attention_wgmma.cu,
// bf16 at head_dim 64 and at the multiples of 8 from 72 to 128) does not
// take: f32 at any head_dim and bf16 at the other head dims, 1 to 256. CUDA
// C++ behind a C interface.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel under `flash_attention`, pallas_call at line 136). Same function:
// GQA attention o = softmax(softcap(q k^T / sqrt(hd)) + mask) v with causal
// and sliding-window masks at -1e30 applied after the softcap, online
// softmax (m, l, acc) in f32, fully-masked rows -> 0, kv head = h / (H / KV),
// output in q's dtype. The Pallas kernel takes any head_dim (its blocks are
// (1, bq, hd)); here the kernel is built for a padded width HDP (16, 32, ...,
// 128, then 160, 192, 224, 256) and the columns hd..HDP are loaded as zeros,
// so hd 16, 32, 64, 112 and 128 pad by nothing and 120 by 8 columns.
//
// Precision. f32 inputs go through the tensor cores as TF32 (10-bit
// mantissa), which alone misses the f32 tolerance of 2e-5 by far
// (tests/test_torch_kernels.py::test_attention_precision_needs_3xtf32), so
// both products are split into three (3xTF32): v = hi + lo, hi rounded to
// TF32 by two integer operations (as csrc/ssd_scan.cu does), lo = v - hi,
// and a . b = lo a * hi b + hi a * lo b + hi a * hi b, the small terms
// first. bf16 inputs use m16n8k16 with f32 accumulators, and P is rounded
// to bf16 before P V, as the wgmma route does; the Pallas kernel keeps P in
// f32, and the difference (a relative 2^-9 on each probability, averaged
// over the keys) stays well inside the bf16 tolerance of 2e-2.
//
// What bounds it, at the serving slice of llama3.2-1b served in f32 (B=4,
// S=T=1024, H=32, KV=8, hd=64, causal): 17.2 GFLOP of visible (q, k) pairs.
// The f32 CUDA cores (67 TFLOP/s) take 0.257 ms for them; the TF32 tensor
// cores at three products each 0.104 ms (3 x 17.2 GFLOP at 495 TFLOP/s);
// the 83.9 MB of q, k, v and o take 0.025 ms at 3.35 TB/s. So the bound is
// 0.104 ms, by operations on the tensor cores. What this design pays on
// top: mma.sync does not reach the rate that wgmma does; the operand splits
// (three integer or float operations per element) compete with the mma
// instructions for the warp schedulers; the masked halves of diagonal tiles
// are computed; the exponentials run on the SM's 16 MUFU lanes.
//
// Design (not the TPU grid carried over). A block of 4 warps owns one
// (b, h, 64-row q tile); each warp owns 16 q rows and keeps S and its O
// accumulator in registers for the whole walk over the kv tiles. Blocks are
// ordered longest causal walk first (the last q tiles of every (b, h) form
// the first blocks of the launch). K and V tiles of BKV keys go into a ring
// of two stages by cp.async (16-byte copies where the rows' bytes and
// strides allow, element copies otherwise, so strided views of a fused
// projection work), the next tile's K and V in flight while the current
// ones are used; two barriers a tile (tile arrived; stage free). Tiles
// wholly above the causal diagonal or left of the window are never loaded;
// only the tiles that the diagonal, the window edge or the end of T cut
// are masked. Online softmax per row in registers: max and sum
// over the 4 lanes of a quad by shuffles (the sum only at the end), 2^x by
// ex2.approx with log2(e) folded into the scale, a row with no visible key
// so far keeps p = 0, a row with l = 0 is written as 0.
//
// Fragment layouts. The contraction index of an mma may map to the
// contracted dimension in any order, as long as both operands use the same
// order; the kernel picks orders that make loads wide and avoid shuffles:
//  - f32 Q K^T: over 16 head columns, k-step 2c reads columns 4t, 4t+1 and
//    k-step 2c+1 columns 4t+2, 4t+3 (t = lane % 4), so one 16-byte load of
//    a Q or K row serves two k-steps;
//  - P V (both types): S's accumulator holds keys 2t, 2t+1 of each 8-key
//    tile, which become the A fragment of P V directly (f32: k = t and
//    t + 4 mapped to keys 2t and 2t + 1; bf16: the usual identity), and V's
//    fragments read the same keys;
//  - f32 P V: the output columns of n-tile i of a group of VG n-tiles are
//    VG g + i (g = lane / 4), so one VG-wide load of a V row serves VG
//    n-tiles; the epilogue undoes the order.
//  - bf16: Q and K by ldmatrix, V by ldmatrix.trans.
// Shared-memory row strides keep every fragment load of a warp free of bank
// conflicts: f32 Q and K 16 mod 32 floats, f32 V 4 mod 16 floats, bf16 rows
// an odd multiple of 16 bytes.
//
// C interface (bound with ctypes): repro_flash_attention_fwd returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 16 * NWARPS;  // q rows a block: 16 a warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile shapes of one (type, padded head_dim). BKV: keys a kv tile, cut
// for wide rows so that two blocks fit an SM; LDQK, LDV: shared-memory row
// strides in elements; VG: f32 P V's n-tiles a V load serves.
template <typename T, int HDP>
struct Tile;

template <int HDP>
struct Tile<float, HDP> {
  static constexpr int BKV = HDP <= 64 ? 64 : 32;
  static constexpr int LDQK = HDP % 32 == 0 ? HDP + 16 : HDP;  // 16 mod 32
  static constexpr int LDV = HDP + 4;                          // 4 mod 16
  static constexpr int VG = HDP % 32 == 0 ? 4 : 2;
};

template <int HDP>
struct Tile<__nv_bfloat16, HDP> {
  static constexpr int BKV = HDP <= 128 ? 64 : 32;
  static constexpr int LDQK = HDP + 8;  // rows an odd multiple of 16 bytes
  static constexpr int LDV = HDP + 8;
  static constexpr int VG = 1;
};

template <typename T, int HDP>
constexpr size_t smem_bytes() {
  using L = Tile<T, HDP>;
  return sizeof(T) * (size_t(BQ) * L::LDQK + 2 * size_t(L::BKV) * (L::LDQK + L::LDV));
}

struct Params {
  const void *q, *k, *v;
  void* o;
  int B, S, Tk, H, group, hd, nq, causal, window, vec;
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

// Rows [0, nrows) x columns [0, HDP) of s (row stride ld) from g (row
// stride gs); rows >= nv and columns >= hd are zero. vec: 16-byte copies
// (hd and every row address a multiple of 16 bytes), else element copies
// (cp.async of 4 bytes for f32, plain stores for bf16).
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, long long gs,
                                          int nrows, int nv, int hd, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CH = HDP / V;
    for (int i = threadIdx.x; i < nrows * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * V;
      const bool ok = r < nv && c < hd;
      cp_async16(s + r * ld + c, ok ? g + r * gs + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * HDP; i += NTHREADS) {
      const int r = i / HDP, c = i % HDP;
      const bool ok = r < nv && c < hd;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(s + r * ld + c, ok ? g + r * gs + c : g, ok);
      else
        s[r * ld + c] = ok ? g[r * gs + c] : __float2bfloat16(0.f);
    }
  }
}

// ---- the two products of one warp -------------------------------------------

// s[j] (16 x 8, keys 8j..8j+7 of the tile) = Q[16 rows of the warp] K^T
template <typename T, int HDP>
__device__ __forceinline__ void scores(float (&s)[Tile<T, HDP>::BKV / 8][4],
                                       const T* sq, const T* sk, int warp, int lane) {
  using L = Tile<T, HDP>;
  constexpr int NT = L::BKV / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    const float* qw = sq + (16 * warp + g) * L::LDQK + 4 * t;
    const float* kw = sk + g * L::LDQK + 4 * t;
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(qw + 16 * c);
      const float4 x1 = *reinterpret_cast<const float4*>(qw + 8 * L::LDQK + 16 * c);
      const FragA a0 = frag_a(x0.x, x1.x, x0.y, x1.y);
      const FragA a1 = frag_a(x0.z, x1.z, x0.w, x1.w);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(kw + 8 * j * L::LDQK + 16 * c);
        mma3(s[j], a0, frag_b(y.x, y.y));
        mma3(s[j], a1, frag_b(y.z, y.w));
      }
    }
  } else {
    const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
    const uint32_t qa = smem_addr(sq + (16 * warp + lr + 8 * l8) * L::LDQK + 8 * l16);
    const uint32_t ka = smem_addr(sk + (lr + 8 * l16) * L::LDQK + 8 * l8);
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) {
      uint32_t a[4];
      ldsm_x4(a, qa + 32 * c);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, ka + 2 * (16 * jj * L::LDQK + 16 * c));
        mma_bf16(s[2 * jj], a, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// o += P V, P the probabilities in s (the accumulator layout of scores)
template <typename T, int HDP>
__device__ __forceinline__ void add_pv(float (&o)[HDP / 8][4],
                                       const float (&s)[Tile<T, HDP>::BKV / 8][4],
                                       const T* sv, int lane) {
  using L = Tile<T, HDP>;
  constexpr int NT = L::BKV / 8;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int VG = L::VG;
    const int g = lane >> 2, t = lane & 3;
    const float* vw = sv + 2 * t * L::LDV + VG * g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // k = t -> key 8j + 2t, k = t + 4 -> key 8j + 2t + 1
      const FragA a = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* v0 = vw + 8 * j * L::LDV;
#pragma unroll
      for (int m = 0; m < HDP / (8 * VG); ++m) {
        // b0 from key 8j + 2t, b1 from key 8j + 2t + 1
        if constexpr (VG == 4) {
          const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * m);
          const float4 y = *reinterpret_cast<const float4*>(v0 + L::LDV + 32 * m);
          mma3(o[4 * m], a, frag_b(x.x, y.x));
          mma3(o[4 * m + 1], a, frag_b(x.y, y.y));
          mma3(o[4 * m + 2], a, frag_b(x.z, y.z));
          mma3(o[4 * m + 3], a, frag_b(x.w, y.w));
        } else {
          const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * m);
          const float2 y = *reinterpret_cast<const float2*>(v0 + L::LDV + 16 * m);
          mma3(o[2 * m], a, frag_b(x.x, y.x));
          mma3(o[2 * m + 1], a, frag_b(x.y, y.y));
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
      for (int n = 0; n < HDP / 16; ++n) {
        uint32_t b[4];
        ldsm_x4_trans(b, va + 2 * (16 * j * L::LDV + 16 * n));
        mma_bf16(o[2 * n], a, b[0], b[1]);
        mma_bf16(o[2 * n + 1], a, b[2], b[3]);
      }
    }
  }
}

// One row of the warp's output (r = 0: row g, r = 1: row g + 8), times inv,
// columns < hd, undoing the f32 column order of add_pv.
template <typename T, int HDP>
__device__ __forceinline__ void store_row(T* orow, const float (&o)[HDP / 8][4], int r,
                                          float inv, int hd, int t) {
  constexpr int VG = Tile<T, HDP>::VG;
#pragma unroll
  for (int m = 0; m < HDP / (8 * VG); ++m)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < VG; ++i) {
        const int d = 8 * VG * m + VG * (2 * t + c) + i;
        const float x = o[VG * m + i][2 * r + c] * inv;
        if (d < hd) {
          if constexpr (std::is_same<T, float>::value) orow[d] = x;
          else orow[d] = __float2bfloat16(x);
        }
      }
}

// ---- the kernel -------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_mma_kernel(const Params p) {
  using L = Tile<T, HDP>;
  constexpr int BKV = L::BKV, NT = BKV / 8;
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);
  T* sk = sq + BQ * L::LDQK;        // + stage * BKV * LDQK
  T* sv = sk + 2 * BKV * L::LDQK;   // + stage * BKV * LDV

  const int nbh = p.B * p.H;
  const int rank = blockIdx.x / nbh;  // the last q tiles (longest causal walk) first
  const int bh = blockIdx.x - rank * nbh;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = (p.nq - 1 - rank) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  // keys this q tile can see: [k_lo, k_hi]
  int k_lo = 0, k_hi = p.Tk - 1;
  if (p.causal) k_hi = min(k_hi, min(q0 + BQ, p.S) - 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / BKV;
  const int ntiles = k_lo <= k_hi ? k_hi / BKV - kt0 + 1 : 0;

  auto load_kv = [&](int i, bool v_too) {
    const int k0 = (kt0 + i) * BKV;
    if (!v_too) {
      load_tile<T, HDP>(sk + (i & 1) * BKV * L::LDQK, L::LDQK, kb + k0 * p.k_ss, p.k_ss,
                        BKV, p.Tk - k0, p.hd, p.vec);
    } else {
      load_tile<T, HDP>(sv + (i & 1) * BKV * L::LDV, L::LDV, vb + k0 * p.v_ss, p.v_ss,
                        BKV, p.Tk - k0, p.hd, p.vec);
    }
  };
  // groups in flight: {Q, K_0, V_0}, then {K_i+1, V_i+1} each step
  load_tile<T, HDP>(sq, L::LDQK, qb, p.q_ss, BQ, p.S - q0, p.hd, p.vec);
  if (ntiles > 0) {
    load_kv(0, false);
    load_kv(0, true);
  }
  cp_async_commit();

  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this lane's part
  const bool capped = p.softcap > 0.f;
  const float mult = capped ? LOG2E : p.scale * LOG2E;  // exponent units per score
  const float cap_in = p.scale / p.softcap;
  const int qa = q0 + 16 * warp + g;  // this lane's rows: qa, qa + 8

  for (int i = 0; i < ntiles; ++i) {
    const bool next = i + 1 < ntiles;
    if (next) {
      load_kv(i + 1, false);
      load_kv(i + 1, true);
      cp_async_commit();
      cp_async_wait<1>();  // K_i and V_i (and Q)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i & 1;
    float s[NT][4];
    scores<T, HDP>(s, sq, sk + st * BKV * L::LDQK, warp, lane);

    const int k0 = (kt0 + i) * BKV;
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
      for (int n = 0; n < HDP / 8; ++n) {
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

    add_pv<T, HDP>(o, s, sv + st * BKV * L::LDV, lane);
    __syncthreads();  // stage st is free for tile i + 2
  }
  cp_async_wait<0>();

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = qa + 8 * r;
    if (qpos < p.S) store_row<T, HDP>(ob + qpos * p.o_ss, o, r, l > 0.f ? 1.f / l : 0.f, p.hd, t);
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

template <typename T, int HDP>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  p.nq = (p.S + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.B * p.H;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_fwd_mma_kernel<T, HDP><<<unsigned(blocks), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// hd 1..128 pads to the next multiple of 16, 129..256 to the next of 32
template <typename T>
cudaError_t dispatch_hd(const Params& p, cudaStream_t stream) {
  const int hdp = p.hd <= 0 ? 0 : p.hd <= 128 ? (p.hd + 15) / 16 * 16 : (p.hd + 31) / 32 * 32;
  switch (hdp) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 48: return launch<T, 48>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 112: return launch<T, 112>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 160: return launch<T, 160>(p, stream);
    case 192: return launch<T, 192>(p, stream);
    case 224: return launch<T, 224>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;  // hd outside 1..256
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// seq, head) for q, k, v, o in that order; head_dim is contiguous.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int S, int Tk, int H,
                              int KV, int hd, const long long* strides,
                              int causal, int window, float softcap,
                              float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.S = S; p.Tk = Tk; p.H = H; p.group = H / KV; p.hd = hd; p.nq = 0;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.vec = (hd * esize) % 16 == 0 && rows16(q, esize, strides, B, S, H) &&
          rows16(k, esize, strides + 3, B, Tk, KV) && rows16(v, esize, strides + 6, B, Tk, KV);
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dispatch_hd<float>(p, st) : dispatch_hd<__nv_bfloat16>(p, st));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
