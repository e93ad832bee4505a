// Flash attention backward for Hopper (sm_90a): TMA loads into rings of
// shared-memory stages, every product on the tensor cores by wgmma, one
// producer warp and two consumer warpgroups. CUDA C++ behind a C interface.
//
// Replaces, for bf16 at head_dim 64 and 128, the backward that the reference
// trains through: the jnp custom VJP `_flash_bwd_vjp`
// (repro/models/attention.py:227) of its blockwise flash core; the Pallas
// kernel (repro/kernels/flash_attention.py) has no VJP.
// kernels/flash_attention.py's backward route table sends f32 and the other
// head dims to the mma.sync kernel (csrc/flash_attention_bwd.cu). Same
// function: with s = q k^T / sqrt(hd), softcapped as cap * tanh(s / cap)
// when cap > 0, the causal and sliding-window masks after the cap,
// P = softmax(s) by rows, D = rowsum(dO o),
//   dV = P^T dO,  dS = P (dO V^T - D) (1 - tanh^2) / sqrt(hd),
//   dQ = dS K,    dK = dS^T Q,
// dK and dV summed over the H / KV query heads of each kv head (GQA) in a
// fixed order, rows with no visible key giving zero, f32 accumulation,
// outputs in bf16; P and dS are rounded to bf16 before the products that
// consume them. No atomics: two calls give the same bits.
//
// Bound at llama3.2-1b's training shape (B=4, S=T=1024, H=32, KV=8, hd=64,
// causal, bf16): the backward's five products over the visible (q, k)
// pairs, 43.0 GFLOP, take 43.5 us at 989 TFLOP/s; its 83.9 MB of inputs
// and outputs 25 us at 3.35 TB/s, so it is bound by operations. This design
// runs eight products (the scores once more for the lse, S and dP in both
// the dK/dV and the dQ pass) in exchange for no atomics.
//
// Design: three passes, each a persistent grid of one block an SM (one
// producer warpgroup that gives up its registers by `setmaxnreg.dec`, of
// which one thread issues every load; two consumer warpgroups by
// `setmaxnreg.inc`), work tiles of 128 rows ordered longest walk first and
// dealt to the blocks in a snake (block i takes tiles i, 2 grid - 1 - i,
// 2 grid + i, ...), so that a block with a long first walk gets a short
// second one. The tiles a walk streams go through a ring of stages, each
// filled by TMA (`cp.async.bulk.tensor`) and completing on its "full"
// mbarrier, each reused after its "empty" mbarrier; the work tile's own
// tiles sit in shared memory for the whole walk, behind a full/empty pair
// of their own (two slots in pass 3, so the next work tile's load overlaps
// this one's walk). Tiles wholly above the causal diagonal or
// outside the window are never loaded; only the tiles that the diagonal,
// the window edge or the ends of S and T cut are masked, and the softcap's
// tanh and the masks' tests are compiled out of the element loops of the
// tiles that need neither (`with_flags`). Ragged S and T: TMA fills rows
// past a tensor's end with zeros, the masks exclude them, and rows past S
// (dQ) or T (dK, dV) are not stored.
//  1. lse and D: a work tile is (b, h, 128 q rows), 64 rows a warpgroup.
//     S = Q K^T by wgmma m64n64k16 over the key tiles the rows see, each
//     tile in two halves of 64 keys, the first half's online max and sum of
//     2^x running while the second half's product is on the tensor cores;
//     lse in the exponent's units (log2, scale folded in) and D = rowsum(dO
//     o) (loaded by the consumers themselves at the work tile's start,
//     summed after its walk) go to f32 scratch [B, H, S_pad], S_pad = S
//     rounded up to 128: rows past S get lse = +inf and D = 0, so every
//     later pass reads whole 16-byte rows.
//  2. dK, dV: a work tile is (b, kv head, 128 keys), 64 keys a warpgroup;
//     K and V stay in shared memory. The producer streams, for each query
//     head of the group and each q tile that sees the keys, the Q and dO
//     tiles (TMA) and their rows of lse and D (a plain bulk copy). Per
//     step: S^T = K Q^T and dP^T = V dO^T by wgmma (A = K or V, B = Q or
//     dO, both K-major in shared memory); P^T in registers while dP^T is on
//     the tensor cores, then dS^T; dV += P^T dO and dK += dS^T Q by wgmma
//     with P^T and dS^T as the register A operand (the accumulator fragment
//     converted to bf16, as the forward converts P) and dO or Q as the
//     MN-major B operand (transpose bit). dK and dV stay in registers for
//     the whole walk. A step's S^T and dP^T are issued while the last
//     step's dV and dK run.
//  3. dQ: a work tile is (b, h, 128 q rows), 64 rows a warpgroup; Q and dO
//     stay in shared memory, the producer streams K and V tiles of 64 keys.
//     Per step: S = Q K^T and dP = dO V^T, P while dP runs, then dS, and
//     dQ += dS K with dS as register A and K as MN-major B; dQ in registers
//     for the walk.
// Registers: a warpgroup's dK and dV of 64 keys are 2 x 64 x hd f32, 128
// registers a thread at hd 128, so pass 2 steps over 64 q rows at hd 64 and
// 32 at hd 128 (`Pass2::BQ`). Tried on an H100 and no faster: the two
// consumer warpgroups taking turns to issue their products (ping-pong on
// two mbarriers), tree reductions in pass 1, a second Q slot in pass 1,
// pass 3 stepping over 128 keys.
//
// Shared memory is laid out as TMA writes it with 128-byte swizzle: a box
// row holds 64 bf16 (128 bytes), so a tile is one 64-column slab of
// [rows][64] (two at hd 128); every tile starts on a 1024-byte boundary, as
// the wgmma descriptors' swizzle mode requires. The tensor maps (4: Q and
// dO in boxes of pass 2's step, K and V in boxes of 64 rows; a taller tile
// is loaded as several boxes) are encoded on the host at each launch over
// the strided [B, L, N, hd] views; cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so the library does not link libcuda. A wait on an mbarrier that never completes traps after ~10 s
// instead of hanging.
//
// C interface (bound with ctypes): repro_flash_attention_bwd_wgmma returns
// 0, a cudaError_t (> 0), or -(CUresult) if a tensor map could not be
// encoded.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // rows of a work tile: q rows (passes 1, 3), keys (2)
constexpr int NCONSUMER = 256;          // consumer threads: two warpgroups of 64 rows
constexpr int NTHREADS = 128 + NCONSUMER;
constexpr int PRODUCER_REGS = 40;       // 128 * 40 + 256 * 232 = 64,512 of 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int ROW_BYTES = 128;          // one 128-byte swizzled box row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WATCHDOG_CYCLES = 20000000000LL;  // ~10 s: trap, do not hang

// element-stride slots of Params::st: (batch, seq, head) of each tensor
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18, SDV = 21 };

struct Params {
  const __nv_bfloat16 *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;
  float *lse, *delta;  // [B, H, S_pad]; lse in the exponent's units (log2)
  int B, S, Tk, H, KV, group, S_pad, causal, window;
  // mult: exponent units per (capped) score; cap_in: raw score to tanh's argument
  float softcap, scale, mult, cap_in;
  long long st[24];
};

// One tensor map per tensor: Q and dO in boxes of pass 2's step (QBOX rows),
// K and V in boxes of KBOX rows (load_tile).
template <int HD>
struct Boxes {
  static constexpr int QBOX = HD == 64 ? 64 : 32;
  static constexpr int KBOX = 64;
};

// Shared-memory layouts (byte offsets from a 1024-byte aligned base).
template <int HD>
struct Pass1 {  // Q of the work tile; K tiles of 128 keys in a ring
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int K_BYTES = BM * HD * 2;
  static constexpr int K_OFF = Q_BYTES;                     // + stage * K_BYTES
  static constexpr int BAR_OFF = K_OFF + STAGES * K_BYTES;  // full_q, empty_q, full[], empty[]
  static constexpr size_t bytes = size_t(BAR_OFF) + 8 * (2 + 2 * STAGES) + 1024;
};

template <int HD>
struct Pass2 {  // K and V of the work tile; Q, dO, lse and D rows of a step in a ring
  static constexpr int BQ = Boxes<HD>::QBOX;  // q rows a step
  static constexpr int STAGES = 4;
  static constexpr int KV_BYTES = BM * HD * 2;
  static constexpr int T_BYTES = BQ * HD * 2;      // a Q or dO tile
  static constexpr int ROWS_BYTES = BQ * 4;        // a row block of lse or D
  static constexpr int STAGE_BYTES = (2 * T_BYTES + 2 * ROWS_BYTES + 1023) / 1024 * 1024;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;   // + stage * STAGE_BYTES: Q, dO, lse, D
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;  // full_kv, empty_kv, full[], empty[]
  static constexpr size_t bytes = size_t(BAR_OFF) + 8 * (2 + 2 * STAGES) + 1024;
};

// Pass 3's work tile's own tiles sit in two slots (work tile i in slot
// i % 2), so the next one's load overlaps this one's walk; each slot has a
// full and an empty mbarrier.
template <int HD>
struct Pass3 {  // Q and dO of the work tile; K and V tiles in a ring
  static constexpr int BK = Boxes<HD>::KBOX;  // keys a step
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;
  static constexpr int SLOT_BYTES = 2 * Q_BYTES;    // Q, then dO
  static constexpr int STAGE_OFF = 2 * SLOT_BYTES;  // + stage * 2 T_BYTES: K, V
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * 2 * T_BYTES;  // full_q[2], empty_q[2], full[], empty[]
  static constexpr size_t bytes = size_t(BAR_OFF) + 8 * (4 + 2 * STAGES) + 1024;
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the pipeline) traps after ~10 s instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
}

// 4-D tiled TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The tile of `rows` rows at (head, row0, b) of `map` into dst, completing
// on `bar`: rows / box boxes of each 64-column slab, box y of slab x at
// dst + (x rows + y box) 128 bytes, the [rows][64] slabs that every
// product's descriptors read, whatever the box.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b, int rows, int box) {
#pragma unroll
  for (int x = 0; x < HD / 64; ++x)
    for (int y = 0; y < rows / box; ++y)
      tma_load_4d(dst + (x * rows + y * box) * ROW_BYTES, map, bar, 64 * x, head, row0 + y * box,
                  b);
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: the start address
// and the leading and stride byte offsets, given in bytes, stored in 16-byte
// units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define F8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F16(d, i) F8(d, i), F8(d, i + 8)
#define F32(d, i) F16(d, i), F16(d, i + 16)
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
            "%31}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
            "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
            "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "  \
            "%61, %62, %63}"

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, A and B K-major in shared memory
// (D is overwritten where `accumulate` is 0).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
               ", %16, %17, p, 1, 1, 0, 0;\n}\n"
               : F16(d, 0) : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : F32(d, 0) : "l"(da), "l"(db), "r"(accumulate));
}
// D[64 x N] += A[64 x 16] . B[16 x N], A in registers (bf16x2), B MN-major in
// shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : F32(d, 0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : F32(d, 0), F32(d, 32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8
#undef F16
#undef F32
#undef R16
#undef R32
#undef R64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The dot product of two 16-byte chunks of bf16.
__device__ __forceinline__ float dot16(const uint4 a, const uint4 b) {
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

// ---- the products of one warpgroup ------------------------------------------
//
// Accumulator fragment of a 64 x N product: element i of thread (warp w of
// its warpgroup, lane = 4 g + t4) is row 16 w + g + 8 ((i % 4) / 2), column
// 8 (i / 4) + 2 t4 + (i % 2). Rounded to bf16 and packed in pairs it is the
// A fragment of the next product, contracted over those N columns.

// acc[64 x N] = A B^T over HD columns, issued (not waited for): A the
// warpgroup's 64 rows at a of a tile of a_rows rows, B N rows at b of a tile
// of b_rows rows. HD / 16 k-steps of 16 along hd, each 32 bytes further
// into a 128-byte row; hd 128 continues in the tile's second slab.
template <int HD, int N>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint32_t a, int a_rows,
                                          uint32_t b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<N>(acc, sw128_desc(a + (kk / 4) * a_rows * ROW_BYTES + off, 16, 1024),
                sw128_desc(b + (kk / 4) * b_rows * ROW_BYTES + off, 16, 1024), kk > 0);
  }
}

// acc[64 x HD] += P B, issued: P [64 x K] in registers (pa, one A fragment
// per 16 columns), B [K rows][HD] at b the MN-major operand in its stored
// layout; a k-step of 16 rows is two 8-row groups of 128-byte rows (2 KB
// on), and hd 128's second slab is the next 64 columns (leading byte offset).
template <int HD, int K>
__device__ __forceinline__ void issue_pb(float (&acc)[HD / 2], const uint32_t (&pa)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<HD>(acc, pa[kk], sw128_desc(b + kk * 16 * ROW_BYTES, K * ROW_BYTES, 1024));
}

template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Rows row0 + 8 r (r = 0, 1) of a 64 x HD accumulator to g (row stride gs),
// as bf16 pairs; rows >= nrows are not stored.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, long long gs,
                                           const float (&acc)[HD / 2], int row0, int nrows,
                                           int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < nrows) {
      __nv_bfloat16* out = g + row * gs + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---- masks, scores and the work lists ----------------------------------------

__device__ __forceinline__ bool visible(const Params& p, int r, int c) {
  return r < p.S && c < p.Tk && (!p.causal || c <= r) && (p.window <= 0 || c > r - p.window);
}

// Whether q rows [q0, q0 + nr) x keys [k0, k0 + nc) hold a pair that the
// masks or the ends of S and T hide.
__device__ __forceinline__ bool edge_tile(const Params& p, int q0, int nr, int k0, int nc) {
  return q0 + nr > p.S || k0 + nc > p.Tk || (p.causal && k0 + nc - 1 > q0) ||
         (p.window > 0 && k0 < q0 + nr - p.window);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// f(cap, edge) with both flags as compile-time constants (Flag<...>), so
// that the element loops hold neither the softcap's tanh nor the masks'
// tests where a tile needs none: a branch inside an unrolled loop would be
// turned into predicated code that runs for every element.
template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool edge, F&& f) {
  if (cap) {
    if (edge) f(Flag<true>{}, Flag<true>{});
    else f(Flag<true>{}, Flag<false>{});
  } else {
    if (edge) f(Flag<false>{}, Flag<true>{});
    else f(Flag<false>{}, Flag<false>{});
  }
}

// P of one score in place: s from the raw score q.k to p (0 where the
// masks hide its q row r and key c, tested under EDGE), with lse2 of its
// row; under CAP, fac gets the softcap's 1 - tanh^2 for its dS.
template <bool CAP, bool EDGE>
__device__ __forceinline__ void prob(const Params& p, float& s, float& fac, float lse2, int r,
                                     int c) {
  float x = s;
  if constexpr (CAP) {
    const float th = tanhf(x * p.cap_in);
    x = p.softcap * th;
    fac = 1.f - th * th;
  }
  s = ex2(fmaf(x, p.mult, -lse2));
  if constexpr (EDGE) {
    if (!visible(p, r, c)) s = 0.f;
  }
}

// dS of one score in place, from its p, dp = dO.v and D of its row, scaled
// by 1 / sqrt(hd): p (dp - D) (1 - tanh^2 under CAP) / sqrt(hd).
template <bool CAP>
__device__ __forceinline__ void dscore(const Params& p, float pr, float& dp, const float& fac,
                                       float d) {
  if constexpr (CAP) dp = pr * (dp - d) * (fac * p.scale);
  else dp = pr * (dp - d) * p.scale;
}

// The work tile of a block's i-th turn: tiles i grid .. (i + 1) grid - 1,
// this block's counted from the front on even turns and from the back on
// odd ones (a snake over tiles ordered longest walk first).
__device__ __forceinline__ int snake(int i) {
  return i * gridDim.x + ((i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A (b, h, 128 q rows) work tile of passes 1 and 3 (the last q tiles, the
// longest causal walks, first) and the key tiles of `bk` keys its rows see.
struct QWork {
  int q0, h, b, kt_lo, n_tiles;
};

__device__ __forceinline__ QWork q_work(const Params& p, int w, int bk) {
  const int n_qt = p.S_pad / BM;
  QWork t;
  t.q0 = (n_qt - 1 - w / (p.H * p.B)) * BM;
  t.h = w % p.H;
  t.b = (w / p.H) % p.B;
  int k_lo = 0, k_hi = p.Tk - 1;  // keys these rows can see: [k_lo, k_hi]
  if (p.causal) k_hi = min(k_hi, min(t.q0 + BM, p.S) - 1);
  if (p.window > 0) k_lo = max(0, t.q0 - p.window + 1);
  t.kt_lo = k_lo / bk;
  t.n_tiles = k_lo <= k_hi ? k_hi / bk - t.kt_lo + 1 : 0;
  return t;
}

// A (b, kv head, 128 keys) work tile of pass 2 (key tile 0, the longest
// causal walk, first) and its steps: for each query head of the group, the
// q tiles of `bq` rows that see a key of the tile.
struct KWork {
  int k0, kvh, b, qt_lo, n_qt, n_steps;
};

__device__ __forceinline__ KWork k_work(const Params& p, int w, int bq) {
  KWork t;
  t.k0 = (w / (p.KV * p.B)) * BM;
  t.kvh = w % p.KV;
  t.b = (w / p.KV) % p.B;
  const int r_lo = p.causal ? t.k0 : 0;
  int r_hi = p.S - 1;
  if (p.window > 0) r_hi = min(r_hi, t.k0 + BM - 1 + p.window - 1);
  t.qt_lo = r_lo / bq;
  t.n_qt = r_lo <= r_hi ? r_hi / bq - t.qt_lo + 1 : 0;
  t.n_steps = p.group * t.n_qt;
  return t;
}

// ---- pass 1: lse and D -------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_wgmma_lse_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k, const Params p) {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  using L = Pass1<HD>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k0 = base + L::K_OFF;
  const uint32_t bar_q = base + L::BAR_OFF, bar_qe = bar_q + 8, bar_f0 = bar_q + 16,
                 bar_e0 = bar_f0 + 8 * STAGES;
  const int n_work = (p.S_pad / BM) * p.H * p.B;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, NCONSUMER);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int kv = 0;  // K tiles loaded: ring slot kv % STAGES, round kv / STAGES
      for (int i = 0;; ++i) {
        const int w = snake(i);
        if (w >= n_work) break;
        const QWork t = q_work(p, w, BM);
        const int hk = t.h / p.group;
        mbar_wait(bar_qe, (i & 1) ^ 1);  // the last tile's Q is no longer read
        mbar_expect_tx(bar_q, L::Q_BYTES);
        load_tile<HD>(s_q, &tm_q, bar_q, t.h, t.q0, t.b, BM, Boxes<HD>::QBOX);
        for (int it = 0; it < t.n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(bar_e0 + 8 * s, ((kv / STAGES) & 1) ^ 1);
          const uint32_t sk = s_k0 + s * L::K_BYTES;
          mbar_expect_tx(bar_f0 + 8 * s, L::K_BYTES);
          load_tile<HD>(sk, &tm_k, bar_f0 + 8 * s, hk, (t.kt_lo + it) * BM, t.b, BM,
                        Boxes<HD>::KBOX);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool capped = p.softcap > 0.f;

    int kv = 0;
    for (int i = 0;; ++i) {
      const int w = snake(i);
      if (w >= n_work) break;
      const QWork t = q_work(p, w, BM);
      const long long bh = (long long)t.b * p.H + t.h;
      const uint32_t q_rows = s_q + cw * 64 * ROW_BYTES;

      // D = rowsum(dO o), two threads a row: the rows' dO and o are loaded
      // here and summed after the walk, which hides the loads' latency
      const int d_row = t.q0 + 64 * cw + tid / 2, part = tid % 2;
      uint4 d_dout[HD / 16], d_o[HD / 16];
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) d_dout[x] = d_o[x] = make_uint4(0, 0, 0, 0);
      if (d_row < p.S) {
        const __nv_bfloat16* orow =
            p.o + t.b * p.st[SO] + d_row * p.st[SO + 1] + t.h * p.st[SO + 2] + 8 * part;
        const __nv_bfloat16* drow =
            p.dout + t.b * p.st[SDO] + d_row * p.st[SDO + 1] + t.h * p.st[SDO + 2] + 8 * part;
#pragma unroll
        for (int x = 0; x < HD / 16; ++x) {
          d_dout[x] = *reinterpret_cast<const uint4*>(drow + 16 * x);
          d_o[x] = *reinterpret_cast<const uint4*>(orow + 16 * x);
        }
      }

      const int row0 = t.q0 + 64 * cw + 16 * warp + g;  // rows row0, row0 + 8
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this lane's part
      // the online max and sum over 64 keys from k0: sc[4j + 2r + e] is row
      // row0 + 8r, key k0 + 8j + 2 t4 + e
      auto online = [&](float (&sc)[32], int k0) {
        with_flags(capped, edge_tile(p, t.q0, BM, k0, 64), [&](auto cap, auto edge) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if constexpr (decltype(cap)::value) sc[e] = p.softcap * tanhf(sc[e] * p.cap_in);
            if constexpr (decltype(edge)::value) {
              if (!visible(p, row0 + 8 * ((e % 4) / 2), k0 + 8 * (e / 4) + 2 * t4 + (e % 2)))
                sc[e] = NEG_INF;
            }
          }
        });
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_run[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // a row with no visible key so far: every p and the correction are 0
          const float mc = mx > 0.5f * NEG_INF ? mx * p.mult : __int_as_float(0x7f800000);
          float sum = l_run[r] * ex2(m_run[r] * p.mult - mc);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum += ex2(fmaf(sc[4 * j + 2 * r], p.mult, -mc)) +
                   ex2(fmaf(sc[4 * j + 2 * r + 1], p.mult, -mc));
          l_run[r] = sum;
          m_run[r] = mx;
        }
      };

      mbar_wait(bar_q, i & 1);
      if (t.n_tiles == 0) mbar_arrive(bar_qe);
      // Each tile's S = Q K^T in two halves of 64 keys: the first half's
      // softmax runs while the second half's product is on the tensor cores.
      for (int it = 0; it < t.n_tiles; ++it, ++kv) {
        const int s = kv % STAGES;
        const uint32_t sk = s_k0 + s * L::K_BYTES;
        mbar_wait(bar_f0 + 8 * s, (kv / STAGES) & 1);
        float s0[32], s1[32];
        wgmma_fence();
        issue_abt<HD, 64>(s0, q_rows, BM, sk, BM);
        wgmma_commit();
        issue_abt<HD, 64>(s1, q_rows, BM, sk + 64 * ROW_BYTES, BM);
        wgmma_commit();
        const int k0 = (t.kt_lo + it) * BM;
        wgmma_wait<1>();
        fence_regs(s0);
        online(s0, k0);
        wgmma_wait<0>();
        fence_regs(s1);
        mbar_arrive(bar_e0 + 8 * s);
        if (it == t.n_tiles - 1) mbar_arrive(bar_qe);
        online(s1, k0 + 64);
      }
      float dsum = 0.f;
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) dsum += dot16(d_dout[x], d_o[x]);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      if (part == 0) p.delta[bh * p.S_pad + d_row] = dsum;  // 0 past S
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row0 + 8 * r;  // < S_pad; rows past S have no visible key
        if (t4 == 0)
          p.lse[bh * p.S_pad + row] =
              l > 0.f ? m_run[r] * p.mult + log2f(l) : __int_as_float(0x7f800000);
      }
    }
  }
}

// ---- pass 2: dK and dV -------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do, const Params p) {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  using L = Pass2<HD>;
  constexpr int STAGES = L::STAGES, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const gen = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t s_k = base, s_v = base + L::V_OFF, s_st0 = base + L::STAGE_OFF;
  const uint32_t bar_kv = base + L::BAR_OFF, bar_kve = bar_kv + 8, bar_f0 = bar_kv + 16,
                 bar_e0 = bar_f0 + 8 * STAGES;
  const int n_work = ((p.Tk + BM - 1) / BM) * p.KV * p.B;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    prefetch_map(&tm_q);
    prefetch_map(&tm_do);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kve, NCONSUMER);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int n = 0;  // steps loaded: ring slot n % STAGES, round n / STAGES
      for (int i = 0;; ++i) {
        const int w = snake(i);
        if (w >= n_work) break;
        const KWork t = k_work(p, w, BQ);
        mbar_wait(bar_kve, (i & 1) ^ 1);  // the last tile's K and V are no longer read
        mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
        load_tile<HD>(s_k, &tm_k, bar_kv, t.kvh, t.k0, t.b, BM, Boxes<HD>::KBOX);
        load_tile<HD>(s_v, &tm_v, bar_kv, t.kvh, t.k0, t.b, BM, Boxes<HD>::KBOX);
        for (int it = 0; it < t.n_steps; ++it, ++n) {
          const int s = n % STAGES;
          const int h = t.kvh * p.group + it / t.n_qt, q0 = (t.qt_lo + it % t.n_qt) * BQ;
          const long long row = ((long long)t.b * p.H + h) * p.S_pad + q0;
          mbar_wait(bar_e0 + 8 * s, ((n / STAGES) & 1) ^ 1);
          const uint32_t st = s_st0 + s * L::STAGE_BYTES, full = bar_f0 + 8 * s;
          mbar_expect_tx(full, 2 * L::T_BYTES + 2 * L::ROWS_BYTES);
          load_tile<HD>(st, &tm_q, full, h, q0, t.b, BQ, BQ);
          load_tile<HD>(st + L::T_BYTES, &tm_do, full, h, q0, t.b, BQ, BQ);
          bulk_load(st + 2 * L::T_BYTES, p.lse + row, L::ROWS_BYTES, full);
          bulk_load(st + 2 * L::T_BYTES + L::ROWS_BYTES, p.delta + row, L::ROWS_BYTES, full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool capped = p.softcap > 0.f;
    const uint32_t k_rows = s_k + cw * 64 * ROW_BYTES, v_rows = s_v + cw * 64 * ROW_BYTES;

    int n = 0;
    for (int i = 0;; ++i) {
      const int w = snake(i);
      if (w >= n_work) break;
      const KWork t = k_work(p, w, BQ);
      const int key0 = t.k0 + 64 * cw + 16 * warp + g;  // this lane's keys: key0, key0 + 8

      // dk[4j + 2r + e], dv likewise: key key0 + 8r, column 8j + 2 t4 + e
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) dk[e] = dv[e] = 0.f;
      float st[BQ / 2], dpt[BQ / 2];  // S^T, dP^T: key key0 + 8r, q row q0 + 8j + 2 t4 + e
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T as A fragments

      mbar_wait(bar_kv, i & 1);
      if (t.n_steps == 0) mbar_arrive(bar_kve);
      // Each step issues its S^T and dP^T while the last step's dV and dK
      // run; a step's stage is released once its dV and dK have landed.
      for (int it = 0; it < t.n_steps; ++it, ++n) {
        const int s = n % STAGES;
        const uint32_t stg = s_st0 + s * L::STAGE_BYTES;
        mbar_wait(bar_f0 + 8 * s, (n / STAGES) & 1);
        wgmma_fence();
        issue_abt<HD, BQ>(st, k_rows, BM, stg, BQ);
        wgmma_commit();
        issue_abt<HD, BQ>(dpt, v_rows, BM, stg + L::T_BYTES, BQ);
        wgmma_commit();
        wgmma_wait<1>();  // S^T (and the last step's dV and dK) landed; dP^T may run
        fence_regs(st);
        fence_regs(dk);
        fence_regs(dv);
        if (it > 0) mbar_arrive(bar_e0 + 8 * ((n - 1) % STAGES));

        const int q0 = (t.qt_lo + it % t.n_qt) * BQ;
        const float* rows = reinterpret_cast<const float*>(
            gen + L::STAGE_OFF + s * L::STAGE_BYTES + 2 * L::T_BYTES);  // lse, then D
        float fac[BQ / 2];  // the softcap's 1 - tanh^2
        with_flags(capped, edge_tile(p, q0, BQ, t.k0, BM), [&](auto cap, auto edge) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e % 2, idx = 4 * j + e;
              prob<decltype(cap)::value, decltype(edge)::value>(
                  p, st[idx], fac[idx], c ? l2.y : l2.x, q0 + 8 * j + 2 * t4 + c,
                  key0 + 8 * (e / 2));
            }
          }
        });
        wgmma_wait<0>();
        fence_regs(dpt);
        if (it == t.n_steps - 1) mbar_arrive(bar_kve);
        with_flags(capped, false, [&](auto cap, auto) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dscore<decltype(cap)::value>(p, st[4 * j + e], dpt[4 * j + e], fac[4 * j + e],
                                           e % 2 ? d2.y : d2.x);
          }
        });
        pack_a<BQ>(st, pa);
        pack_a<BQ>(dpt, da);
        wgmma_fence();
        issue_pb<HD, BQ>(dv, pa, stg + L::T_BYTES);  // dV += P^T dO
        issue_pb<HD, BQ>(dk, da, stg);               // dK += dS^T Q
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (t.n_steps > 0) mbar_arrive(bar_e0 + 8 * ((n - 1) % STAGES));

      const int nk = p.Tk;
      store_rows<HD>(p.dk + t.b * p.st[SDK] + t.kvh * p.st[SDK + 2], p.st[SDK + 1], dk, key0,
                     nk, t4);
      store_rows<HD>(p.dv + t.b * p.st[SDV] + t.kvh * p.st[SDV + 2], p.st[SDV + 1], dv, key0,
                     nk, t4);
    }
  }
}

// ---- pass 3: dQ --------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  using L = Pass3<HD>;
  constexpr int STAGES = L::STAGES, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_st0 = base + L::STAGE_OFF;  // slot c: Q, dO at s_q + c SLOT_BYTES
  // full_q and empty_q of slot c at bar_q + 8c, bar_qe + 8c
  const uint32_t bar_q = base + L::BAR_OFF, bar_qe = bar_q + 16, bar_f0 = bar_q + 32,
                 bar_e0 = bar_f0 + 8 * STAGES;
  const int n_work = (p.S_pad / BM) * p.H * p.B;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_do);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    for (int c = 0; c < 2; ++c) {
      mbar_init(bar_q + 8 * c, 1);
      mbar_init(bar_qe + 8 * c, NCONSUMER);
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int kv = 0;
      for (int i = 0;; ++i) {
        const int w = snake(i);
        if (w >= n_work) break;
        const QWork t = q_work(p, w, BK);
        const int hk = t.h / p.group, c = i % 2;
        const uint32_t sq = s_q + c * L::SLOT_BYTES, full_q = bar_q + 8 * c;
        mbar_wait(bar_qe + 8 * c, ((i / 2) & 1) ^ 1);  // the slot's last Q and dO are no longer read
        mbar_expect_tx(full_q, 2 * L::Q_BYTES);
        load_tile<HD>(sq, &tm_q, full_q, t.h, t.q0, t.b, BM, Boxes<HD>::QBOX);
        load_tile<HD>(sq + L::Q_BYTES, &tm_do, full_q, t.h, t.q0, t.b, BM, Boxes<HD>::QBOX);
        for (int it = 0; it < t.n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(bar_e0 + 8 * s, ((kv / STAGES) & 1) ^ 1);
          const uint32_t sk = s_st0 + s * 2 * L::T_BYTES, full = bar_f0 + 8 * s;
          const int k0 = (t.kt_lo + it) * BK;
          mbar_expect_tx(full, 2 * L::T_BYTES);
          load_tile<HD>(sk, &tm_k, full, hk, k0, t.b, BK, BK);
          load_tile<HD>(sk + L::T_BYTES, &tm_v, full, hk, k0, t.b, BK, BK);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool capped = p.softcap > 0.f;

    int kv = 0;
    for (int i = 0;; ++i) {
      const int w = snake(i);
      if (w >= n_work) break;
      const QWork t = q_work(p, w, BK);
      const int c = i % 2;
      const uint32_t q_rows = s_q + c * L::SLOT_BYTES + cw * 64 * ROW_BYTES;
      const uint32_t do_rows = q_rows + L::Q_BYTES;
      const int row0 = t.q0 + 64 * cw + 16 * warp + g;  // this lane's rows: row0, row0 + 8
      const long long at = ((long long)t.b * p.H + t.h) * p.S_pad + row0;
      const float lse2[2] = {p.lse[at], p.lse[at + 8]};  // +inf past S: p = 0
      const float dd[2] = {p.delta[at], p.delta[at + 8]};

      float dq[HD / 2];  // dq[4j + 2r + e]: row row0 + 8r, column 8j + 2 t4 + e
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) dq[e] = 0.f;
      float sc[BK / 2], dp[BK / 2];  // S, dP: row row0 + 8r, key k0 + 8j + 2 t4 + e
      uint32_t da[BK / 16][4];       // dS as A fragments

      mbar_wait(bar_q + 8 * c, (i / 2) & 1);
      if (t.n_tiles == 0) mbar_arrive(bar_qe + 8 * c);
      // Each step issues its S and dP while the last step's dQ runs
      for (int it = 0; it < t.n_tiles; ++it, ++kv) {
        const int s = kv % STAGES;
        const uint32_t sk = s_st0 + s * 2 * L::T_BYTES;
        mbar_wait(bar_f0 + 8 * s, (kv / STAGES) & 1);
        wgmma_fence();
        issue_abt<HD, BK>(sc, q_rows, BM, sk, BK);
        wgmma_commit();
        issue_abt<HD, BK>(dp, do_rows, BM, sk + L::T_BYTES, BK);
        wgmma_commit();
        wgmma_wait<1>();  // S (and the last step's dQ) landed; dP may run
        fence_regs(sc);
        fence_regs(dq);
        if (it > 0) mbar_arrive(bar_e0 + 8 * ((kv - 1) % STAGES));

        const int k0 = (t.kt_lo + it) * BK;
        float fac[BK / 2];  // the softcap's 1 - tanh^2
        with_flags(capped, edge_tile(p, t.q0, BM, k0, BK), [&](auto cap, auto edge) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int r = (e % 4) / 2;
            prob<decltype(cap)::value, decltype(edge)::value>(
                p, sc[e], fac[e], lse2[r], row0 + 8 * r, k0 + 8 * (e / 4) + 2 * t4 + (e % 2));
          }
        });
        wgmma_wait<0>();
        fence_regs(dp);
        if (it == t.n_tiles - 1) mbar_arrive(bar_qe + 8 * c);
        with_flags(capped, false, [&](auto cap, auto) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e)
            dscore<decltype(cap)::value>(p, sc[e], dp[e], fac[e], dd[(e % 4) / 2]);
        });
        pack_a<BK>(dp, da);
        wgmma_fence();
        issue_pb<HD, BK>(dq, da, sk);  // dQ += dS K
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dq);
      if (t.n_tiles > 0) mbar_arrive(bar_e0 + 8 * ((kv - 1) % STAGES));

      store_rows<HD>(p.dq + t.b * p.st[SDQ] + t.h * p.st[SDQ + 2], p.st[SDQ + 1], dq, row0, p.S,
                     t4);
    }
  }
}

// ---- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a strided [B, L, N, hd] bf16 view (element strides st[0..2]
// of batch, seq and head; hd contiguous), boxes of 64 x 1 x rows x 1 with
// 128-byte swizzle. Positions past L read as zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L,
                  int N, int hd, const long long* st, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(N), cuuint64_t(L), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

int grid_of(long long n_work, int sms) { return int(n_work < sms ? n_work : sms); }

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  using X = Boxes<HD>;
  CUtensorMap q_m, k_m, v_m, do_m;
  const struct { CUtensorMap* map; const void* ptr; int L, N, slot, rows; } maps[4] = {
      {&q_m, q, p.S, p.H, SQ, X::QBOX}, {&k_m, k, p.Tk, p.KV, SK, X::KBOX},
      {&v_m, v, p.Tk, p.KV, SV, X::KBOX}, {&do_m, p.dout, p.S, p.H, SDO, X::QBOX}};
  for (const auto& m : maps) {
    const CUresult res = make_map(encode, m.map, m.ptr, p.B, m.L, m.N, HD, p.st + m.slot, m.rows);
    if (res != CUDA_SUCCESS) return -int(res);
  }

  cudaError_t err;
  if ((err = prepare(flash_bwd_wgmma_lse_kernel<HD>, Pass1<HD>::bytes)) != cudaSuccess ||
      (err = prepare(flash_bwd_wgmma_dkdv_kernel<HD>, Pass2<HD>::bytes)) != cudaSuccess ||
      (err = prepare(flash_bwd_wgmma_dq_kernel<HD>, Pass3<HD>::bytes)) != cudaSuccess)
    return int(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long rows = (long long)(p.S_pad / BM) * p.H * p.B;
  const long long keys = (long long)((p.Tk + BM - 1) / BM) * p.KV * p.B;
  flash_bwd_wgmma_lse_kernel<HD><<<grid_of(rows, sms), NTHREADS, Pass1<HD>::bytes, stream>>>(
      q_m, k_m, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  flash_bwd_wgmma_dkdv_kernel<HD><<<grid_of(keys, sms), NTHREADS, Pass2<HD>::bytes, stream>>>(
      k_m, v_m, q_m, do_m, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  flash_bwd_wgmma_dq_kernel<HD><<<grid_of(rows, sms), NTHREADS, Pass3<HD>::bytes, stream>>>(
      q_m, do_m, k_m, v_m, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16 (the only one taken; the argument keeps the mma.sync
// kernel's interface). q [B,S,H,hd], k/v [B,Tk,KV,hd], o, dout and dq like q,
// dk and dv like k; hd 64 or 128. strides: 24 element strides, (batch, seq,
// head) for q, k, v, o, dout, dq, dk, dv in that order; hd is contiguous,
// q, k, v, o and dout 16-byte aligned with strides of 16-byte multiples (the
// wrapper checks). lse and delta: f32 scratch of B * H * S_pad each, S_pad =
// S rounded up to 128, 16-byte aligned. Returns 0, a cudaError_t, or
// -(CUresult) when a tensor map could not be encoded.
int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, void* dq, void* dk,
                                    void* dv, void* lse, void* delta, int dtype, int B, int S,
                                    int Tk, int H, int KV, int hd, const long long* strides,
                                    int causal, int window, float softcap, float scale,
                                    void* stream) {
  if (dtype != 1 || B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.Tk = Tk; p.H = H; p.KV = KV; p.group = H / KV;
  p.S_pad = (S + BM - 1) / BM * BM;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  p.mult = softcap > 0.f ? LOG2E : scale * LOG2E;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, p, st);
  if (hd == 128) return launch<128>(q, k, v, p, st);
  return int(cudaErrorInvalidValue);
}

const char* repro_bwd_wgmma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
