// Flash attention forward for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, both products on the tensor cores by wgmma, one
// producer warp and two consumer warpgroups. CUDA C++ behind a C interface.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel under `flash_attention`, pallas_call at line 136) for bf16 at
// head_dim 64 and at every multiple of 8 from 72 to 128 (the latter through
// the hd-128 instance, below); kernels/flash_attention.py's route table sends
// f32 and the other head dims to the mma.sync kernel (csrc/flash_attention.cu).
// Same function: GQA attention o = softmax(softcap(q k^T / sqrt(hd)) + mask) v
// with causal and sliding-window masks at -1e30 applied after the softcap,
// online softmax (m, l, acc) in f32, fully-masked rows -> 0, kv head =
// h / (H / KV) read through strides, output in bf16. P is rounded to bf16
// before P.V, as scaled_dot_product_attention does and as the reference's
// non-flash `attend` does (probabilities cast to v's dtype).
//
// Bound at the serving slice's shape (llama3.2-1b prefill: B=4, S=T=1024,
// H=32, KV=8, hd=64, bf16, causal): 17.2 GFLOP of visible (q, k) pairs ->
// 17.4 us at 989 TFLOP/s, against 42 MB -> 12.5 us at 3.35 TB/s, so it is
// bound by operations. At hd 64 the exponentials weigh as much as the
// products: a 128 x 128 tile is 4.2 MFLOP (1,024 tensor-core cycles of an
// SM) and 16,384 ex2 (1,024 cycles of the SM's 16 MUFU lanes), so the design
// runs a warpgroup's softmax while its own last P V product, and the other
// warpgroup's products, are on the tensor cores.
//
// Design. A work tile is one (b, h, 128-row q tile); they are ordered
// longest causal walk first (the last q tiles of every (b, h), then the ones
// before). The grid is persistent, one block an SM, and block i takes work
// tiles i, i + grid, ...: with one block an SM (its registers) a block per
// work tile would fill and drain its pipeline alone at every tile.
// Warpgroup 0 is the producer: after `setmaxnreg.dec` one thread issues TMA
// loads, Q once a work tile (after the consumers released the last one) and
// K and V tiles of 128 keys into a ring of 3 stages (2 at hd 128), each load
// completing on its own mbarrier and each stage reused after its "empty"
// barrier. Warpgroups 1 and 2 are consumers of 64 q rows each
// (`setmaxnreg.inc`). Per kv tile: S = Q K^T by wgmma m64n128k16 (both
// operands in shared memory, K-major); scale, softcap, masks and the online
// softmax on the accumulator fragment in registers (row max and sum over
// the 4 lanes of a quad by shuffles; the scale folded into the exponent's
// FFMA); P converted to bf16 in registers and O += P V by wgmma m64n{hd}k16
// with P as the register A operand and V as the MN-major B operand in its
// stored layout (transpose bit). Within a warpgroup, tile j's S = Q K^T is
// issued together with tile j-1's P V, and tile j's softmax runs while that
// P V is on the tensor cores. Tiles wholly above the causal diagonal or left
// of the window are never loaded; only the tiles that the diagonal, the
// window edge or the end of T cut are masked. Ragged S and T: TMA fills rows
// past the tensor's end with zeros, the masks exclude them, and rows >= S
// are not stored. O is stored from registers with 4-byte stores.
//
// Shared memory is laid out as TMA writes it with 128-byte swizzle: a box
// row holds 64 bf16 (128 bytes), so hd 128 is loaded as two boxes, each a
// [rows][64] tile; every tile starts on a 1024-byte boundary, as the wgmma
// descriptors' swizzle mode requires.
//
// Head dims 72..120 (multiples of 8: zamba2-7b's 112, h2o-danube-3-4b's 120)
// run the hd-128 instance with the call's true hd as the tensor maps'
// innermost extent. TMA fills the second box's columns hd..127 with zeros,
// as it fills rows past S or T, and still counts the whole box's bytes for
// the mbarrier's expect_tx; it never reads the next head's columns. Q K^T
// over the 128 zero-padded columns is the product over hd, O's columns
// hd..127 stay 0, the scale is the true hd's (the wrapper passes it), and
// the epilogue stores hd / 8 column groups, so nothing past hd is written.
// hd must be a multiple of 8: TMA needs 16-byte strides (2 hd bytes a head)
// and the epilogue writes 8 columns a group.
//
// The tensor maps are encoded on the host at each launch, over the strided
// [B, S, H, hd] views (4-D, hd innermost); cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so the library does not link libcuda.
//
// C interface (bound with ctypes): repro_flash_attention_wgmma_fwd returns 0,
// a cudaError_t (> 0), or -(CUresult) if a tensor map could not be encoded.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                 // q rows per work tile (two consumer warpgroups)
constexpr int BKV = 128;                // keys per tile
constexpr int NCONSUMER = 256;          // consumer threads
constexpr int NTHREADS = 128 + NCONSUMER;
constexpr int PRODUCER_REGS = 40;       // 128 * 40 + 256 * 232 = 64,512 of 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int ROW_BYTES = 128;          // one 128-byte swizzled box row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WATCHDOG_CYCLES = 20000000000LL;  // ~10 s: trap, do not hang

template <int HD>
struct Smem {
  static constexpr int STAGES = HD == 64 ? 3 : 2;  // K/V ring depth
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;                      // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;    // + stage * KV_BYTES
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;  // 8-byte mbarriers:
  // full_q, empty_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int NBAR = 2 + 3 * STAGES;
  static constexpr size_t bytes = size_t(BAR_OFF) + 8 * NBAR + 1024;  // + alignment
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

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16x2), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16x2), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t desc_v) {
  wgmma_m64n64k16_rs(o, a, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t desc_v) {
  wgmma_m64n128k16_rs(o, a, desc_v);
}

// ---- the kernel ---------------------------------------------------------------

// S = Q K^T for this warpgroup's 64 rows and a tile of 128 keys, issued (not
// waited for): HD / 16 k-steps of 16 along hd, each 32 bytes further into a
// 128-byte box row; hd 128 continues in the second box.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_m64n128k16_ss(sc, sw128_desc(q_rows + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024),
                        sw128_desc(k_tile + (kk / 4) * BKV * ROW_BYTES + off, 16, 1024),
                        kk > 0);
  }
}

// O += P V, issued: V [keys][hd] is the MN-major B operand; a k-step of 16
// keys is two 8-row groups of 128-byte rows (2 KB on), and hd 128's second
// box is the next 64 columns (leading byte offset).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_pv<HD>(o, pa[kk], sw128_desc(v_tile + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 1024));
}

// One work tile: a (b, h, 128-row q tile) and the kv tiles its rows can see.
struct Work {
  int q0, h, b, kt_lo, n_tiles;
};

// Work tile w of n_qt * H * B, longest causal walks first: the last q tiles
// of every (b, h), then the ones before them.
__device__ __forceinline__ Work work_tile(int w, int n_qt, int H, int B, int S, int Tk,
                                          int causal, int window) {
  Work t;
  t.q0 = (n_qt - 1 - w / (H * B)) * BQ;
  t.h = w % H;
  t.b = (w / H) % B;
  int k_lo = 0, k_hi = Tk - 1;  // keys this q tile can see: [k_lo, k_hi]
  if (causal) k_hi = min(k_hi, min(t.q0 + BQ, S) - 1);
  if (window > 0) k_lo = max(0, t.q0 - window + 1);
  t.kt_lo = k_lo / BKV;
  t.n_tiles = k_lo <= k_hi ? k_hi / BKV - t.kt_lo + 1 : 0;
  return t;
}

// Persistent: each block takes work tiles blockIdx.x, + gridDim.x, ... (one
// block an SM), so the producer loads the next tile's Q and first K/V while
// the consumers finish the last one.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int B, int S, int Tk, int H,
                       int group, int hd, long long o_sb, long long o_ss,
                       long long o_sh, int causal, int window, float softcap,
                       float scale) {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  constexpr int NBOX = HD / 64;  // 128-byte box rows along hd
  using L = Smem<HD>;
  constexpr int STAGES = L::STAGES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::Q_OFF;
  // stage s: K at s_k0 + s * KV_BYTES, V likewise; barriers 8 bytes apart
  const uint32_t s_k0 = base + L::K_OFF, s_v0 = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF, bar_qe = bar_q + 8;
  const uint32_t bar_k0 = bar_qe + 8, bar_v0 = bar_k0 + 8 * STAGES,
                 bar_e0 = bar_v0 + 8 * STAGES;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_work = n_qt * H * B;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, NCONSUMER);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k0 + 8 * s, 1);
      mbar_init(bar_v0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles loaded: ring slot kv % STAGES, round kv / STAGES
      int local = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++local) {
        const Work t = work_tile(w, n_qt, H, B, S, Tk, causal, window);
        const int hk = t.h / group;
        mbar_wait(bar_qe, (local & 1) ^ 1);  // the last tile's Q is no longer read
        mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          tma_load_4d(s_q + c * BQ * ROW_BYTES, &tm_q, bar_q, 64 * c, t.h, t.q0, t.b);
        for (int it = 0; it < t.n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(bar_e0 + 8 * s, ((kv / STAGES) & 1) ^ 1);  // the stage is free
          const int k0 = (t.kt_lo + it) * BKV;
          const uint32_t sk = s_k0 + s * L::KV_BYTES, sv = s_v0 + s * L::KV_BYTES;
          mbar_expect_tx(bar_k0 + 8 * s, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NBOX; ++c)
            tma_load_4d(sk + c * BKV * ROW_BYTES, &tm_k, bar_k0 + 8 * s, 64 * c, hk, k0, t.b);
          mbar_expect_tx(bar_v0 + 8 * s, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NBOX; ++c)
            tma_load_4d(sv + c * BKV * ROW_BYTES, &tm_v, bar_v0 + 8 * s, 64 * c, hk, k0, t.b);
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
    // Scores stay in "u" units: q.k, or softcap * tanh(q.k * scale / softcap)
    // with a softcap; p = 2^(u * c - m * c) folds the scale into one FFMA.
    const bool capped = softcap > 0.f;
    const float cap_mul = capped ? scale / softcap : 0.f;
    const float c = capped ? LOG2E : scale * LOG2E;
    const uint32_t q_rows = s_q + cw * 64 * ROW_BYTES;

    int kv = 0;  // K/V tiles consumed, as the producer counts them
    int local = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++local) {
      const Work t = work_tile(w, n_qt, H, B, S, Tk, causal, window);
      const int row0 = t.q0 + 64 * cw + 16 * warp + g;  // rows row0, row0 + 8

      // o_acc[4j + 2r + e] is row row0 + 8r, column 8j + 2 t4 + e
      float o_acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
      float m_i[2] = {NEG_INF, NEG_INF};  // running row max, u units
      float l_i[2] = {0.f, 0.f};          // this lane's part of the running sum
      float sc[BKV / 2];         // sc[4j + 2r + e]: row row0 + 8r, key k0 + 8j + 2 t4 + e
      uint32_t pa[BKV / 16][4];  // P in bf16: the A fragments of P V's 8 k-steps

      // u, masks and the online softmax of one tile in sc, leaving P (f32)
      // in sc and the factor that rescales the earlier O and l in corr.
      auto softmax = [&](int k0, float (&corr)[2]) {
        if (capped) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) sc[i] = softcap * tanhf(sc[i] * cap_mul);
        }
        // only the tiles that the diagonal, the window edge or the end of T cut
        if ((causal && k0 + BKV - 1 > t.q0) ||
            (window > 0 && k0 <= t.q0 + BQ - 1 - window) || k0 + BKV > Tk) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int qpos = row0 + 8 * ((i % 4) / 2);
            const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
            bool ok = kpos < Tk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) sc[i] = NEG_INF;
          }
        }
        float mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_i[r];
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // a row with no visible key yet keeps m = -1e30; then every p is
          // 2^(-1e30 c) = 0, and so is the factor on its (zero) O and l
          const float m_use = mx > 0.5f * NEG_INF ? mx : 0.f;
          corr[r] = ex2((m_i[r] - m_use) * c);
          m_i[r] = mx;
          mc[r] = m_use * c;
        }
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int r = (i % 4) / 2;
          sc[i] = ex2(fmaf(sc[i], c, -mc[r]));
          psum[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + psum[r];
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      mbar_wait(bar_q, local & 1);
      if (t.n_tiles == 0) mbar_arrive(bar_qe);

      // Tile 0: S, softmax, P. Then each tile `it` issues its S = Q K^T and
      // the previous tile's O += P V together, and runs its softmax while
      // P V is on the tensor cores; O is rescaled once that product landed.
      // Q is released as soon as the last S has landed.
      if (t.n_tiles > 0) {
        float corr[2];
        const int s = kv % STAGES;
        mbar_wait(bar_k0 + 8 * s, (kv / STAGES) & 1);
        wgmma_fence();
        issue_qk<HD>(sc, q_rows, s_k0 + s * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (t.n_tiles == 1) mbar_arrive(bar_qe);
        softmax(t.kt_lo * BKV, corr);
        pack_p();
      }
      for (int it = 1; it < t.n_tiles; ++it) {
        const int s = (kv + it) % STAGES, sp = (kv + it - 1) % STAGES;
        mbar_wait(bar_k0 + 8 * s, ((kv + it) / STAGES) & 1);
        mbar_wait(bar_v0 + 8 * sp, ((kv + it - 1) / STAGES) & 1);
        fence_regs(o_acc);
        wgmma_fence();
        issue_qk<HD>(sc, q_rows, s_k0 + s * L::KV_BYTES);
        wgmma_commit();
        issue_pv<HD>(o_acc, pa, s_v0 + sp * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S of this tile has landed; P V may still run
        fence_regs(sc);
        if (it == t.n_tiles - 1) mbar_arrive(bar_qe);
        float corr[2];
        softmax((t.kt_lo + it) * BKV, corr);
        wgmma_wait<0>();
        fence_regs(o_acc);
        mbar_arrive(bar_e0 + 8 * sp);  // the previous stage is no longer read
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o_acc[i] *= corr[(i % 4) / 2];
        pack_p();
      }
      if (t.n_tiles > 0) {
        const int sp = (kv + t.n_tiles - 1) % STAGES;
        mbar_wait(bar_v0 + 8 * sp, ((kv + t.n_tiles - 1) / STAGES) & 1);
        fence_regs(o_acc);
        wgmma_fence();
        issue_pv<HD>(o_acc, pa, s_v0 + sp * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_acc);
        mbar_arrive(bar_e0 + 8 * sp);
      }
      kv += t.n_tiles;

      // epilogue: O / l, rows >= S and columns >= hd not stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_i[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int row = row0 + 8 * r;
        if (row < S) {
          __nv_bfloat16* orow = o + t.b * o_sb + row * o_ss + t.h * o_sh + 2 * t4;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            if (8 * j < hd)
              *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                  pack_bf16(o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
        }
      }
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

// A 4-D map over a strided [B, L, N, hd] bf16 view (element strides sb, sl,
// sn; hd contiguous), boxes of 64 x 1 x rows x 1 with 128-byte swizzle.
// Positions past L, and columns past hd, read as zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L,
                  int N, int hd, long long sb, long long sl, long long sn, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(N), cuuint64_t(L), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sn) * 2, cuuint64_t(sl) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The instance of width HD (64 or 128) at the call's hd <= HD: the maps span
// hd columns, TMA zero-fills the rest of the box.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
           int H, int KV, int hd, const long long* st, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = make_map(encode, &tm_q, q, B, S, H, hd, st[0], st[1], st[2], BQ);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tm_k, k, B, Tk, KV, hd, st[3], st[4], st[5], BKV);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tm_v, v, B, Tk, KV, hd, st[6], st[7], st[8], BKV);
  if (res != CUDA_SUCCESS) return -int(res);

  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long n_work = (long long)((S + BQ - 1) / BQ) * H * B;
  const int grid = int(n_work < sms ? n_work : sms);  // one block an SM
  flash_fwd_wgmma_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B, S, Tk, H, H / KV, hd, st[9],
      st[10], st[11], causal, window, softcap, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16 (the only one taken; the argument keeps the scalar
// kernel's interface). q [B,S,H,hd], k/v [B,Tk,KV,hd], o [B,S,H,hd]; hd 64, or
// a multiple of 8 from 72 to 128 (the hd-128 instance). strides:
// 12 element strides, (batch, seq, head) for q, k, v, o in that order; hd
// is contiguous, q/k/v 16-byte aligned with strides of 16-byte multiples
// (the wrapper checks). Returns 0, a cudaError_t, or -(CUresult) when a
// tensor map could not be encoded.
int repro_flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int S, int Tk, int H, int KV, int hd,
                                    const long long* strides, int causal, int window,
                                    float softcap, float scale, void* stream) {
  if (dtype != 1 || B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, o, B, S, Tk, H, KV, hd, strides, causal, window, softcap,
                      scale, st);
  if (hd > 64 && hd <= 128 && hd % 8 == 0)
    return launch<128>(q, k, v, o, B, S, Tk, H, KV, hd, strides, causal, window,
                       softcap, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* repro_wgmma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
