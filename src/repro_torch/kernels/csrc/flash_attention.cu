// Flash attention forward for Hopper (sm_90a), CUDA C++ behind a C interface.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel under `flash_attention`, pallas_call at line 136). Same function:
// GQA attention o = softmax(softcap(q k^T / sqrt(hd)) + mask) v with causal
// and sliding-window masks at -1e30, online softmax (m, l, acc) in f32,
// fully-masked rows -> 0, kv head = h / (H / KV), output in q's dtype.
//
// Bound at the serving slice's shape (llama3.2-1b prefill: B=4, S=T=1024,
// H=32, KV=8, hd=64, bf16, causal):
//   operations: 4 * B*H * hd * S(S+1)/2  ~ 17.2 GFLOP -> ~17 us at 989 TFLOP/s
//   bytes:      (2*H + 2*KV) * B*S*hd * 2 B ~ 42 MB  -> ~12.5 us at 3.35 TB/s
// so the kernel is bound by operations (~17 us a layer). This first version
// does its products as scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak,
// 1/15 of the tensor cores), so it is expected to run far above that bound;
// tensor cores (mma.sync / wgmma) and TMA staging come later.
//
// Design (not the TPU grid carried over): one thread block owns one
// (b, h, q-tile of 64 rows) and walks its kv tiles in a loop, so (m, l, acc)
// live in registers for the whole walk instead of being carried across a
// sequential grid axis. K/V tiles of 64 rows are staged in shared memory in
// f32; tiles wholly above the causal diagonal or left of the window are
// never visited (the loop bounds skip them, as `pl.when(run)` does). Four
// threads share a query row: each computes 16 of the 64 scores of the tile,
// the row max / sum are combined with warp shuffles, and each thread keeps a
// quarter of the row's output accumulator. Ragged S and T are masked here,
// so any S, T work (no block halving). q/k/v/o are read and written in the
// [B, S, H, hd] layout through element strides; hd must be contiguous.
//
// C interface (bound with ctypes): repro_flash_attention_fwd returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BKV = 64;              // key/value rows per tile
constexpr int TPR = 4;               // threads per query row
constexpr int NTHREADS = BQ * TPR;   // 256
constexpr int CPT = BKV / TPR;       // score columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;    // q/k/v row stride in floats: rows stay
                                       // 16-byte aligned, banks staggered
  static constexpr int LDP = BKV + 1;  // probability row stride
  static constexpr size_t bytes =
      sizeof(float) * (size_t(BQ) * LD + 2 * size_t(BKV) * LD + size_t(BQ) * LDP);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int Tk, int group,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 int causal, int window, float softcap, float scale) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = Layout<HD>::LD;
  constexpr int LDP = Layout<HD>::LDP;
  constexpr int NCHUNK = HD / (4 * TPR);  // float4 chunks of acc per thread

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * LD;
  float* sv = sk + BKV * LD;
  float* sp = sv + BKV * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int j = tid % TPR;
  const int qpos = q0 + row;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    sq[r * LD + d] = s < S ? to_f32(qb[s * q_ss + d]) : 0.f;
  }

  // keys this q-tile can see: [k_lo, k_hi]
  int k_lo = 0, k_hi = Tk - 1;
  if (causal) k_hi = min(k_hi, min(q0 + BQ, S) - 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / BKV;
  const int kt_hi = k_lo <= k_hi ? k_hi / BKV : kt_lo - 1;

  float acc[NCHUNK * 4];
#pragma unroll
  for (int a = 0; a < NCHUNK * 4; ++a) acc[a] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // Q staged / previous tile no longer read
    for (int idx = tid; idx < BKV * HD; idx += NTHREADS) {
      const int r = idx / HD, d = idx % HD;
      const int t = k0 + r;
      const bool in = t < Tk;
      sk[r * LD + d] = in ? to_f32(kb[t * k_ss + d]) : 0.f;
      sv[r * LD + d] = in ? to_f32(vb[t * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's columns j, j+4, ..., j+60
    float sc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) sc[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&sq[row * LD + d]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(&sk[(j + TPR * c) * LD + d]);
        sc[c] = fmaf(qv.x, kv.x, sc[c]);
        sc[c] = fmaf(qv.y, kv.y, sc[c]);
        sc[c] = fmaf(qv.z, kv.z, sc[c]);
        sc[c] = fmaf(qv.w, kv.w, sc[c]);
      }
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kpos = k0 + j + TPR * c;
      float s = sc[c] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      sc[c] = ok ? s : NEG_INF;
      tmax = fmaxf(tmax, sc[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    const bool live = m_new > 0.5f * NEG_INF;  // else the row is all masked so far
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float p = live ? expf(sc[c] - m_new) : 0.f;
      sp[row * LDP + j + TPR * c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = m_i > 0.5f * NEG_INF ? expf(m_i - m_new) : 0.f;
    l_i = l_i * corr + psum;
    m_i = m_new;
#pragma unroll
    for (int a = 0; a < NCHUNK * 4; ++a) acc[a] *= corr;
    __syncwarp();  // the row's probabilities come from the 4 lanes of this warp

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float p = sp[row * LDP + c];
#pragma unroll
      for (int m = 0; m < NCHUNK; ++m) {
        const float4 vv = *reinterpret_cast<const float4*>(&sv[c * LD + 4 * j + 4 * TPR * m]);
        acc[4 * m + 0] = fmaf(p, vv.x, acc[4 * m + 0]);
        acc[4 * m + 1] = fmaf(p, vv.y, acc[4 * m + 1]);
        acc[4 * m + 2] = fmaf(p, vv.z, acc[4 * m + 2]);
        acc[4 * m + 3] = fmaf(p, vv.w, acc[4 * m + 3]);
      }
    }
  }

  if (qpos < S) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* ob = o + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int m = 0; m < NCHUNK; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&ob[4 * j + 4 * TPR * m + e], acc[4 * m + e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV,
                   const long long* st, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H / KV,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int Tk, int H, int KV,
                        const long long* st, int causal, int window,
                        float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, KV, st, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, KV, st, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, KV, st, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, KV, st, causal, window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
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
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_hd<float>(hd, q, k, v, o, B, S, Tk, H, KV, strides,
                                  causal, window, softcap, scale, st));
  if (dtype == 1)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, Tk, H, KV,
                                          strides, causal, window, softcap,
                                          scale, st));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
