// Flash-attention forward at head_dims above 256 (the `wide` route), CUDA
// C++ for Hopper (sm_90a) behind a C interface.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel under `flash_attention`, pallas_call at line 136) for the head_dims
// that the other two routes do not take: the Pallas kernel's block is
// (1, bq, hd), so it takes any head_dim. Same function: GQA attention
// [B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd], scale 1/sqrt(hd), tanh softcap
// before the causal / sliding-window masks, f32 scores, online softmax and
// accumulators, output in q's type; a row with no visible key gives 0.
//
// A simple kernel that is right first; it is not tuned. A block of 128
// threads owns 16 query rows of one (batch, head) and up to 256 output
// columns (gridDim.z splits wider head_dims into column slices, each
// recomputing the scores). For each tile of 32 keys:
//  - S = Q K^T is summed over head_dim in slices of 64 columns staged in
//    shared memory (Q rows and K rows padded to 65 floats so that a warp's
//    reads hit distinct banks); each thread owns one query row and 4 keys;
//  - scale, softcap and masks; the online softmax in f32 with the row max
//    and sum reduced across the 8 threads of a row by shuffles; P goes to
//    shared memory with each row's rescale factor;
//  - O = O * alpha + P V over the block's columns, V staged 64 columns at a
//    time; each thread owns one column of each 64 and 8 rows, in registers.
// Masked scores are -inf; a row whose visible keys are all still to come
// keeps max -inf and adds nothing, and a row that never sees a key writes 0.
// Key tiles that no row of the block can see (causal, window) are skipped.
// Loads and stores are element by element through the strides, so any
// [B, L, N, hd] view with a contiguous head_dim works.
//
// C interface (bound with ctypes): repro_flash_attention_wide_fwd returns
// the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads a block
constexpr int BQ = 16;   // query rows a block
constexpr int BK = 32;   // keys a tile
constexpr int DS = 64;   // head_dim columns staged for Q K^T
constexpr int DV = 256;  // output columns a block
constexpr int NPART = DV / 64;

struct Params {
  const void *q, *k, *v;
  void* o;
  int S, Tk, H, group, hd, causal, window;
  float softcap, scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_wide_kernel(Params p) {
  __shared__ float qs[BQ][DS + 1];
  __shared__ float ks[BK][DS + 1];
  __shared__ float vs[BK][64];
  __shared__ float ps[BQ][BK];
  __shared__ float alpha_s[BQ];
  __shared__ float l_s[BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.group;
  const int c0 = blockIdx.z * DV;  // first output column of the block
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // scores: row sr, keys sc + 8 j
  const int sr = tid >> 3, sc = tid & 7;
  const int qrow = q0 + sr;
  // output: column oc of each 64-column part, rows orow + 2 i
  const int oc = tid & 63, orow = tid >> 6;
  float acc[NPART][BQ / 2];
#pragma unroll
  for (int part = 0; part < NPART; ++part)
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) acc[part][i] = 0.f;
  float m = -INFINITY, l = 0.f;

  // keys some row of the block may see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_hi = p.causal ? min(p.Tk, q_last + 1) : p.Tk;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < p.hd; d0 += DS) {
      for (int i = tid; i < BQ * DS; i += NT) {
        const int r = i / DS, c = i % DS, row = q0 + r, d = d0 + c;
        qs[r][c] = row < p.S && d < p.hd ? to_f(q[row * p.q_ss + d]) : 0.f;
      }
      for (int i = tid; i < BK * DS; i += NT) {
        const int r = i / DS, c = i % DS, row = t0 + r, d = d0 + c;
        ks[r][c] = row < p.Tk && d < p.hd ? to_f(k[row * p.k_ss + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DS; ++c) {
        const float qv = qs[sr][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qv, ks[sc + 8 * j][c], s[j]);
      }
      __syncthreads();
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = t0 + sc + 8 * j;
      float x = s[j] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      bool ok = key < p.Tk && qrow < p.S;
      if (p.causal) ok = ok && key <= qrow;
      if (p.window > 0) ok = ok && key > qrow - p.window;
      s[j] = ok ? x : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    float alpha = 1.f, rsum = 0.f;
    if (m_new != -INFINITY) {
      alpha = expf(m - m_new);  // 0 while m is -inf
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = expf(s[j] - m_new);
        rsum += s[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = 0.f;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l = l * alpha + rsum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[sr][sc + 8 * j] = s[j];
    if (sc == 0) alpha_s[sr] = alpha;
    __syncthreads();

#pragma unroll
    for (int part = 0; part < NPART; ++part) {
      const int col0 = c0 + part * 64;
      if (col0 >= p.hd) break;  // uniform over the block
      for (int i = tid; i < BK * 64; i += NT) {
        const int r = i / 64, c = i % 64, row = t0 + r, d = col0 + c;
        vs[r][c] = row < p.Tk && d < p.hd ? to_f(v[row * p.v_ss + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = orow + 2 * i;
        float a = acc[part][i] * alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(ps[r][j], vs[j][oc], a);
        acc[part][i] = a;
      }
      __syncthreads();
    }
  }

  if (sc == 0) l_s[sr] = l;
  __syncthreads();
#pragma unroll
  for (int part = 0; part < NPART; ++part) {
    const int col = c0 + part * 64 + oc;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = orow + 2 * i, row = q0 + r;
      if (row < p.S && col < p.hd) {
        const float lv = l_s[r];
        store(o + row * p.o_ss + col, lv > 0.f ? acc[part][i] / lv : 0.f);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.S + BQ - 1) / BQ, B * p.H, (p.hd + DV - 1) / DV);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  flash_fwd_wide_kernel<T><<<grid, NT, 0, stream>>>(p);
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
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.S = S; p.Tk = Tk; p.H = H; p.group = H / KV; p.hd = hd;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch<float>(p, B, st) : launch<__nv_bfloat16>(p, B, st));
}

const char* repro_wide_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
