// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++ behind a C interface.
//
// Replaces repro/kernels/ssd_scan.py:_ssd_kernel (the Pallas TPU kernel under
// `ssd_scan`, pallas_call at line 90). Same function: for each (batch b,
// head h) and chunk of Q positions, with dA = dt * A and csum its prefix sum
// inside the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(csum_i - csum_j) x_j dt_j      (intra)
//         + exp(csum_i) C_i . state^T                                  (inter)
//   state <- exp(csum_last) state + sum_j exp(csum_last - csum_j) (x_j dt_j) B_j^T
// with an f32 [P, N] state carried across chunks from zero. B and C are
// shared by all heads (one group). Inputs and output are f32.
//
// Bound at the serving slice's shape (mamba2-370m prefill: B=4, S=1024,
// H=32, P=64, N=128, Q=128): C.B^T over the causal half once per
// (b, chunk), as all heads share B and C, then per (b, h, chunk) its
// product with x, C@state^T and the state update:
//   operations: 5.44 GFLOP -> 0.081 ms at 67 TFLOP/s (f32, CUDA cores)
//   bytes:      x and y (33.6 MB each), B and C (2.1 MB each), dt (0.5 MB),
//               the final state (4.2 MB)                          ~ 76 MB
//               -> ~23 us at 3.35 TB/s
// so the kernel is bound by operations. This first version does every
// product as scalar f32 FMAs from shared memory, and each (b, h) block
// recomputes the chunk's C.B^T (2.10 GFLOP more than the bound counts);
// tensor cores (TF32 mma / wgmma), scores shared across heads and a
// chunk-parallel two-pass scan are a later PR's work.
//
// Design (not the TPU grid carried over): Pallas runs the chunk axis in
// order and keeps the state in VMEM scratch. CUDA blocks run in no order,
// so one block of 256 threads owns one (b, h) and loops over its chunks,
// with the state in shared memory (32 KB at P=64, N=128). A whole chunk's
// scores (Q x Q) do not fit beside B, x and the state, so the chunk's rows
// are walked in blocks of 32: each row block computes its 32 x (r0 + 32)
// slice of C.B^T (columns above the block's diagonal are never visited),
// then its 32 rows of output. After the last row block the state is
// updated in place. Q is the caller's chunk (1..128); a ragged last chunk
// and the chunk's padding up to a multiple of 32 are masked: padded
// positions get dt = 0, x = 0, B = C = 0, so they add nothing to the state
// and their output is not written. The chunk's prefix sum of dt * A is
// carried in double: it reaches ~-100 over 128 steps at the serving shape,
// where f32 would put errors of ~1e-4 into y at S = 1024 (the Pallas
// kernel sums in f32).
//
// C interface (bound with ctypes): repro_ssd_scan_fwd returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int R = 32;      // rows of a chunk per row block
constexpr int QMAX = 128;  // largest chunk

__host__ __device__ constexpr int round_up32(int q) { return (q + 31) / 32 * 32; }

// Shared memory, in floats. Row strides of N + 4 keep float4 rows 16-byte
// aligned and put the 8 lanes of a quarter warp on distinct bank groups.
template <int P, int N>
struct Layout {
  static constexpr int LDB = N + 4;
  __host__ __device__ static constexpr int LDS(int qp) { return qp + 1; }
  __host__ __device__ static constexpr size_t floats(int qp) {
    return size_t(qp) * LDB        // B of the chunk      [Qp][N]
         + size_t(R) * LDB         // C of the row block  [R][N]
         + size_t(qp) * P          // x * dt              [Qp][P]
         + size_t(P) * LDB         // state               [P][N]
         + size_t(R) * LDS(qp)     // masked scores       [R][Qp]
         + 3 * size_t(qp);         // csum (double), decay to the chunk's end
  }
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int Q,
                long long x_sb, long long x_ss, long long x_sh,
                long long dt_sb, long long dt_ss,
                long long b_sb, long long b_ss,
                long long c_sb, long long c_ss,
                long long y_sb, long long y_ss, long long y_sh) {
  static_assert(P % 4 == 0 && N % 4 == 0, "P and N must be multiples of 4");
  using L = Layout<P, N>;
  constexpr int LDB = L::LDB;
  constexpr int N4 = N / 4;
  constexpr int P4 = P / 4;
  const int Qp = round_up32(Q);
  const int LDS = L::LDS(Qp);

  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);
  float* sC = sB + Qp * LDB;
  float* sX = sC + R * LDB;
  float* sState = sX + Qp * P;
  float* sS = sState + P * LDB;
  double* sCs = reinterpret_cast<double*>(sS + R * LDS);  // offset is even
  float* sW = reinterpret_cast<float*>(sCs + Qp);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];

  x += b * x_sb + h * x_sh;
  dt += b * dt_sb + h;
  Bm += b * b_sb;
  Cm += b * c_sb;
  y += b * y_sb + h * y_sh;

  for (int i = tid; i < P * LDB; i += NTHREADS) sState[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int nv = min(Q, S - t0);  // valid positions of this chunk

    // ---- load dt, x*dt and B; padded positions are zero ----
    for (int j = tid; j < Qp; j += NTHREADS)
      sW[j] = j < nv ? dt[(t0 + j) * dt_ss] : 0.f;
    __syncthreads();
    for (int i = tid; i < Qp * P; i += NTHREADS) {
      const int j = i / P, p = i % P;
      sX[i] = j < nv ? x[(t0 + j) * x_ss + p] * sW[j] : 0.f;
    }
    for (int i = tid; i < Qp * N; i += NTHREADS) {
      const int j = i / N, n = i % N;
      sB[j * LDB + n] = j < nv ? Bm[(t0 + j) * b_ss + n] : 0.f;
    }
    // ---- csum = prefix sum of dt * A: one warp, Qp / 32 values a lane.
    // In double: csum reaches ~-100 over a chunk, where an f32 sum would
    // lose ~1e-5 of every exp(csum_i - csum_j) the chunk uses. ----
    if (warp == 0) {
      const int per = Qp / 32;
      double run = 0.0;
      for (int e = 0; e < per; ++e) {
        run += double(sW[lane * per + e]) * double(a);
        sCs[lane * per + e] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const double excl = incl - run;
      for (int e = 0; e < per; ++e) sCs[lane * per + e] += excl;
    }
    __syncthreads();
    const double total = sCs[Qp - 1];
    for (int j = tid; j < Qp; j += NTHREADS) sW[j] = expf(float(total - sCs[j]));

    // ---- the chunk's rows, 32 at a time ----
    for (int r0 = 0; r0 < nv; r0 += R) {
      for (int i = tid; i < R * N; i += NTHREADS) {
        const int ii = i / N, n = i % N;
        sC[ii * LDB + n] = r0 + ii < nv ? Cm[(t0 + r0 + ii) * c_ss + n] : 0.f;
      }
      __syncthreads();

      // scores[ii][j] = C_i . B_j for j < r0 + 32: thread (warp, lane) owns
      // rows warp + 8k and columns lane + 32m
      const int M = r0 / 32 + 1;
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;
      for (int n4 = 0; n4 < N4; ++n4) {
        float4 c[4], bb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[k] = reinterpret_cast<const float4*>(sC + (warp + 8 * k) * LDB)[n4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (m < M)
            bb[m] = reinterpret_cast<const float4*>(sB + (lane + 32 * m) * LDB)[n4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m < M) acc[k][m] = dot4(c[k], bb[m], acc[k][m]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ii = warp + 8 * k, i = r0 + ii;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = lane + 32 * m;
          if (m < M)
            sS[ii * LDS + j] = j <= i ? acc[k][m] * expf(float(sCs[i] - sCs[j])) : 0.f;
        }
      }
      __syncthreads();

      // output: lane = row, each warp takes groups of 4 columns of P
      {
        const int ii = lane, i = r0 + ii;
        const float e = expf(float(sCs[i]));
        const int jend = r0 + R;
        for (int g = warp; g < P4; g += NWARPS) {
          float4 intra = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int j = 0; j < jend; ++j) {
            const float s = sS[ii * LDS + j];
            const float4 xv = reinterpret_cast<const float4*>(sX + j * P)[g];
            intra.x = fmaf(s, xv.x, intra.x);
            intra.y = fmaf(s, xv.y, intra.y);
            intra.z = fmaf(s, xv.z, intra.z);
            intra.w = fmaf(s, xv.w, intra.w);
          }
          float inter[4] = {0.f, 0.f, 0.f, 0.f};
          const float4* crow = reinterpret_cast<const float4*>(sC + ii * LDB);
          for (int n4 = 0; n4 < N4; ++n4) {
            const float4 cv = crow[n4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              inter[q] = dot4(cv, reinterpret_cast<const float4*>(
                                      sState + (4 * g + q) * LDB)[n4], inter[q]);
          }
          if (i < nv) {
            float* yr = y + (t0 + i) * y_ss + 4 * g;
            yr[0] = fmaf(e, inter[0], intra.x);
            yr[1] = fmaf(e, inter[1], intra.y);
            yr[2] = fmaf(e, inter[2], intra.z);
            yr[3] = fmaf(e, inter[3], intra.w);
          }
        }
      }
      __syncthreads();
    }

    // ---- state <- exp(total) state + sum_j w_j (x_j dt_j) B_j^T ----
    {
      const float decay = expf(float(total));
      for (int it = tid; it < P4 * N4; it += NTHREADS) {
        const int g = it / N4, n4 = it % N4;
        float4 acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 s = reinterpret_cast<const float4*>(sState + (4 * g + q) * LDB)[n4];
          acc[q] = make_float4(s.x * decay, s.y * decay, s.z * decay, s.w * decay);
        }
        for (int j = 0; j < nv; ++j) {
          const float w = sW[j];
          const float4 xv = reinterpret_cast<const float4*>(sX + j * P)[g];
          const float4 bv = reinterpret_cast<const float4*>(sB + j * LDB)[n4];
          const float xs[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q].x = fmaf(xs[q], bv.x, acc[q].x);
            acc[q].y = fmaf(xs[q], bv.y, acc[q].y);
            acc[q].z = fmaf(xs[q], bv.z, acc[q].z);
            acc[q].w = fmaf(xs[q], bv.w, acc[q].w);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<float4*>(sState + (4 * g + q) * LDB)[n4] = acc[q];
      }
    }
    __syncthreads();
  }

  if (state_out != nullptr) {
    float* so = state_out + (size_t(b) * H + h) * P * N;
    for (int i = tid; i < P * N; i += NTHREADS)
      so[i] = sState[(i / N) * LDB + i % N];
  }
}

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* state_out,
                   int B, int S, int H, int Q, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = Layout<P, N>::floats(round_up32(Q)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<P, N><<<B * H, NTHREADS, smem, stream>>>(
      x, dt, A, Bm, Cm, y, state_out, S, H, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y,
                       float* state_out, int B, int S, int H, int Q,
                       const long long* st, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<P, 8>(x, dt, A, Bm, Cm, y, state_out, B, S, H, Q, st, stream);
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, y, state_out, B, S, H, Q, st, stream);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, y, state_out, B, S, H, Q, st, stream);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, y, state_out, B, S, H, Q, st, stream);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, y, state_out, B, S, H, Q, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All tensors f32. strides: 12 element strides, in order x (batch, seq,
// head), dt (batch, seq), B (batch, seq), C (batch, seq), y (batch, seq,
// head); the last dimension of each is contiguous, dt's is the head.
// state_out: [B, H, P, N] contiguous, or null.
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state_out,
                       int B, int S, int H, int P, int N, int chunk,
                       const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > QMAX)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return int(dispatch_n<16>(N, xf, dtf, af, bf, cf, yf, sf, B, S, H, chunk, strides, st));
    case 32: return int(dispatch_n<32>(N, xf, dtf, af, bf, cf, yf, sf, B, S, H, chunk, strides, st));
    case 64: return int(dispatch_n<64>(N, xf, dtf, af, bf, cf, yf, sf, B, S, H, chunk, strides, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
