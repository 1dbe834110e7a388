// Mamba-1's selective scan over time, for sm_90a, with x, B and C in bf16
// or f32 and every product and sum in f32.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as one
// lax.scan over time in mamba1_forward (src/repro/models/ssm.py:256-269),
// which XLA compiles into one device loop.  In eager PyTorch each step
// is about eight launches on a (B, d_inner, N) state (ref.py), some
// 262,000 launches for one sublayer's prefill of 2 x 32,768 tokens, and
// the host's launch rate, not the card, sets its time.  For batch row b,
// channel c and state n, from h = 0:
//   h_t[n] = exp(dt_t[c] * A[c, n]) * h_{t-1}[n] + (dt_t[c] * B_t[n]) * x_t[c]
//   y_t[c] = sum_n h_t[n] * C_t[n]
// with the reference's operand order and rounding points: dt * A rounds
// before the exp (expf, as torch.exp computes it on the card), dt * B
// before * x, dA * h before + dBx (no fused multiply-add: __fmul_rn and
// __fadd_rn), and y is a dot product over n accumulated in f32.  y leaves
// in f32 (B, S, D) and the final state in f32 (B, D, N).
//
// Bound.  At the serving shape (B 2, S 32,768, D 16,384, N 16) the kernel
// reads x (2.1 GB bf16) and dt (4.3 GB f32) and writes y (4.3 GB f32),
// 10.7 GB or 3.2 ms at 3.35 TB/s; it takes B * S * D * N = 1.72e10
// exponentials, 4.4 ms on the special-function units (16 a clock an SM,
// 132 SMs, 1.83 GHz).  So the exponentials bound it; the latency floor
// is one dependent update of h a step, S steps in order.
//
// Design, simple first: one thread per (b, c) holds its N states and its
// row of A in registers and walks t in order; a block scans CHANNELS
// consecutive channels of one batch row.  For each tile of TILE steps the
// block stages x and dt (each thread its own channel: loads coalesced
// along channels, TILE of them in flight a thread) and B_t and C_t
// (shared by all channels of the row) in shared memory, converted to f32,
// then runs the tile's steps from shared memory.  B * D = 32,768 threads
// at the serving shape fill 8 warps an SM; wgmma, TMA and a chunked
// parallel form of the scan are for a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHANNELS = 64;   // threads (channels) a block
constexpr int TILE = 64;       // time steps staged at once

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* h_out;
  int S, D;
  long long x_sb, x_ss, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(CHANNELS) selective_scan_kernel(Params p) {
  __shared__ float s_x[TILE][CHANNELS];
  __shared__ float s_dt[TILE][CHANNELS];
  __shared__ float s_B[TILE][N];
  __shared__ float s_C[TILE][N];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int c = blockIdx.x * CHANNELS + tid;
  const bool live = c < p.D;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb;
  const float* dt = p.dt + b * p.d_sb;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.c_sb;
  float* y = p.y + b * p.S * p.D;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? p.A[static_cast<long long>(c) * N + n] : 0.f;
    h[n] = 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += TILE) {
    const int steps = min(TILE, p.S - t0);
    __syncthreads();  // the previous tile is consumed
    if (live) {
#pragma unroll 8
      for (int j = 0; j < steps; ++j) {
        const long long t = t0 + j;
        s_x[j][tid] = to_f32(x[t * p.x_ss + c]);
        s_dt[j][tid] = dt[t * p.d_ss + c];
      }
    }
    for (int i = tid; i < steps * N; i += CHANNELS) {
      const int j = i / N, n = i % N;
      const long long t = t0 + j;
      s_B[j][n] = to_f32(Bm[t * p.b_ss + n]);
      s_C[j][n] = to_f32(Cm[t * p.c_ss + n]);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < steps; ++j) {
      const float xv = s_x[j][tid], dv = s_dt[j][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dA = expf(__fmul_rn(dv, a[n]));
        const float dBx = __fmul_rn(__fmul_rn(dv, s_B[j][n]), xv);
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
        acc = fmaf(h[n], s_C[j][n], acc);
      }
      y[static_cast<long long>(t0 + j) * p.D + c] = acc;
    }
  }
  if (live) {
    float* h_out = p.h_out + (b * p.D + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[n] = h[n];
  }
}

template <typename T>
int launch(const Params& p, int B, int N, cudaStream_t stream) {
  const dim3 grid((p.D + CHANNELS - 1) / CHANNELS, B);
  if (N == 16) {
    selective_scan_kernel<T, 16><<<grid, CHANNELS, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, Bm, Cm: bf16 (bf16 != 0) or f32, read through their batch and step
// strides with unit channel stride; dt f32 likewise; A (D, N) f32
// contiguous; y (B, S, D) and h (B, D, N) f32 contiguous.  Launches on
// ``stream``, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch.
extern "C" int selective_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* h, int bf16, int B, int S, int D, int N,
    long long x_sb, long long x_ss, long long d_sb, long long d_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return cudaErrorInvalidValue;
  const Params p{x, static_cast<const float*>(dt),
                 static_cast<const float*>(A), Bm, Cm,
                 static_cast<float*>(y), static_cast<float*>(h), S, D,
                 x_sb, x_ss, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss};
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, B, N, st)
              : launch<float>(p, B, N, st);
}
