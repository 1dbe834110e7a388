// Mamba-2 SSD within one chunk, for sm_90a, in bf16 and f32.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssd/kernel.py  ssd_intra_chunk (:61), pallas_call
//   (:75), body _ssd_chunk_kernel (:29)
// For one (batch b, head h, chunk c of Q tokens), with cum the prefix sum
// of a = dt * A over the chunk:
//   y     = ((C B^T) .* exp(cum_i - cum_j) [j > i masked before the exp]
//            .* dt_j) @ x                                      (Q, hd)
//   S_loc = B^T @ (x .* dt .* exp(cum_last - cum))             (N, hd) f32
//   dec   = exp(cum_last)
// with the TPU kernel's rounding points: f32 scores, w rounded to x's type
// before w @ x (f32 accumulation), y rounded to x's type, S_loc in f32.
// Unlike the TPU kernel it reads x, a and dt through strides, so the
// model's sequence-major (B, S, H, hd) activations go in as they are and y
// comes out sequence-major: no transposes of x or y in device memory.
//
// Bound: bytes.  Per (b, h, c) at Q 256, N 128, hd 64 the block reads x
// (32 KB bf16) and writes y (32 KB) and S_loc (32 KB f32); B and C are
// shared by the 64 heads of a (b, c), so device memory sees them once.
// The products come to ~17 MFLOP per block against ~100 KB, about 170
// flops per byte, below the card's ~295 bf16 flops per byte.  So the
// design moves each byte once and keeps every intermediate on chip:
//   * bf16: one block of 4 warps per (b, h, c), heads fastest in the grid
//     so the blocks of one (b, c) share B and C in L2.  The whole chunk's
//     B (row-major) and x (transposed) are staged in shared memory once;
//     the (Q, Q) scores, decays and weights never leave registers.  Each
//     warp owns 16-row query tiles (zig-zag, so the causal triangle is
//     shared evenly), keeps their C fragments in registers, and walks the
//     16-key tiles at or below the diagonal only: C B^T and w @ x are
//     mma.sync m16n8k16 (bf16 in, f32 accumulate; B and C are bf16, so the
//     scores are the reference's f32 scores up to summation order).  The
//     score accumulator's layout is the A operand's, so w is rounded to
//     bf16 in registers.  S_loc's right operand is f32 in the reference;
//     here B .* dt .* decay is split into bf16 hi + lo (relative residue
//     ~2^-17) and both halves go through the tensor cores against x.
//   * f32 (the checking path; no tensor core takes f32 at full
//     precision): shared-memory tiles of 64 rows and f32 FMAs throughout.
// A simple first design: no cp.async / TMA pipelining, no wgmma, no
// sharing of C B^T across heads (later work, see PERF.md).
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a size it was not built for).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;  // the TPU kernel's mask value

struct Params {
  const float* a;
  const float* dt;
  const void* Bm;
  const void* Cm;
  const void* x;
  void* y;
  float* s_loc;  // (B, H, nc, N, hd), dense
  float* dec;    // (B, H, nc), dense
  int B, H, nc;
  long long a_sb, a_sh, a_sc, a_sq;  // strides in elements
  long long d_sb, d_sh, d_sc, d_sq;
  long long b_sb, b_sc, b_sq;        // Bm, Cm: the last dim is 1
  long long c_sb, c_sc, c_sq;
  long long x_sb, x_sh, x_sc, x_sq;  // x, y: the last dim is 1
  long long y_sb, y_sh, y_sc, y_sq;
};

struct Chunk {
  int b, h, c;
};

// Heads vary fastest over the grid: the blocks of one (b, c) run together.
__device__ __forceinline__ Chunk chunk_of(const Params& p) {
  const int bid = blockIdx.x;
  const int rest = bid / p.H;
  return {rest / p.nc, bid % p.H, rest % p.nc};
}

// cum (inclusive prefix sum of a), dts = dt and sdec = dt * exp(cum_last -
// cum) for the chunk's Q rows, in f32, and dec = exp(cum_last).  One
// thread sums in order, as torch's scan along a strided dim does on the
// card: the cumulative decays come out bit for bit as the plain
// version's, whose rounding grows with |cum| (its ulp at |cum| ~ 10^3 is
// 6e-5, far above the f32 tolerance).
template <int Q>
__device__ void chunk_decays(const Params& p, const Chunk& k, float* cum,
                             float* dts, float* sdec) {
  const float* ap = p.a + k.b * p.a_sb + k.h * p.a_sh + k.c * p.a_sc;
  const float* dp = p.dt + k.b * p.d_sb + k.h * p.d_sh + k.c * p.d_sc;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    dts[i] = dp[i * p.d_sq];
    cum[i] = ap[i * p.a_sq];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
#pragma unroll 16
    for (int i = 0; i < Q; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
  const float last = cum[Q - 1];
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    sdec[i] = dts[i] * expf(last - cum[i]);
  if (threadIdx.x == 0)
    p.dec[(static_cast<long long>(k.b) * p.H + k.h) * p.nc + k.c] = expf(last);
  __syncthreads();
}

__device__ __forceinline__ float* s_loc_of(const Params& p, const Chunk& k,
                                           int N, int HD) {
  return p.s_loc +
         ((static_cast<long long>(k.b) * p.H + k.h) * p.nc + k.c) * N * HD;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, f32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Split f32 pairs into bf16 hi and lo halves: v0 ~ hi.x + lo.x.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

template <int Q, int N, int HD>
struct Bf16Smem {
  static constexpr int BSTR = N + 8;  // B row stride (bank padding)
  static constexpr int XSTR = Q + 8;  // x^T row stride
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (Q * BSTR + HD * XSTR) + sizeof(float) * 3 * Q;
};

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = A[g][2t:2t+2], a1 = A[g+8][2t:2t+2],
//                     a2 = A[g][2t+8:2t+10], a3 = A[g+8][2t+8:2t+10]
//   B (16 x 8, col):  b0 = B[2t:2t+2][g],  b1 = B[2t+8:2t+10][g]
//   C (16 x 8):       c0,c1 = C[g][2t:2t+2], c2,c3 = C[g+8][2t:2t+2]
template <int Q, int N, int HD>
__global__ void __launch_bounds__(128)
ssd_chunk_bf16(const Params p) {
  static_assert(Q % 32 == 0 && N % 16 == 0 && HD % 8 == 0, "tile sizes");
  using SM = Bf16Smem<Q, N, HD>;
  constexpr int BSTR = SM::BSTR, XSTR = SM::XSTR;
  constexpr int KN = N / 16;   // k-steps of C B^T
  constexpr int ND = HD / 8;   // n-tiles of y and S_loc
  constexpr int MQ = Q / 16;   // 16-row query tiles
  constexpr int MN = N / 16;   // 16-row tiles of S_loc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Q][BSTR]
  __nv_bfloat16* xT = Bs + Q * BSTR;                      // [HD][XSTR]
  auto* cum = reinterpret_cast<float*>(xT + HD * XSTR);
  float* dts = cum + Q;
  float* sdec = dts + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Chunk k = chunk_of(p);
  const auto* bp = static_cast<const __nv_bfloat16*>(p.Bm) + k.b * p.b_sb + k.c * p.b_sc;
  const auto* cp = static_cast<const __nv_bfloat16*>(p.Cm) + k.b * p.c_sb + k.c * p.c_sc;
  const auto* xp = static_cast<const __nv_bfloat16*>(p.x) + k.b * p.x_sb +
                   k.h * p.x_sh + k.c * p.x_sc;
  auto* yp = static_cast<__nv_bfloat16*>(p.y) + k.b * p.y_sb + k.h * p.y_sh +
             k.c * p.y_sc;

  // stage the chunk: B row-major, x transposed, 8 values per load
  for (int i = tid; i < Q * N / 8; i += 128) {
    const int r = i / (N / 8), n = (i % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(&Bs[r * BSTR + n]) =
        *reinterpret_cast<const uint4*>(bp + r * p.b_sq + n);
  }
  for (int i = tid; i < Q * HD / 8; i += 128) {
    const int r = i / (HD / 8), d = (i % (HD / 8)) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(xp + r * p.x_sq + d);
    const auto* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) xT[(d + j) * XSTR + r] = e[j];
  }
  chunk_decays<Q>(p, k, cum, dts, sdec);  // ends in __syncthreads()

  // y: query tiles dealt zig-zag over the 4 warps
  for (int round = 0; round < (MQ + 3) / 4; ++round) {
    const int mt = (round & 1) ? round * 4 + 3 - warp : round * 4 + warp;
    if (mt >= MQ) continue;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    uint32_t cf[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const int col = kk * 16 + 2 * t;
      cf[kk][0] = ld32(cp + r0 * p.c_sq + col);
      cf[kk][1] = ld32(cp + r1 * p.c_sq + col);
      cf[kk][2] = ld32(cp + r0 * p.c_sq + col + 8);
      cf[kk][3] = ld32(cp + r1 * p.c_sq + col + 8);
    }
    const float cum0 = cum[r0], cum1 = cum[r1];
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kb = 0; kb <= mt; ++kb) {  // 16-key tiles at or below the diagonal
      const int j0 = kb * 16;
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* brow = &Bs[(j0 + nt * 8 + g) * BSTR + 2 * t];
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
          mma_bf16(s[nt], cf[kk], ld32(brow + kk * 16), ld32(brow + kk * 16 + 8));
      }
      // w = scores * exp(cum_i - cum_j, masked before the exp) * dt_j
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? r0 : r1;
          const int col = j0 + nt * 8 + 2 * t + (i & 1);
          const float e = row >= col ? (i < 2 ? cum0 : cum1) - cum[col] : NEG;
          s[nt][i] = s[nt][i] * __expf(e) * dts[col];
        }
      }
      // the C fragments of the two key n-tiles are the A fragment of w,
      // rounded to bf16 as the TPU kernel rounds w to x's type
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* xrow = &xT[(n * 8 + g) * XSTR + j0 + 2 * t];
        mma_bf16(acc[n], a, ld32(xrow), ld32(xrow + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(yp + r0 * p.y_sq + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(yp + r1 * p.y_sq + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }

  // S_loc = (B .* sdec)^T @ x: state rows n as M, tokens j as K; the f32
  // left operand goes in as bf16 hi + lo
  float* sp = s_loc_of(p, k, N, HD);
  for (int mt = warp; mt < MN; mt += 4) {
    const int n0 = mt * 16 + g, n1 = n0 + 8;
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += 16) {
      const int ja = j0 + 2 * t, jb = ja + 8;
      const float w0 = sdec[ja], w1 = sdec[ja + 1], w2 = sdec[jb], w3 = sdec[jb + 1];
      auto bv = [&](int j, int n) { return __bfloat162float(Bs[j * BSTR + n]); };
      uint32_t hi[4], lo[4];
      split_pair(bv(ja, n0) * w0, bv(ja + 1, n0) * w1, hi[0], lo[0]);
      split_pair(bv(ja, n1) * w0, bv(ja + 1, n1) * w1, hi[1], lo[1]);
      split_pair(bv(jb, n0) * w2, bv(jb + 1, n0) * w3, hi[2], lo[2]);
      split_pair(bv(jb, n1) * w2, bv(jb + 1, n1) * w3, hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* xrow = &xT[(n * 8 + g) * XSTR + ja];
        const uint32_t b0 = ld32(xrow), b1 = ld32(xrow + 8);
        mma_bf16(acc[n], hi, b0, b1);
        mma_bf16(acc[n], lo, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(sp + n0 * HD + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(sp + n1 * HD + col) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiles of T rows, FMAs in f32
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int Q, int N, int HD>
struct F32Smem {
  static constexpr int T = Q < 64 ? Q : 64;  // query and key tile rows
  static constexpr size_t bytes =
      sizeof(float) * (3 * Q + 2 * T * (N + 1) + T * HD + T * (T + 1));
};

template <int Q, int N, int HD>
__global__ void __launch_bounds__(F32_THREADS)
ssd_chunk_f32(const Params p) {
  using SM = F32Smem<Q, N, HD>;
  constexpr int T = SM::T, NS = N + 1, WS = T + 1;
  constexpr int YPT = (T * HD + F32_THREADS - 1) / F32_THREADS;
  constexpr int SPT = (N * HD + F32_THREADS - 1) / F32_THREADS;
  static_assert(Q % T == 0, "Q must be a multiple of the tile");
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;
  float* dts = cum + Q;
  float* sdec = dts + Q;
  float* Cs = sdec + Q;   // [T][NS]
  float* Bs = Cs + T * NS;  // [T][NS]
  float* Xs = Bs + T * NS;  // [T][HD]
  float* Ws = Xs + T * HD;  // [T][WS]

  const int tid = threadIdx.x;
  const Chunk k = chunk_of(p);
  const float* bp = static_cast<const float*>(p.Bm) + k.b * p.b_sb + k.c * p.b_sc;
  const float* cp = static_cast<const float*>(p.Cm) + k.b * p.c_sb + k.c * p.c_sc;
  const float* xp = static_cast<const float*>(p.x) + k.b * p.x_sb +
                    k.h * p.x_sh + k.c * p.x_sc;
  float* yp = static_cast<float*>(p.y) + k.b * p.y_sb + k.h * p.y_sh + k.c * p.y_sc;
  chunk_decays<Q>(p, k, cum, dts, sdec);

  // y, one T-row query tile at a time over the key tiles at or below it
  for (int q0 = 0; q0 < Q; q0 += T) {
    for (int i = tid; i < T * N; i += F32_THREADS)
      Cs[(i / N) * NS + i % N] = cp[(q0 + i / N) * p.c_sq + i % N];
    float acc[YPT];
#pragma unroll
    for (int r = 0; r < YPT; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 <= q0; k0 += T) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < T * N; i += F32_THREADS)
        Bs[(i / N) * NS + i % N] = bp[(k0 + i / N) * p.b_sq + i % N];
      for (int i = tid; i < T * HD; i += F32_THREADS)
        Xs[i] = xp[(k0 + i / HD) * p.x_sq + i % HD];
      __syncthreads();
      for (int e = tid; e < T * T; e += F32_THREADS) {
        const int i = e / T, j = e % T, row = q0 + i, col = k0 + j;
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(Cs[i * NS + n], Bs[j * NS + n], s);
        const float ex = row >= col ? cum[row] - cum[col] : NEG;
        Ws[i * WS + j] = s * expf(ex) * dts[col];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < YPT; ++r) {
        const int e = tid + r * F32_THREADS;
        if (e < T * HD) {
          const int i = e / HD, d = e % HD;
          float v = acc[r];
          for (int j = 0; j < T; ++j) v = fmaf(Ws[i * WS + j], Xs[j * HD + d], v);
          acc[r] = v;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < YPT; ++r) {
      const int e = tid + r * F32_THREADS;
      if (e < T * HD) yp[(q0 + e / HD) * p.y_sq + e % HD] = acc[r];
    }
    __syncthreads();  // Cs is restaged next
  }

  // S_loc[n][d] = sum_j B[j][n] * (x[j][d] * sdec[j])
  float sacc[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r) sacc[r] = 0.f;
  for (int k0 = 0; k0 < Q; k0 += T) {
    __syncthreads();
    for (int i = tid; i < T * N; i += F32_THREADS)
      Bs[(i / N) * NS + i % N] = bp[(k0 + i / N) * p.b_sq + i % N];
    for (int i = tid; i < T * HD; i += F32_THREADS)
      Xs[i] = xp[(k0 + i / HD) * p.x_sq + i % HD] * sdec[k0 + i / HD];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int e = tid + r * F32_THREADS;
      if (e < N * HD) {
        const int n = e / HD, d = e % HD;
        float v = sacc[r];
        for (int j = 0; j < T; ++j) v = fmaf(Bs[j * NS + n], Xs[j * HD + d], v);
        sacc[r] = v;
      }
    }
  }
  float* sp = s_loc_of(p, k, N, HD);
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int e = tid + r * F32_THREADS;
    if (e < N * HD) sp[e] = sacc[r];
  }
}

template <int Q, int N, int HD>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  const dim3 grid(p.B * p.H * p.nc);
  cudaError_t err;
  if (bf16) {
    constexpr size_t smem = Bf16Smem<Q, N, HD>::bytes;
    err = cudaFuncSetAttribute(ssd_chunk_bf16<Q, N, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_chunk_bf16<Q, N, HD><<<grid, 128, smem, stream>>>(p);
  } else {
    constexpr size_t smem = F32Smem<Q, N, HD>::bytes;
    err = cudaFuncSetAttribute(ssd_chunk_f32<Q, N, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_chunk_f32<Q, N, HD><<<grid, F32_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_intra_chunk(
    const void* a, const void* dt, const void* Bm, const void* Cm,
    const void* x, void* y, void* s_loc, void* dec, int bf16, int B, int H,
    int nc, int Q, int N, int hd, long long a_sb, long long a_sh,
    long long a_sc, long long a_sq, long long d_sb, long long d_sh,
    long long d_sc, long long d_sq, long long b_sb, long long b_sc,
    long long b_sq, long long c_sb, long long c_sc, long long c_sq,
    long long x_sb, long long x_sh, long long x_sc, long long x_sq,
    long long y_sb, long long y_sh, long long y_sc, long long y_sq,
    void* stream) {
  const Params p{static_cast<const float*>(a), static_cast<const float*>(dt),
                 Bm, Cm, x, y, static_cast<float*>(s_loc),
                 static_cast<float*>(dec), B, H, nc,
                 a_sb, a_sh, a_sc, a_sq, d_sb, d_sh, d_sc, d_sq,
                 b_sb, b_sc, b_sq, c_sb, c_sc, c_sq,
                 x_sb, x_sh, x_sc, x_sq, y_sb, y_sh, y_sc, y_sq};
  auto st = static_cast<cudaStream_t>(stream);
  if (Q == 256 && N == 128 && hd == 64) return launch<256, 128, 64>(p, bf16, st);
  if (Q == 32 && N == 16 && hd == 16) return launch<32, 16, 16>(p, bf16, st);
  return cudaErrorInvalidValue;
}
