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
// Bound: bytes.  At the serving shape (B 2, H 64, 128 chunks of Q 256, N
// 128, hd 64) the kernel reads x (0.54 GB bf16) and writes y (0.54 GB)
// and S_loc (0.54 GB f32); B and C are shared by the 64 heads of a (b,
// c), so device memory need see them once: 1.68 GB, 0.50 ms at 3.35 TB/s.
// The products are 0.28 TFLOP counted once and 0.36 as computed (C B^T
// for every head, S_loc in two halves), 0.3-0.4 ms at the bf16 peak, so
// both bounds stand near 0.5 ms and the design overlaps them and the
// exponentials.
//
// Each instance runs one of two bf16 bodies (Bf16Body below; ops.py's
// BF16_BODIES names the same):
//   * wgmma, the serving instance (Q 256, N 128, hd 64).  One block per
//     (b, c, group of G = 8 heads), groups fastest in the grid, so the
//     blocks of one (b, c) share B and C in L2; one block an SM.  Two
//     consumer warpgroups and a producer warpgroup (setmaxnreg: 240 and
//     24 registers a thread; the host refuses to launch a build whose
//     register count is not the block's share, which setmaxnreg.inc
//     counts on):
//     - TMA brings the chunk's C and B (2 x 64 KB, 128B-swizzled panels of
//       64 state columns) once per block, then each head's x tile (256
//       tokens x 64, 32 KB, through a 5-D map over the strided (hd, Q, nc,
//       H, B) view) into a ring of 2 stages with full/empty mbarriers;
//     - meanwhile the consumers stage a and dt of the G heads and scan
//       each head's cumulative decays in one thread, in order (the plain
//       version's order on the card: a tree order moves cum by its ulp,
//       6e-5 at |cum| ~ 10^3, far above the f32 tolerance), then write dt,
//       cum, sdec = dt exp(cum_last - cum) and the key factors below;
//     - both warpgroups work on the same head, so one x stage is in use
//       while the other fills.  Warpgroup 0 takes state rows 0-63 of S_loc
//       and then query tiles 0 and 3, warpgroup 1 query tiles 1 and 2 and
//       then state rows 64-127: equal work (5 score tiles and one S_loc
//       tile each), in phases that interleave;
//     - y: each warpgroup keeps its two query tiles' C in registers as
//       wgmma A fragments (ldmatrix through the swizzle) for all heads.
//       For each 64-key tile at or below the diagonal, s = C B^T is an RS
//       wgmma m64n64k16 with B K-major in shared memory, issued one tile
//       ahead; the weights are made in registers while it runs: on the
//       diagonal tile exp of the masked difference (masked before the
//       exp), below it exp(cum_i - cum_end) exp(cum_end - cum_j) with
//       cum_end the tile's last key (2 exponentials a thread instead of
//       32; the key factors, dt folded in, come from shared memory; each
//       factor is at most 1 as a = dt A is not positive).  w packed to
//       bf16 is the A fragment of y += w x (RS wgmma, x MN-major straight
//       from the TMA tile).  y goes out through shared memory (C's space,
//       free once C is in registers) by TMA stores of whole rows;
//     - S_loc = (B .* sdec)^T x: the A operand (state rows x tokens) comes
//       from the staged B by ldmatrix.trans through the 128B swizzle, is
//       scaled by sdec in f32 and split into bf16 hi + lo (relative
//       residue ~2^-17), and both halves go through RS wgmma against the
//       same x tile, 4 k-steps a group, each group's fragments built while
//       the previous group runs; out through shared memory by TMA too.
//     C B^T is recomputed for each head (0.146 TFLOP of the 0.36): the
//     causal triangle of f32 scores is 160 KB and fits neither beside B,
//     the x ring and the staged outputs in 227 KB nor in a warpgroup's
//     registers, and a build that skips the scores altogether bounds what
//     sharing could gain (PERF.md).
//   * mma.sync, the reduced config's instance (Q 32: below wgmma's 64
//     rows): one block of 4 warps per (b, h, c), B row-major and x
//     transposed in shared memory, mma.sync m16n8k16 for C B^T, w x and
//     the hi + lo S_loc, the scores never leaving registers.
// f32 (the checking path; no tensor core takes f32 at full precision):
// one block per (b, h, c), shared-memory tiles of 64 rows and f32 FMAs.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a size it was not built for or a layout
// TMA refuses, and cudaErrorInvalidDeviceFunction for a wgmma build with
// fewer registers than setmaxnreg.inc counts on).  The grid is
// one-dimensional.

#include "../../csrc/hopper.cuh"

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
// bf16, small chunks (Q 32): mma.sync m16n8k16, f32 accumulators, one
// block of 4 warps per (b, h, c)
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

// ---------------------------------------------------------------------------
// bf16, the serving chunk (Q 256, N 128, hd 64): TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int CONSUMER_THREADS = 256;  // 2 warpgroups, then the producer's
constexpr int WG_THREADS = CONSUMER_THREADS + 128;
constexpr int ROW_BYTES = 128;   // one 64-column bf16 panel row, the swizzle span
// registers a thread: at launch (one block an SM takes the whole file; the
// compiler must allocate exactly this, or setmaxnreg.inc would wait for
// registers that never come, so launch_bf16 checks it), the producer's
// after setmaxnreg.dec, and what that leaves each consumer thread
constexpr int LAUNCH_REGS = 65536 / WG_THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS =
    (WG_THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / CONSUMER_THREADS / 8 * 8;

// The shared-memory plan of the wgmma body for G heads a block, in bytes
// from a 1,024-aligned base: C and B as two panels of Q rows x 64 state
// columns each, a ring of 2 x tiles, dt, cum, sdec and the key factors of
// the G heads, then the barriers.
template <int Q, int N, int HD, int G>
struct WgmmaPlan {
  static_assert(Q == 256 && N == 128 && HD == 64,
                "the wgmma body is laid out for Q 256, N 128, hd 64");
  static constexpr int PANEL_BYTES = Q * ROW_BYTES;
  static constexpr int BLOCK_BYTES = 64 * ROW_BYTES;   // 64 rows of a panel
  static constexpr int BLOCKS = Q / 64;                // row blocks of B, C
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = C_OFF + 2 * PANEL_BYTES;
  static constexpr int X_BYTES = Q * HD * 2;
  // staged outputs, in C's place once C is in registers: y tiles (bf16)
  // and S_loc tiles (f32) of 64 rows, two of each a consumer warpgroup
  static constexpr int Y_BYTES = 64 * HD * 2;
  static constexpr int S_BYTES = 64 * HD * 4;
  static_assert(4 * Y_BYTES + 2 * S_BYTES <= 2 * PANEL_BYTES, "C's space");
  static constexpr int X_OFF = B_OFF + 2 * PANEL_BYTES;
  // dts, cum and sdec, [G][DSTR] each: 4 floats of padding a head put the
  // 8 heads' rows in different banks for the one-thread-a-head scan
  static constexpr int DSTR = Q + 4;
  static_assert(Q * G % CONSUMER_THREADS == 0, "the decays' staging");
  static constexpr int DEC_OFF = X_OFF + 2 * X_BYTES;
  // kf, [G][Q - 64]: exp(cum_end - cum_j) dt_j for key j of each 64-key
  // tile below the last, cum_end the cum of the tile's last key
  static constexpr int KF = Q - 64;
  static constexpr int KF_OFF = DEC_OFF + 3 * G * DSTR * 4;
  static constexpr int BAR_OFF = KF_OFF + G * KF * 4;
  // bc_full per row block; x_full and x_empty per stage
  static constexpr int BARS = BLOCKS + 4;
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;
};

// Tile kt's weights w = s .* exp(cum_i - cum_j) .* dt_j in place.  Element
// i of a thread's fragment lies in row row0 + 8 * ((i >> 1) & 1) and key
// col0 + 8 * (i >> 2) + (i & 1).
//   The diagonal tile: one exponential an element, of the difference
//   masked (key j > query i) before the exp.
__device__ __forceinline__ void diagonal_weights(float (&s)[32],
                                                 const float* cum,
                                                 const float* dts,
                                                 const float (&crow)[2],
                                                 int row0, int col0) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int col = col0 + 8 * k;
    const float2 cv = *reinterpret_cast<const float2*>(cum + col);
    const float2 dv = *reinterpret_cast<const float2*>(dts + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * k + e, hi = (e >> 1) & 1;
      const float cj = (e & 1) ? cv.y : cv.x, dj = (e & 1) ? dv.y : dv.x;
      const float w = s[i] * __expf(crow[hi] - cj) * dj;
      s[i] = col + (e & 1) > row0 + 8 * hi ? 0.f : w;
    }
  }
}
//   A tile wholly below the diagonal: exp(cum_i - cum_j) = exp(cum_i -
//   cum_end) exp(cum_end - cum_j), with cum_end the cum of the tile's
//   last key, so each factor is at most 1 (the decays a = dt A are not
//   positive: cum falls along the chunk) and only the row factor is a
//   thread's own (2 exponentials where the direct form takes 32); the key
//   factors kf (dt_j folded in) come from shared memory.
__device__ __forceinline__ void lower_weights(float (&s)[32], const float* kf,
                                              const float (&crow)[2],
                                              float cum_end, int col0) {
  const float rf[2] = {__expf(crow[0] - cum_end), __expf(crow[1] - cum_end)};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float2 f = *reinterpret_cast<const float2*>(kf + col0 + 8 * k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * k + e;
      s[i] = s[i] * rf[(e >> 1) & 1] * ((e & 1) ? f.y : f.x);
    }
  }
}

// s = C B^T for key tile kt (64 x 64, K = the N state columns in two
// swizzled panels), with the query tile's C in registers, issued and
// committed, not waited for.
template <class P>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint32_t (&cf)[8][4], int kt,
                                             uint32_t base) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // 16 state columns: panel kk / 4, a 32-byte step in its rows
    const uint32_t off = (kk / 4) * P::PANEL_BYTES + (kk % 4) * 32;
    wgmma_rs_k(s, cf[kk],
               smem_desc(base + P::B_OFF + off + kt * P::BLOCK_BYTES, 16,
                         8 * ROW_BYTES, 1),
               kk);
  }
  wg_commit();
}

// The query tile M's C as the A fragments of its 8 k-steps (16 state
// columns each): lane gives row lane % 8 of quarter lane / 8 of a 16 x 16
// block (rows + 8 (q & 1), columns + 8 (q >> 1)), through the swizzle.
template <class P>
__device__ __forceinline__ void load_c(uint32_t (&cf)[8][4], int M,
                                       uint32_t base) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane >> 3, row = 16 * warp + (lane & 7) + 8 * (q & 1);
  const uint32_t cp = base + P::C_OFF + M * P::BLOCK_BYTES + row * ROW_BYTES;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t chunk = 2 * (kk % 4) + (q >> 1);
    ldmatrix_x4(cf[kk], cp + (kk / 4) * P::PANEL_BYTES +
                            ((chunk ^ (lane & 7)) << 4));
  }
}

// A barrier of one consumer warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + threadIdx.x / 128) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(v0), "f"(v1) : "memory");
}

// y rows 64 M .. 64 M + 63 of head h, by one consumer warpgroup.  The key
// tiles are software-pipelined: tile kt + 1's scores and tile kt - 1's w x
// run on the tensor cores while this warpgroup turns tile kt's scores into
// weights.  Groups complete in commit order (S kt + 1 is committed before
// w x kt), so wg_wait<1> names the older of the two in flight.  y leaves
// through ``stage`` (8 KB of shared memory in TMA's 128B-swizzled layout)
// by one TMA store, whole 128-byte rows at a time.
template <class P, int M>
__device__ __forceinline__ void y_tile(uint32_t base, uint32_t xs,
                                       const uint32_t (&cf)[8][4],
                                       const float* cum, const float* dts,
                                       const float* kf, uint32_t stage,
                                       const CUtensorMap* ty, int b, int h,
                                       int c) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = 64 * M + 16 * warp + lane / 4;  // and row0 + 8
  const float crow[2] = {cum[row0], cum[row0 + 8]};
  float o[32], s[2][32];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[0][i] = s[1][i] = 0.f;
  hold(s[0]);
  issue_scores<P>(s[0], cf, 0, base);
#pragma unroll
  for (int kt = 0; kt <= M; ++kt) {
    const int cur = kt & 1;
    if (kt == 0) wg_wait<0>(); else wg_wait<1>();  // S kt (w x kt - 1 may run)
    hold(s[cur]);
    if (kt < M) {
      hold(s[cur ^ 1]);
      issue_scores<P>(s[cur ^ 1], cf, kt + 1, base);
    }
    const int col0 = 64 * kt + 2 * (lane & 3);
    if (kt == M)
      diagonal_weights(s[cur], cum, dts, crow, row0, col0);
    else
      lower_weights(s[cur], kf, crow, cum[64 * kt + 63], col0);
    if (kt > 0) {  // w x kt - 1 has read pa
      if (kt < M) wg_wait<1>(); else wg_wait<0>();
      hold(pa);
    }
    // w rounded to bf16, as the TPU kernel rounds it to x's type
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kc][j] = pack_bf16(s[cur][8 * kc + 2 * j], s[cur][8 * kc + 2 * j + 1]);
    hold(o);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs(o, pa[kc],
               smem_desc(xs + (64 * kt + 16 * kc) * ROW_BYTES, P::X_BYTES,
                         8 * ROW_BYTES, 1));
    wg_commit();
  }
  wg_wait<0>();
  hold(o);
  hold(pa);
  // the stage's previous store (a head ago) has read it: the bulk groups
  // of a warpgroup's thread 0 (three a head: two y tiles and S_loc)
  // complete in order, and two others are younger
  const bool issuer = threadIdx.x % 128 == 0;
  if (issuer) bulk_wait_read<2>();
  warpgroup_sync();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 - 64 * M + 8 * half;  // row in the tile
      st_shared(stage + r * ROW_BYTES + ((n ^ (r & 7)) << 4) + 4 * (lane & 3),
                pack_bf16(o[4 * n + 2 * half], o[4 * n + 2 * half + 1]));
    }
  fence_async_shared();
  warpgroup_sync();
  if (issuer) {
    tma_store(ty, stage, 0, 64 * M, c, h, b);
    bulk_commit();
  }
}

// Split (bf16 pair r) .* (w.x, w.y) into bf16 hi and lo halves.
__device__ __forceinline__ void scaled_split(uint32_t r, float2 w,
                                             uint32_t& hi, uint32_t& lo) {
  const float v0 = __uint_as_float(r << 16) * w.x;
  const float v1 = __uint_as_float(r & 0xFFFF0000u) * w.y;
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// S_loc rows 64 r .. 64 r + 63 (state panel r of B) of one head, by one
// consumer warpgroup: M = state rows, K = tokens, N = hd.  The k-steps go
// in groups of KG: a group's fragments are built while the previous
// group's wgmma run.
template <class P>
__device__ __forceinline__ void s_loc_tile(int r, uint32_t base, uint32_t xs,
                                           const float* sdec, uint32_t stage,
                                           const CUtensorMap* ts, int b, int h,
                                           int c) {
  constexpr int KS = P::PANEL_BYTES / ROW_BYTES / 16;  // 16-token k-steps
  constexpr int KG = 4;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3, mat = lane >> 3;
  static_assert(P::S_BYTES == 2 * 64 * ROW_BYTES, "two 32-column boxes");
  // ldmatrix: lane gives row lane % 8 of matrix mat, whose 8 x 8 block is
  // tokens + 8 (mat >> 1), state columns 16 warp + 8 (mat & 1) of the panel
  const uint32_t chunk = 2 * warp + (mat & 1);
  const uint32_t bp = base + P::B_OFF + r * P::PANEL_BYTES;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t hi[2][KG][4], lo[2][KG][4];
#pragma unroll
  for (int g = 0; g < KS / KG; ++g) {
    const int buf = g & 1;
#pragma unroll
    for (int kq = 0; kq < KG; ++kq) {
      const int ks = g * KG + kq;
      const int tok = 16 * ks + (lane & 7) + 8 * (mat >> 1);
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, bp + tok * ROW_BYTES + ((chunk ^ (lane & 7)) << 4));
      const float2 wa = *reinterpret_cast<const float2*>(sdec + 16 * ks + 2 * t);
      const float2 wb =
          *reinterpret_cast<const float2*>(sdec + 16 * ks + 8 + 2 * t);
      scaled_split(bt[0], wa, hi[buf][kq][0], lo[buf][kq][0]);
      scaled_split(bt[1], wa, hi[buf][kq][1], lo[buf][kq][1]);
      scaled_split(bt[2], wb, hi[buf][kq][2], lo[buf][kq][2]);
      scaled_split(bt[3], wb, hi[buf][kq][3], lo[buf][kq][3]);
    }
    hold(acc);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < KG; ++kq) {
      const uint64_t dx = smem_desc(xs + 16 * (g * KG + kq) * ROW_BYTES,
                                    P::X_BYTES, 8 * ROW_BYTES, 1);
      wgmma_rs(acc, hi[buf][kq], dx);
      wgmma_rs(acc, lo[buf][kq], dx);
    }
    wg_commit();
    // the previous group's wgmma have read their fragments, which the
    // next group rebuilds
    wg_wait<1>();
    hold(hi[buf ^ 1]);
    hold(lo[buf ^ 1]);
  }
  wg_wait<0>();
  hold(acc);
  hold(hi[0]);
  hold(lo[0]);
  hold(hi[1]);
  hold(lo[1]);
  // staged as two boxes of 64 rows x 32 columns (128B-swizzled), stored
  // by TMA as y is
  const bool issuer = threadIdx.x % 128 == 0;
  if (issuer) bulk_wait_read<2>();
  warpgroup_sync();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + lane / 4 + 8 * half;
      const uint32_t chunk = 2 * (n % 4) + (t >> 1);
      st_shared(stage + (n / 4) * 64 * ROW_BYTES + row * ROW_BYTES +
                    ((chunk ^ (row & 7)) << 4) + 8 * (t & 1),
                acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
    }
  fence_async_shared();
  warpgroup_sync();
  if (issuer) {
    tma_store(ts, stage, 0, 64 * r, c, h, b);
    tma_store(ts, stage + 64 * ROW_BYTES, 32, 64 * r, c, h, b);
    bulk_commit();
  }
}

// The consumers' own barrier (the producer warpgroup never waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMER_THREADS) : "memory");
}

// dt, cum (the inclusive prefix sum of a), sdec = dt * exp(cum_last - cum)
// and the key factors kf (WgmmaPlan) of the block's hg <= G heads in
// shared memory, and dec = exp(cum_last) to device memory, by the
// consumer threads: a and dt staged by all (heads fastest, so the model's
// (B, nc, Q, H) layout reads whole sectors), then one thread a head sums
// in order, as torch's scan along a strided dim does on the card.
template <class P, int Q, int G>
__device__ __forceinline__ void group_decays(const Params& p, int b, int c,
                                             int h0, int hg, float* dts,
                                             float* cum, float* sdec,
                                             float* kf) {
  constexpr int DSTR = P::DSTR, PER = Q * G / CONSUMER_THREADS;
  const int ct = threadIdx.x;
  const float* ap = p.a + b * p.a_sb + c * p.a_sc + h0 * p.a_sh;
  const float* dp = p.dt + b * p.d_sb + c * p.d_sc + h0 * p.d_sh;
  float va[PER], vd[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = ct + CONSUMER_THREADS * k, q = i / G, hh = i % G;
    const bool in = hh < hg;
    va[k] = in ? __ldg(ap + hh * p.a_sh + q * p.a_sq) : 0.f;
    vd[k] = in ? __ldg(dp + hh * p.d_sh + q * p.d_sq) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = ct + CONSUMER_THREADS * k, q = i / G, hh = i % G;
    cum[hh * DSTR + q] = va[k];
    dts[hh * DSTR + q] = vd[k];
  }
  consumer_sync();
  if (ct < hg) {  // 32 values at a time in registers
    float* cr = cum + ct * DSTR;
    float run = 0.f;
    for (int i0 = 0; i0 < Q; i0 += 32) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = cr[i0 + k];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        run += v[k];
        v[k] = run;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) cr[i0 + k] = v[k];
    }
    p.dec[(static_cast<long long>(b) * p.H + h0 + ct) * p.nc + c] = expf(run);
  }
  consumer_sync();
  for (int i = ct; i < Q * hg; i += CONSUMER_THREADS) {
    const int e = (i / Q) * DSTR + i % Q;
    sdec[e] = dts[e] * expf(cum[(i / Q) * DSTR + Q - 1] - cum[e]);
  }
  for (int i = ct; i < P::KF * hg; i += CONSUMER_THREADS) {
    const int h = i / P::KF, j = i % P::KF;
    const float* ch = cum + h * DSTR;
    kf[i] = expf(ch[j | 63] - ch[j]) * dts[h * DSTR + j];
  }
  consumer_sync();
}

template <int Q, int N, int HD, int G>
__global__ void __launch_bounds__(WG_THREADS, 1)
ssd_chunk_wgmma(const __grid_constant__ CUtensorMap tc,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap ty,
                const __grid_constant__ CUtensorMap ts, const Params p) {
  using P = WgmmaPlan<Q, N, HD, G>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128B swizzle's atom
  constexpr int DSTR = P::DSTR;
  float* dts = reinterpret_cast<float*>(smem_raw + (base - raw) + P::DEC_OFF);
  float* cum = dts + G * DSTR;
  float* sdec = cum + G * DSTR;
  float* kf = reinterpret_cast<float*>(smem_raw + (base - raw) + P::KF_OFF);
  const uint32_t bc_full = base + P::BAR_OFF;  // + 8 i: B, C rows 64 i ..
  const uint32_t x_full = bc_full + 8 * P::BLOCKS;
  const uint32_t x_empty = x_full + 16;

  const int groups = (p.H + G - 1) / G;
  const int grp = blockIdx.x % groups, bc = blockIdx.x / groups;
  const int b = bc / p.nc, c = bc % p.nc;
  const int h0 = grp * G, hg = min(G, p.H - h0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::BLOCKS; ++i) mbar_init(bc_full + 8 * i, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(x_full + 8 * st, 1);
      mbar_init(x_empty + 8 * st, CONSUMER_THREADS / 32);  // lane 0 a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // producer warpgroup: one thread keeps B, C and the x ring coming
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMER_THREADS) {
      for (int i = 0; i < P::BLOCKS; ++i) {
        mbar_expect_tx(bc_full + 8 * i, 4 * P::BLOCK_BYTES);
        for (int pn = 0; pn < 2; ++pn) {
          const uint32_t off = pn * P::PANEL_BYTES + i * P::BLOCK_BYTES;
          tma_load(base + P::C_OFF + off, &tc, bc_full + 8 * i, 64 * pn,
                   64 * i, c, b);
          tma_load(base + P::B_OFF + off, &tb, bc_full + 8 * i, 64 * pn,
                   64 * i, c, b);
        }
      }
      for (int j = 0; j < hg; ++j) {
        const int st = j & 1;
        mbar_wait(x_empty + 8 * st, ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(x_full + 8 * st, P::X_BYTES);
        tma_load(base + P::X_OFF + st * P::X_BYTES, &tx, x_full + 8 * st, 0, 0,
                 c, h0 + j, b);
      }
    }
  } else {
    // consumers: the decays, then warpgroup wg takes state rows 64 wg ..
    // 64 wg + 63 and query tiles {wg, 3 - wg} of every head
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    group_decays<P, Q, G>(p, b, c, h0, hg, dts, cum, sdec, kf);
    const int wg = threadIdx.x / 128;
    // the C of the warpgroup's two query tiles stays in registers for all
    // heads, and C's shared memory then stages y and S_loc
    uint32_t cfa[8][4], cfb[8][4];
    mbar_wait(bc_full + 8 * wg, 0);
    mbar_wait(bc_full + 8 * (3 - wg), 0);
    load_c<P>(cfa, wg, base);
    load_c<P>(cfb, 3 - wg, base);
    consumer_sync();
    const uint32_t stage = base + P::C_OFF + 2 * wg * P::Y_BYTES;
    const uint32_t s_stage =
        base + P::C_OFF + 4 * P::Y_BYTES + wg * P::S_BYTES;
    for (int i = 0; i < P::BLOCKS; ++i) mbar_wait(bc_full + 8 * i, 0);  // B
    for (int j = 0; j < hg; ++j) {
      const int st = j & 1, h = h0 + j;
      const uint32_t xs = base + P::X_OFF + st * P::X_BYTES;
      mbar_wait(x_full + 8 * st, (j >> 1) & 1);
      const float* cj = cum + j * DSTR;
      const float* dj = dts + j * DSTR;
      const float* kj = kf + j * P::KF;
      if (wg == 0) {  // S_loc first: the two warpgroups' phases interleave
        s_loc_tile<P>(wg, base, xs, sdec + j * DSTR, s_stage, &ts, b, h, c);
        y_tile<P, 0>(base, xs, cfa, cj, dj, kj, stage, &ty, b, h, c);
        y_tile<P, 3>(base, xs, cfb, cj, dj, kj, stage + P::Y_BYTES,
                     &ty, b, h, c);
      } else {
        y_tile<P, 1>(base, xs, cfa, cj, dj, kj, stage, &ty, b, h, c);
        y_tile<P, 2>(base, xs, cfb, cj, dj, kj, stage + P::Y_BYTES,
                     &ty, b, h, c);
        s_loc_tile<P>(wg, base, xs, sdec + j * DSTR, s_stage, &ts, b, h, c);
      }
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(x_empty + 8 * st);
    }
    hold(cfa);
    hold(cfb);
    if (threadIdx.x % 128 == 0) bulk_wait<0>();  // y and S_loc are written
  }
}

// A tiled map of a tensor with ``rank`` dims (innermost first), strides in
// elements for dims 1.., boxes of ``box``, 128B swizzle.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rank, const long long* dims, const long long* strides,
                const int* box,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                int elem_bytes = 2) {
  cuuint64_t d[5], s[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * elem_bytes;
  }
  return encode(map, type, rank,
                const_cast<void*>(ptr), d, s, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 body of each (Q, N, hd) instance: ops.BF16_BODIES names the
// same (the tests and chip_smoke.py hold the two against each other).
struct MmaSync {};
template <int G>
struct Wgmma {};  // G heads a block
template <int Q, int N, int HD>
struct Bf16Body;
template <>
struct Bf16Body<256, 128, 64> : Wgmma<8> {};
template <>
struct Bf16Body<32, 16, 16> : MmaSync {};

template <int Q, int N, int HD>
cudaError_t launch_bf16(MmaSync, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Bf16Smem<Q, N, HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bf16<Q, N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_bf16<Q, N, HD><<<p.B * p.H * p.nc, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int Q, int N, int HD, int G>
cudaError_t launch_bf16(Wgmma<G>, const Params& p, cudaStream_t stream) {
  using P = WgmmaPlan<Q, N, HD, G>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tc, tb, tx;
  const long long bc_dims[4] = {N, Q, p.nc, p.B};
  const long long b_str[3] = {p.b_sq, p.b_sc, p.b_sb};
  const long long c_str[3] = {p.c_sq, p.c_sc, p.c_sb};
  const int bc_box[4] = {64, 64, 1, 1};
  const long long x_dims[5] = {HD, Q, p.nc, p.H, p.B};
  const long long x_str[4] = {p.x_sq, p.x_sc, p.x_sh, p.x_sb};
  const int x_box[5] = {64, Q, 1, 1, 1};
  const long long y_str[4] = {p.y_sq, p.y_sc, p.y_sh, p.y_sb};
  const int y_box[5] = {64, 64, 1, 1, 1};
  // S_loc: dense (B, H, nc, N, hd) f32, in boxes of 64 rows x 32 columns
  const long long s_dims[5] = {HD, N, p.nc, p.H, p.B};
  const long long s_str[4] = {HD, N * HD, p.nc * N * HD,
                              static_cast<long long>(p.H) * p.nc * N * HD};
  const int s_box[5] = {32, 64, 1, 1, 1};
  CUtensorMap ty, ts;
  if (!tensor_map(encode, &tc, p.Cm, 4, bc_dims, c_str, bc_box) ||
      !tensor_map(encode, &tb, p.Bm, 4, bc_dims, b_str, bc_box) ||
      !tensor_map(encode, &tx, p.x, 5, x_dims, x_str, x_box) ||
      !tensor_map(encode, &ty, p.y, 5, x_dims, y_str, y_box) ||
      !tensor_map(encode, &ts, p.s_loc, 5, s_dims, s_str, s_box,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4))
    return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>(p.B) * p.nc * ((p.H + G - 1) / G);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // setmaxnreg.inc takes its registers from those the block was launched
  // with, so a build that gave the kernel fewer than LAUNCH_REGS a thread
  // (another compiler, an edited kernel) would leave the consumers waiting
  // forever: such a build refuses to launch.
  static const cudaError_t regs = [] {
    cudaFuncAttributes a{};
    const cudaError_t e = cudaFuncGetAttributes(&a, ssd_chunk_wgmma<Q, N, HD, G>);
    if (e != cudaSuccess) return e;
    return a.numRegs == LAUNCH_REGS ? cudaSuccess
                                    : cudaErrorInvalidDeviceFunction;
  }();
  if (regs != cudaSuccess) return regs;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_wgmma<Q, N, HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (err != cudaSuccess) return err;
  ssd_chunk_wgmma<Q, N, HD, G><<<static_cast<unsigned>(blocks), WG_THREADS,
                                 P::SMEM, stream>>>(tc, tb, tx, ty, ts, p);
  return cudaGetLastError();
}

template <int Q, int N, int HD>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<Q, N, HD>(Bf16Body<Q, N, HD>{}, p, stream);
  constexpr size_t smem = F32Smem<Q, N, HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_f32<Q, N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_f32<Q, N, HD><<<p.B * p.H * p.nc, F32_THREADS, smem, stream>>>(p);
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
