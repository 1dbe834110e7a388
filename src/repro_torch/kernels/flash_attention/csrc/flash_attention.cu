// Flash-attention forward for sm_90a: softmax(q k^T * scale, causal or
// not) v with the online softmax, for bf16 and f32.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_fwd (:77),
//   body _flash_fwd_kernel (:28)
// with the same arithmetic: f32 scores, the scale applied to the f32
// scores, a running (max, sum, accumulator) triple in f32, p rounded to
// the input type before p @ v, out = acc / max(l, 1e-30) in the input
// type, and key tiles entirely above the diagonal skipped.  Unlike the
// TPU kernel it reads grouped-query layouts through strides (query head
// h reads kv head h / (H / Hkv); repeated K/V is never materialised) and
// masks a ragged tail itself (keys >= S masked, no stores past S) where
// the TPU kernel asserted S % 128 == 0.
//
// Bound: operations.  A (BQ x BK) tile pair does 4 * hd * BQ * BK flops
// against (BQ + 2 BK) * hd input elements; at S = 32,768 the causal
// forward does ~8.8 TFLOP per 64 heads against ~0.4 GB of q, k, v and o,
// some 20,000 flops per byte, far above the card's ~295 bf16 flops per
// byte.  So the design spends its effort on the tensor cores:
//   * bf16: one block of 4 warps per (b*h, 64-query tile); each warp owns
//     16 query rows, keeps its q fragments in registers for the whole
//     key loop and issues mma.sync m16n8k16 (bf16 in, f32 accumulate) for
//     both q k^T and p v.  K and V tiles of 64 keys are staged through
//     shared memory (V transposed, rows padded so that fragment loads hit
//     32 distinct banks); the score tile never leaves registers, and the
//     score accumulator is reused in place as the A operand of p v.
//   * f32 (the checking path; no tensor core takes f32 at full
//     precision): one block of 256 threads per (b*h, 64-query tile), q,
//     k, v and the 64 x 64 score tile in shared memory, 4 x 4 register
//     micro-tiles, f32 FMAs throughout.
// A simple first design: no cp.async / TMA pipelining, no wgmma, no warp
// specialisation (later work, see PERF.md).
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a head dim it was not built for).  The
// grid is (query tiles, B*H): more than 65,535 (batch, head) pairs is a
// launch the card refuses, and the error comes back to the caller.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per staged tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, S;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  float scale;
};

// Number of key tiles a query tile starting at q0 visits: every tile up
// to S, or for causal attention up to the one holding the tile's last row.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int n = (p.S + BK - 1) / BK;
  if (p.causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return col >= p.S || (p.causal && col > row);
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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* base,
                                            long long row_stride, int row,
                                            int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + col);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = A[g][2t:2t+2], a1 = A[g+8][2t:2t+2],
//                     a2 = A[g][2t+8:2t+10], a3 = A[g+8][2t+8:2t+10]
//   B (16 x 8, col):  b0 = B[2t:2t+2][g],  b1 = B[2t+8:2t+10][g]
//   C (16 x 8):       c0,c1 = C[g][2t:2t+2], c2,c3 = C[g+8][2t:2t+2]
template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const Params p) {
  constexpr int KSTR = HD + 8;  // K row stride in smem (bank padding)
  constexpr int VSTR = BK + 8;  // V^T row stride in smem
  constexpr int KD = HD / 16;   // k-steps of q k^T
  constexpr int ND = HD / 8;    // n-tiles of the output
  constexpr int NK = BK / 8;    // n-tiles of the score tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const auto* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const auto* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld_pair(qp, p.q_ss, r0, c, p.S);
    qf[kk][1] = ld_pair(qp, p.q_ss, r1, c, p.S);
    qf[kk][2] = ld_pair(qp, p.q_ss, r0, c + 8, p.S);
    qf[kk][3] = ld_pair(qp, p.q_ss, r1, c + 8, p.S);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_tiles = key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BK * HD / 8; c += 128) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.S) {
        kv = *reinterpret_cast<const uint4*>(kp + (k0 + r) * p.k_ss + d);
        vv = *reinterpret_cast<const uint4*>(vp + (k0 + r) * p.v_ss + d);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KSTR + d]) = kv;
      const auto* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d + i) * VSTR + r] = ve[i];
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + g) * KSTR + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    // scale, mask, and the online softmax; row j (0: r0, 1: r1) of a
    // score tile is spread over the 4 lanes of a quad
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const float x = masked(p, i < 2 ? r0 : r1, col) ? NEG_INF : s[n][i] * p.scale;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      alpha[j] = __expf(m[j] - m_new);
      m[j] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = __expf(s[n][i] - m[i >> 1]);
        sum[i >> 1] += s[n][i];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
      l[j] = l[j] * alpha[j] + sum[j];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p v: the C fragments of score n-tiles 2c, 2c+1 are the A
    // fragment of keys 16c .. 16c+15, rounded to bf16 as the TPU kernel
    // rounds p to v's type
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vrow = &Vt[(n * 8 + g) * VSTR + c * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16(o[n], a, b0, b1);
      }
    }
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * p.o_ss + c) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (r1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(op + r1 * p.o_ss + c) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiles, 4 x 4 register micro-tiles, FMAs in f32
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int HD>
constexpr size_t f32_smem_bytes() {
  // q, k (padded rows), v, the score tile (padded rows), m, l, alpha
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const Params p) {
  constexpr int QSTR = HD + 1, PSTR = BK + 1, DJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QSTR;
  float* Vs = Ks + BK * QSTR;
  float* Ps = Vs + BK * HD;
  float* m_row = Ps + BQ * PSTR;
  float* l_row = m_row + BQ;
  float* a_row = l_row + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * HD; i += F32_THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r * QSTR + d] = q0 + r < p.S ? qp[(q0 + r) * p.q_ss + d] : 0.f;
  }
  if (tid < BQ) {
    m_row[tid] = NEG_INF;
    l_row[tid] = 0.f;
  }
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  const int n_tiles = key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * HD; i += F32_THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < p.S;
      Ks[r * QSTR + d] = in ? kp[(k0 + r) * p.k_ss + d] : 0.f;
      Vs[r * HD + d] = in ? vp[(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i, keys tx + 16 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QSTR + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        Ps[row * PSTR + col] =
            masked(p, q0 + row, k0 + col) ? NEG_INF : acc[i][j] * p.scale;
      }
    __syncthreads();

    // online softmax: each warp takes 8 rows, each lane 2 keys of a row
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int row = warp * (BQ / 8) + rr;
      const float x0 = Ps[row * PSTR + lane], x1 = Ps[row * PSTR + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_row[row];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      Ps[row * PSTR + lane] = p0;
      Ps[row * PSTR + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_row[row] = l_row[row] * alpha + sum;
        m_row[row] = m_new;
        a_row[row] = alpha;
      }
    }
    __syncthreads();

    // o = o * alpha + p v for rows ty + 16 i, dims tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_row[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PSTR + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= p.S) continue;
    const float den = fmaxf(l_row[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[(q0 + row) * p.o_ss + tx + 16 * j] = o[i][j] / den;
  }
}

template <int HD>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  if (bf16) {
    flash_fwd_bf16<HD><<<grid, 128, 0, stream>>>(p);
  } else {
    constexpr size_t smem = f32_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_f32<HD><<<grid, F32_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int H, int Hkv, int S, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, float scale, void* stream) {
  const Params p{q,    k,    v,    o,    B,    H,    Hkv,  S,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                 v_ss, o_sb, o_sh, o_ss, causal, scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(p, bf16, st);
    case 64: return launch<64>(p, bf16, st);
    case 128: return launch<128>(p, bf16, st);
    default: return cudaErrorInvalidValue;
  }
}
