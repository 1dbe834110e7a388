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
// Bound: operations, of two kinds.  A query-key pair costs 4 * hd
// tensor-core flops (q k^T and p v) and one exponential.  At the serving
// shape (B 2, 32 heads, S 32,768, hd 64, causal) that is 8.8 TFLOP, 8.9 ms
// at the H100's 989 TFLOP/s, beside 3.4e10 exponentials, 8.8 ms at the
// special-function units' ~3.9e12 a second (16 per SM per clock); q, k, v
// and o are 0.4 GB, 0.1 ms of memory traffic.  Done one after the other
// the two would take ~17.7 ms, so the bf16 design keeps the tensor cores
// and the exponential units busy at the same time:
//   * warp specialisation: one block per (b*h, query tile), longest tiles
//     first, with a producer warpgroup (one thread issues every load; the
//     warpgroup gives up registers with setmaxnreg.dec) and 2 or 3
//     consumer warpgroups of 64 query rows each (setmaxnreg.inc);
//   * TMA (cp.async.bulk.tensor) brings the block's q tile once and K, V
//     tiles of 128 keys into a ring of shared-memory stages, each with
//     full and empty mbarriers for K and for V (a stage's K is refilled as
//     soon as q k^T has read it).  The 4-D tensor maps carry the tensors'
//     strides, so transposed (B, S, H, hd) views go in as they are, and
//     rows past S arrive as zeros;
//   * wgmma for both products: s = q k^T with both operands in shared
//     memory (K-major), o += p v with p in registers (the f32 score
//     fragment packed in pairs to bf16 is the A fragment) and V read
//     MN-major from the tile TMA wrote: nothing is transposed or written
//     back to shared memory.  TMA's swizzle and the wgmma descriptors
//     agree: 128B for hd 64, 64B for hd 32, two 64-column panels of 128B
//     for hd 128;
//   * softmax in registers: p = exp2(s * c - m * c) with c = log2(e) /
//     sqrt(hd) (one FFMA an element), the row max and sum in four chains
//     each, over the 4 threads of a row (the sum once, at the end), and
//     the mask only on the tiles that cross the diagonal or S;
//   * overlap between warpgroups: while one consumer waits on its wgmma,
//     the others run their exponentials.  Three consumers (192 query rows)
//     where their registers suffice (hd 32, 64: 128 a thread at launch);
//     two for hd 128, whose 64 output registers need the 168 that two
//     allow.  Issuing the next tile's q k^T before this tile's softmax, and
//     ordering the consumers' issues with named barriers, were measured
//     slower (PERF.md): they hold scores, p and the output at once, which
//     the compiler fits only with two consumers, and two consumers
//     overlap less than three.
// The f32 path (the checking path: no tensor core takes f32 at full
// precision) is one block of 256 threads per (b*h, 64-query tile), q, k,
// v and the 64 x 64 score tile in shared memory, 4 x 4 register
// micro-tiles, f32 FMAs throughout.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a head dim it was not built for or a
// layout TMA refuses, and cudaErrorInvalidDeviceFunction for a bf16 build
// with fewer registers than setmaxnreg.inc counts on).  The grid is (query tiles, B*H): more than 65,535
// (batch, head) pairs is a launch the card refuses, and the error comes
// back to the caller.  The TMA, mbarrier and wgmma helpers, and
// cuTensorMapEncodeTiled reached through the runtime (no libcuda link),
// are ../../csrc/hopper.cuh's.

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int BQ = 64;             // f32 path: query rows per block
constexpr int BK = 64;             // f32 path: keys per staged tile

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
// bf16: TMA, mbarriers, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int PRODUCER_REGS = 24;

// Tile sizes and the shared-memory plan of one bf16 kernel instance.  A
// tile of R rows is stored as HD / PANEL panels of R rows x ROW_BYTES,
// each in TMA's (and wgmma's) swizzled layout.
template <int HD_, int BK_, int STAGES_, int CONSUMERS_>
struct Tiles {
  static constexpr int HD = HD_;
  static constexpr int CONSUMERS = CONSUMERS_;  // warpgroups of 64 query rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // registers a thread at launch (one block an SM takes the whole file;
  // the compiler must allocate exactly this, or setmaxnreg.inc would wait
  // for registers that never come, so launch_bf16 checks it), and what
  // the producer's 24 leave each consumer thread of the block's pool
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int CONSUMER_REGS =
      (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
  static constexpr int BQ = 64 * CONSUMERS;   // query rows per block
  static constexpr int BK = BK_;              // keys per stage
  static constexpr int STAGES = STAGES_;
  static constexpr int PANEL = HD < 64 ? HD : 64;
  static constexpr int ROW_BYTES = PANEL * 2;            // the swizzle span
  static constexpr uint32_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // 128B / 64B
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q full; K full, V full, K empty and V empty for each stage
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(HD % PANEL == 0 && PANEL % 16 == 0, "head dim");
};

struct TmaParams {
  void* o;
  int H, Hkv, S;
  long long o_sb, o_sh, o_ss;
  int causal;
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = q k^T for one consumer's 64 rows and a stage's BK keys.
template <class T>
__device__ __forceinline__ void issue_qk(float (&s)[T::BK / 2], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < T::HD / 16; ++kk) {
    // 16 columns of hd: panel pn, a 32-byte step inside its swizzled rows
    const uint32_t pn = kk * 16 / T::PANEL, off = (kk * 16 % T::PANEL) * 2;
    wgmma_ss(s,
             smem_desc(q_s + pn * T::BQ * T::ROW_BYTES + off, 16,
                       8 * T::ROW_BYTES, T::LAYOUT),
             smem_desc(k_s + pn * T::BK * T::ROW_BYTES + off, 16,
                       8 * T::ROW_BYTES, T::LAYOUT),
             kk);
  }
}

// o += p v for one consumer's 64 rows and a stage's BK keys.
template <class T>
__device__ __forceinline__ void issue_pv(float (&o)[T::HD / 2],
                                         const uint32_t (&pa)[T::BK / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kc = 0; kc < T::BK / 16; ++kc)
    wgmma_rs(o, pa[kc],
             smem_desc(v_s + kc * 16 * T::ROW_BYTES, T::BK * T::ROW_BYTES,
                       8 * T::ROW_BYTES, T::LAYOUT));
}

// The online softmax of one score tile in place: s becomes p (f32), m the
// new row max, l the thread's part of the row sum, alpha the factor the
// accumulator is rescaled by.  Element i of a thread's fragment lies in
// row row0 + 8 * ((i >> 1) & 1) and key k0 + 8 * (i >> 2) + 2 * (lane %
// 4) + (i & 1); the 4 threads of a quad share a row.
template <bool MASK, int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               float c, int row0, int k0,
                                               int S, int causal) {
  if (MASK) {
    const int col0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      if (col >= S || (causal && col > row)) s[i] = NEG_INF;
    }
  }
  // four chains a row for the max and the sum, not one
  float mq[2][4], sq[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      mq[j][g] = m[j];
      sq[j][g] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < N; ++i)
    mq[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mq[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float mx[2], mc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(fmaxf(mq[j][0], mq[j][1]), fmaxf(mq[j][2], mq[j][3]));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    alpha[j] = ex2((m[j] - mx[j]) * c);
    m[j] = mx[j];
    mc[j] = mx[j] * c;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    sq[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    l[j] = l[j] * alpha[j] + ((sq[j][0] + sq[j][1]) + (sq[j][2] + sq[j][3]));
}

// p rounded to bf16, in the A fragment of k-step kc (keys 16 kc ..).
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int kc = 0; kc < N / 8; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kc][j] = pack_bf16(s[8 * kc + 2 * j], s[8 * kc + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const TmaParams p) {
  constexpr int HD = T::HD;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + T::BAR_OFF;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + T::STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * T::STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * T::STAGES + st); };
  auto k_smem = [&](int st) { return base + T::K_OFF + st * T::KV_BYTES; };
  auto v_smem = [&](int st) { return base + T::V_OFF + st * T::KV_BYTES; };

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;  // longest tiles first
  int n_tiles = (p.S + T::BK - 1) / T::BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + T::BQ - 1) / T::BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * T::CONSUMERS);  // lane 0 of each consumer warp
      mbar_init(v_empty(st), 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring of K, V stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int pn = 0; pn < HD / T::PANEL; ++pn)
        tma_load(base + pn * T::BQ * T::ROW_BYTES, &tq, q_full,
                 pn * T::PANEL, q0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % T::STAGES;
        const uint32_t ph = ((n / T::STAGES) & 1) ^ 1;
        mbar_wait(k_empty(st), ph);
        mbar_expect_tx(k_full(st), T::KV_BYTES);
        for (int pn = 0; pn < HD / T::PANEL; ++pn)
          tma_load(k_smem(st) + pn * T::BK * T::ROW_BYTES, &tk, k_full(st),
                   pn * T::PANEL, n * T::BK, hk, b);
        mbar_wait(v_empty(st), ph);
        mbar_expect_tx(v_full(st), T::KV_BYTES);
        for (int pn = 0; pn < HD / T::PANEL; ++pn)
          tma_load(v_smem(st) + pn * T::BK * T::ROW_BYTES, &tv, v_full(st),
                   pn * T::PANEL, n * T::BK, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(T::CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;  // rows q0 + 64 c .. q0 + 64 c + 63
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t q_s = base + 64 * c * T::ROW_BYTES;
    float o[HD / 2], s[T::BK / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < T::BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[T::BK / 16][4];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % T::STAGES, k0 = n * T::BK;
      const uint32_t ph = (n / T::STAGES) & 1;
      mbar_wait(k_full(st), ph);
      hold(s);
      wg_fence();
      issue_qk<T>(s, q_s, k_smem(st));
      wg_commit();
      wg_wait<0>();
      hold(s);
      // a stage's K is free once q k^T has read it, its V once p v has
      if (lane == 0) mbar_arrive(k_empty(st));
      // the mask only where the tile crosses S or, causal, this
      // consumer's first row; interior tiles take no compare
      if (k0 + T::BK > p.S || (p.causal && k0 + T::BK - 1 > q0 + 64 * c))
        online_softmax<true>(s, m, l, alpha, p.scale_log2, row0, k0, p.S,
                             p.causal);
      else
        online_softmax<false>(s, m, l, alpha, p.scale_log2, row0, k0, p.S,
                              p.causal);
      rescale(o, alpha);
      pack_p(pa, s);
      mbar_wait(v_full(st), ph);
      hold(o);
      wg_fence();
      issue_pv<T>(o, pa, v_smem(st));
      wg_commit();
      wg_wait<0>();
      hold(o);
      hold(pa);
      if (lane == 0) mbar_arrive(v_empty(st));
    }

    // out = acc / max(l, 1e-30), the row sum taken over the quad now
    auto* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      l[j] = fmaxf(l[j], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (row0 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(op + row0 * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * n] / l[0], o[4 * n + 1] / l[0]);
      if (row0 + 8 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(op + (row0 + 8) * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * n + 2] / l[1], o[4 * n + 3] / l[1]);
    }
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

// The 4-D map (hd, S, heads, B) of a bf16 tensor with strides in
// elements, boxes of one panel x ``rows`` rows, rows past S read as zeros.
template <class T>
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int S,
                int heads, int B, long long ss, long long sh, long long sb,
                int rows) {
  const cuuint64_t dims[4] = {T::HD, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {T::PANEL, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<T>(encode, &tq, p.q, p.S, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                     T::BQ) ||
      !tensor_map<T>(encode, &tk, p.k, p.S, p.Hkv, p.B, p.k_ss, p.k_sh,
                     p.k_sb, T::BK) ||
      !tensor_map<T>(encode, &tv, p.v, p.S, p.Hkv, p.B, p.v_ss, p.v_sh,
                     p.v_sb, T::BK))
    return cudaErrorInvalidValue;
  const TmaParams tp{p.o,    p.H,    p.Hkv,    p.S,
                     p.o_sb, p.o_sh, p.o_ss,   p.causal,
                     p.scale * 1.4426950408889634f};
  // setmaxnreg.inc takes its registers from those the block was launched
  // with, so a build that gave the kernel fewer than LAUNCH_REGS a thread
  // (another compiler, an edited kernel) would leave the consumers waiting
  // forever: such a build refuses to launch.
  static const cudaError_t regs = [] {
    cudaFuncAttributes a{};
    const cudaError_t e = cudaFuncGetAttributes(&a, flash_fwd_bf16<T>);
    if (e != cudaSuccess) return e;
    return a.numRegs == T::LAUNCH_REGS ? cudaSuccess
                                       : cudaErrorInvalidDeviceFunction;
  }();
  if (regs != cudaSuccess) return regs;
  const dim3 grid((p.S + T::BQ - 1) / T::BQ, p.B * p.H);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<T><<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, tp);
  return cudaGetLastError();
}

// The bf16 instance for each head dim, as Tiles<HD, keys, stages,
// consumers> (PERF.md has the shapes tried).  ops.BF16_TILES names the
// same (query rows, keys, stages); the tests and chip_smoke.py hold the
// two against each other.
template <int HD>
struct Bf16Tiles;
template <>
struct Bf16Tiles<32> {
  using T = Tiles<32, 128, 2, 3>;
};
template <>
struct Bf16Tiles<64> {
  using T = Tiles<64, 128, 3, 3>;
};
template <>
struct Bf16Tiles<128> {
  using T = Tiles<128, 128, 2, 2>;
};

template <int HD>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<typename Bf16Tiles<HD>::T>(p, stream);
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  constexpr size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_f32<HD><<<grid, F32_THREADS, smem, stream>>>(p);
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
