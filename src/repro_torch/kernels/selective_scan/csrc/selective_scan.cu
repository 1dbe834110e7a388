// Mamba-1's selective scan over time, for sm_90a, with x, B and C in bf16
// or f32 and every product and sum in f32: the forward (selective_scan)
// and, below it, its backward (selective_scan_bwd).
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as one
// lax.scan over time in mamba1_forward (src/repro/models/ssm.py:256-269),
// which XLA compiles into one device loop.  In eager PyTorch each step
// is about twelve launches on a (B, d_inner, N) state (ref.py), some
// 393,000 launches for one sublayer's prefill of 2 x 32,768 tokens, and
// the host's launch rate, not the card, sets its time.  For batch row b,
// channel c and state n, from h = 0:
//   h_t[n] = exp(dt_t[c] * A[c, n]) * h_{t-1}[n] + (dt_t[c] * B_t[n]) * x_t[c]
//   y_t[c] = sum_n h_t[n] * C_t[n]
// with the reference's operand order and rounding points: dt * A rounds
// before the exp (expf, as torch.exp computes it on the card: no
// --use_fast_math), dt * B before * x, dA * h before + dBx (no fused
// multiply-add: __fmul_rn and __fadd_rn), so each state's recurrence, and
// the final state, is the plain loop's bit for bit.  y is a dot product
// over n accumulated in f32.  y leaves in f32 (B, S, D) and the final
// state in f32 (B, D, N).
//
// Bound.  At the serving shape (B 2, S 32,768, D 16,384, N 16) the kernel
// reads x (2.1 GB bf16) and dt (4.3 GB f32) and writes y (4.3 GB f32),
// 10.7 GB or 3.2 ms at 3.35 TB/s; it takes B * S * D * N = 1.72e10
// exponentials, 4.1 ms on the special-function units (16 a clock an SM,
// 132 SMs, 1.98 GHz).  Nearer is the issue rate: expf is six FP32
// instructions, a shift and a MUFU.EX2, the update and y six more FP32
// ones, so at least 14 instructions an element at one a clock on each of
// an SM's four schedulers: 7.2 ms, and about 8 ms with the loads, the
// store and the loop (compare.py --sass reads the built loop).  The
// latency floor, one dependent update of h a step, S steps in order, is
// far below either.
//
// Design (Hopper):
//   * One thread a (batch row, channel) holds the channel's N states and
//     its row of A in registers; y_t is the sum of two f32 partial sums
//     over N / 2 consecutive states each, the order in which the plain
//     loop's torch.einsum sums its 16 terms on the card where it was
//     measured (y equal bit for bit at jamba's shape, compare.py; the row
//     limit holds y elsewhere).  A block scans CHANNELS consecutive
//     channels of one batch row.  At the serving shape that is 512 blocks
//     of 2 warps, about 7.8 warps an SM: with 16 independent states a
//     thread the schedulers stay fed (splitting a channel's states over 2
//     or 4 lanes for 16 or 31 warps an SM was measured slower: its
//     shuffles and per-step loads cost an issue-bound loop more).
//   * Time is cut into tiles of TILE steps.  x and dt of a tile (steps x
//     channels) and B and C (steps x N) go into shared memory by
//     cp.async in 16-byte chunks, x and dt into a ring of 2 stages:
//     the copies of tile k + 1 are issued right after the barrier that
//     opens tile k and land while tile k is scanned.  Each thread then
//     waits for its own copies and converts the B and C chunks it copied
//     to f32 (read as float4 broadcasts by the scan, double-buffered), so
//     the one barrier a tile comes when the next tile is already there.
//   * Any stride with a unit channel stride: a row is copied as the
//     16-byte-aligned chunks that hold its bytes (a chunk that holds a
//     byte of the row lies on the row's page), its first element at the
//     row's address & 15 in its shared row.  Where every row of the four
//     arrays starts on 16 bytes (base pointers and batch and step strides;
//     jamba's contiguous x and dt and its B and C slices of the x_proj
//     output), the ALIGNED instance knows those offsets are 0 and its rows
//     need no spare chunk; otherwise the other instance reads each row's
//     offset.  Both run the same copies and the same scan; at jamba's
//     shape the aligned one is 1.2 times as fast (compare.py's
//     ``unaligned``).
//   * The step loop reads x once a step (converted once), dt, and B_t and
//     C_t as float4 broadcasts, and stores y with one predicated store
//     through a pointer it moves by a row.
//   Shared memory a block (TILE 32, CHANNELS 64, N 16): x and dt
//   stages 2 x 32 x (64 x 2 + 64 x 4) = 24 KB in bf16 (32 KB in f32), one
//   raw B and C tile 2 KB (4 KB), the f32 B and C 2 x 4 KB: 34 KB (44 KB);
//   the unaligned instance adds 16 bytes a row.  Registers: up to 255 a
//   thread (launch bounds THREADS, MIN_BLOCKS); at least 4 blocks an SM
//   fit in registers and shared memory, so the serving grid is resident
//   at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHANNELS = 64;   // channels a block scans, a thread each
constexpr int TILE = 32;       // time steps a ring stage holds
constexpr int MIN_BLOCKS = 4;  // blocks an SM the launch bounds allow
constexpr int THREADS = CHANNELS;

// The ring of x and dt has two stages: tile k + 1's copies are issued as
// tile k's scan starts, so a third stage would never fill.
static_assert(TILE % 4 == 0, "TILE a multiple of 4");

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

// Shared memory of one block, in bytes.  A row pitch is the row's bytes,
// and one spare chunk where rows may start off 16 bytes.
template <typename T, int N, int ALIGNED>
struct Layout {
  static constexpr int SPARE = ALIGNED ? 0 : 16;
  static constexpr int XP = CHANNELS * int(sizeof(T)) + SPARE;
  static constexpr int DP = CHANNELS * 4 + SPARE;
  static constexpr int BP = N * int(sizeof(T)) + SPARE;
  static constexpr int XD = TILE * (XP + DP);   // one stage of x and dt
  static constexpr int RAW = 2 * XD;            // B then C as copied
  static constexpr int CONV = RAW + 2 * TILE * BP;   // f32 B then C, 2 bufs
  static constexpr int CONV_BYTES = 2 * TILE * N * 4;
  static constexpr int BYTES = CONV + 2 * CONV_BYTES;
  static_assert(XP % 16 == 0 && DP % 16 == 0 && BP % 16 == 0, "16 B rows");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// *ptr = v where ``on``, as one predicated store: no branch, so the warp
// never splits around it
__device__ __forceinline__ void store_if(float* ptr, float v, bool on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p st.global.f32 [%0], %1;\n}\n"
               :: "l"(ptr), "f"(v), "r"(static_cast<int>(on)) : "memory");
}

// The byte offset of a row's first element in its shared row: its
// address & 15, or 0 in the aligned instance.
template <int ALIGNED>
__device__ __forceinline__ int row_off(const char* row) {
  return ALIGNED ? 0 : int(reinterpret_cast<uintptr_t>(row) & 15);
}

// Thread ``tid``'s share of copying ``rows`` rows of ``nbytes`` bytes
// (row r at src + r * stride) as the 16-byte chunks that hold them: row
// r's chunks to dst + r * PITCH.  Items run row-major over (row, chunk
// slot), THREADS apart, so a warp reads along a row; the slots a row has,
// PITCH / 16, are a compile-time power of two in the aligned instance, so
// the item's row and slot are a shift and a mask.
template <int PITCH, int ALIGNED>
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          long long stride, int rows,
                                          int nbytes, int tid) {
  constexpr int SLOTS = PITCH / 16;
#pragma unroll
  for (int i0 = 0; i0 < TILE * SLOTS; i0 += THREADS) {
    const int i = i0 + tid;
    const int r = i / SLOTS, q = i - r * SLOTS;
    if ((TILE * SLOTS % THREADS == 0 || i < TILE * SLOTS) && r < rows) {
      const char* row = src + r * stride;
      const int off = row_off<ALIGNED>(row);
      if (16 * q < off + nbytes)
        cp_async16(dst + r * PITCH + 16 * q, row - off + 16 * q);
    }
  }
}

// After cp_async_wait_all: the N elements of each B or C row whose bytes
// lie in the chunks this thread copied (copy_rows' items), converted to
// f32 into out[r * N + n].
template <typename T, int N, int PITCH, int ALIGNED>
__device__ __forceinline__ void convert_rows(const unsigned char* raw,
                                             float* out, const char* src,
                                             long long stride, int rows,
                                             int tid) {
  constexpr int SLOTS = PITCH / 16, ES = int(sizeof(T)), PER = 16 / ES;
  auto chunk = [&](int r, int q) {
    if constexpr (ALIGNED != 0) {               // PER elements, all of them
      const uint4 v = *reinterpret_cast<const uint4*>(raw + r * PITCH +
                                                      16 * q);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      float f[PER];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (ES == 2) {                 // bf16: the high 16 bits
          f[2 * u] = __uint_as_float(w[u] << 16);
          f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
        } else {
          f[u] = __uint_as_float(w[u]);
        }
      }
      float4* o = reinterpret_cast<float4*>(out + r * N + q * PER);
#pragma unroll
      for (int u = 0; u < PER / 4; ++u)
        o[u] = make_float4(f[4 * u], f[4 * u + 1], f[4 * u + 2],
                           f[4 * u + 3]);
    } else {
      const int off = row_off<ALIGNED>(src + r * stride);
      // elements n with off + n * ES in [16 q, 16 q + 16)
      const int n0 = max(0, (16 * q - off + ES - 1) / ES);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int n = n0 + u, at = off + n * ES;
        if (n < N && at < 16 * q + 16)
          out[r * N + n] = to_f32(*reinterpret_cast<const T*>(
              raw + r * PITCH + at));
      }
    }
  };
#pragma unroll
  for (int i0 = 0; i0 < TILE * SLOTS; i0 += THREADS) {
    const int i = i0 + tid;
    const int r = i / SLOTS, q = i - r * SLOTS;
    if ((TILE * SLOTS % THREADS == 0 || i < TILE * SLOTS) && r < rows)
      chunk(r, q);
  }
}

template <typename T, int N, int ALIGNED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
selective_scan_kernel(Params p) {
  using Lay = Layout<T, N, ALIGNED>;
  constexpr int ES = int(sizeof(T));
  static_assert(N % 8 == 0, "float4 reads of B and C, y in two halves");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int c0 = blockIdx.x * CHANNELS;
  const int nch = min(CHANNELS, p.D - c0);
  const int c = c0 + tid;
  const bool live = tid < nch;
  // byte pointers to this block's part of each array's first row
  const char* xg = static_cast<const char*>(p.x) + (b * p.x_sb + c0) * ES;
  const char* dg = reinterpret_cast<const char*>(p.dt) +
                   (b * p.d_sb + c0) * 4;
  const char* bg = static_cast<const char*>(p.Bm) + b * p.b_sb * ES;
  const char* cg = static_cast<const char*>(p.Cm) + b * p.c_sb * ES;
  const long long xs = p.x_ss * ES, ds = p.d_ss * 4, bs = p.b_ss * ES,
                  cs = p.c_ss * ES;       // step strides in bytes
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // zero the ring, so that a channel past D scans zeros, not stale bits
  for (int i = tid; i < Lay::BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  float a[N], h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = live ? p.A[static_cast<long long>(c) * N + k] : 0.f;
    h[k] = 0.f;
  }

  const int tiles = (p.S + TILE - 1) / TILE;
  auto issue = [&](int k) {               // copies of tile k, one group
    const long long t0 = static_cast<long long>(k) * TILE;
    const int rows = min(TILE, p.S - k * TILE);
    const uint32_t st = sbase + (k & 1) * Lay::XD;
    copy_rows<Lay::XP, ALIGNED>(st, xg + t0 * xs, xs, rows, nch * ES, tid);
    copy_rows<Lay::DP, ALIGNED>(st + TILE * Lay::XP, dg + t0 * ds, ds, rows,
                                nch * 4, tid);
    copy_rows<Lay::BP, ALIGNED>(sbase + Lay::RAW, bg + t0 * bs, bs, rows,
                                N * ES, tid);
    copy_rows<Lay::BP, ALIGNED>(sbase + Lay::RAW + TILE * Lay::BP,
                                cg + t0 * cs, cs, rows, N * ES, tid);
    cp_async_commit();
  };
  auto land = [&](int k) {                // own copies of tile k landed:
    const long long t0 = static_cast<long long>(k) * TILE;   // B, C to f32
    const int rows = min(TILE, p.S - k * TILE);
    float* conv = reinterpret_cast<float*>(smem + Lay::CONV +
                                           (k & 1) * Lay::CONV_BYTES);
    cp_async_wait_all();
    convert_rows<T, N, Lay::BP, ALIGNED>(smem + Lay::RAW, conv, bg + t0 * bs,
                                         bs, rows, tid);
    convert_rows<T, N, Lay::BP, ALIGNED>(smem + Lay::RAW + TILE * Lay::BP,
                                         conv + TILE * N, cg + t0 * cs, cs,
                                         rows, tid);
  };

  float* y = p.y + b * p.S * p.D + c;
  issue(0);
  land(0);
  for (int k = 0; k < tiles; ++k) {
    const long long t0 = static_cast<long long>(k) * TILE;
    const int steps = min(TILE, p.S - k * TILE);
    __syncthreads();  // tile k staged and converted; tile k - 1 consumed
    if (k + 1 < tiles) issue(k + 1);
    const unsigned char* stage = smem + (k & 1) * Lay::XD;
    const unsigned char* sx = stage + tid * ES;
    const unsigned char* sd = stage + TILE * Lay::XP + tid * 4;
    const float* sB = reinterpret_cast<const float*>(
        smem + Lay::CONV + (k & 1) * Lay::CONV_BYTES);
    const float* sC = sB + TILE * N;
    const int xo = row_off<ALIGNED>(xg + t0 * xs);   // tile row 0's offsets
    const int dof = row_off<ALIGNED>(dg + t0 * ds);
    const uint32_t xs16 = static_cast<uint32_t>(xs),
                   ds16 = static_cast<uint32_t>(ds);
    float* yt = y + t0 * p.D;             // y of the step, row by row

    auto step = [&](int j) {
      const float xv = to_f32(*reinterpret_cast<const T*>(
          sx + j * Lay::XP + ((xo + j * xs16) & (ALIGNED ? 0 : 15))));
      const float dv = *reinterpret_cast<const float*>(
          sd + j * Lay::DP + ((dof + j * ds16) & (ALIGNED ? 0 : 15)));
      float bv[N], cv[N];
#pragma unroll
      for (int u = 0; u < N / 4; ++u) {
        const float4 b4 = reinterpret_cast<const float4*>(sB + j * N)[u];
        const float4 c4 = reinterpret_cast<const float4*>(sC + j * N)[u];
        bv[4 * u] = b4.x; bv[4 * u + 1] = b4.y;
        bv[4 * u + 2] = b4.z; bv[4 * u + 3] = b4.w;
        cv[4 * u] = c4.x; cv[4 * u + 1] = c4.y;
        cv[4 * u + 2] = c4.z; cv[4 * u + 3] = c4.w;
      }
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dA = expf(__fmul_rn(dv, a[n]));
        const float dBx = __fmul_rn(__fmul_rn(dv, bv[n]), xv);
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
        part[2 * n / N] = fmaf(h[n], cv[n], part[2 * n / N]);
      }
      store_if(yt, part[0] + part[1], live);
      yt += p.D;
    };
    if (steps == TILE) {
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) step(j);
    } else {
      for (int j = 0; j < steps; ++j) step(j);
    }
    if (k + 1 < tiles) land(k + 1);
  }
  if (live) {
    float4* h_out = reinterpret_cast<float4*>(
        p.h_out + (b * p.D + c) * N);
#pragma unroll
    for (int u = 0; u < N / 4; ++u)
      h_out[u] = make_float4(h[4 * u], h[4 * u + 1], h[4 * u + 2],
                             h[4 * u + 3]);
  }
}

bool rows_aligned(const void* base, long long sb, long long ss, int es) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sb * es % 16 == 0 &&
         ss * es % 16 == 0;
}

// Lets an instance take its shared memory where that is over 48 KB.
template <typename T, int N, int ALIGNED>
cudaError_t allow_shared() {
  constexpr int bytes = Layout<T, N, ALIGNED>::BYTES;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(selective_scan_kernel<T, N, ALIGNED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int N, int ALIGNED>
int launch_instance(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t e = allow_shared<T, N, ALIGNED>();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.D + CHANNELS - 1) / CHANNELS, B);
  selective_scan_kernel<T, N, ALIGNED>
      <<<grid, THREADS, Layout<T, N, ALIGNED>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const Params& p, int B, int N, cudaStream_t stream) {
  constexpr int ES = int(sizeof(T));
  const bool aligned = rows_aligned(p.x, p.x_sb, p.x_ss, ES) &&
                       rows_aligned(p.dt, p.d_sb, p.d_ss, 4) &&
                       rows_aligned(p.Bm, p.b_sb, p.b_ss, ES) &&
                       rows_aligned(p.Cm, p.c_sb, p.c_ss, ES);
  if (N != 16) return cudaErrorInvalidValue;
  return aligned ? launch_instance<T, 16, 1>(p, B, stream)
                 : launch_instance<T, 16, 0>(p, B, stream);
}

template <typename T, int ALIGNED>
int occupancy() {
  int blocks = 0;
  cudaError_t e = allow_shared<T, 16, ALIGNED>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, selective_scan_kernel<T, 16, ALIGNED>, THREADS,
        Layout<T, 16, ALIGNED>::BYTES);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// The backward: selective_scan_bwd.
//
// Replaces no Pallas kernel either: the JAX package differentiates the
// lax.scan of mamba1_forward (src/repro/models/ssm.py:269) with jax.grad,
// which XLA runs as a reverse device loop.  In eager PyTorch autograd
// through the step loop is some twenty launches a step, forward and
// backward.  With a_t = exp(dt_t A), the carry g_t = gy_t C_t + a_{t+1}
// g_{t+1} (g after the last step: the final state's cotangent), per batch
// row b, channel c and state n:
//   dx_t[c]  = dt_t[c] sum_n g_t[n] B_t[n]
//   ddt_t[c] = sum_n g_t[n] (A[c, n] a_t[n] h_{t-1}[n] + B_t[n] x_t[c])
//   dA[c, n] = sum_{b, t} g_t[n] dt_t[c] a_t[n] h_{t-1}[n]
//   dB_t[n]  = sum_c g_t[n] dt_t[c] x_t[c]
//   dC_t[n]  = sum_c gy_t[c] h_t[n]
// The reverse walk needs h_{t-1} and h_t, last step first.  They are
// recomputed, not saved by the forward: the forward kernel stays the
// serving path's, bit for bit, and under remat it runs two or three
// times a training step, so a saved state (268 MB a sublayer at jamba's
// training shape, B 2, S 4,096, D 16,384) would be written that often
// and live from the forward to the backward.  The recompute costs about
// three forward scans of arithmetic and keeps nothing between the two.
//   * Phase 1: one thread a (batch row, channel), as the forward, scans
//     from h = 0 and writes the state before every BWD_TILE-step tile to
//     a scratch (B, S / BWD_TILE, D, N) f32 (268 MB at that shape).
//   * Phase 2 walks the tiles last first.  A tile's state is replayed
//     once to keep the state before each of its SUB-step sub-tiles in
//     shared memory; then, last sub-tile first, the sub-tile is replayed
//     with each step's state kept in shared memory (SUB x N x CHANNELS
//     f32, 32 KB: a thread reads only its own column, so no barrier
//     guards it), and walked backwards: g carried in registers, dx, ddt
//     written, dA accumulated in registers over the whole walk.
//   * dB and dC sum over all D channels.  Each warp sums its 32 lanes'
//     16 terms by a halving exchange of shuffles (16 a vector, lane l
//     ends with state l / 2's sum), the block adds its two warps, and
//     each block writes its (B, S, N) partial sums; a second kernel adds
//     the D / CHANNELS partials in block order, and dA's B partials in
//     batch order.  No atomics: two runs agree bit for bit.
//   * x, dt, B and C are read through their batch and step strides, as
//     in the forward (B and C staged a sub-tile at a time in shared
//     memory, converted to f32); gy and the outputs are contiguous.  The
//     state's replay rounds as the forward does, so h_t is the forward's.
// Bound at (B 2, S 4,096, D 16,384, N 16): 2.1e9 exponentials a pass at
// 4.18e12/s, 0.51 ms, and about 2.4 GB of x, dt, gy, dx and ddt at
// 3.35 TB/s, 0.72 ms.  The kernel takes about four exponentials an
// element (phase 1, the two replays and the walk), so it is a simple
// kernel several times its bound; its time is in PERF.md.

constexpr int BWD_TILE = 32;   // steps between two saved states
constexpr int SUB = 8;         // steps a sub-tile keeps in shared memory
constexpr int SUBS = BWD_TILE / SUB;
constexpr int BWD_MIN_BLOCKS = 4;
constexpr int WARPS = THREADS / 32;
static_assert(BWD_TILE % SUB == 0 && THREADS % 32 == 0, "tiling");

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* gy;      // (B, S, D) contiguous
  const float* gh;      // (B, D, N) contiguous, or null: zero
  float* ck;            // (B, ceil(S / BWD_TILE), D, N) scratch
  float* dx;            // (B, S, D)
  float* ddt;           // (B, S, D)
  float* dB_part;       // (D / CHANNELS blocks, B, S, N)
  float* dC_part;       // (D / CHANNELS blocks, B, S, N)
  float* dA_part;       // (B, D, N)
  int B, S, D;
  long long x_sb, x_ss, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss;
};

// Shared memory of one backward block, in floats.
template <int N>
struct BwdLayout {
  static constexpr int HS = 0;                          // [SUB][N][THREADS]
  static constexpr int STARTS = HS + SUB * N * THREADS; // [SUBS][N][THREADS]
  static constexpr int SB = STARTS + SUBS * N * THREADS;   // [SUB][N]
  static constexpr int SC = SB + SUB * N;                   // [SUB][N]
  static constexpr int RED = SC + SUB * N;     // [WARPS][SUB][2][N]
  static constexpr int FLOATS = RED + WARPS * SUB * 2 * N;
  static constexpr int BYTES = FLOATS * 4;
};

// The sum over a warp's 32 lanes of v[n], n < 16: at each of four
// exchanges a lane keeps half its sums and sends its partner the other
// half, then pairs of lanes add; lane l returns the sum of v[l >> 1].
__device__ __forceinline__ float warp_sum16(const float (&v)[16]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float w8[8], w4[4], w2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w8[i] = (b4 ? v[8 + i] : v[i]) +
            __shfl_xor_sync(full, b4 ? v[i] : v[8 + i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (b3 ? w8[4 + i] : w8[i]) +
            __shfl_xor_sync(full, b3 ? w8[i] : w8[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (b2 ? w4[2 + i] : w4[i]) +
            __shfl_xor_sync(full, b2 ? w4[i] : w4[2 + i], 4);
  const float w1 = (b1 ? w2[1] : w2[0]) +
                   __shfl_xor_sync(full, b1 ? w2[0] : w2[1], 2);
  return w1 + __shfl_xor_sync(full, w1, 1);
}

// B and C of steps t0 .. t0 + steps - 1 to f32 in shared memory, zeros
// past the last step; barriers on both sides, so that no thread still
// reads the sub-tile before and every thread sees this one.
template <typename T, int N>
__device__ __forceinline__ void stage_bc(const BwdParams& p, long long b,
                                         int t0, int steps, float* sB,
                                         float* sC, int tid) {
  __syncthreads();
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb;
  for (int i = tid; i < SUB * N; i += THREADS) {
    const int j = i / N, n = i - j * N;
    const long long t = t0 + j;
    sB[i] = j < steps ? to_f32(Bg[t * p.b_ss + n]) : 0.f;
    sC[i] = j < steps ? to_f32(Cg[t * p.c_ss + n]) : 0.f;
  }
  __syncthreads();
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
selective_scan_bwd_kernel(BwdParams p) {
  static_assert(N == 16, "warp_sum16 sums 16 states");
  using Lay = BwdLayout<N>;
  extern __shared__ __align__(16) float fsmem[];
  float* hs = fsmem + Lay::HS;
  float* starts = fsmem + Lay::STARTS;
  float* sB = fsmem + Lay::SB;
  float* sC = fsmem + Lay::SC;
  float* red = fsmem + Lay::RED;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.y;
  const int c = blockIdx.x * CHANNELS + tid;
  const bool live = c < p.D;
  const int S = p.S, D = p.D;
  const int tiles = (S + BWD_TILE - 1) / BWD_TILE;
  // this thread's channel of x and dt (a dead channel reads channel 0 and
  // takes zeros), and of gy, dx and ddt
  const int cc = live ? c : 0;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + cc;
  const float* dg = p.dt + b * p.d_sb + cc;
  const long long row = b * S * D + cc;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? p.A[static_cast<long long>(c) * N + n] : 0.f;
    h[n] = 0.f;
  }
  auto load_xd = [&](long long t, float& xv, float& dv) {
    xv = live ? to_f32(xg[t * p.x_ss]) : 0.f;
    dv = live ? dg[t * p.d_ss] : 0.f;
  };
  // one step of the forward, rounded as selective_scan_kernel rounds it
  auto advance = [&](int j, long long t) {
    float xv, dv;
    load_xd(t, xv, dv);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float dA = expf(__fmul_rn(dv, a[n]));
      const float dBx = __fmul_rn(__fmul_rn(dv, sB[j * N + n]), xv);
      h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
    }
  };
  float* ck = p.ck + (b * tiles * D + c) * N;     // tile 0's saved state

  // phase 1: the state before each tile
  for (int t0 = 0; t0 < S; t0 += SUB) {
    const int steps = min(SUB, S - t0);
    if (t0 % BWD_TILE == 0 && live) {
      float4* dst = reinterpret_cast<float4*>(
          ck + static_cast<long long>(t0 / BWD_TILE) * D * N);
#pragma unroll
      for (int u = 0; u < N / 4; ++u)
        dst[u] = make_float4(h[4 * u], h[4 * u + 1], h[4 * u + 2],
                             h[4 * u + 3]);
    }
    stage_bc<T, N>(p, b, t0, steps, sB, sC, tid);
    for (int j = 0; j < steps; ++j) advance(j, t0 + j);
  }

  // phase 2: the tiles in reverse
  float g[N], dA_acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    g[n] = (live && p.gh) ? p.gh[(b * D + c) * N + n] : 0.f;
    dA_acc[n] = 0.f;
  }
  for (int k = tiles - 1; k >= 0; --k) {
    const int T0 = k * BWD_TILE;
    const int subs = (min(BWD_TILE, S - T0) + SUB - 1) / SUB;
    if (live) {
      const float4* src = reinterpret_cast<const float4*>(
          ck + static_cast<long long>(k) * D * N);
#pragma unroll
      for (int u = 0; u < N / 4; ++u) {
        const float4 v = src[u];
        h[4 * u] = v.x; h[4 * u + 1] = v.y;
        h[4 * u + 2] = v.z; h[4 * u + 3] = v.w;
      }
    }
    // the state before each sub-tile of the tile
    for (int s = 0; s < subs; ++s) {
#pragma unroll
      for (int n = 0; n < N; ++n) starts[(s * N + n) * THREADS + tid] = h[n];
      if (s + 1 < subs) {
        const int t0 = T0 + s * SUB;
        stage_bc<T, N>(p, b, t0, SUB, sB, sC, tid);
        for (int j = 0; j < SUB; ++j) advance(j, t0 + j);
      }
    }
    for (int s = subs - 1; s >= 0; --s) {
      const int t0 = T0 + s * SUB, steps = min(SUB, S - t0);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = starts[(s * N + n) * THREADS + tid];
      stage_bc<T, N>(p, b, t0, steps, sB, sC, tid);
      for (int j = 0; j < steps; ++j) {       // h_t of each step, kept
        advance(j, t0 + j);
#pragma unroll
        for (int n = 0; n < N; ++n) hs[(j * N + n) * THREADS + tid] = h[n];
      }
      for (int j = steps - 1; j >= 0; --j) {  // the walk back
        const long long t = t0 + j;
        float xv, dv;
        load_xd(t, xv, dv);
        const float gv = live ? p.gy[row + t * D] : 0.f;
        const float* prev = j ? hs + (j - 1) * N * THREADS
                              : starts + s * N * THREADS;
        float vB[N], vC[N], sdx = 0.f, sdt = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float bv = sB[j * N + n];
          const float an = expf(__fmul_rn(dv, a[n]));
          const float ah = an * prev[n * THREADS + tid];  // a_t h_{t-1}
          g[n] = fmaf(gv, sC[j * N + n], g[n]);
          vB[n] = g[n] * dv * xv;
          vC[n] = gv * hs[(j * N + n) * THREADS + tid];
          sdx = fmaf(g[n], bv, sdx);
          sdt = fmaf(g[n], fmaf(a[n], ah, bv * xv), sdt);
          dA_acc[n] = fmaf(g[n] * dv, ah, dA_acc[n]);
          g[n] *= an;                          // carried to step t - 1
        }
        if (live) {
          p.dx[row + t * D] = dv * sdx;
          p.ddt[row + t * D] = sdt;
        }
        const float sumB = warp_sum16(vB), sumC = warp_sum16(vC);
        if ((lane & 1) == 0) {
          red[((warp * SUB + j) * 2) * N + (lane >> 1)] = sumB;
          red[((warp * SUB + j) * 2 + 1) * N + (lane >> 1)] = sumC;
        }
      }
      __syncthreads();
      // the block's partial sums of the sub-tile, its warps in order
      for (int i = tid; i < steps * 2 * N; i += THREADS) {
        const int j = i / (2 * N), w = (i / N) & 1, n = i % N;
        float v = red[((0 * SUB + j) * 2 + w) * N + n];
#pragma unroll
        for (int q = 1; q < WARPS; ++q) v += red[((q * SUB + j) * 2 + w) * N + n];
        float* part = w ? p.dC_part : p.dB_part;
        part[((static_cast<long long>(blockIdx.x) * p.B + b) * S + t0 + j) *
                 N + n] = v;
      }
      // the next stage_bc's first barrier keeps red until these reads end
    }
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(p.dA_part + (b * D + c) * N);
#pragma unroll
    for (int u = 0; u < N / 4; ++u)
      dst[u] = make_float4(dA_acc[4 * u], dA_acc[4 * u + 1],
                           dA_acc[4 * u + 2], dA_acc[4 * u + 3]);
  }
}

// out[i] = part[0][i] + part[1][i] + ... + part[parts - 1][i], in order
__global__ void sum_parts_kernel(const float* part, float* out, int parts,
                                 long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int k = 1; k < parts; ++k) v += part[k * n + i];
  out[i] = v;
}

int sum_parts(const float* part, float* out, int parts, long long n,
              cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_parts_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      part, out, parts, n);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdParams& p, int N, float* dA, float* dB, float* dC,
               cudaStream_t stream) {
  if (N != 16) return cudaErrorInvalidValue;
  constexpr int bytes = BwdLayout<16>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T, 16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int nblk = (p.D + CHANNELS - 1) / CHANNELS;
  selective_scan_bwd_kernel<T, 16>
      <<<dim3(nblk, p.B), THREADS, bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long bsn = static_cast<long long>(p.B) * p.S * N;
  int rc = sum_parts(p.dB_part, dB, nblk, bsn, stream);
  if (rc == 0) rc = sum_parts(p.dC_part, dC, nblk, bsn, stream);
  if (rc == 0)
    rc = sum_parts(p.dA_part, dA, p.B, static_cast<long long>(p.D) * N,
                   stream);
  return rc;
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

// Blocks of THREADS that one SM holds at once for the N 16 instance of
// the given input type and row alignment (the occupancy calculator's
// answer with the instance's registers and shared memory), or minus a CUDA
// error.
extern "C" int selective_scan_blocks_per_sm(int bf16, int aligned) {
  if (bf16)
    return aligned ? occupancy<__nv_bfloat16, 1>()
                   : occupancy<__nv_bfloat16, 0>();
  return aligned ? occupancy<float, 1>() : occupancy<float, 0>();
}


// The backward of selective_scan.  x, dt, A, Bm, Cm as there; gy (B, S,
// D) f32 contiguous; gh (B, D, N) f32 contiguous or null (zero).  Writes
// dx, ddt (B, S, D), dA (D, N), dB, dC (B, S, N), all f32 contiguous,
// through the scratch ck (B, ceil(S / 32), D, N), dB_part and dC_part
// (ceil(D / 64), B, S, N) and dA_part (B, D, N).  Launches on ``stream``
// (the scan, then three ordered sums), allocates nothing, does not
// synchronise; returns the first launch error.
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* gy, const void* gh, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* ck, void* dB_part, void* dC_part,
    void* dA_part, int bf16, int B, int S, int D, int N, long long x_sb,
    long long x_ss, long long d_sb, long long d_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return cudaErrorInvalidValue;
  const BwdParams p{x, static_cast<const float*>(dt),
                    static_cast<const float*>(A), Bm, Cm,
                    static_cast<const float*>(gy),
                    static_cast<const float*>(gh), static_cast<float*>(ck),
                    static_cast<float*>(dx), static_cast<float*>(ddt),
                    static_cast<float*>(dB_part),
                    static_cast<float*>(dC_part),
                    static_cast<float*>(dA_part), B, S, D,
                    x_sb, x_ss, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss};
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* q) { return static_cast<float*>(q); };
  return bf16 ? launch_bwd<__nv_bfloat16>(p, N, f(dA), f(dB), f(dC), st)
              : launch_bwd<float>(p, N, f(dA), f(dB), f(dC), st);
}
