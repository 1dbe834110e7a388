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

// Thread ``tid``'s share of copying ``rows`` (at most ROWS) rows of
// ``nbytes`` bytes (row r at src + r * stride) as the 16-byte chunks that
// hold them: row r's chunks to dst + r * PITCH.  Items run row-major over
// (row, chunk slot), NT (the block's threads) apart, so a warp reads along
// a row; the slots a row has, PITCH / 16, are a compile-time power of two
// in the aligned instance, so the item's row and slot are a shift and a
// mask.
template <int PITCH, int ALIGNED, int ROWS = TILE, int NT = THREADS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          long long stride, int rows,
                                          int nbytes, int tid) {
  constexpr int SLOTS = PITCH / 16;
#pragma unroll
  for (int i0 = 0; i0 < ROWS * SLOTS; i0 += NT) {
    const int i = i0 + tid;
    const int r = i / SLOTS, q = i - r * SLOTS;
    if ((ROWS * SLOTS % NT == 0 || i < ROWS * SLOTS) && r < rows) {
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
// The reverse walk needs h_{t-1}, h_t and a_t, last step first.  They are
// recomputed, not saved by the forward: the forward kernel stays the
// serving path's, bit for bit, and under remat it runs two or three times
// a training step, so a saved state would be written that often and live
// from the forward to the backward.
//
// Bound at jamba's training shape (B 2, S 4,096, D 16,384, N 16): about
// 2.4 GB of x, dt, gy, dx and ddt at 3.35 TB/s, 0.72 ms; one pass of
// exponentials, 2.15e9 at 4.18e12/s, 0.51 ms.  Nearer is the issue rate:
// an exponential pass is some 15 instructions an element (state and step)
// and the walk some 25 more, so 2.5 passes, the walk and the tiles' work
// are about 70, 4.5 ms at one warp instruction a clock on each of an SM's
// four schedulers (compare.py --bwd --sass reads the built loops).
//
// Design (Hopper):
//   * Two lanes a (batch row, channel), each holding HALF of its 16 states
//     (its A, carry g and dA sum in registers), so a thread needs half the
//     registers and twice the warps fill an SM; the two lanes' dx and ddt
//     halves meet by one shuffle, the even lane stores dx, the odd ddt.
//     A block walks BWD_CHANNELS channels of one batch row; at jamba's
//     width the grid, 256 blocks of 8 warps, is resident at once (2 blocks
//     and 16 warps an SM: 128 registers a thread, 101 KB of shared memory
//     a block in bf16).  Blocks of 32 channels, 8 an SM, were measured
//     slower (compare.py --bwd --variants).
//   * Phase 1 scans forward from h = 0, as the forward kernel does, and
//     saves the state before every BWD_TILE-step tile to a scratch (B,
//     ceil(S / BWD_TILE), D, N) f32 (1.07 GB at that shape).  Phase 2 walks
//     the tiles last first: from the saved state it replays the starts of
//     the tile's SUB-step sub-tiles, then each sub-tile, last first,
//     keeping h_t and a_t of its steps in shared memory (the last step's
//     in registers), and walks it back with no exponential of its own:
//     a_t h_{t-1} is the forward's rounded product again, and a_t carries
//     g.  So an element takes one exponential in phase 1, one in its
//     replay and (SUBS - 1) / SUBS in the replay of the starts, 2.5 in
//     all (the first design took 3.75).  The replay rounds as the forward
//     does from the forward's own saved state, so h_t is the forward's bit
//     for bit.
//   * Every step's operands come from shared memory: x, dt, gy, B and C of
//     a tile are copied by cp.async in 16-byte chunks into a ring of two
//     stages, the tile before this one (the walk runs last tile first)
//     issued right after the barrier that opens this one, so its copies
//     land while this tile is replayed and walked; a lane reads its HALF
//     states of B and C from the copied rows (bf16 in one 16-byte read).
//     A lane loads its own half of the next tile's saved state, which it
//     wrote itself in phase 1, while this tile is walked.  Rows are read
//     through their batch and step strides as the forward reads them (an
//     ALIGNED instance, and one that reads each row's offset).
//   * dB and dC sum over all D channels.  Each warp sums its 16 channels'
//     terms by a halving exchange of shuffles (pair_sum8), and writes each
//     step's 32 sums to shared memory; a cluster of BWD_CLUSTER blocks
//     (adjacent channels of one batch row) adds them through distributed
//     shared memory, each rank adding a slice of the tile's sums (a lane a
//     block, that block's warps in order, then the blocks in rank order),
//     and writes one partial a cluster (2 x 33.5 MB at that shape; the
//     first design's 64-channel blocks wrote 2 x 134 MB).  The buffer of sums is double,
//     so one cluster barrier a tile, split in two, serves: a block arrives
//     when it has walked a tile and waits, after replaying the next one's
//     sub-tile starts, until every block has walked it.  Larger clusters
//     were measured slower.  A second kernel adds the clusters' partials
//     in order, and dA's batch rows in order.  No atomics: two runs agree
//     bit for bit.
//   Shared memory a block (BWD_CHANNELS 128, BWD_TILE 8, SUB 4, bf16): the
//   two stages 21 KB, h_t and a_t of a sub-tile's first three steps 48 KB,
//   the sub-tile starts 16 KB, the sums 16 KB: 101 KB.

constexpr int BWD_CHANNELS = 128; // channels a block walks, two lanes each
constexpr int HALF = 8;           // states a lane holds: N 16 over two lanes
constexpr int BWD_TILE = 8;       // steps between two saved states: a stage
constexpr int SUB = 4;            // steps whose h_t and a_t a block keeps
constexpr int BWD_CLUSTER = 2;    // blocks that add their dB, dC on chip
constexpr int BWD_MIN_BLOCKS = 2; // blocks an SM the launch bounds allow
constexpr int BWD_THREADS = 2 * BWD_CHANNELS;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int SUBS = BWD_TILE / SUB;
static_assert(BWD_TILE % SUB == 0 && BWD_THREADS % 32 == 0, "tiling");
static_assert(BWD_TILE * 2 * 2 * HALF % (4 * BWD_CLUSTER) == 0 &&
                  32 % BWD_CLUSTER == 0,
              "a tile's sums split evenly over the cluster's blocks, and a "
              "group of a lane a block lies in one warp");

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
  float* dB_part;       // (clusters a batch row, B, S, N)
  float* dC_part;       // (clusters a batch row, B, S, N)
  float* dA_part;       // (B, D, N)
  int B, S, D;
  long long x_sb, x_ss, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss;
};

// Shared memory of one backward block, in bytes.  A row pitch is the row's
// bytes, and one spare chunk where rows may start off 16 bytes.  A lane's
// HALF states are two float4s, laid out [which float4][thread], so a
// warp's 16-byte reads fall on consecutive addresses.
template <typename T, int N, int ALIGNED>
struct BwdLayout {
  static constexpr int SPARE = ALIGNED ? 0 : 16;
  static constexpr int XP = BWD_CHANNELS * int(sizeof(T)) + SPARE;
  static constexpr int FP = BWD_CHANNELS * 4 + SPARE;   // dt and gy rows
  static constexpr int BP = N * int(sizeof(T)) + SPARE;
  static constexpr int LANES4 = 2 * BWD_THREADS * 16;   // HALF f32 a lane
  // one stage: x, dt, gy, B and C rows as copied
  static constexpr int X = 0;
  static constexpr int DT = X + BWD_TILE * XP;
  static constexpr int GY = DT + BWD_TILE * FP;
  static constexpr int BR = GY + BWD_TILE * FP;
  static constexpr int CR = BR + BWD_TILE * BP;
  static constexpr int STAGE = CR + BWD_TILE * BP;
  // h_t and a_t of a sub-tile's steps but its last (kept in registers)
  static constexpr int HS = 2 * STAGE;
  static constexpr int AS = HS + (SUB - 1) * LANES4;
  static constexpr int STARTS = AS + (SUB - 1) * LANES4;   // sub-tiles'
  static constexpr int RED = STARTS + SUBS * LANES4;
  static constexpr int RED_BYTES = BWD_WARPS * BWD_TILE * 2 * N * 4;
  static constexpr int BYTES = RED + 2 * RED_BYTES;   // the sums, 2 bufs
  static_assert(XP % 16 == 0 && FP % 16 == 0 && BP % 16 == 0, "16 B rows");
};

// The sum over the 16 lanes of one parity of a warp of v[i], i < 8: at
// each of three exchanges a lane keeps half its sums and sends its partner
// the other half, then pairs add, and a last exchange adds pairs of lanes;
// lane l returns the sum of v[((l >> 4) & 1) * 4 + ((l >> 3) & 1) * 2 +
// ((l >> 2) & 1)] over the lanes of its parity (lanes l and l ^ 2 agree).
__device__ __forceinline__ float pair_sum8(const float (&v)[8]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (b4 ? v[4 + i] : v[i]) +
            __shfl_xor_sync(full, b4 ? v[i] : v[4 + i], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (b3 ? w4[2 + i] : w4[i]) +
            __shfl_xor_sync(full, b3 ? w4[i] : w4[2 + i], 8);
  const float w1 = (b2 ? w2[1] : w2[0]) +
                   __shfl_xor_sync(full, b2 ? w2[0] : w2[1], 4);
  return w1 + __shfl_xor_sync(full, w1, 2);
}

// ``local``'s address in the shared memory of the cluster's block ``rank``
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster barrier in two halves: a thread's wait returns once every
// thread of the cluster's blocks has arrived (as often as it has), and
// what each wrote before arriving, to its shared or device memory, is seen
// after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(float* v, const void* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void st4(void* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int N, int ALIGNED>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
selective_scan_bwd_kernel(BwdParams p) {
  static_assert(N == 2 * HALF, "two lanes a channel, HALF states each");
  using Lay = BwdLayout<T, N, ALIGNED>;
  constexpr int ES = int(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = tid >> 1, half = tid & 1;
  const long long b = blockIdx.y;
  const int S = p.S, D = p.D;
  const int c0 = blockIdx.x * BWD_CHANNELS;
  const int nch = max(0, min(BWD_CHANNELS, D - c0));
  const int c = c0 + ch;
  const bool live = ch < nch;
  const int tiles = (S + BWD_TILE - 1) / BWD_TILE;
  // byte pointers to this block's part of each array's first row.  A
  // block past D (the grid is whole clusters) points at the last channel:
  // copy_rows takes the chunk that holds a row's first byte even when it
  // copies none of the row, and past D that chunk would lie past the
  // array's end.  The block reads no channel of what it copies.
  const int cr = min(c0, D - 1);
  const char* xg = static_cast<const char*>(p.x) + (b * p.x_sb + cr) * ES;
  const char* dg = reinterpret_cast<const char*>(p.dt) +
                   (b * p.d_sb + cr) * 4;
  const char* gg = reinterpret_cast<const char*>(p.gy) +
                   (b * S * D + cr) * 4;
  const char* bg = static_cast<const char*>(p.Bm) + b * p.b_sb * ES;
  const char* cg = static_cast<const char*>(p.Cm) + b * p.c_sb * ES;
  const long long xs = p.x_ss * ES, ds = p.d_ss * 4,
                  gs = static_cast<long long>(D) * 4, bs = p.b_ss * ES,
                  cs = p.c_ss * ES;       // step strides in bytes
  // this lane's HALF states of tile 0's saved state; tile k's are k * D * N
  // floats on
  float* ck = p.ck + (b * tiles * D + (live ? c : 0)) * N + half * HALF;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // zero the ring, so that a channel past D reads zeros, not stale bits
  for (int i = tid; i < Lay::BYTES / 16; i += BWD_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  float a[HALF];
#pragma unroll
  for (int n = 0; n < HALF; ++n)
    a[n] = live ? p.A[static_cast<long long>(c) * N + half * HALF + n] : 0.f;

  // the copies of tile k, one group: x, dt and B; in phase 2 also gy and
  // C.  A thread waits for its own with cp_async_wait_all, and the barrier
  // after it shows every thread's.
  auto issue = [&](int k, bool walk) {
    const long long t0 = static_cast<long long>(k) * BWD_TILE;
    const int rows = min(BWD_TILE, S - k * BWD_TILE);
    const uint32_t st = sbase + (k & 1) * Lay::STAGE;
    copy_rows<Lay::XP, ALIGNED, BWD_TILE, BWD_THREADS>(
        st + Lay::X, xg + t0 * xs, xs, rows, nch * ES, tid);
    copy_rows<Lay::FP, ALIGNED, BWD_TILE, BWD_THREADS>(
        st + Lay::DT, dg + t0 * ds, ds, rows, nch * 4, tid);
    copy_rows<Lay::BP, ALIGNED, BWD_TILE, BWD_THREADS>(
        st + Lay::BR, bg + t0 * bs, bs, rows, N * ES, tid);
    if (walk) {
      copy_rows<Lay::FP, ALIGNED, BWD_TILE, BWD_THREADS>(
          st + Lay::GY, gg + t0 * gs, gs, rows, nch * 4, tid);
      copy_rows<Lay::BP, ALIGNED, BWD_TILE, BWD_THREADS>(
          st + Lay::CR, cg + t0 * cs, cs, rows, N * ES, tid);
    }
    cp_async_commit();
  };

  // tile k's staged rows: x_t, dt_t and gy_t of this lane's channel (zeros
  // for a channel past D), B_t and C_t of its HALF states, and where rows
  // may start off 16 bytes the offsets of the tile's first rows
  struct Tile {
    int x, d, g, b, c;                    // byte offsets in smem
    uint32_t xo, dof, go, bo, co;
  };
  auto tile = [&](int k) {
    const long long t0 = static_cast<long long>(k) * BWD_TILE;
    const int st = (k & 1) * Lay::STAGE;
    return Tile{st + Lay::X + ch * ES, st + Lay::DT + ch * 4,
                st + Lay::GY + ch * 4, st + Lay::BR, st + Lay::CR,
                static_cast<uint32_t>(row_off<ALIGNED>(xg + t0 * xs)),
                static_cast<uint32_t>(row_off<ALIGNED>(dg + t0 * ds)),
                static_cast<uint32_t>(row_off<ALIGNED>(gg + t0 * gs)),
                static_cast<uint32_t>(row_off<ALIGNED>(bg + t0 * bs)),
                static_cast<uint32_t>(row_off<ALIGNED>(cg + t0 * cs))};
  };
  const uint32_t xs32 = static_cast<uint32_t>(xs),
                 ds32 = static_cast<uint32_t>(ds),
                 gs32 = static_cast<uint32_t>(gs),
                 bs32 = static_cast<uint32_t>(bs),
                 cs32 = static_cast<uint32_t>(cs);
  constexpr uint32_t OFF = ALIGNED ? 0 : 15;
  auto xat = [&](const Tile& tl, int r) {
    return live ? to_f32(*reinterpret_cast<const T*>(
                      smem + tl.x + r * Lay::XP + ((tl.xo + r * xs32) & OFF)))
                : 0.f;
  };
  auto dat = [&](const Tile& tl, int r) {
    return live ? *reinterpret_cast<const float*>(
                      smem + tl.d + r * Lay::FP + ((tl.dof + r * ds32) & OFF))
                : 0.f;
  };
  auto gat = [&](const Tile& tl, int r) {
    return live ? *reinterpret_cast<const float*>(
                      smem + tl.g + r * Lay::FP + ((tl.go + r * gs32) & OFF))
                : 0.f;
  };
  // this lane's HALF values of a staged B or C row (its first element at
  // byte ``off`` of the row), in f32: in bf16 one 16-byte read
  auto bc_at = [&](int row, uint32_t off, float* v) {
    const unsigned char* at = smem + row + off + half * HALF * ES;
    if constexpr (ALIGNED && ES == 2) {
      const uint4 w = *reinterpret_cast<const uint4*>(at);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {           // bf16: the high 16 bits
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else if constexpr (ALIGNED) {
      ld4(v, at);
      ld4(v + 4, at + 16);
    } else {
#pragma unroll
      for (int n = 0; n < HALF; ++n)
        v[n] = to_f32(*reinterpret_cast<const T*>(at + n * ES));
    }
  };
  // one step of the forward at row r, rounded as selective_scan_kernel
  // rounds it: h advanced, and each state's decay a_t in an
#ifdef SCAN_BWD_COUNT_EXP
  int exps = 0;       // the probe build's count of this lane's exponentials
#endif
  auto forward = [&](const Tile& tl, int r, float (&h)[HALF],
                     float (&an)[HALF]) {
    const float xv = xat(tl, r), dv = dat(tl, r);
    float bv[HALF];
    bc_at(tl.b + r * Lay::BP, (tl.bo + r * bs32) & OFF, bv);
#pragma unroll
    for (int n = 0; n < HALF; ++n) {
      const float dA = expf(__fmul_rn(dv, a[n]));
#ifdef SCAN_BWD_COUNT_EXP
      ++exps;
#endif
      const float dBx = __fmul_rn(__fmul_rn(dv, bv[n]), xv);
      h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
      an[n] = dA;
    }
  };
  // a lane's HALF f32 in the [float4][thread] layout at byte ``at``
  auto lane_ld = [&](float* v, int at) {
    ld4(v, smem + at + tid * 16);
    ld4(v + 4, smem + at + (BWD_THREADS + tid) * 16);
  };
  auto lane_st = [&](int at, const float* v) {
    st4(smem + at + tid * 16, v);
    st4(smem + at + (BWD_THREADS + tid) * 16, v + 4);
  };

  // phase 1: the state before each tile; the last tile's own steps are
  // replayed in phase 2
  {
    float h[HALF], an[HALF];
#pragma unroll
    for (int n = 0; n < HALF; ++n) h[n] = 0.f;
    issue(0, false);
    cp_async_wait_all();
    for (int k = 0; k < tiles; ++k) {
      __syncthreads();  // this tile staged, the one before it consumed
      if (live) {
        float* dst = ck + static_cast<long long>(k) * D * N;
        st4(dst, h);
        st4(dst + 4, h + 4);
      }
      if (k + 1 == tiles) break;
      issue(k + 1, false);
      const Tile tl = tile(k);
#pragma unroll
      for (int r = 0; r < BWD_TILE; ++r) forward(tl, r, h, an);
      cp_async_wait_all();
    }
  }
  __syncthreads();   // phase 1's stages consumed, its saved states written

  // phase 2: the tiles in reverse
  const uint32_t rank = cluster_rank();
  const long long cluster = blockIdx.x / BWD_CLUSTER;
  float g[HALF], dA_acc[HALF], saved[HALF];
#pragma unroll
  for (int n = 0; n < HALF; ++n) {
    g[n] = (live && p.gh) ? p.gh[(b * D + c) * N + half * HALF + n] : 0.f;
    dA_acc[n] = 0.f;
    saved[n] = 0.f;
  }
  // the lane's half of tile k's saved state, which it wrote in phase 1
  auto load_saved = [&](int k) {
    if (live) {
      const float* src = ck + static_cast<long long>(k) * D * N;
      ld4(saved, src);
      ld4(saved + 4, src + 4);
    }
  };
  // tile kk's dB and dC: this block's slice of the tile's sums, four
  // states a group of BWD_CLUSTER lanes.  Lane q of a group adds rank q's
  // warps' terms in warp order, and the group's first lane adds the ranks'
  // partials in rank order.
  auto reduce = [&](int kk) {
    constexpr int PER = BWD_TILE * 2 * N / 4 / BWD_CLUSTER;   // a rank's
    const int steps = min(BWD_TILE, S - kk * BWD_TILE);
    const uint32_t red = sbase + Lay::RED + (kk & 1) * Lay::RED_BYTES;
#pragma unroll
    for (int i0 = 0; i0 < PER * BWD_CLUSTER; i0 += BWD_THREADS) {
      const int i = i0 + tid, q = i % BWD_CLUSTER;
      const int slot = static_cast<int>(rank) * PER + i / BWD_CLUSTER;
      const int r = slot / (N / 2), w = (slot / (N / 4)) & 1,
                n = 4 * (slot % (N / 4));
      const bool on = i < PER * BWD_CLUSTER && r < steps;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {
#pragma unroll
        for (int wp = 0; wp < BWD_WARPS; ++wp) {
          const float4 u = ld_cluster4(
              peer_addr(red, q) + (((wp * BWD_TILE + r) * 2 + w) * N + n) * 4);
          t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
        }
      }
      float4 v = t;
#pragma unroll
      for (int d = 1; d < BWD_CLUSTER; ++d) {
        const unsigned full = 0xffffffffu;
        v.x += __shfl_down_sync(full, t.x, d, BWD_CLUSTER);
        v.y += __shfl_down_sync(full, t.y, d, BWD_CLUSTER);
        v.z += __shfl_down_sync(full, t.z, d, BWD_CLUSTER);
        v.w += __shfl_down_sync(full, t.w, d, BWD_CLUSTER);
      }
      if (on && q == 0) {
        float* part = w ? p.dC_part : p.dB_part;
        *reinterpret_cast<float4*>(
            part + ((cluster * p.B + b) * S + kk * BWD_TILE + r) * N + n) = v;
      }
    }
  };
  const int nl = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                 ((lane >> 2) & 1);            // pair_sum8's state
  float* out = (half ? p.ddt : p.dx) + b * S * D + c;   // dx, ddt at t = 0
  issue(tiles - 1, true);
  load_saved(tiles - 1);
  cp_async_wait_all();
  for (int k = tiles - 1; k >= 0; --k) {
    const int T0 = k * BWD_TILE;
    const int steps = min(BWD_TILE, S - T0);
    const int subs = (steps + SUB - 1) / SUB;
    __syncthreads();  // tile k staged; tile k + 1 consumed
    if (k > 0) issue(k - 1, true);
    const Tile tl = tile(k);
    float* red = reinterpret_cast<float*>(smem + Lay::RED +
                                          (k & 1) * Lay::RED_BYTES) +
                 warp * BWD_TILE * 2 * N + half * HALF + nl;
    lane_st(Lay::STARTS, saved);        // sub-tile 0's start
    if (subs > 1) {                     // the starts of sub-tiles 1 ..
      float h[HALF], an[HALF];
#pragma unroll
      for (int n = 0; n < HALF; ++n) h[n] = saved[n];
      for (int s = 1; s < subs; ++s) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) forward(tl, (s - 1) * SUB + j, h, an);
        lane_st(Lay::STARTS + s * Lay::LANES4, h);
      }
    }
    if (k + 1 < tiles) {
      // every block of the cluster has walked tile k + 1: its sums are
      // written, and tile k + 2's read, so tile k's buffer is free
      cluster_wait();
      reduce(k + 1);
    }
    for (int s = subs - 1; s >= 0; --s) {
      const int r0 = s * SUB, n_s = min(SUB, steps - r0);
      const int start = Lay::STARTS + s * Lay::LANES4;
      float h[HALF], an[HALF];
      lane_ld(h, start);
      if (s == 0 && k > 0) load_saved(k - 1);   // in flight while walked
      auto keep = [&](int j) {          // h_t and a_t of step j, kept
        forward(tl, r0 + j, h, an);
        if (j < n_s - 1) {               // the last stay in registers
          lane_st(Lay::HS + j * Lay::LANES4, h);
          lane_st(Lay::AS + j * Lay::LANES4, an);
        }
      };
      if (n_s == SUB) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) keep(j);
      } else {
        for (int j = 0; j < n_s; ++j) keep(j);
      }
      auto back = [&](int j) {           // the walk at step j; h is h_t
        const int r = r0 + j;
        const long long t = T0 + r;
        const float xv = xat(tl, r), dv = dat(tl, r), gv = gat(tl, r);
        float bv[HALF], cv[HALF], hp[HALF];
        bc_at(tl.b + r * Lay::BP, (tl.bo + r * bs32) & OFF, bv);
        bc_at(tl.c + r * Lay::BP, (tl.co + r * cs32) & OFF, cv);
        lane_ld(hp, j ? Lay::HS + (j - 1) * Lay::LANES4 : start);
        if (j < n_s - 1) lane_ld(an, Lay::AS + j * Lay::LANES4);
        float vB[HALF], vC[HALF], sdx = 0.f, sdt = 0.f;
#pragma unroll
        for (int n = 0; n < HALF; ++n) {
          const float ah = __fmul_rn(an[n], hp[n]);   // a_t h_{t-1}
          g[n] = fmaf(gv, cv[n], g[n]);
          const float gd = g[n] * dv;
          vB[n] = gd * xv;
          vC[n] = gv * h[n];
          sdx = fmaf(g[n], bv[n], sdx);
          sdt = fmaf(g[n], fmaf(a[n], ah, bv[n] * xv), sdt);
          dA_acc[n] = fmaf(gd, ah, dA_acc[n]);
          g[n] *= an[n];                    // carried to step t - 1
          h[n] = hp[n];
        }
        // the channel's two halves; each lane sums them in its own order,
        // and a + b = b + a
        sdx += __shfl_xor_sync(0xffffffffu, sdx, 1);
        sdt += __shfl_xor_sync(0xffffffffu, sdt, 1);
        store_if(out + t * D, half ? sdt : dv * sdx, live);
        const float sumB = pair_sum8(vB), sumC = pair_sum8(vC);
        if ((lane & 2) == 0) {
          red[r * 2 * N] = sumB;
          red[(r * 2 + 1) * N] = sumC;
        }
      };
      if (n_s == SUB && ALIGNED && ES == 2) {   // (unrolled, others spill)
#pragma unroll
        for (int j = SUB - 1; j >= 0; --j) back(j);
      } else {
        for (int j = n_s - 1; j >= 0; --j) back(j);
      }
    }
    cluster_arrive();                   // tile k walked
    if (k > 0) cp_async_wait_all();     // tile k - 1's own copies
  }
#ifdef SCAN_BWD_COUNT_EXP
  // the probe build: dA's first state of each lane's half holds the
  // exponentials the lane took, summed over batch rows as dA is
#pragma unroll
  for (int n = 0; n < HALF; ++n) dA_acc[n] = n == 0 ? float(exps) : 0.f;
#endif
  if (live) {
    float* dst = p.dA_part + (b * D + c) * N + half * HALF;
    st4(dst, dA_acc);
    st4(dst + 4, dA_acc + 4);
  }
  cluster_wait();
  reduce(0);
  cluster_arrive();   // no block leaves while a peer reads its sums
  cluster_wait();
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

// Blocks a batch row: the channels' blocks, rounded up to whole clusters.
int bwd_blocks(int D) {
  const int blocks = (D + BWD_CHANNELS - 1) / BWD_CHANNELS;
  return (blocks + BWD_CLUSTER - 1) / BWD_CLUSTER * BWD_CLUSTER;
}

template <typename T, int ALIGNED>
cudaError_t bwd_allow_shared() {
  return cudaFuncSetAttribute(selective_scan_bwd_kernel<T, 16, ALIGNED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              BwdLayout<T, 16, ALIGNED>::BYTES);
}

template <typename T, int ALIGNED>
int launch_bwd_instance(const BwdParams& p, cudaStream_t stream) {
  cudaError_t e = bwd_allow_shared<T, ALIGNED>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BWD_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bwd_blocks(p.D), p.B);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = BwdLayout<T, 16, ALIGNED>::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, selective_scan_bwd_kernel<T, 16, ALIGNED>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdParams& p, int N, float* dA, float* dB, float* dC,
               cudaStream_t stream) {
  constexpr int ES = int(sizeof(T));
  if (N != 16) return cudaErrorInvalidValue;
  const bool aligned = rows_aligned(p.x, p.x_sb, p.x_ss, ES) &&
                       rows_aligned(p.dt, p.d_sb, p.d_ss, 4) &&
                       rows_aligned(p.gy, static_cast<long long>(p.S) * p.D,
                                    p.D, 4) &&
                       rows_aligned(p.Bm, p.b_sb, p.b_ss, ES) &&
                       rows_aligned(p.Cm, p.c_sb, p.c_ss, ES);
  int rc = aligned ? launch_bwd_instance<T, 1>(p, stream)
                   : launch_bwd_instance<T, 0>(p, stream);
  if (rc != 0) return rc;
  const long long bsn = static_cast<long long>(p.B) * p.S * N;
  const int parts = bwd_blocks(p.D) / BWD_CLUSTER;
  rc = sum_parts(p.dB_part, dB, parts, bsn, stream);
  if (rc == 0) rc = sum_parts(p.dC_part, dC, parts, bsn, stream);
  if (rc == 0)
    rc = sum_parts(p.dA_part, dA, p.B, static_cast<long long>(p.D) * N,
                   stream);
  return rc;
}

template <typename T, int ALIGNED>
int bwd_occupancy() {
  int blocks = 0;
  cudaError_t e = bwd_allow_shared<T, ALIGNED>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, selective_scan_bwd_kernel<T, 16, ALIGNED>, BWD_THREADS,
        BwdLayout<T, 16, ALIGNED>::BYTES);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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
// through the f32 scratch ck, dB_part, dC_part and dA_part, each of the
// floats selective_scan_bwd_scratch gives.  Launches on ``stream`` (the
// scan, then three ordered sums), allocates nothing, does not
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

// Backward blocks of BWD_THREADS that one SM holds at once for the N 16
// instance of the given input type and row alignment, or minus a CUDA
// error.
extern "C" int selective_scan_bwd_blocks_per_sm(int bf16, int aligned) {
  if (bf16)
    return aligned ? bwd_occupancy<__nv_bfloat16, 1>()
                   : bwd_occupancy<__nv_bfloat16, 0>();
  return aligned ? bwd_occupancy<float, 1>() : bwd_occupancy<float, 0>();
}

// The floats of selective_scan_bwd's four scratch arrays at (B, S, D, N),
// written to floats[0..3]: ck, the state before every BWD_TILE-step tile
// (B, ceil(S / BWD_TILE), D, N); dB_part and dC_part, a partial a cluster
// of each batch row (clusters, B, S, N); dA_part (B, D, N).
extern "C" void selective_scan_bwd_scratch(int B, int S, int D, int N,
                                           long long* floats) {
  const long long b = B, n = N, clusters = bwd_blocks(D) / BWD_CLUSTER;
  floats[0] = b * ((S + BWD_TILE - 1) / BWD_TILE) * D * n;
  floats[1] = floats[2] = clusters * b * S * n;
  floats[3] = b * D * n;
}

// Threads of a backward block.
extern "C" int selective_scan_bwd_threads() { return BWD_THREADS; }
