// Mamba-1's selective scan over time, for sm_90a, with x, B and C in bf16
// or f32 and every product and sum in f32.
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
