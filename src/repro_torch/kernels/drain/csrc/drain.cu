// Departure-ordered max-min drain, one block per seed, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package drains event timing's bytes
// on the host with numpy,
//   src/repro/core/vector_throughput.py  departure_fill (:395)
// one round per departure epoch: a parallel local-bottleneck max-min fill
// of the live (column, seed) cells, each cell's finish time rem / (rate x
// efficiency), the seed's earliest finish as its horizon, every cell
// within 1e-12 of it departing, the others draining rate x efficiency x
// horizon, and a re-fill of the survivors.  Its seeds never interact, so
// here each seed's whole drain runs in one block: the seed's per-link
// state (member count, weight sum, residual, fair share, undercut mark)
// lives in shared memory, its cells' state in global memory (each cell
// owned by one thread for the whole launch), and every round's host
// decision (any cell left, the horizon, the zero-goodput fault) is a
// block reduction.  One launch replaces the PyTorch plain version's
// dozens of launches and one host read per freeze round.
//
// Arithmetic follows the reference's operation by operation (products,
// quotients and differences rounded one at a time: no contraction); the
// per-link sums are shared-memory atomics, so their order, and the last
// bits of the shares, change from run to run, as in the card's PyTorch
// fill.  A freeze round freezes every free cell whose path holds a link
// that no free member's bottleneck share undercuts (the reference's
// "min over members == share" test).
//
// Bound: latency.  The rounds are sequential; each moves a seed's cells
// (4 to 16 bytes a hop) through L1/L2 a few times and does a handful of
// float64 operations a cell-hop; the kernel counts those operations.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// cell states: departed (or never live), free in the current fill,
// frozen in it, frozen in this freeze round (its weight still to drain)
constexpr uint8_t kGone = 0, kFree = 1, kFrozen = 2, kFroze = 3;
constexpr double kInf = __builtin_huge_val();

struct Params {
  const int32_t* links;  // (H, A) link within the seed, -1: no link
  const int64_t* seg;    // (S + 1,) first cell of each seed
  const double* cap;     // (L,) Gb/s
  const double* gbits;   // (A,) gigabits to drain, > 0
  const double* eff;     // (A,) goodput multiplier
  const double* w;       // (A,) demand weights, or null: unit demand
  const double* init;    // (A,) round-1 rates, or null
  double* rem;           // (A,) scratch: gigabits left
  double* rate;          // (A,) scratch: the fill's max-min rate
  double* fm;            // (A,) scratch: bottleneck share
  uint8_t* st;           // (A,) scratch: cell state
  double* done;          // (A,) out: completion, seconds from t = 0
  long long* stats;      // (S, 4) out: drain rounds, freeze rounds,
                         //   float64 operations, fault (1: a live cell
                         //   with zero goodput, 2: no convergence)
  long long A;
  long long max_rounds;
  int H;
  int L;
};

__device__ __forceinline__ double block_min(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : kInf;
    for (int o = 16; o > 0; o >>= 1)
      v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ double finish(double rem, double rate,
                                         double eff, double* good) {
  *good = __dmul_rn(rate, eff);
  const double fin = __ddiv_rn(rem, *good);
  return isnan(fin) ? kInf : fin;
}

__global__ void __launch_bounds__(kThreads) drain_kernel(Params p) {
  extern __shared__ double smem[];
  const int L = p.L, H = p.H;
  const long long A = p.A;
  double* mem = smem;
  double* wsum = mem + L;
  double* res = wsum + L;
  double* share = res + L;
  double* red = share + L;
  uint8_t* undercut = reinterpret_cast<uint8_t*>(red + kWarps);
  const int s = blockIdx.x, tid = threadIdx.x;
  const long long c0 = p.seg[s], c1 = p.seg[s + 1];
  const int32_t* links = p.links;

  for (long long c = c0 + tid; c < c1; c += kThreads) {
    p.rem[c] = p.gbits[c];
    p.st[c] = kFree;
  }
  double t = 0.0;
  long long rounds = 0, fills = 0, ops = 0, fault = 0;
  bool live = c1 > c0;
  while (live) {
    ++rounds;
    if (rounds > p.max_rounds) {
      fault = 2;
      break;
    }
    if (rounds == 1 && p.init) {
      for (long long c = c0 + tid; c < c1; c += kThreads)
        p.rate[c] = p.init[c];
    } else {
      // the fill: member counts and weight sums of the live cells
      for (int l = tid; l < L; l += kThreads) {
        mem[l] = 0.0;
        wsum[l] = 0.0;
        res[l] = p.cap[l];
      }
      __syncthreads();
      for (long long c = c0 + tid; c < c1; c += kThreads) {
        if (p.st[c] == kGone) continue;
        const double wc = p.w ? p.w[c] : 1.0;
        bool linked = false;
        for (int h = 0; h < H; ++h) {
          const int l = links[h * A + c];
          if (l < 0) continue;
          atomicAdd(&mem[l], 1.0);
          atomicAdd(&wsum[l], wc);
          linked = true;
          ops += 2;
        }
        if (linked) {
          p.st[c] = kFree;
        } else {              // crosses no link: drains at infinite rate
          p.st[c] = kFrozen;
          p.rate[c] = kInf;
        }
      }
      __syncthreads();
      for (int l = tid; l < L; l += kThreads)
        share[l] = mem[l] > 0.0 ? __ddiv_rn(res[l], fmax(wsum[l], 1e-300))
                                : kInf;
      __syncthreads();
      while (true) {
        // each free cell's bottleneck share; clear the undercut marks
        int any_free = 0;
        for (int l = tid; l < L; l += kThreads) undercut[l] = 0;
        for (long long c = c0 + tid; c < c1; c += kThreads) {
          if (p.st[c] != kFree) continue;
          double m = kInf;
          for (int h = 0; h < H; ++h) {
            const int l = links[h * A + c];
            if (l >= 0) m = fmin(m, share[l]);
            ops += l >= 0;
          }
          p.fm[c] = m;
          any_free = 1;
        }
        if (!__syncthreads_or(any_free)) break;
        ++fills;
        // a link some free member's bottleneck undercuts is no local
        // bottleneck
        for (long long c = c0 + tid; c < c1; c += kThreads) {
          if (p.st[c] != kFree) continue;
          const double m = p.fm[c];
          for (int h = 0; h < H; ++h) {
            const int l = links[h * A + c];
            if (l >= 0 && share[l] > m) undercut[l] = 1;
            ops += l >= 0;
          }
        }
        __syncthreads();
        // a free cell on any local bottleneck freezes at its share
        int any_left = 0;
        for (long long c = c0 + tid; c < c1; c += kThreads) {
          if (p.st[c] != kFree) continue;
          bool fz = false;
          for (int h = 0; h < H; ++h) {
            const int l = links[h * A + c];
            fz |= l >= 0 && !undercut[l];
          }
          if (fz) {
            p.rate[c] = p.w ? __dmul_rn(p.w[c], p.fm[c]) : p.fm[c];
            p.st[c] = kFroze;
            ops += 1;
          } else {
            any_left = 1;
          }
        }
        if (!__syncthreads_or(any_left)) {   // all froze: nothing to drain
          for (long long c = c0 + tid; c < c1; c += kThreads)
            if (p.st[c] == kFroze) p.st[c] = kFrozen;
          break;
        }
        // drain the frozen cells' members, weights and rates
        for (long long c = c0 + tid; c < c1; c += kThreads) {
          if (p.st[c] != kFroze) continue;
          const double wc = p.w ? p.w[c] : 1.0, rc = p.rate[c];
          for (int h = 0; h < H; ++h) {
            const int l = links[h * A + c];
            if (l < 0) continue;
            atomicAdd(&mem[l], -1.0);
            atomicAdd(&wsum[l], -wc);
            atomicAdd(&res[l], -rc);
            ops += 3;
          }
          p.st[c] = kFrozen;
        }
        __syncthreads();
        for (int l = tid; l < L; l += kThreads) {
          share[l] = mem[l] > 0.0
                         ? __ddiv_rn(res[l], fmax(wsum[l], 1e-300))
                         : kInf;
          ops += 1;
        }
        __syncthreads();
      }
    }
    // the horizon: the seed's earliest finish
    double lo = kInf, good;
    for (long long c = c0 + tid; c < c1; c += kThreads) {
      if (p.st[c] == kGone) continue;
      lo = fmin(lo, finish(p.rem[c], p.rate[c], p.eff[c], &good));
      ops += 3;
    }
    const double dt = block_min(lo, red);
    if (!isfinite(dt)) {
      fault = 1;
      break;
    }
    // everything within float tolerance of the horizon departs; the
    // others drain for it
    const double horizon = __dmul_rn(dt, 1.0 + 1e-12);
    int any_live = 0;
    for (long long c = c0 + tid; c < c1; c += kThreads) {
      if (p.st[c] == kGone) continue;
      const double fin = finish(p.rem[c], p.rate[c], p.eff[c], &good);
      if (fin <= horizon) {
        p.done[c] = __dadd_rn(t, fin);
        p.st[c] = kGone;
      } else {
        const double d = isfinite(good) ? good : 0.0;
        p.rem[c] = fmax(__dsub_rn(p.rem[c], __dmul_rn(d, dt)), 0.0);
        any_live = 1;
      }
      ops += 4;
    }
    t = __dadd_rn(t, dt);
    live = __syncthreads_or(any_live);
  }
  atomicAdd(reinterpret_cast<unsigned long long*>(&p.stats[4 * s + 2]),
            static_cast<unsigned long long>(ops));
  if (tid == 0) {
    p.stats[4 * s] = rounds;
    p.stats[4 * s + 1] = fills;
    p.stats[4 * s + 3] = fault;
  }
}

}  // namespace

extern "C" int departure_drain(const void* links, const void* seg,
                               const void* cap, const void* gbits,
                               const void* eff, const void* w,
                               const void* init, void* rem, void* rate,
                               void* fm, void* st, void* done, void* stats,
                               long long A, long long max_rounds, int H,
                               int L, int S, void* stream) {
  if (S <= 0) return 0;
  const size_t smem = static_cast<size_t>(L) * 4 * sizeof(double) +
                      kWarps * sizeof(double) + static_cast<size_t>(L);
  cudaError_t err = cudaFuncSetAttribute(
      drain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const int32_t*>(links),
           static_cast<const int64_t*>(seg),
           static_cast<const double*>(cap),
           static_cast<const double*>(gbits),
           static_cast<const double*>(eff),
           static_cast<const double*>(w),
           static_cast<const double*>(init),
           static_cast<double*>(rem),
           static_cast<double*>(rate),
           static_cast<double*>(fm),
           static_cast<uint8_t*>(st),
           static_cast<double*>(done),
           static_cast<long long*>(stats),
           A, max_rounds, H, L};
  drain_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
