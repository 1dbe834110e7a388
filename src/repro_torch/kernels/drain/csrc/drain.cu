// Departure-ordered max-min drain for sm_90a: a thread-block cluster
// per seed, working over dense lists of live and free cells.
//
// Replaces no Pallas kernel: the JAX package drains event timing's bytes
// on the host with numpy,
//   src/repro/core/vector_throughput.py  departure_fill (:395)
// one round per departure epoch: a parallel local-bottleneck max-min fill
// of the live (column, seed) cells, each cell's finish time rem / (rate x
// efficiency), the seed's earliest finish as its horizon, every cell
// within 1e-12 of it departing, the others draining rate x efficiency x
// horizon, and a fresh fill of the survivors.  Seeds never interact, so
// each seed's whole drain runs in one cluster of one launch.
//
// Bound: latency.  The work is a chain of rounds, about 10 freeze rounds
// to a drain round (29,602 freeze rounds of 2,795 drain rounds at
// prime-spray's MoE step: 32,768 columns x 64 seeds, 1,024 links, 4
// hops).  The first design (one 1,024-thread block a seed, every pass
// striding over all of the seed's cells in global memory) spent 136 us a
// freeze round there and 16.5 us at ECMP's 4,096 columns.  The numbers
// below are NVIDIA H100 80GB HBM3 at 700 W, from kernels/drain/compare.py.
//
// - Dense lists.  A CTA keeps its cells' live list, and within a fill
//   the free list, as uint16 offsets in shared memory, compacted as they
//   are written (warp ballot, one shared atomic a warp), so every pass
//   runs over cells that matter and no lane loads a state byte only to
//   skip it.  Three list buffers rotate: the live list and the free
//   lists' two ping-pong halves; a drain round writes the new live list
//   into a free half.
// - Small hot state.  Links within a seed are int16, a cell's hops one
//   8-byte load (4 hops; 16 bytes up to 8): 16.8 MB for 2,097,152 cells,
//   which stays in the 50 MB L2.  A CTA holds each link's share (float64),
//   undercut stamp and member count (int32) in shared memory; the seed's
//   weight sums and residuals (16 bytes a link) sit in L2.  Rates, remaining
//   gigabits, weights and efficiency are read or written only at freeze
//   time and at the horizon.  No member count: a free cell is a member
//   of each of its links, so the shares it reads always have a member,
//   and the reference's "no member: infinite share" never shows.
// - Sums as L2 reductions.  Float64 atomicAdd into shared memory is a
//   compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN.64 in the SASS), and
//   a bottleneck link's members all drain into it in one round; the sums
//   take fire-and-forget REDG.E.ADD.F64 into L2 instead (freeze and
//   drain: 55 % of the cycles before, 42 % after; 1,056 -> 881 ms at
//   prime-spray's step, 16.0 -> 11.5 ms at ECMP's).  A frozen cell drains
//   only its stamped links: an unstamped link's free members all freeze
//   with it, and nothing reads its sums again in the fill (881 -> 836 ms).
//   Under one power-of-two weight for every cell (unit demand: 1;
//   prime-spray's eight flowlets a flow: 0.125) a partial weight sum is
//   exactly members x weight in any order, so the weight sums are int32
//   member counts in shared memory under native atomics, and only the
//   residuals go to L2 (777 -> 623 ms, 10.32 -> 9.31 ms).  The
//   reductions' throughput, not the loads' latency, bounded the passes:
//   2, 4 or 8 cells in flight a thread timed the same.
// - Fewer barriers.  A freeze round is three: the bottleneck pass stamps
//   undercut links with the round's number in every CTA of the cluster
//   (no clearing pass), a cluster barrier, the freeze pass recomputes
//   each free cell's bottleneck (no stored fm), freezes it, drains it
//   and appends survivors to the next free list, a cluster barrier, then
//   each CTA computes the shares from the seed's sums (every link's sums
//   read only after every freeze of the round has drained, the
//   reference's order) and a block barrier.  A drain round adds three:
//   the fill's weight sums, the horizon and the departures.  A
//   cluster-wide count or minimum rides on the barrier it needs anyway:
//   each warp stores its value into its row of every CTA's table (two
//   tables alternating by phase), and after the barrier each warp
//   reduces the table's C x 16 rows.  Plain stores, because 64-bit
//   atomics into a peer's shared memory did not reach it (the first
//   build on the card: each CTA departed on its own horizon).
// - More SMs.  A seed's cells are split over a cluster of 1 to 8 CTAs
//   (ops.plan: the smallest that holds the lists, spread up to 4 while
//   each CTA keeps 2,048 cells and the card keeps every cluster
//   resident), which share stamps, member counts, list counts and the
//   horizon through distributed shared memory.  ECMP's step takes 2 (10.15 ms against
//   10.94 for 1), prime-spray's 2 (829 ms; 1 does not hold its lists in
//   one CTA at 1,888 ms, and 4 runs two waves at 1,222 ms).  512
//   threads a CTA leave ptxas 128 registers: no spills.
//
// Arithmetic follows the reference's operation by operation (products,
// quotients and differences rounded one at a time: no contraction), and
// every fill starts from fresh sums.  The per-link sums are atomic
// reductions, so their order, and the last bits of the shares, change
// from run to run, as in the first design; every CTA of a cluster reads
// the same sums, so its CTAs agree on every share.  A freeze round
// freezes every free cell whose path holds a link that no free member's
// bottleneck share undercuts (the reference's "min over members ==
// share" test).
//
// The operations counted (stats[:, 2]) are the float64 operations the
// inputs' live and free cells and links need, by the first design's
// rule, not what this design executes: 2 a hop of each live cell in a
// fill, 2 a hop of each free cell in a freeze round, 1 a frozen cell, 3
// a hop of each cell drained before a next round, 1 a link a next
// round's shares, 3 and 4 a live cell at the horizon and its departure.
//
// A second entry point, drain_sync_probe, runs one launch shape's
// cluster-wide reduction (a warp minimum stored into every CTA's table,
// the barrier and each warp's minimum over the table) in a loop: the cost
// of one round of the chain.  drain_resident_clusters asks the runtime
// how many clusters of a shape the card keeps resident (ops.plan), and
// drain_stats_cols how wide a seed's statistics row is (-DDRAIN_PROFILE
// builds add the cycles of each phase).
//
// Plain C interface for ctypes: the launches go on the caller's stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;       // ops.THREADS
constexpr int kMaxCluster = 8;      // ops.MAX_CLUSTER: portable cluster size
constexpr int kSmemBudget = 232448; // ops.SMEM_BUDGET
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr double kInf = __builtin_huge_val();

struct Params {
  const uint2* links;    // (A, 4 x chunks) int16 links within the seed,
                         //   -1: no link; a uint2 holds 4 hops
  const int64_t* seg;    // (S + 1,) first cell of each seed
  const double* cap;     // (L,) Gb/s
  const double* gbits;   // (A,) gigabits to drain, > 0
  const double* eff;     // (A,) goodput multiplier
  const double* w;       // (A,) demand weights, or null: every cell w0
  const double* init;    // (A,) round-1 rates, or null
  double* rem;           // (A,) scratch: gigabits left
  double* rate;          // (A,) scratch: the fill's max-min rate
  double* done;          // (A,) out: completion, seconds from t = 0
  double* sums;          // (S, 2, L) scratch: each seed's weight sums and
                         //   residuals
  long long* stats;      // (S, kStats) out: drain rounds, freeze rounds,
                         //   float64 operations, fault (1: a live cell
                         //   with zero goodput, 2: no convergence)
  long long max_rounds;
  double w0;             // every cell's weight where w is null: a power
                         //   of two (1: unit demand)
  int L;
  int cap_cells;         // list capacity of one CTA (ops.Plan)
};

constexpr int kWarps = kThreads / 32;
// A phase's cluster-wide values: each warp's value, stored by its lane 0
// into row (rank, warp) of every CTA's table for the phase's parity;
// and the CTA's own list length (append position) for the phase.
constexpr int kTableWords = 2 * kMaxCluster * kWarps;
constexpr int kFixedBytes = kTableWords * 8 + 4 * 4;   // ops.FIXED_BYTES

// smem: shares (float64 a link), the two value tables and three list
// lengths, undercut stamps and member counts (int32 a link), three lists
// (uint16 a cell): ops.smem_bytes
size_t smem_bytes(int L, int cap_cells) {
  return static_cast<size_t>(L) * 16 + kFixedBytes +
         static_cast<size_t>(cap_cells) * 6;
}

// The cluster's barriers, each the end of a phase.  Phase j's values go
// to table j % 2 by plain stores (no remote atomics); after barrier j
// each warp reduces the C x kWarps values, which are next written in
// phase j + 2, after barrier j + 1.  Every warp puts a value in a phase
// whose values are read.  Phase j appends at length j % 3, which thread 0
// zeroes after barrier j - 2 (phase j - 3 read it before barrier j - 2).
struct Cluster {
  unsigned long long* table;   // [2][kMaxCluster][kWarps]
  unsigned int* len;           // [3]
  int C, rank, j;

  __device__ void put(unsigned long long v) {   // lane 0 of each warp
    unsigned long long* mine =
        table + ((j & 1) * kMaxCluster + rank) * kWarps + (threadIdx.x >> 5);
    if (C == 1) {
      *mine = v;
      return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    for (int r = 0; r < C; ++r) *cluster.map_shared_rank(mine, r) = v;
  }
  __device__ unsigned int* local() { return len + j % 3; }
  __device__ void sync() {
    if (C == 1)
      __syncthreads();
    else
      cg::this_cluster().sync();
    if (threadIdx.x == 0) len[(j + 2) % 3] = 0;
    ++j;
  }
  // the ended phase's values and list length (after sync)
  __device__ const unsigned long long* ended() {
    return table + ((j - 1) & 1) * kMaxCluster * kWarps;
  }
  __device__ unsigned long long sum() {
    const unsigned long long* v = ended();
    unsigned long long a = 0;
    for (int i = threadIdx.x & 31; i < C * kWarps; i += 32) a += v[i];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    return a;
  }
  __device__ double min() {
    const unsigned long long* v = ended();
    double a = kInf;
    for (int i = threadIdx.x & 31; i < C * kWarps; i += 32)
      a = fmin(a, __longlong_as_double(static_cast<long long>(v[i])));
    for (int o = 16; o > 0; o >>= 1)
      a = fmin(a, __shfl_xor_sync(kFull, a, o));
    return a;
  }
  __device__ int ended_len() { return static_cast<int>(len[(j - 1) % 3]); }
};

// Appends v where keep (every lane of the warp calls): one shared atomic
// a warp; the warp's count of appended entries grows in *count.
__device__ __forceinline__ void append(bool keep, int v, uint16_t* out,
                                       unsigned int* len, unsigned* count) {
  const unsigned m = __ballot_sync(kFull, keep);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  unsigned base = 0;
  if (lane == 0) base = atomicAdd(len, static_cast<unsigned>(__popc(m)));
  base = __shfl_sync(kFull, base, 0);
  if (keep)
    out[base + __popc(m & ((1u << lane) - 1u))] = static_cast<uint16_t>(v);
  *count += __popc(m);
}

template <int NC>
__device__ __forceinline__ int hop(const uint2 (&hv)[NC], int h) {
  const uint32_t word = (h & 2) ? hv[h >> 2].y : hv[h >> 2].x;
  return static_cast<int16_t>(word >> ((h & 1) * 16));
}

// f(offset or -1, hops) over list[0, n), every thread the same number of
// calls (the lists' appends are warp-wide), kBatch cells' loads in
// flight before the first is used: 4 cells of 4 hops or 2 of 8 (2, 4 and
// 8 time the same; 4 of 8 hops spill at the 128-register cap).
template <int NC, class F>
__device__ __forceinline__ void over_list(const uint16_t* list, int n,
                                          const uint2* lk, F&& f) {
  constexpr int kBatch = 4 / NC;
  for (int t0 = 0; t0 < n; t0 += kThreads * kBatch) {
    int idx[kBatch];
    uint2 hv[kBatch][NC];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = t0 + u * kThreads + static_cast<int>(threadIdx.x);
      idx[u] = i < n ? list[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int k = 0; k < NC; ++k)
        hv[u][k] = idx[u] >= 0 ? __ldg(lk + static_cast<size_t>(idx[u]) * NC + k)
                               : make_uint2(kFull, kFull);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) f(idx[u], hv[u]);
  }
}

// -DDRAIN_PROFILE builds add the SM clock cycles that rank 0's thread 0
// spends in each phase (from the barrier before to the barrier that ends
// it) to the statistics: the fill's member sums, the shares, the
// bottleneck pass, the freeze pass, the horizon, the departures.
#ifdef DRAIN_PROFILE
constexpr int kPhases = 6;
struct PhaseClock {
  long long t = 0, acc[kPhases] = {};
  __device__ void start() { t = clock64(); }
  __device__ void lap(int k) {
    const long long now = clock64();
    acc[k] += now - t;
    t = now;
  }
  __device__ void store(long long* out) const {
    for (int k = 0; k < kPhases; ++k) out[k] = acc[k];
  }
};
#else
constexpr int kPhases = 0;
struct PhaseClock {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void store(long long*) const {}
};
#endif
constexpr int kStats = 4 + kPhases;   // ops: drain_stats_cols()

// A load of a link sum that other threads' reductions reached (L2, not
// L1), ordered after them by the barrier between.
__device__ __forceinline__ double load_l2(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ double finish(double rem, double rate,
                                         double eff, double* good) {
  *good = __dmul_rn(rate, eff);
  const double fin = __ddiv_rn(rem, *good);
  return isnan(fin) ? kInf : fin;
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) drain_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = p.L, tid = threadIdx.x, lane = tid & 31;
  double* share = reinterpret_cast<double*>(smem);
  auto* table = reinterpret_cast<unsigned long long*>(share + L);
  auto* len = reinterpret_cast<unsigned int*>(table + kTableWords);
  int* stamp = reinterpret_cast<int*>(len + 4);
  int* count = stamp + L;          // this CTA's members a link (w null)
  uint16_t* lists = reinterpret_cast<uint16_t*>(count + L);
  auto buf = [&](int b) { return lists + b * p.cap_cells; };

  // this CTA's cells: a contiguous share of the seed's segment
  const int s = blockIdx.x / C;
  const long long c0 = p.seg[s], n = p.seg[s + 1] - c0;
  const long long q = (n + C - 1) / C;
  const long long b0 = c0 + min(n, rank * q);
  const int nr = static_cast<int>(min(n, (rank + 1) * q) - min(n, rank * q));
  const uint2* lk = p.links + static_cast<size_t>(b0) * NC;
  const double* w = p.w ? p.w + b0 : nullptr;
  const double* init = p.init ? p.init + b0 : nullptr;
  const double* eff = p.eff + b0;
  double* rem = p.rem + b0;
  double* rate = p.rate + b0;
  double* done = p.done + b0;
  // the seed's link sums, in L2: every CTA of the cluster adds into
  // them.  Under one power-of-two weight w0 every partial weight sum is
  // exactly members x w0, in any order, so the weight sums are member
  // counts in shared memory (native integer atomics) instead
  double* wsum = p.sums + static_cast<size_t>(2 * L) * s;
  double* res = wsum + L;
  const double w0 = p.w0;
  auto fresh_sums = [&] {
    for (int l = rank * kThreads + tid; l < L; l += C * kThreads) {
      wsum[l] = 0.0;
      res[l] = p.cap[l];
    }
    for (int l = tid; l < L; l += kThreads) count[l] = 0;
  };

  for (int l = tid; l < L; l += kThreads) stamp[l] = -1;
  fresh_sums();
  if (tid < 3) len[tid] = 0;
  int iL = 0;                                        // the live list
  for (int i = tid; i < nr; i += kThreads) {
    buf(iL)[i] = static_cast<uint16_t>(i);
    rem[i] = p.gbits[b0 + i];
  }
  Cluster cl{table, len, C, rank, 0};
  cl.sync();                // every CTA runs before any peer writes to it
  if (lane == 0) cl.put(tid == 0 ? nr : 0);
  cl.sync();
  unsigned long long live_total = cl.sum();
  int n_live = nr;
  PhaseClock phase;
  phase.start();

  double t = 0.0;
  long long rounds = 0, fills = 0, ops = 0, fault = 0;
  while (live_total > 0) {
    ++rounds;
    if (rounds > p.max_rounds) {
      fault = 2;
      break;
    }
    const bool use_init = rounds == 1 && init;
    if (!use_init) {
      // the fill: weight sums of the live cells; the free list
      int cur = (iL + 1) % 3, nxt = (iL + 2) % 3;
      unsigned kept = 0;
      over_list<NC>(buf(iL), n_live, lk, [&](int i, const uint2 (&hv)[NC]) {
        bool linked = false;
        if (i >= 0) {
#pragma unroll
          for (int h = 0; h < 4 * NC; ++h) {
            const int l = hop<NC>(hv, h);
            if (l < 0) continue;
            if (w)
              atomicAdd(&wsum[l], w[i]);
            else
              atomicAdd(&count[l], 1);
            linked = true;
            ops += 2;
          }
          if (!linked) rate[i] = kInf;   // crosses no link: drains at once
        }
        append(linked, i, buf(cur), cl.local(), &kept);
      });
      if (lane == 0) cl.put(kept);
      cl.sync();
      phase.lap(0);
      unsigned long long free_total = cl.sum();
      int n_free = cl.ended_len();
      bool first = true;
      while (free_total > 0) {
        // shares from the seed's sums
        for (int l = tid; l < L; l += kThreads) {
          double ws;
          if (w) {
            ws = load_l2(wsum + l);
          } else {                       // the cluster's counts, exact
            int members = 0;
            for (int r = 0; r < C; ++r)
              members += C == 1 ? count[l]
                                : cluster.map_shared_rank(count, r)[l];
            ws = __dmul_rn(static_cast<double>(members), w0);
          }
          share[l] = __ddiv_rn(load_l2(res + l), fmax(ws, 1e-300));
          ops += !first && rank == 0;
        }
        __syncthreads();
        phase.lap(1);
        const int k = static_cast<int>(fills++);
        // each free cell's bottleneck share; a link some free member's
        // bottleneck undercuts is stamped in every CTA: no local
        // bottleneck this round
        over_list<NC>(buf(cur), n_free, lk,
                      [&](int i, const uint2 (&hv)[NC]) {
          if (i < 0) return;
          double m = kInf;
#pragma unroll
          for (int h = 0; h < 4 * NC; ++h) {
            const int l = hop<NC>(hv, h);
            if (l >= 0) {
              m = fmin(m, share[l]);
              ops += 2;
            }
          }
#pragma unroll
          for (int h = 0; h < 4 * NC; ++h) {
            const int l = hop<NC>(hv, h);
            if (l >= 0 && share[l] > m && stamp[l] != k) {
              stamp[l] = k;
              for (int r = 0; r < C; ++r)
                if (r != rank) *cluster.map_shared_rank(stamp + l, r) = k;
            }
          }
        });
        cl.sync();
        phase.lap(2);
        // a free cell on any unstamped link freezes at its bottleneck
        // share and drains its weight and rate; the others go on
        kept = 0;
        long long pend = 0;
        over_list<NC>(buf(cur), n_free, lk,
                      [&](int i, const uint2 (&hv)[NC]) {
          bool keep = false;
          if (i >= 0) {
            double m = kInf;
            bool fz = false;
            int hops = 0;
#pragma unroll
            for (int h = 0; h < 4 * NC; ++h) {
              const int l = hop<NC>(hv, h);
              if (l >= 0) {
                m = fmin(m, share[l]);
                fz |= stamp[l] != k;
                ++hops;
              }
            }
            if (fz) {
              const double wc = w ? w[i] : w0;
              const double rc = __dmul_rn(wc, m);
              rate[i] = rc;
              // only stamped links keep free members after this round:
              // an unstamped link's members all freeze, and no later
              // round of the fill reads its sums
#pragma unroll
              for (int h = 0; h < 4 * NC; ++h) {
                const int l = hop<NC>(hv, h);
                if (l < 0 || stamp[l] != k) continue;
                if (w)
                  atomicAdd(&wsum[l], -wc);
                else
                  atomicSub(&count[l], 1);
                atomicAdd(&res[l], -rc);
              }
              ops += 1;
              pend += 3 * hops;
            } else {
              keep = true;
            }
          }
          append(keep, i, buf(nxt), cl.local(), &kept);
        });
        if (lane == 0) cl.put(kept);
        cl.sync();
        phase.lap(3);
        free_total = cl.sum();       // 0: all froze, nothing to drain for
        n_free = cl.ended_len();
        if (free_total > 0) ops += pend;
        const int b = cur;
        cur = nxt;
        nxt = b;
        first = false;
      }
    }
    // the horizon: the seed's earliest finish
    double lo = kInf, good;
    for (int k = tid; k < n_live; k += kThreads) {
      const int i = buf(iL)[k];
      lo = fmin(lo, finish(rem[i], use_init ? init[i] : rate[i], eff[i],
                           &good));
      ops += 3;
    }
    for (int o = 16; o > 0; o >>= 1)
      lo = fmin(lo, __shfl_xor_sync(kFull, lo, o));
    if (lane == 0) cl.put(__double_as_longlong(lo));
    cl.sync();
    phase.lap(4);
    const double dt = cl.min();
    if (!isfinite(dt)) {
      fault = 1;
      break;
    }
    // everything within float tolerance of the horizon departs; the
    // others drain for it and make the next live list; the next fill's
    // partials start afresh
    const double horizon = __dmul_rn(dt, 1.0 + 1e-12);
    const int nl = (iL + 1) % 3;
    unsigned kept = 0;
    for (int t0 = 0; t0 < n_live; t0 += kThreads) {
      const int k = t0 + tid;
      const int i = k < n_live ? buf(iL)[k] : -1;
      bool keep = false;
      if (i >= 0) {
        const double fin = finish(rem[i], use_init ? init[i] : rate[i],
                                  eff[i], &good);
        if (fin <= horizon) {
          done[i] = __dadd_rn(t, fin);
        } else {
          const double d = isfinite(good) ? good : 0.0;
          rem[i] = fmax(__dsub_rn(rem[i], __dmul_rn(d, dt)), 0.0);
          keep = true;
        }
        ops += 4;
      }
      append(keep, i, buf(nl), cl.local(), &kept);
    }
    fresh_sums();
    if (lane == 0) cl.put(kept);
    cl.sync();
    phase.lap(5);
    live_total = cl.sum();
    n_live = cl.ended_len();
    iL = nl;
    t = __dadd_rn(t, dt);
  }
  long long* stats = p.stats + static_cast<size_t>(kStats) * s;
  if (ops)
    atomicAdd(reinterpret_cast<unsigned long long*>(&stats[2]),
              static_cast<unsigned long long>(ops));
  if (rank == 0 && tid == 0) {
    stats[0] = rounds;
    stats[1] = fills;
    stats[3] = fault;
    phase.store(stats + 4);
  }
  cl.sync();               // no CTA leaves while a peer may reach its smem
}

// One round of the chain: a warp minimum, atomicMin in every CTA of the
// cluster, the barrier and the read, iters times.
__global__ void __launch_bounds__(kThreads, 1) sync_probe(int iters,
                                                          double* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* table = reinterpret_cast<unsigned long long*>(smem);
  auto* len = reinterpret_cast<unsigned int*>(table + kTableWords);
  if (threadIdx.x < 3) len[threadIdx.x] = 0;
  Cluster cl{table, len, static_cast<int>(cg::this_cluster().num_blocks()),
             static_cast<int>(cg::this_cluster().block_rank()), 0};
  cl.sync();
  double v = threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    double lo = v;
    for (int o = 16; o > 0; o >>= 1)
      lo = fmin(lo, __shfl_xor_sync(kFull, lo, o));
    if ((threadIdx.x & 31) == 0) cl.put(__double_as_longlong(lo));
    cl.sync();
    v = __dadd_rn(v, cl.min());
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = v;
  cl.sync();
}

template <class K, class... Args>
int launch(K kernel, int S, int C, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int L, int C, int cap_cells) {
  return L > 0 && L < 32768 && C >= 1 && C <= kMaxCluster &&
         (C & (C - 1)) == 0 && cap_cells >= 0 && cap_cells <= 65536 &&
         smem_bytes(L, cap_cells) <= static_cast<size_t>(kSmemBudget);
}

}  // namespace

extern "C" int departure_drain(const void* links, const void* seg,
                               const void* cap, const void* gbits,
                               const void* eff, const void* w,
                               const void* init, void* rem, void* rate,
                               void* done, void* sums, void* stats,
                               long long max_rounds, double w0, int L,
                               int S, int cluster, int chunks,
                               int cap_cells, void* stream) {
  if (S <= 0) return 0;
  if (!valid_shape(L, cluster, cap_cells) || (chunks != 1 && chunks != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint2*>(links),
           static_cast<const int64_t*>(seg),
           static_cast<const double*>(cap),
           static_cast<const double*>(gbits),
           static_cast<const double*>(eff),
           static_cast<const double*>(w),
           static_cast<const double*>(init),
           static_cast<double*>(rem),
           static_cast<double*>(rate),
           static_cast<double*>(done),
           static_cast<double*>(sums),
           static_cast<long long*>(stats),
           max_rounds, w0, L, cap_cells};
  const size_t smem = smem_bytes(L, cap_cells);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return chunks == 1 ? launch(drain_kernel<1>, S, cluster, smem, st, p)
                     : launch(drain_kernel<2>, S, cluster, smem, st, p);
}

extern "C" int drain_stats_cols() { return kStats; }

// The most clusters of a launch shape the card keeps resident at once.
extern "C" int drain_resident_clusters(int cluster, int chunks, int L,
                                       int cap_cells, void* out) {
  if (!valid_shape(L, cluster, cap_cells) || (chunks != 1 && chunks != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L, cap_cells);
  auto kernel = chunks == 1 ? drain_kernel<1> : drain_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      static_cast<int*>(out), kernel, &cfg));
}

extern "C" int drain_sync_probe(int S, int cluster, int L, int cap_cells,
                                int iters, void* out, void* stream) {
  if (S <= 0 || !valid_shape(L, cluster, cap_cells))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(sync_probe, S, cluster, smem_bytes(L, cap_cells),
                static_cast<cudaStream_t>(stream), iters,
                static_cast<double*>(out));
}
