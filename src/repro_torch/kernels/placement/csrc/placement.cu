// Sequential greedy congestion-aware placement for sm_90a: a warp per
// seed, the seed's load row and the fabric's compact tables in shared
// memory.
//
// Replaces the host loop of the JAX package's routing strategies
//   src/repro/core/strategies.py  _sequential_congestion_place (:467)
// which the reference runs on the host under every engine (it has no
// Pallas kernel): ``congestion-aware`` routes every flow through it, and
// ``wave-congestion-aware`` its residue at the round cap.
//
// Flows are placed one at a time in placement order: at every hop a flow
// takes the candidate egress link whose load (under that seed) is least,
// ties broken by the flow's hash (murmur3 or the exact splitmix fold)
// modulo the number of tied candidates, in table order; after its walk it
// adds its weight to every link it took.  Each placement reads the loads
// the earlier ones wrote, but only within its own seed, so the seeds are
// independent chains, and each runs in one warp.
//
// Bound: latency, a seed's chain of dependent shared-memory reads.  A hop
// cannot avoid two, the second waiting on the first: the candidates' link
// ids, then those links' loads.  Between hops sit a two-step warp minimum
// (__reduce_min_sync on the high, then the low word of an order-preserving
// key of the float64 loads), a ballot of the ties, the tie of rank
// hash % n_tie and a shuffle from its lane.  Everything else a hop needs
// is worked out off that chain: while the loads are read and compared,
// each lane follows its own candidate one step ahead (the next device and
// whether it is a server, that device's candidate row, and the flow's
// hash there: murmur3 or the exact fold over the flow's first 8 fields,
// unrolled in registers), and the chosen lane's answer is shuffled to the
// warp with the link.  So a seed costs about its placed hops x two
// shared-memory latencies plus that arithmetic, and more seeds cost
// nothing until they fill the card.
//
// What stays out of global memory in the chain:
//   * the loads: a block holds W seeds (W = ops.WARPS = 8 warps, fewer
//     where a row is too wide), each warp its seed's (L,) float64 row,
//     copied in once and written back once on every exit, a fault
//     included.  The adds after a walk stay in flow order, so each link's
//     sum is the host loop's, bit for bit, for any weights;
//   * the tables, where they fit beside the W rows (``ops.plan``, by the
//     shared-memory budget alone): the candidate rows compacted to the
//     non-empty ones as a CSR of int16 link ids with int32 row offsets,
//     the int16 next device of each link with its server bit, and the
//     crc32 seeds of the devices and of each link's next device, staged
//     once per block (the multipod fabric: 67 KB of candidates, 74 KB of
//     offsets, 2, 1 and 8 KB, beside 8 rows of 8 KB: 214 KB of the 227
//     KB).  Where they do not fit, the
//     instances congestion_place_kernel<false, ...> read them from global
//     memory through the read-only path and keep only the rows in shared
//     memory;
//   * the per-flow inputs: the wrapper gathers them in placement order
//     (endpoints, the first hop's key and the later hops' key as one int4,
//     the weight, the fields) and, under a mask, lists each seed's
//     positions to place.  Lane i holds item i of a batch of 32, loaded a
//     batch ahead (the positions two batches ahead), and readies it when
//     its batch comes up: its fields mixed, its first candidate row and
//     its hash at its source.  A flow's start is a shuffle from its lane;
//   * the path: lane t keeps hop t's link in a register (hops past 32 go
//     to link_ids and are read back), so the adds after the walk read
//     nothing back, and link_ids is written by stores only.  A path
//     crosses a link at most once, so the adds never collide;
//   * one read of each candidate's load: the minimum, the tie ballot and
//     the pick all come from that register (tables wider than 32
//     candidates are walked in chunks, read again, and their next step
//     worked out after the pick).
// Flows with more than 8 hash fields take the kWide instances, which fold
// the fields past 8 from a per-warp slot of shared memory.
//
// Faults (a walk that does not end in ``max_hops`` hops, or ends at
// another device than the flow's destination) stop that seed's chain and
// are reported in ``fault[s] = {order position, kind 1 or 2, device}``,
// position -1 when none.  ``hops[s]`` is the seed's longest walk.
//
// A second entry point, smem_latency_probe, times a chain of dependent
// shared-memory loads of one warp with clock64: the latency the chain's
// bound counts.
//
// Plain C interface for ctypes: the launches go on the caller's stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "../../csrc/murmur.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kHashInit = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kEmpty = ~0ull;      // the key of a lane with no live candidate
constexpr int kMaxWarps = 8;            // ops.WARPS
constexpr int kFieldBytes = 256;        // a warp's slot of 32 mixed fields

struct Params {
  const unsigned char* tables;          // ops.pack_tables, in global memory
  long long table_bytes;
  long long off_crc, off_lcrc, off_row, off_next, off_cand;
  const int64_t* fields;                // (N, F), placement order
  int n_fields;
  const int64_t* seeds;
  const int4* ends;                     // (N,): src, dst, first key, later key
  const double* weight;                 // (N,)
  const int64_t* order;                 // (N,): the flow at each position
  const int32_t* sel;                   // each seed's positions, or null: all
  const int64_t* sel_off;               // (S + 1,)
  double* load;                         // (S, L)
  int32_t* link_ids;                    // (H, N, S), by flow
  int64_t* fault;                       // (S, 3)
  int32_t* hops;                        // (S,)
  int64_t n_flows, n_seeds;
  int n_keys, n_links, max_hops, warps, murmur;
};

template <bool kShared>
struct Tables {
  const unsigned long long* crc;
  const unsigned long long* link_crc;   // dev_crc[link_dst]
  const int32_t* row_off;
  const int16_t* next;                  // 2 * link_dst + is_server[link_dst]
  const int16_t* cand;

  __device__ __forceinline__ uint64_t dev_crc(int v) const {
    if constexpr (kShared) return crc[v];
    else return __ldg(crc + v);
  }
  __device__ __forceinline__ uint64_t next_crc(int link) const {
    if constexpr (kShared) return link_crc[link];
    else return __ldg(link_crc + link);
  }
  __device__ __forceinline__ int row(int vk) const {
    if constexpr (kShared) return row_off[vk];
    else return __ldg(row_off + vk);
  }
  __device__ __forceinline__ int next_dev(int link) const {
    if constexpr (kShared) return next[link];
    else return __ldg(next + link);
  }
  __device__ __forceinline__ int id(int i) const {
    if constexpr (kShared) return cand[i];
    else return __ldg(cand + i);
  }
};

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// An unsigned key in the order of the float64 loads, in integer
// operations alone: a positive load's bits with the sign bit set, a
// negative load's bits negated (so -0 and +0 share a key), and NaN, which
// the host loop never takes as a minimum nor a tie, the key of an empty
// lane.
__device__ __forceinline__ uint64_t load_key(double v) {
  const uint64_t b = static_cast<uint64_t>(__double_as_longlong(v));
  if ((b << 1) > 0xFFE0000000000000ull) return kEmpty;
  return (b >> 63) ? 0ull - b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t k) {
  const unsigned hi = __reduce_min_sync(kFull, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                  : 0xFFFFFFFFu);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ double shfl_f64(double v, int src) {
  return __shfl_sync(kFull, v, src);
}

constexpr int kRegFields = 8;           // hash fields held in registers

// A flow's hash at one device is a fold of its fields from the device's
// seed: murmur3 over the fields' 32-bit mixed words, or the exact
// splitmix fold over their raw 64 bits.
template <bool kMurmur>
using Hash = std::conditional_t<kMurmur, uint32_t, uint64_t>;

template <bool kMurmur>
__device__ __forceinline__ Hash<kMurmur> prep_field(uint64_t raw) {
  if constexpr (kMurmur) {
    return murmur::mix_k(static_cast<uint32_t>(raw));
  } else {
    return raw;
  }
}

// The hash's start from a device seed, one fold of a field and its end.
template <bool kMurmur>
__device__ __forceinline__ Hash<kMurmur> hash_start(uint64_t dseed) {
  if constexpr (kMurmur) {
    return static_cast<uint32_t>(dseed);
  } else {
    return mix64(dseed ^ kHashInit);
  }
}

template <bool kMurmur>
__device__ __forceinline__ Hash<kMurmur> hash_fold(Hash<kMurmur> h,
                                                   Hash<kMurmur> field) {
  if constexpr (kMurmur) {
    return murmur::fold_mixed(h, field);
  } else {
    return mix64(h ^ field);
  }
}

template <bool kMurmur>
__device__ __forceinline__ Hash<kMurmur> hash_end(Hash<kMurmur> h) {
  if constexpr (kMurmur) {
    return murmur::fmix(h);
  } else {
    return h;
  }
}

// The first 8 folds, unrolled and branch-free, so that they interleave
// with a hop's reads.
template <bool kMurmur>
__device__ __forceinline__ Hash<kMurmur> fold_regs(
    Hash<kMurmur> h, const Hash<kMurmur> (&fk)[kRegFields], int n_fields) {
#pragma unroll
  for (int f = 0; f < kRegFields; ++f) {
    const Hash<kMurmur> g = hash_fold<kMurmur>(h, fk[f]);
    h = f < n_fields ? g : h;
  }
  return h;
}

// The hash at the device seed ``dseed`` of the flow whose fields are
// fk[0..8) and, past 8 (the kWide instances), tail[8..F).
template <bool kMurmur, bool kWide>
__device__ __forceinline__ Hash<kMurmur> flow_hash(
    uint64_t dseed, const Hash<kMurmur> (&fk)[kRegFields],
    const Hash<kMurmur>* tail, int n_fields) {
  Hash<kMurmur> h = fold_regs<kMurmur>(hash_start<kMurmur>(dseed), fk,
                                       n_fields);
  if constexpr (kWide) {
    for (int f = kRegFields; f < n_fields; ++f) {
      h = hash_fold<kMurmur>(h, tail[f]);
    }
  }
  return hash_end<kMurmur>(h);
}

// Where a walk stands before a hop: the device, the row of candidates
// for (device, key) and the flow's hash there.
template <bool kMurmur>
struct At {
  int state;
  int done;
  int off;
  int n;
  Hash<kMurmur> h;
};

// Where taking ``link`` from a device leads, for a flow whose later hops
// use key ``dkey`` (past its source a walk is never at a server).
template <bool kShared, bool kMurmur, bool kWide>
__device__ __forceinline__ At<kMurmur> step(
    const Tables<kShared>& tab, const Params& p, int link, int dkey,
    uint64_t seed, const Hash<kMurmur> (&fk)[kRegFields],
    const Hash<kMurmur>* tail) {
  const int nd = tab.next_dev(link);
  At<kMurmur> a;
  a.state = nd >> 1;
  a.done = nd & 1;
  const int vk = a.state * p.n_keys + dkey;
  a.off = tab.row(vk);
  a.n = tab.row(vk + 1) - a.off;
  a.h = flow_hash<kMurmur, kWide>(tab.next_crc(link) ^ seed, fk, tail,
                                  p.n_fields);
  return a;
}

// The (rank + 1)-th set bit of ``ties``, the lanes' own way: the lane
// whose tie has ``rank`` ties before it.
__device__ __forceinline__ int rank_lane(unsigned ties, unsigned rank,
                                         int lane) {
  const bool mine = ((ties >> lane) & 1u) &&
                    __popc(ties & ((1u << lane) - 1u)) == static_cast<int>(rank);
  return __ffs(__ballot_sync(kFull, mine)) - 1;
}

// hash % n for n <= 32 by multiplication (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019): exact for every 32-bit a with
// M = 2**64 / n rounded up; the 64-bit exact hash goes by its halves,
// with 2**32 % n.
#define PLACEMENT_M(n) (0xFFFFFFFFFFFFFFFFull / (n) + 1)
#define PLACEMENT_P(n) ((0xFFFFFFFFull % (n) + 1) % (n))
__constant__ unsigned long long kModMagic[33] = {
    0, PLACEMENT_M(1), PLACEMENT_M(2), PLACEMENT_M(3), PLACEMENT_M(4),
    PLACEMENT_M(5), PLACEMENT_M(6), PLACEMENT_M(7), PLACEMENT_M(8),
    PLACEMENT_M(9), PLACEMENT_M(10), PLACEMENT_M(11), PLACEMENT_M(12),
    PLACEMENT_M(13), PLACEMENT_M(14), PLACEMENT_M(15), PLACEMENT_M(16),
    PLACEMENT_M(17), PLACEMENT_M(18), PLACEMENT_M(19), PLACEMENT_M(20),
    PLACEMENT_M(21), PLACEMENT_M(22), PLACEMENT_M(23), PLACEMENT_M(24),
    PLACEMENT_M(25), PLACEMENT_M(26), PLACEMENT_M(27), PLACEMENT_M(28),
    PLACEMENT_M(29), PLACEMENT_M(30), PLACEMENT_M(31), PLACEMENT_M(32)};
__constant__ unsigned kPow32Mod[33] = {
    0, PLACEMENT_P(1), PLACEMENT_P(2), PLACEMENT_P(3), PLACEMENT_P(4),
    PLACEMENT_P(5), PLACEMENT_P(6), PLACEMENT_P(7), PLACEMENT_P(8),
    PLACEMENT_P(9), PLACEMENT_P(10), PLACEMENT_P(11), PLACEMENT_P(12),
    PLACEMENT_P(13), PLACEMENT_P(14), PLACEMENT_P(15), PLACEMENT_P(16),
    PLACEMENT_P(17), PLACEMENT_P(18), PLACEMENT_P(19), PLACEMENT_P(20),
    PLACEMENT_P(21), PLACEMENT_P(22), PLACEMENT_P(23), PLACEMENT_P(24),
    PLACEMENT_P(25), PLACEMENT_P(26), PLACEMENT_P(27), PLACEMENT_P(28),
    PLACEMENT_P(29), PLACEMENT_P(30), PLACEMENT_P(31), PLACEMENT_P(32)};
#undef PLACEMENT_M
#undef PLACEMENT_P

__device__ __forceinline__ unsigned fastmod(uint32_t a, unsigned n) {
  return static_cast<unsigned>(__umul64hi(kModMagic[n] * a, n));
}

// The tie's rank, hash % n_tie (0 for one tie), for n_tie <= 32.
template <bool kMurmur>
__device__ __forceinline__ unsigned tie_rank(Hash<kMurmur> h, unsigned n_tie) {
  if (n_tie <= 1) return 0u;
  if constexpr (kMurmur) {
    return fastmod(h, n_tie);
  } else {
    const unsigned hi = fastmod(static_cast<uint32_t>(h >> 32), n_tie);
    const unsigned lo = fastmod(static_cast<uint32_t>(h), n_tie);
    return fastmod(hi * kPow32Mod[n_tie] + lo, n_tie);
  }
}

// The same for any n_tie (tables wider than a warp).
template <bool kMurmur>
__device__ __forceinline__ unsigned wide_rank(Hash<kMurmur> h, unsigned n_tie) {
  return n_tie > 1 ? static_cast<unsigned>(h % n_tie) : 0u;
}

// One hop: the link taken from ``at`` (-1 where no candidate is live) and
// where it leads.  Each lane reads its candidate's load once; meanwhile
// it works out where its candidate would lead (the next device, its
// candidate row and the hash there), so the next hop starts from a
// shuffle of the chosen lane's answer.
template <bool kShared, bool kMurmur, bool kWide>
__device__ __forceinline__ int hop(
    const Tables<kShared>& tab, const double* row, const Params& p,
    At<kMurmur>& at, int dkey, uint64_t seed,
    const Hash<kMurmur> (&fk)[kRegFields], const Hash<kMurmur>* tail,
    int lane) {
  const int off = at.off, n = at.n;
  if (n <= 32) {
    const int cd0 = lane < n ? tab.id(off + lane) : -1;
    const At<kMurmur> ahead = step<kShared, kMurmur, kWide>(
        tab, p, cd0 >= 0 ? cd0 : 0, dkey, seed, fk, tail);
    const uint64_t k0 = cd0 >= 0 ? load_key(row[cd0]) : kEmpty;
    const uint64_t kmin = warp_min(k0);
    const unsigned ties = __ballot_sync(kFull, k0 == kmin && k0 != kEmpty);
    const unsigned n_tie = __popc(ties);
    const int src = rank_lane(ties, tie_rank<kMurmur>(at.h, n_tie), lane);
    if (src < 0) return -1;             // no live candidate: the walk stays
    const int link = __shfl_sync(kFull, cd0, src);
    at.state = __shfl_sync(kFull, ahead.state, src);
    at.done = __shfl_sync(kFull, ahead.done, src);
    at.off = __shfl_sync(kFull, ahead.off, src);
    at.n = __shfl_sync(kFull, ahead.n, src);
    at.h = __shfl_sync(kFull, ahead.h, src);
    return link;
  }
  // tables wider than a warp: chunks of 32, read again for the ties and
  // the pick, and the chosen link's next step worked out after it
  uint64_t kl = kEmpty;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cd = c0 + lane < n ? tab.id(off + c0 + lane) : -1;
    const uint64_t k = cd >= 0 ? load_key(row[cd]) : kEmpty;
    kl = k < kl ? k : kl;
  }
  const uint64_t kmin = warp_min(kl);
  if (kmin == kEmpty) return -1;
  unsigned n_tie = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cd = c0 + lane < n ? tab.id(off + c0 + lane) : -1;
    n_tie += __popc(__ballot_sync(kFull, cd >= 0 && load_key(row[cd]) == kmin));
  }
  unsigned rank = wide_rank<kMurmur>(at.h, n_tie);
  int link = -1;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cd = c0 + lane < n ? tab.id(off + c0 + lane) : -1;
    const unsigned ties =
        __ballot_sync(kFull, cd >= 0 && load_key(row[cd]) == kmin);
    const unsigned cnt = __popc(ties);
    if (rank < cnt) {
      link = __shfl_sync(kFull, cd, rank_lane(ties, rank, lane));
      break;
    }
    rank -= cnt;
  }
  const At<kMurmur> a = step<kShared, kMurmur, kWide>(
      tab, p, link >= 0 ? link : 0, dkey, seed, fk, tail);
  at.state = a.state;
  at.done = a.done;
  at.off = a.off;
  at.n = a.n;
  at.h = a.h;
  return link;
}

// A lane's batch item: as loaded (a batch ahead of its use) ...
struct Raw {
  int64_t j;
  int4 ends;                            // src, dst, first key, later key
  double w;
  uint64_t field[kRegFields];
};

// ... and ready to place: the flow, where its walk starts, its fields.
template <bool kMurmur>
struct Item {
  int64_t j;
  int src, dst, dkey;
  double w;
  At<kMurmur> at;
  Hash<kMurmur> fk[kRegFields];
};

template <bool kShared, bool kMurmur, bool kWide>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    congestion_place_kernel(const Params p) {
  using H = Hash<kMurmur>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = p.n_links;
  const int F = p.n_fields;
  const long long rows_bytes = align16(static_cast<long long>(p.warps) * L * 8);
  Tables<kShared> tab;
  const unsigned char* tb = p.tables;
  if constexpr (kShared) {
    unsigned char* staged = smem + rows_bytes + p.warps * kFieldBytes;
    const int4* src = reinterpret_cast<const int4*>(p.tables);
    int4* dst = reinterpret_cast<int4*>(staged);
    for (long long i = threadIdx.x; i < p.table_bytes / 16; i += blockDim.x) {
      dst[i] = __ldg(src + i);
    }
    tb = staged;
  }
  tab.crc = reinterpret_cast<const unsigned long long*>(tb + p.off_crc);
  tab.link_crc = reinterpret_cast<const unsigned long long*>(tb + p.off_lcrc);
  tab.row_off = reinterpret_cast<const int32_t*>(tb + p.off_row);
  tab.next = reinterpret_cast<const int16_t*>(tb + p.off_next);
  tab.cand = reinterpret_cast<const int16_t*>(tb + p.off_cand);

  const int64_t s = static_cast<int64_t>(blockIdx.x) * p.warps + warp;
  double* row = reinterpret_cast<double*>(smem) + static_cast<long long>(warp) * L;
  double* gload = p.load + s * L;
  if (s < p.n_seeds) {
    for (int i = lane; i < L; i += 32) row[i] = gload[i];
  }
  __syncthreads();                      // the tables are staged
  if (s >= p.n_seeds) return;
  // fields past the 8 held in registers (kWide), mixed, per warp
  H* tail = reinterpret_cast<H*>(smem + rows_bytes + warp * kFieldBytes);
  const uint64_t seed = static_cast<uint64_t>(p.seeds[s]);
  const int64_t NS = p.n_flows * p.n_seeds;

  // the seed's items: every position, or its listed ones
  const int32_t* sel = p.sel == nullptr ? nullptr : p.sel + p.sel_off[s];
  const int64_t n_items =
      p.sel == nullptr ? p.n_flows : p.sel_off[s + 1] - p.sel_off[s];
  auto item_pos = [&](int64_t i) -> int32_t {
    if (i >= n_items) return -1;
    return sel == nullptr ? static_cast<int32_t>(i) : sel[i];
  };
  auto fetch = [&](int32_t pos) -> Raw {
    Raw r;
    r.j = 0;
    r.ends = make_int4(0, 0, 0, 0);
    r.w = 0.0;
#pragma unroll
    for (int f = 0; f < kRegFields; ++f) r.field[f] = 0;
    if (pos >= 0) {
      r.j = p.order[pos];
      r.ends = p.ends[pos];
      r.w = p.weight[pos];
      const int64_t* fp = p.fields + static_cast<int64_t>(pos) * F;
#pragma unroll
      for (int f = 0; f < kRegFields; ++f) {
        if (f < F) r.field[f] = static_cast<uint64_t>(fp[f]);
      }
    }
    return r;
  };
  // lane-parallel: each lane readies its own item (where its walk starts
  // and the hash there)
  auto ready = [&](const Raw& r, int32_t pos) -> Item<kMurmur> {
    Item<kMurmur> it;
    it.j = r.j;
    it.src = r.ends.x;
    it.dst = r.ends.y;
    it.dkey = r.ends.w;
    it.w = r.w;
#pragma unroll
    for (int f = 0; f < kRegFields; ++f) it.fk[f] = prep_field<kMurmur>(r.field[f]);
    const int vk = r.ends.x * p.n_keys + r.ends.z;
    it.at.state = r.ends.x;
    it.at.done = 0;
    it.at.off = tab.row(vk);
    it.at.n = tab.row(vk + 1) - it.at.off;
    H h = fold_regs<kMurmur>(
        hash_start<kMurmur>(tab.dev_crc(r.ends.x) ^ seed), it.fk, F);
    if constexpr (kWide) {
      for (int f = kRegFields; pos >= 0 && f < F; ++f) {
        h = hash_fold<kMurmur>(h, prep_field<kMurmur>(static_cast<uint64_t>(
                                      p.fields[static_cast<int64_t>(pos) * F + f])));
      }
    }
    it.at.h = hash_end<kMurmur>(h);
    return it;
  };

  // lane i holds batch item i: this batch's, ready; the next batch's as
  // loaded while this one is placed; and the positions after that
  int32_t pos_cur = item_pos(lane);
  Item<kMurmur> cur = ready(fetch(pos_cur), pos_cur);
  int32_t pos_nxt = item_pos(32 + lane);
  Raw nxt = fetch(pos_nxt);
  int32_t pos_far = item_pos(64 + lane);
  int hop_hw = 0;
  for (int64_t i0 = 0; i0 < n_items; i0 += 32) {
    const int in_batch = static_cast<int>(n_items - i0 < 32 ? n_items - i0 : 32);
    for (int k = 0; k < in_batch; ++k) {
      const int32_t pos = __shfl_sync(kFull, pos_cur, k);
      const int64_t j = __shfl_sync(kFull, cur.j, k);
      const int dst = __shfl_sync(kFull, cur.dst, k);
      const int dkey = __shfl_sync(kFull, cur.dkey, k);
      const double w = shfl_f64(cur.w, k);
      At<kMurmur> at;
      at.state = __shfl_sync(kFull, cur.at.state, k);
      at.done = 0;
      at.off = __shfl_sync(kFull, cur.at.off, k);
      at.n = __shfl_sync(kFull, cur.at.n, k);
      at.h = __shfl_sync(kFull, cur.at.h, k);
      H fk[kRegFields];
#pragma unroll
      for (int f = 0; f < kRegFields; ++f) fk[f] = __shfl_sync(kFull, cur.fk[f], k);
      if constexpr (kWide) {
        if (lane >= kRegFields && lane < F) {
          tail[lane] = prep_field<kMurmur>(static_cast<uint64_t>(
              p.fields[static_cast<int64_t>(pos) * F + lane]));
        }
        __syncwarp();
      }

      int32_t* out = p.link_ids + j * p.n_seeds + s;   // hop t at t*N*S
      int t_end = 0;
      int my_link = -1;                 // lane t: hop t's link
      for (int t = 0; t < p.max_hops && !at.done; ++t) {
        t_end = t + 1;
        const int link = hop<kShared, kMurmur, kWide>(tab, row, p, at, dkey,
                                                      seed, fk, tail, lane);
        if (t < 32) {
          if (lane == t) my_link = link;
        } else if (lane == 0) {
          out[static_cast<int64_t>(t) * NS] = link;
        }
        if (link < 0) at.done = 1;
      }
      if (lane < t_end) out[static_cast<int64_t>(lane) * NS] = my_link;
      if (!at.done || at.state != dst) {
        if (lane == 0) {
          p.fault[3 * s] = pos;
          p.fault[3 * s + 1] = at.done ? 2 : 1;
          p.fault[3 * s + 2] = at.state;
          p.hops[s] = hop_hw > t_end ? hop_hw : t_end;
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32) gload[i] = row[i];
        return;
      }
      if (lane < t_end && my_link >= 0) row[my_link] += w;
      if (t_end > 32) {
        __syncwarp();
        for (int t = 32 + lane; t < t_end; t += 32) {
          const int l = out[static_cast<int64_t>(t) * NS];
          if (l >= 0) row[l] += w;
        }
      }
      __syncwarp();
      hop_hw = hop_hw > t_end ? hop_hw : t_end;
    }
    pos_cur = pos_nxt;
    cur = ready(nxt, pos_cur);
    pos_nxt = pos_far;
    nxt = fetch(pos_nxt);
    pos_far = item_pos(i0 + 96 + lane);
  }
  for (int i = lane; i < L; i += 32) gload[i] = row[i];
  if (lane == 0) p.hops[s] = hop_hw;
}

__global__ void __launch_bounds__(32)
    smem_latency_probe_kernel(long long* out, int steps) {
  __shared__ unsigned next[1024];
  const int lane = threadIdx.x;
  // lane i's chain steps through its own bank: each warp-wide load is one
  // conflict-free wavefront, and each address is the value just loaded
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(next));
  for (int i = lane; i < 1024; i += 32) next[i] = base + 4u * ((i + 32) & 1023);
  __syncwarp();
  unsigned q = base + 4u * lane;
  for (int k = 0; k < 64; ++k) {
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(q));
  }
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int k = 0; k < steps; ++k) {
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(q));
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(ns1 - ns0);
  }
  out[2 + lane] = q;                    // keeps the chain live
}

template <bool kShared, bool kMurmur, bool kWide>
int launch(const Params& p, int smem_bytes, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      congestion_place_kernel<kShared, kMurmur, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long blocks = (p.n_seeds + p.warps - 1) / p.warps;
  congestion_place_kernel<kShared, kMurmur, kWide>
      <<<static_cast<unsigned int>(blocks), 32 * p.warps, smem_bytes,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kShared>
int launch_for(const Params& p, int smem_bytes, cudaStream_t stream) {
  const bool wide = p.n_fields > kRegFields;
  if (p.murmur) {
    return wide ? launch<kShared, true, true>(p, smem_bytes, stream)
                : launch<kShared, true, false>(p, smem_bytes, stream);
  }
  return wide ? launch<kShared, false, true>(p, smem_bytes, stream)
              : launch<kShared, false, false>(p, smem_bytes, stream);
}

}  // namespace

extern "C" int congestion_place(
    const void* tables, long long table_bytes, long long off_crc,
    long long off_lcrc, long long off_row, long long off_next,
    long long off_cand,
    int shared_tables, int warps, int smem_bytes, const void* fields,
    int n_fields, const void* seeds, const void* ends, const void* weight,
    const void* order, const void* sel, const void* sel_off, void* load,
    void* link_ids, void* fault, void* hops, long long n_flows,
    long long n_seeds, long long n_keys, long long n_links, int max_hops,
    int use_murmur, void* stream) {
  if (n_seeds <= 0) return 0;
  if (n_fields > 32 || warps < 1 || warps > kMaxWarps ||
      (n_seeds + warps - 1) / warps > 0x7FFFFFFFLL || n_flows > 0x7FFFFFFFLL ||
      n_keys > 0x7FFFFFFFLL || n_links > 0x7FFF || table_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.tables = static_cast<const unsigned char*>(tables);
  p.table_bytes = table_bytes;
  p.off_crc = off_crc;
  p.off_lcrc = off_lcrc;
  p.off_row = off_row;
  p.off_next = off_next;
  p.off_cand = off_cand;
  p.fields = static_cast<const int64_t*>(fields);
  p.n_fields = n_fields;
  p.seeds = static_cast<const int64_t*>(seeds);
  p.ends = static_cast<const int4*>(ends);
  p.weight = static_cast<const double*>(weight);
  p.order = static_cast<const int64_t*>(order);
  p.sel = static_cast<const int32_t*>(sel);
  p.sel_off = static_cast<const int64_t*>(sel_off);
  p.load = static_cast<double*>(load);
  p.link_ids = static_cast<int32_t*>(link_ids);
  p.fault = static_cast<int64_t*>(fault);
  p.hops = static_cast<int32_t*>(hops);
  p.n_flows = n_flows;
  p.n_seeds = n_seeds;
  p.n_keys = static_cast<int>(n_keys);
  p.n_links = static_cast<int>(n_links);
  p.max_hops = max_hops;
  p.warps = warps;
  p.murmur = use_murmur;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shared_tables ? launch_for<true>(p, smem_bytes, st)
                       : launch_for<false>(p, smem_bytes, st);
}

extern "C" int smem_latency_probe(void* out, int steps, void* stream) {
  smem_latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
