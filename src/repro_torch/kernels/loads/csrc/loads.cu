// Ordered (seed, link) load sums for sm_90a: each CTA owns one seed's
// bins (or a run of its links) for the whole call, a cluster of 8 CTAs
// brings in the rows of the 8 seeds that share a 32-byte sector once,
// the CTA's ranking warps rank its tiles of cells stably in shared memory,
// and its adding warps add every bin's weights in that order.
//
// Replaces no Pallas kernel: the JAX package sums the routing
// strategies' demand-weighted link loads on the host with np.bincount
//   src/repro/core/strategies.py  _weighted_link_loads (:261)
//   src/repro/core/strategies.py  _scatter_cell_loads  (:800)
// which adds each cell's weight into its (seed, link) bin one cell after
// another, in C order.  Adaptive re-spray marks and accepts moves by
// comparing those float sums, so their order decides paths; the atomics
// of torch.bincount on the card add in an order that changes from run to
// run, and a comparison that ties in exact arithmetic can go either way.
//
// out[s, l] = ((0.0 + w[n0]) + w[n1]) + ... over the cells (h, n, s) of
// the (H, N, S) int32 link ids that hold l, in order of (h, n): the order
// of np.bincount over the C-order cells, bit for bit for any weights.
// Cells outside [0, L) (-1: no link) are skipped.
//
// Bound: bytes.  The function reads each link id once (4 bytes a cell),
// the (N,) weights and writes the (S, L) sums.  A bin's adds are one
// dependent chain, so its run of cells also sets a floor of one float64
// add latency a cell of the longest run.  Where the cells of a bin come
// in long runs of neighbouring rows (a host's flowlets share its first
// and last links), a tile of rows holds one or two hot runs, and adds
// that end with their tile wait for them: 3.1 ms of chains at the
// strategies' shape against 0.014 ms for the longest bin (compare.py's
// ``tile_chain_floor_ms``).
//
// Design.
//  * Bins owned, never shared.  CTA b owns the bins of one seed and a run
//    of LP links (l0 .. l0 + LP): key l - l0, at most MAX_KEYS keys, each
//    key's float64 sum in a register of one fixed adding thread for the
//    whole call.  No partial sum crosses CTAs, so nothing is carried
//    between them.  A fabric whose links do not fit MAX_KEYS keys splits
//    them over ceil(L / LP) clusters (ops.plan picks LP).
//  * The cells streamed once, in order, a sector read once.  A seed's
//    cells are 4 bytes every S * 4 bytes of a row: a CTA that fetched its
//    own would make one memory request a cell.  So the 8 CTAs of a
//    cluster own the 8 seeds of one 32-byte sector of every row.  A tile
//    is TILE rows; CTA r brings rows r * SHARE .. (r + 1) * SHARE of it,
//    all 8 seeds, in TMA boxes of 256 rows x 32 bytes, and pushes each
//    seed's values into that seed's CTA's column with 16-byte st.async
//    stores to distributed shared memory, which count their bytes on the
//    column's "full" mbarrier where they land; each consumer arrives on
//    each pusher's "free" one once it has read the column.  So only the
//    ranking warps of a cluster keep step, and no fence waits.  A share
//    is brought in while the tile before it is ranked.  Seed counts that
//    are not a multiple of 4 (or below 8, or unaligned link ids) bring
//    the shares by 4-byte cp.async instead of TMA.
//  * A stable ranking in shared memory (warps 0-7).  Warp w takes the
//    tile's cells w * SEG .. (w + 1) * SEG in chunks of 32 and groups the
//    lanes that hold one key (one key in all lanes is tested first, the
//    common case in a hot run; else __match_any_sync).  The group's lowest
//    lane adds the group's size to the warp's count of the key with one
//    shared atomic, which returns the count before it (8 chunks' atomics
//    in flight together); each lane's rank in its warp's segment is that
//    count plus its place in the group.  A ranking barrier later each thread
//    scans its keys' counts over the warps and the warps scan the keys'
//    totals in key order: (warp, key) gets an offset into one key-major
//    slot array of the stage, and each key the start of its run.  After
//    another, each kept cell writes its weight w[n] (loaded from the (N,)
//    vector while the tile was ranked) into slot offset + rank, so a key's
//    slots hold its weights in ascending cell order, which is ascending
//    (h, n).
//  * Adds in order, apart from the ranking (warps 8-15): a ring of STAGES
//    slot stages between them (mbarriers "full" and "empty"), so an
//    adding thread with a hot run falls behind by up to STAGES - 1 tiles
//    while the ranking and the other keys go on; neighbouring links (a
//    host's, hot in the same tiles) belong to different adding warps.
//    Each thread adds the slots of its keys' runs in slot order with
//    __dadd_rn (never contracted or reassociated), the next 8 weights
//    loaded while 8 are added: one float64 add latency a cell of a run.
//
// A second entry point, dadd_latency_probe, times a chain of dependent
// float64 adds of one thread with clock64: the latency the chain floors
// count.
//
// Plain C interface for ctypes: the launches go on the caller's stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int RANKERS = 256;                  // warps 0-7: load, rank, place
constexpr int ADDERS = 256;                   // warps 8-15: the adds
constexpr int THREADS = RANKERS + ADDERS;
constexpr int WARPS = RANKERS / 32;           // ranking warps
constexpr int TILE = 4096;                    // rows (the seed's cells) a tile
constexpr int PER_LANE = TILE / RANKERS;      // cells a ranking thread ranks
constexpr int SEG = TILE / WARPS;             // cells a ranking warp ranks
constexpr int CLUSTER = 8;                    // seeds of a sector, a CTA each
constexpr int SHARE = TILE / CLUSTER;         // rows of a tile a CTA brings
constexpr int BOX = 256;                      // rows of a TMA box
constexpr int MAX_KEYS = 1024;                // bins a CTA owns
constexpr int KPT = MAX_KEYS / RANKERS;       // keys a thread scans or adds
constexpr int STAGES = 4;                     // slot stages, ranking to adds
constexpr int STARTS = MAX_KEYS + 8;          // run starts a stage (+ total)
constexpr unsigned SKIP = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(SEG < 65536 && TILE <= 65536 && MAX_KEYS < 65536,
              "counts, offsets, keys and starts are 16-bit");
static_assert(TILE % RANKERS == 0 && MAX_KEYS % RANKERS == 0 &&
                  RANKERS == ADDERS && SHARE % BOX == 0,
              "even splits");

struct Params {
  const int32_t* ids;   // (rows, seeds), rows = H * N
  const double* w;      // (N,)
  double* out;          // (seeds, links)
  long long rows;
  int n;                // N: row r's weight is w[r % N]
  int seeds;
  int links;
  int parts;            // link parts: clusters of one seed group
  int lp;               // links a part
};

// Shared memory of one CTA, in bytes: the share (SHARE rows x 8 seeds),
// the columns (2 stages of the CTA's seed's TILE cells), per
// (ranking warp, key) a 32-bit word whose low half counts the key's cells
// in the warp's segment and whose high half is their first slot once the
// tile is scanned, the slot stages (TILE weights each) and their run
// starts, each ranking warp's key totals, and the mbarriers: share full,
// columns full (2), pushers' columns free (2), slots full and empty
// (STAGES each).
struct Layout {
  static constexpr int SHARES = 0;
  static constexpr int COLS = SHARES + SHARE * CLUSTER * 4;
  static constexpr int COUNTS = COLS + 2 * TILE * 4;
  static constexpr int SLOTS = COUNTS + WARPS * MAX_KEYS * 4;
  static constexpr int RUNS = SLOTS + STAGES * TILE * 8;
  static constexpr int TOTALS = RUNS + STAGES * STARTS * 2;
  static constexpr int BARS = TOTALS + KPT * WARPS * 4;
  static constexpr int NBARS = 5 + 2 * STAGES;
  static constexpr int BYTES = BARS + NBARS * 8;
  static_assert(COLS % 128 == 0 && COUNTS % 128 == 0 && SLOTS % 128 == 0 &&
                    RUNS % 16 == 0 && BARS % 8 == 0,
                "aligned regions");
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}
// ``local``'s address in the shared memory of the cluster's CTA ``rank``
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(local), "r"(rank));
  return out;
}
// 16 bytes into a cluster peer's shared memory, counted on the peer's
// mbarrier ``bar`` (its transaction bytes) when they land.
__device__ __forceinline__ void st_async(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// One arrival on a cluster peer's mbarrier.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(bar) : "memory");
}
// mbar_wait that acquires at cluster scope (the phase was completed by
// arrivals from the cluster's other CTAs).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// The ranking warps' own barrier (the adding warps never wait on it).
__device__ __forceinline__ void ranking_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(RANKERS) : "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -DLOADS_PROFILE builds add the SM clock cycles that each CTA's first
// ranking thread spends in each phase of a tile (the share's wait and the
// push, the wait for the column, the ranking, the hand-over, the wait for
// a free slot stage, the scan, the placement), and that its first adding
// thread spends waiting for a full stage and adding, to loads_profile's
// totals.
#ifdef LOADS_PROFILE
constexpr int PHASES = 9;
__device__ unsigned long long g_phase_cycles[PHASES];
#define LAP(k)                                \
  do {                                        \
    if (tid == 0 || tid == RANKERS) {         \
      const long long now = clock64();        \
      lap[k] += now - lap_t;                  \
      lap_t = now;                            \
    }                                         \
  } while (0)
#else
#define LAP(k) \
  do {         \
  } while (0)
#endif

template <bool kTma>
__global__ void __launch_bounds__(THREADS, 1)
    ordered_cell_sum_kernel(const __grid_constant__ CUtensorMap id_map,
                            const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int32_t* shares = reinterpret_cast<int32_t*>(smem + Layout::SHARES);
  int32_t* cols = reinterpret_cast<int32_t*>(smem + Layout::COLS);
  uint32_t* counts = reinterpret_cast<uint32_t*>(smem + Layout::COUNTS);
  double* slots = reinterpret_cast<double*>(smem + Layout::SLOTS);
  uint16_t* runs = reinterpret_cast<uint16_t*>(smem + Layout::RUNS);
  int* totals = reinterpret_cast<int*>(smem + Layout::TOTALS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::BARS);
  const uint32_t share_full = smem_u32(bars), col_full = smem_u32(bars + 1),
                 col_free = smem_u32(bars + 3), slot_full = smem_u32(bars + 5),
                 slot_empty = smem_u32(bars + 5 + STAGES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned rank = cg::this_cluster().block_rank();
  const int cluster = blockIdx.x / CLUSTER;
  const int part = cluster % p.parts;
  const int s0 = (cluster / p.parts) * CLUSTER;   // the cluster's seeds
  const int seed = s0 + static_cast<int>(rank);
  const int l0 = part * p.lp;
  const unsigned owned =
      seed < p.seeds ? static_cast<unsigned>(min(p.lp, p.links - l0)) : 0u;
  const long long tiles = (p.rows + TILE - 1) / TILE;

  // the bytes the peers push into this CTA's column a tile
  const uint32_t col_bytes = seed < p.seeds ? TILE * 4 : 0;
  for (int i = tid; i < WARPS * MAX_KEYS; i += THREADS) counts[i] = 0;
  if (tid == 0) {
    mbar_init(share_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(col_full + 8 * i, 1);
      mbar_init(col_free + 8 * i, CLUSTER);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(slot_full + 8 * i, RANKERS);
      mbar_init(slot_empty + 8 * i, ADDERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 && i < tiles; ++i) {   // tiles 0 and 1
      mbar_expect_tx(col_full + 8 * i, col_bytes);
    }
  }
  // every CTA of the cluster runs, its barriers ready for peers' arrivals
  cluster_sync_all();
#ifdef LOADS_PROFILE
  long long lap[PHASES] = {}, lap_t = clock64();
#endif

  if (tid < RANKERS) {
    // ---- ranking warps ----
    const CUtensorMap* ids_map = &id_map;
    // tile k's share: rows k * TILE + rank * SHARE .. + SHARE, the
    // cluster's 8 seeds, once the last is pushed (after a ranking barrier)
    auto issue_share = [&](long long k) {
      if (k >= tiles) return;
      const long long r0 = k * TILE + rank * SHARE;
      if constexpr (kTma) {
        if (tid == 0) {
          mbar_expect_tx(share_full, SHARE * CLUSTER * 4);
          for (int b = 0; b < SHARE / BOX; ++b) {
            tma_load_2d(smem_u32(shares + b * BOX * CLUSTER), ids_map,
                        share_full, s0, static_cast<int>(r0 + b * BOX));
          }
        }
      } else {
        for (int c = tid; c < SHARE * CLUSTER; c += RANKERS) {
          const long long r = r0 + c / CLUSTER;
          const int s = s0 + c % CLUSTER;
          if (r < p.rows && s < p.seeds) {
            cp_async4(smem_u32(shares + c), p.ids + r * p.seeds + s);
          }
        }
        cp_async_commit();
      }
    };
    auto wait_share = [&](long long k) {
      if constexpr (kTma) {
        mbar_wait(share_full, static_cast<uint32_t>(k & 1));
      } else {
        cp_async_wait_all();
        ranking_sync();
      }
    };
    // tile k's share, each seed's values into that seed's CTA's column
    // (stage k & 1, rows rank * SHARE ..; rows past the end hold -1), once
    // every CTA has read the column stage's last tile: 4 rows and 4 seeds
    // at a time, 16 bytes a seed, counted on the seed's CTA's column
    // barrier
    const uint32_t cols_at = smem_u32(cols);
    auto push = [&](long long k) {
      mbar_wait_cluster(col_free + 8 * static_cast<uint32_t>(k & 1),
                        static_cast<uint32_t>(((k >> 1) + 1) & 1));
      const int32_t* src = shares;
      for (int it = tid; it < SHARE / 2; it += RANKERS) {
        const int quad = it % (SHARE / 4), half = it / (SHARE / 4);
        const long long r0 = k * TILE + rank * SHARE + quad * 4;
        int4 v[4];                     // rows 4 quad .., seeds half * 4 ..
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = r0 + i < p.rows
                     ? *reinterpret_cast<const int4*>(
                           src + (quad * 4 + i) * CLUSTER + half * 4)
                     : make_int4(-1, -1, -1, -1);
        }
        const uint32_t off = 4u * static_cast<uint32_t>(
            (k & 1) * TILE + rank * SHARE + quad * 4);
        const uint32_t bar = col_full + 8 * static_cast<uint32_t>(k & 1);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int peer = half * 4 + g;
          if (s0 + peer < p.seeds) {
            const int4 col =
                g == 0 ? make_int4(v[0].x, v[1].x, v[2].x, v[3].x)
                : g == 1 ? make_int4(v[0].y, v[1].y, v[2].y, v[3].y)
                : g == 2 ? make_int4(v[0].z, v[1].z, v[2].z, v[3].z)
                         : make_int4(v[0].w, v[1].w, v[2].w, v[3].w);
            st_async(peer_addr(cols_at + off, peer), col,
                     peer_addr(bar, peer));
          }
        }
      }
    };
    // after a ranking barrier: this CTA has read its column of tile k,
    // which takes tile k + 2 next
    auto hand_over = [&](long long k) {
      if (tid == 0 && k + 2 < tiles) {
        mbar_expect_tx(col_full + 8 * static_cast<uint32_t>(k & 1),
                       col_bytes);
      }
      if (tid < CLUSTER) {             // lane g tells the CTA of rank g
        mbar_arrive_peer(
            peer_addr(col_free + 8 * static_cast<uint32_t>(k & 1), tid));
      }
    };

    const unsigned below = (1u << lane) - 1u;
    uint32_t* mine = counts + warp * MAX_KEYS;
    issue_share(0);
    if (tiles > 0) {
      wait_share(0);
      push(0);
      ranking_sync();                  // share 0 pushed
      issue_share(1);
    }
    int d = 0;                         // the slot stage of tile t
    uint32_t use = 0;                  // how often stage d was used before
    for (long long t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        wait_share(t + 1);
        push(t + 1);
      }
      LAP(0);
      mbar_wait_cluster(col_full + 8 * static_cast<uint32_t>(t & 1),
                        static_cast<uint32_t>((t >> 1) & 1));
      LAP(1);

      // rank: each kept cell's key and its place among the warp's cells of
      // that key, in cell order; and its weight, for the placement
      const int32_t* ids = cols + (t & 1) * TILE;
      const int n0 = static_cast<int>(t * TILE % p.n);
      uint32_t kr[PER_LANE];
      double wv[PER_LANE];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        constexpr int E = PER_LANE / 2;
        unsigned key[E], grp[E], base[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = warp * SEG + (half * E + e) * 32 + lane;
          key[e] = static_cast<unsigned>(ids[c] - l0);
          if (key[e] >= owned) key[e] = SKIP;   // -1, other parts' links
          const unsigned first = __shfl_sync(FULL, key[e], 0);
          grp[e] = __all_sync(FULL, key[e] == first)
                       ? FULL
                       : __match_any_sync(FULL, key[e]);
          int n = n0 + c;
          if (n >= p.n) n = n - p.n < p.n ? n - p.n : n % p.n;
          wv[half * E + e] = key[e] != SKIP ? __ldg(p.w + n) : 0.0;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          base[e] = 0;
          if (key[e] != SKIP && (grp[e] & below) == 0) {
            base[e] = atomicAdd(&mine[key[e]], __popc(grp[e]));
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int leader = __ffs(grp[e]) - 1;
          const unsigned b = __shfl_sync(FULL, base[e], leader) & 0xFFFFu;
          kr[half * E + e] = key[e] != SKIP
                                 ? (key[e] << 16) | (b + __popc(grp[e] & below))
                                 : SKIP;
        }
      }
      LAP(2);
      ranking_sync();                  // column t read, share t + 1 pushed
      hand_over(t);
      issue_share(t + 2);
      LAP(3);

      // scan: each owned key's counts over the warps, then the keys'
      // totals over the ranking warps in key order (key = j * RANKERS +
      // tid), into slot stage d once its adds are done
      mbar_wait(slot_empty + 8 * d, (use + 1) & 1);
      LAP(4);
      uint16_t* start = runs + d * STARTS;
      int pre[KPT][WARPS], tot[KPT], incl[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = j * RANKERS + tid;
        int run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          pre[j][w] = run;
          run += static_cast<int>(counts[w * MAX_KEYS + k] & 0xFFFFu);
        }
        tot[j] = incl[j] = run;
      }
#pragma unroll
      for (int dd = 1; dd < 32; dd *= 2) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int up = __shfl_up_sync(FULL, incl[j], dd);
          if (lane >= dd) incl[j] += up;
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) totals[j * WARPS + warp] = incl[j];
      }
      ranking_sync();
      int base = 0;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = j * RANKERS + tid;
        int chunk = 0, earlier = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int x = totals[j * WARPS + w];
          chunk += x;
          if (w < warp) earlier += x;
        }
        const int first = base + earlier + incl[j] - tot[j];
        start[k] = static_cast<uint16_t>(first);
        if (k == MAX_KEYS - 1) start[MAX_KEYS] = first + tot[j];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {   // offset in, count zeroed
          counts[w * MAX_KEYS + k] =
              static_cast<uint32_t>(first + pre[j][w]) << 16;
        }
        base += chunk;
      }
      ranking_sync();
      LAP(5);

      // place: each kept cell's weight into its key's next slot
      double* slot = slots + d * TILE;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        if (kr[e] != SKIP) {
          slot[(mine[kr[e] >> 16] >> 16) + (kr[e] & 0xFFFFu)] = wv[e];
        }
      }
      mbar_arrive(slot_full + 8 * d);
      LAP(6);
      if (++d == STAGES) {
        d = 0;
        ++use;
      }
    }
  } else {
    // ---- adding warps: tile t's runs from slot stage t % STAGES ----
    // thread a owns keys 256 j + 8 (a % 32) + a / 32: neighbouring links
    // (a host's, and the next hosts' links, hot in the same tiles) fall
    // to different warps, whose lanes would otherwise wait for each other
    const int a = tid - RANKERS;
    const int key0 = 8 * (a % 32) + a / 32;
    double sum[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sum[j] = 0.0;
    int d = 0;
    uint32_t use = 0;
    for (long long t = 0; t < tiles; ++t) {
      mbar_wait(slot_full + 8 * d, use & 1);
      LAP(7);
      const uint16_t* start = runs + d * STARTS;
      const double* slot = slots + d * TILE;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = j * ADDERS + key0;
        const double* run = slot + start[k];
        const int n = start[k + 1] - start[k];
        double acc = sum[j], x[8];
        int i = 0;
        if (n >= 8) {                  // the next 8 in flight while 8 add
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = run[u];
          for (; i + 16 <= n; i += 8) {
            double y[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) y[u] = run[i + 8 + u];
#pragma unroll
            for (int u = 0; u < 8; ++u) acc = __dadd_rn(acc, x[u]);
#pragma unroll
            for (int u = 0; u < 8; ++u) x[u] = y[u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __dadd_rn(acc, x[u]);
          i += 8;
        }
        for (; i < n; ++i) acc = __dadd_rn(acc, run[i]);
        sum[j] = acc;
      }
      mbar_arrive(slot_empty + 8 * d);
      LAP(8);
      if (++d == STAGES) {
        d = 0;
        ++use;
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const unsigned k = j * ADDERS + key0;
      if (k < owned) {
        p.out[static_cast<long long>(seed) * p.links + l0 + k] = sum[j];
      }
    }
  }
#ifdef LOADS_PROFILE
  if (tid == 0 || tid == RANKERS) {
    for (int k = 0; k < PHASES; ++k) {
      atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(lap[k]));
    }
  }
#endif
  // no peer still pushes into this CTA or arrives on its barriers
  cluster_sync_all();
}

__global__ void dadd_latency_probe_kernel(long long* out, int steps,
                                          double x) {
  double s = x;
  const double d = x * 0.5;
  s = __dadd_rn(s, d);
  long long c0, c1;
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  c0 = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) s = __dadd_rn(s, d);
  c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  out[0] = c1 - c0;
  out[1] = static_cast<long long>(ns1 - ns0);
  out[2] = __double_as_longlong(s);
}

template <bool kTma>
int launch(const CUtensorMap& id_map, const Params& p, long long blocks,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ordered_cell_sum_kernel<kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ordered_cell_sum_kernel<kTma>, id_map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (rows, seeds) int32 link ids and (n,) float64 weights -> (seeds, links)
// float64 sums, ``links_per_block`` links a CTA (at most 1,024).
extern "C" int ordered_cell_sum(const void* ids, const void* weights,
                                void* out, long long rows, long long n,
                                long long seeds, long long links,
                                int links_per_block, void* stream) {
  if (seeds <= 0 || links <= 0) return 0;
  if (rows < 0 || rows > 0x7FFFFFFFLL - 2 * TILE || (rows > 0 && n <= 0) ||
      n > 0x7FFFFFFFLL - 2 * TILE || seeds > 0x7FFFFFFFLL ||
      links > 0x7FFFFFFFLL || links_per_block < 1 ||
      links_per_block > MAX_KEYS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.ids = static_cast<const int32_t*>(ids);
  p.w = static_cast<const double*>(weights);
  p.out = static_cast<double*>(out);
  p.rows = rows;
  p.n = static_cast<int>(n > 0 ? n : 1);
  p.seeds = static_cast<int>(seeds);
  p.links = static_cast<int>(links);
  p.lp = links_per_block;
  p.parts = static_cast<int>((links + links_per_block - 1) / links_per_block);
  CUtensorMap id_map{};
  const bool tma = rows > 0 && seeds >= CLUSTER && seeds % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  if (tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(seeds),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(seeds) * 4};
    const cuuint32_t box[2] = {CLUSTER, BOX};
    const cuuint32_t unit[2] = {1, 1};
    if (enc(&id_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
            const_cast<void*>(ids), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long blocks =
      (seeds + CLUSTER - 1) / CLUSTER * p.parts * CLUSTER;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tma ? launch<true>(id_map, p, blocks, s)
             : launch<false>(id_map, p, blocks, s);
}

// The phase totals of a -DLOADS_PROFILE build into ``out`` (9 unsigned
// 64-bit counters, host memory), zeroed after; other builds refuse.
extern "C" int loads_profile(void* out) {
#ifdef LOADS_PROFILE
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[PHASES] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
#else
  (void)out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

extern "C" int dadd_latency_probe(void* out, int steps, void* stream) {
  dadd_latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps, 1.0);
  return static_cast<int>(cudaGetLastError());
}
