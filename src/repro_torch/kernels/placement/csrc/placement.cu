// Sequential greedy congestion-aware placement, one warp per seed, for
// sm_90a.
//
// Replaces the host loop of the JAX package's routing strategies
//   src/repro/core/strategies.py  _sequential_congestion_place (:467)
// which the reference runs on the host under every engine (it has no
// Pallas kernel): ``congestion-aware`` routes every flow through it, and
// ``wave-congestion-aware`` its residue at the round cap.
//
// Flows are placed one at a time in ``order``: at every hop a flow takes
// the candidate egress link whose load (under that seed) is least, ties
// broken by the flow's hash (murmur3 or the exact splitmix fold) modulo
// the number of tied candidates, in table order; after its walk it adds
// its weight to every link it took.  Each placement reads the loads the
// earlier ones wrote, but only within its own seed: a seed reads and
// writes row ``s`` of the (S, L) load table alone.  So the seeds are
// independent chains, and each runs in one warp:
//   * the lanes hold the 32 candidates of a hop (tables wider than 32
//     are walked in chunks): one load read each, a warp min, a ballot of
//     the ties, and the tie of rank ``hash % n_tie`` picked from the
//     ballot;
//   * lane f holds hash field f of the flow being placed (at most 32
//     fields), shuffled into the hash only when a hop has a tie;
//   * after the walk, lane t adds the weight to hop t's link.  A path
//     crosses a link at most once, so the adds never collide, and each
//     link's row sees them in flow order: the same float64 sums as the
//     host loop, bit for bit, for any weights;
//   * ``mask`` (N, S) selects the cells to place (the wave's residue);
//     the warp reads 32 flows' bits at once and skips unselected flows.
// Bound: latency.  Each hop is a chain of dependent reads (device kind,
// candidate count, candidates, their loads, the next device), so a seed
// costs about (flows x hops) round trips to L2 however many seeds run
// beside it; the seeds fill S warps of the card.
//
// Faults (a walk that does not end in ``max_hops`` hops, or ends at
// another device than the flow's destination) stop that seed's chain and
// are reported in ``fault[s] = {order position, kind 1 or 2, device}``,
// position -1 when none.  ``hops[s]`` is the seed's longest walk.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/murmur.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kHashInit = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(32) congestion_place_kernel(
    const int64_t* __restrict__ cand, const int64_t* __restrict__ cand_n,
    const int64_t* __restrict__ dev_crc, const bool* __restrict__ is_server,
    const int64_t* __restrict__ link_dst, const int64_t* __restrict__ fields,
    int n_fields, const int64_t* __restrict__ seeds,
    const int64_t* __restrict__ src_dev, const int64_t* __restrict__ dst_dev,
    const int64_t* __restrict__ src_key, const int64_t* __restrict__ dst_key,
    const double* __restrict__ weight, const int64_t* __restrict__ order,
    const bool* __restrict__ mask, double* load, int32_t* link_ids,
    int64_t* __restrict__ fault, int32_t* __restrict__ hops_out,
    int64_t n_flows, int64_t n_seeds, int64_t n_keys, int c_max,
    int64_t n_links, int max_hops, int use_murmur) {
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  double* row = load + s * n_links;
  const uint64_t seed = static_cast<uint64_t>(seeds[s]);
  int hop_hw = 0;
  for (int64_t p0 = 0; p0 < n_flows; p0 += 32) {
    const int64_t p = p0 + lane;
    int64_t jj = -1;
    bool want = false;
    if (p < n_flows) {
      jj = order[p];
      want = mask == nullptr || mask[jj * n_seeds + s];
    }
    unsigned todo = __ballot_sync(kFull, want);
    while (todo) {
      const int src_lane = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t j = __shfl_sync(kFull, jj, src_lane);
      const uint64_t my_field =
          lane < n_fields ? static_cast<uint64_t>(fields[j * n_fields + lane])
                          : 0;
      const int64_t sk = src_key[j], dk = dst_key[j];
      int32_t* out = link_ids + j * n_seeds + s;   // hop t at t*N*S
      int64_t state = src_dev[j];
      bool done = false;
      int t_end = 0;
      for (int t = 0; t < max_hops && !done; ++t) {
        t_end = t + 1;
        const int64_t key = is_server[state] ? sk : dk;
        const int64_t vk = state * n_keys + key;
        const int64_t nc = cand_n[vk];
        const int n_eff = static_cast<int>(nc < c_max ? nc : c_max);
        const int64_t* cands = cand + vk * c_max;
        double best = INFINITY;
        for (int c0 = 0; c0 < n_eff; c0 += 32) {
          const int64_t cd = c0 + lane < n_eff ? cands[c0 + lane] : -1;
          if (cd >= 0) best = fmin(best, row[cd]);
        }
        best = warp_min(best);
        int n_tie = 0;
        for (int c0 = 0; c0 < n_eff; c0 += 32) {
          const int64_t cd = c0 + lane < n_eff ? cands[c0 + lane] : -1;
          n_tie += __popc(__ballot_sync(kFull, cd >= 0 && row[cd] == best));
        }
        int64_t link = -1;
        if (n_tie > 0) {
          uint64_t rank = 0;
          if (n_tie > 1) {
            const uint64_t dseed = static_cast<uint64_t>(dev_crc[state]) ^ seed;
            uint64_t h;
            if (use_murmur) {
              uint32_t h32 = static_cast<uint32_t>(dseed);
              for (int f = 0; f < n_fields; ++f) {
                h32 = murmur::fold(h32, static_cast<uint32_t>(
                                            __shfl_sync(kFull, my_field, f)));
              }
              h = murmur::fmix(h32);
            } else {
              h = mix64(dseed ^ kHashInit);
              for (int f = 0; f < n_fields; ++f) {
                h = mix64(h ^ __shfl_sync(kFull, my_field, f));
              }
            }
            rank = h % static_cast<uint64_t>(n_tie);
          }
          for (int c0 = 0; c0 < n_eff; c0 += 32) {
            const int64_t cd = c0 + lane < n_eff ? cands[c0 + lane] : -1;
            const unsigned ties =
                __ballot_sync(kFull, cd >= 0 && row[cd] == best);
            const unsigned cnt = __popc(ties);
            if (rank < cnt) {
              // the (rank + 1)-th set bit of ``ties``
              const int pos = __fns(ties, 0, static_cast<int>(rank) + 1);
              link = cands[c0 + pos];
              break;
            }
            rank -= cnt;
          }
        }
        if (lane == 0) out[t * n_flows * n_seeds] = static_cast<int32_t>(link);
        if (link >= 0) {
          state = link_dst[link];
          done = is_server[state];
        } else {
          done = true;
        }
      }
      if (!done || state != dst_dev[j]) {
        if (lane == 0) {
          fault[3 * s] = p0 + src_lane;
          fault[3 * s + 1] = done ? 2 : 1;
          fault[3 * s + 2] = state;
          hops_out[s] = hop_hw > t_end ? hop_hw : t_end;
        }
        return;
      }
      __syncwarp();
      const double w = weight[j];
      for (int t = lane; t < t_end; t += 32) {
        const int32_t l = out[t * n_flows * n_seeds];
        if (l >= 0) row[l] += w;
      }
      __syncwarp();
      hop_hw = hop_hw > t_end ? hop_hw : t_end;
    }
  }
  if (lane == 0) hops_out[s] = hop_hw;
}

}  // namespace

extern "C" int congestion_place(
    const void* cand, const void* cand_n, const void* dev_crc,
    const void* is_server, const void* link_dst, const void* fields,
    int n_fields, const void* seeds, const void* src_dev, const void* dst_dev,
    const void* src_key, const void* dst_key, const void* weight,
    const void* order, const void* mask, void* load, void* link_ids,
    void* fault, void* hops, long long n_flows, long long n_seeds,
    long long n_keys, int c_max, long long n_links, int max_hops,
    int use_murmur, void* stream) {
  if (n_seeds <= 0) return 0;
  if (n_fields > 32 || n_seeds > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  congestion_place_kernel<<<static_cast<unsigned int>(n_seeds), 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cand), static_cast<const int64_t*>(cand_n),
      static_cast<const int64_t*>(dev_crc), static_cast<const bool*>(is_server),
      static_cast<const int64_t*>(link_dst),
      static_cast<const int64_t*>(fields), n_fields,
      static_cast<const int64_t*>(seeds), static_cast<const int64_t*>(src_dev),
      static_cast<const int64_t*>(dst_dev),
      static_cast<const int64_t*>(src_key),
      static_cast<const int64_t*>(dst_key),
      static_cast<const double*>(weight), static_cast<const int64_t*>(order),
      static_cast<const bool*>(mask), static_cast<double*>(load),
      static_cast<int32_t*>(link_ids), static_cast<int64_t*>(fault),
      static_cast<int32_t*>(hops), n_flows, n_seeds, n_keys, c_max, n_links,
      max_hops, use_murmur);
  return static_cast<int>(cudaGetLastError());
}
