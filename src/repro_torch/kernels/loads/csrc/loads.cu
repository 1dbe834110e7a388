// Ordered per-bin float64 sums, one thread per bin, for sm_90a.
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
// out[b] = ((0.0 + w[perm[start[b]]]) + w[perm[start[b] + 1]]) + ...
// over bin b's run perm[start[b] .. start[b + 1]): the positions of the
// elements keyed b in ascending order, from a stable sort of the keys
// (done by the caller), so every bin adds its weights in input order,
// the order of np.bincount and of torch.bincount on the CPU, bit for bit
// for any weights.
//
// Bound: memory.  Each element's position (8 bytes) is read in runs and
// its weight (8 bytes) gathered once; a bin's adds are one dependent
// chain, so the longest run also sets a floor of one float64 add latency
// per element.  Design: one thread a bin walks its contiguous run with
// four positions and four weights in flight ahead of the adds; the adds
// stay in order and are never contracted or reassociated.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ordered_bin_sum_kernel(
    const int64_t* __restrict__ perm, const int64_t* __restrict__ start,
    const double* __restrict__ w, double* __restrict__ out, int64_t n_bins) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (b >= n_bins) return;
  int64_t i = start[b];
  const int64_t e = start[b + 1];
  double s = 0.0;
  for (; i + 4 <= e; i += 4) {
    const int64_t p0 = perm[i], p1 = perm[i + 1], p2 = perm[i + 2],
                  p3 = perm[i + 3];
    const double w0 = w[p0], w1 = w[p1], w2 = w[p2], w3 = w[p3];
    s = __dadd_rn(s, w0);
    s = __dadd_rn(s, w1);
    s = __dadd_rn(s, w2);
    s = __dadd_rn(s, w3);
  }
  for (; i < e; ++i) s = __dadd_rn(s, w[perm[i]]);
  out[b] = s;
}

}  // namespace

extern "C" int ordered_bin_sum(const void* perm, const void* start,
                               const void* weights, void* out,
                               long long n_bins, void* stream) {
  if (n_bins <= 0) return 0;
  const long long blocks = (n_bins + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  ordered_bin_sum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(perm), static_cast<const int64_t*>(start),
      static_cast<const double*>(weights), static_cast<double*>(out), n_bins);
  return static_cast<int>(cudaGetLastError());
}
