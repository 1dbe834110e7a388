// murmur3 flow hash over a (rows x seeds) grid, for sm_90a.
//
// Replaces both Pallas TPU flow-hash kernels of the JAX package:
//   src/repro/kernels/flowhash/kernel.py  bulk_hash_kernel        (:70)
//   src/repro/kernels/flowhash/kernel.py  bulk_hash_seeded_kernel (:90)
// and the per-(flow, seed) murmur grid the JAX engines evaluate inline
// on every hop of the ECMP walk (vector_sim._murmur_hash_grid).
//
// out[n, s] = fmix(fold(... fold(seed32[n, s], f[n, 0]) ..., f[n, F-1]))
// with seed32 the low 32 bits of seeds[n * seed_stride_n + s * seed_stride_s]
// and every field truncated to its low 32 bits.  (1, 0) with one column is
// bulk_hash_seeded's per-row seed, (S, 1) the walk's device-seed grid.  A
// null ``seeds`` takes ``seed_value`` for every cell: bulk_hash's scalar
// seed, passed by value so that its call copies nothing to the card and
// never waits on it.
//
// Bound: memory.  Per cell the body does F folds of ~9 32-bit integer
// operations plus a ~9-operation fmix (about 54 for F = 5), against 16
// bytes of traffic: an int64 seed read and an int64 hash written (the
// (N, F) int64 field matrix is read once and shared by the S cells of a
// row).  A 102,400 x 2,560 grid moves 4.2 GB; at ~3.4 integer operations
// per byte the card's memory, not its ALUs, sets the pace.
// Design: one thread per cell over a 1-D grid with s fastest, so a
// warp's 32 cells share one field row (broadcast loads) and its seed
// reads and hash writes are coalesced.  No shared memory, no tensor
// cores: there is no reuse for them to exploit.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/murmur.cuh"

namespace {

__global__ void flowhash_grid_kernel(const int64_t* __restrict__ fields,
                                     int n_fields,
                                     const int64_t* __restrict__ seeds,
                                     int64_t seed_stride_n,
                                     int64_t seed_stride_s,
                                     uint32_t seed_value,
                                     int64_t* __restrict__ out,
                                     int64_t n_rows, int64_t n_seeds) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rows * n_seeds) return;
  const int64_t n = i / n_seeds;
  const int64_t s = i - n * n_seeds;
  uint32_t h = seeds == nullptr
                   ? seed_value
                   : static_cast<uint32_t>(
                         seeds[n * seed_stride_n + s * seed_stride_s]);
  const int64_t* row = fields + n * n_fields;
  for (int f = 0; f < n_fields; ++f) {
    h = murmur::fold(h, static_cast<uint32_t>(row[f]));
  }
  out[i] = static_cast<int64_t>(murmur::fmix(h));
}

}  // namespace

extern "C" int flowhash_grid(const void* fields, int n_fields,
                             const void* seeds, long long seed_stride_n,
                             long long seed_stride_s,
                             unsigned int seed_value, void* out,
                             long long n_rows, long long n_seeds,
                             void* stream) {
  const long long cells = n_rows * n_seeds;
  if (cells <= 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  flowhash_grid_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(fields), n_fields,
      static_cast<const int64_t*>(seeds), seed_stride_n, seed_stride_s,
      seed_value, static_cast<int64_t*>(out), n_rows, n_seeds);
  return static_cast<int>(cudaGetLastError());
}
