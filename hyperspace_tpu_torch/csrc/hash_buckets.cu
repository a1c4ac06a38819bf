// Bucket ids from uint32 key lanes: THE hash identity of the on-disk index
// layout, as a hand-written Hopper kernel.
//
// Replaces: hyperspace_tpu/ops/pallas/hash_kernel.py::hash_lanes_to_buckets
// (Pallas body `_kernel`). Per row: murmur3 fmix32 of lane 0, then for each
// further lane boost hash_combine(h, fmix32(lane)) =
// h ^ (h2 + 0x9E3779B9 + (h << 6) + (h >> 2)), then h % num_buckets as int32.
// It must equal hyperspace_tpu/ops/hash_partition.py::flat_hash32 bit for bit.
//
// Bound: device-memory bytes. The kernel reads each of the L lanes once and
// writes one int32 id per row: 4 * n * (L + 1) bytes and ~20 integer
// operations per lane per row, far below the card's integer rate. At the
// build's shape (n = 16,777,216, an int64 key = 2 lanes) that is 201 MB, or
// about 60 us at the H100's 3.35 TB/s.
//
// Design: one row per thread in a grid-stride loop, so neighbouring threads
// read neighbouring words of each lane (coalesced). The whole chain stays in
// uint32 registers, where multiply wraps and shifts are logical natively; no
// shared memory, no synchronisation, no allocation. Lanes arrive as one
// contiguous [L, n] buffer, so there is no limit on the lane count.
//
// Interface: plain C, loaded with ctypes. Launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is seen at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash_lanes_to_buckets_kernel(const uint32_t* __restrict__ lanes,
                                             int n_lanes, int64_t n,
                                             uint32_t num_buckets,
                                             int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = fmix32(__ldg(lanes + i));
    for (int l = 1; l < n_lanes; ++l) {
      const uint32_t h2 = fmix32(__ldg(lanes + static_cast<int64_t>(l) * n + i));
      h ^= h2 + 0x9E3779B9u + (h << 6) + (h >> 2);
    }
    out[i] = static_cast<int32_t>(h % num_buckets);
  }
}

}  // namespace

extern "C" int hs_hash_lanes_to_buckets(const void* lanes, int n_lanes,
                                        long long n, unsigned int num_buckets,
                                        void* out, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  // Enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest.
  const long long needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < 132LL * 64 ? needed : 132LL * 64);
  hash_lanes_to_buckets_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lanes), n_lanes, static_cast<int64_t>(n),
      num_buckets, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
