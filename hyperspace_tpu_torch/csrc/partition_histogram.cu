// Bucket ids AND per-bucket row counts from uint32 key lanes in one pass:
// the repartition primitive of the Exchange, as a hand-written Hopper kernel.
//
// Replaces: hyperspace_tpu/ops/pallas/partition_kernel.py::
// partition_ids_and_histogram (Pallas body `_kernel`). Per row: THE bucket
// hash identity (murmur3 fmix32 of lane 0, then boost hash_combine with
// fmix32 of each further lane, then h % num_buckets as int32, exactly as
// csrc/hash_buckets.cu), and lengths[b] = the number of rows whose id is b.
//
// Bound: device-memory bytes. The kernel reads each of the L lanes once,
// writes one int32 id per row and one int64 count per bucket:
// 4 * n * L + 4 * n + 8 * B bytes. At the Exchange's shape (n = 8,388,608,
// L = 2, B = 200) that is 100.7 MB, about 30 us at the H100's 3.35 TB/s; the
// ~20 integer operations per lane per row and one shared-memory atomic per
// row are far below the card's rates.
//
// Design: the TPU kernel's one-hot sub-block accumulation suits a vector
// unit with a large VMEM, not Hopper. Here one row per thread in a
// grid-stride loop (neighbouring threads read neighbouring words of each
// lane, so loads coalesce); the hash chain stays in uint32 registers; each
// id is written once. Each block keeps a histogram of num_buckets 32-bit
// counters in shared memory (4 KB at B = 1024): zeroed, one shared atomicAdd
// per row, then after __syncthreads() one global 64-bit atomicAdd per
// non-zero bin into the [B] output, which the caller zeroes. Integer atomics
// commute, so the result is exact whatever order the atomics land in.
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

__global__ void partition_histogram_kernel(const uint32_t* __restrict__ lanes,
                                           int n_lanes, int64_t n,
                                           uint32_t num_buckets,
                                           int32_t* __restrict__ ids,
                                           unsigned long long* __restrict__ lengths) {
  extern __shared__ uint32_t hist[];
  for (uint32_t b = threadIdx.x; b < num_buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = fmix32(__ldg(lanes + i));
    for (int l = 1; l < n_lanes; ++l) {
      const uint32_t h2 = fmix32(__ldg(lanes + static_cast<int64_t>(l) * n + i));
      h ^= h2 + 0x9E3779B9u + (h << 6) + (h >> 2);
    }
    const uint32_t bucket = h % num_buckets;
    ids[i] = static_cast<int32_t>(bucket);
    atomicAdd(&hist[bucket], 1u);
  }
  __syncthreads();

  for (uint32_t b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    const uint32_t count = hist[b];
    if (count != 0) atomicAdd(&lengths[b], static_cast<unsigned long long>(count));
  }
}

}  // namespace

extern "C" int hs_partition_ids_and_histogram(const void* lanes, int n_lanes,
                                              long long n,
                                              unsigned int num_buckets,
                                              void* ids, void* lengths,
                                              void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  // 8 blocks per SM on 132 SMs: enough to hide latency, few enough that the
  // per-block histogram flush (B global atomics per block) stays small.
  const long long needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < 132LL * 8 ? needed : 132LL * 8);
  const size_t shared = static_cast<size_t>(num_buckets) * sizeof(uint32_t);
  partition_histogram_kernel<<<blocks, kThreads, shared,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lanes), n_lanes, static_cast<int64_t>(n),
      num_buckets, static_cast<int32_t*>(ids),
      static_cast<unsigned long long*>(lengths));
  return static_cast<int>(cudaGetLastError());
}
