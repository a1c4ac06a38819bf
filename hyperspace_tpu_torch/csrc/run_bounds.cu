// Run bounds of a sorted sequence from its adjacent-difference flags: the
// counting join's run scan, as a hand-written Hopper kernel.
//
// Replaces: no Pallas kernel. It stands in for the jax.lax.cummax / cummin
// pair at hyperspace_tpu/ops/join.py:311-314, which XLA computes. PyTorch's
// cummax / cummin on a 1-D tensor run as ONE block of 512 threads that walks
// the whole array (ATen's ScanUtils.cuh), so on an H100 one SM of 132 scanned
// every element of every counting join at about 8.6 GB/s. This kernel was
// added for that measurement: the two scans held 76 % of the card's busy time
// in the TPC-H streams benchmark.
//
// Function: `differs` holds T - 1 flags (differs[k] != 0: element k + 1
// starts a new run; element 0 always does). For every i in [0, T):
//   first[i] = the largest start s <= i
//            = max({0} u {k + 1 : k < i, differs[k]})
//   last[i]  = the end of i's run = (the smallest start s > i, else T) - 1
//            = min({T - 1} u {k : k >= i, differs[k]})
// both int64. The second form of each is what the kernel computes.
//
// Bound: device-memory bytes. The flags are read once (1 byte an element)
// and both outputs written once (16 bytes), 17 bytes an element: at the
// benchmark's largest join (T = 6,226,893) 105.9 MB, 31.6 us at 3.35 TB/s.
//
// Design: T is cut into tiles of 4,096 elements, one block of 256 threads
// (8 warps of 512 elements) each, so the whole card takes part. Two launches
// on the caller's stream:
//   1. `tile_summary_kernel`: each tile's last start (0 if none) and first
//      flagged k (T - 1 if none) into a [2, tiles] int64 scratch vector.
//   2. `run_bounds_kernel`: each tile finds its carries by walking the
//      summaries, 32 tiles a step with one ballot: the nearest earlier tile
//      that has a start (else 0) and the nearest later tile that has one
//      (else T - 1). TPC-H's runs of 1-7 rows stop the walk at the first
//      step; a run longer than a tile walks further, at most
//      ceil(tiles / 32) steps, from L2.
// Inside a tile each lane reads its 16 flags with one 16-byte load and packs
// them into 16 bits; one shuffle pairs neighbouring lanes, so lane 2 r holds
// the 32-bit mask of the warp's round r (elements 32 r .. 32 r + 31). The
// warp's summaries are one integer warp reduction each, and the earlier /
// later warps' carries come through shared memory. Each lane then writes
// element 32 r + lane of every round: its bounds within the round are one
// clz (the highest start below it) and one ffs (the lowest flag at or above
// it) of the round's mask. So each store is 32 neighbouring int64 (256
// contiguous bytes), and nothing waits on another block.
// The second launch reads the flags again, mostly from L2 (the first just
// read them), so device memory sees close to 17 bytes an element. The result
// is defined element for element: no atomics, no order dependence.
//
// Interface: plain C, loaded with ctypes. Launches on the caller's stream,
// allocates nothing (the caller passes one buffer for both outputs and the
// scratch vector) and returns cudaGetLastError() so a refused launch is seen
// at once. Flags that are not 16-byte aligned (a view into a buffer) take
// byte loads.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpSpan = 512;                          // 16 per lane
constexpr int64_t kTile = int64_t{kWarpSpan} * kWarps;  // 4,096 per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// Bit i set: byte i of `w` is not 0.
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  const unsigned ones = __vcmpne4(w, 0u) & 0x01010101u;
  return (ones * 0x01020408u) >> 24;  // byte i's 1 lands on bit 24 + i
}

// Bit j set: differs[k0 + j] != 0, for j < 16 (0 past the last flag).
// One 16-byte load where the flags allow it.
__device__ __forceinline__ unsigned flag_bits(const uint8_t* __restrict__ differs,
                                              int64_t n_flags, int64_t k0,
                                              bool aligned) {
  if (aligned && k0 + 16 <= n_flags) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(differs + k0));
    return byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8
           | byte_bits(v.w) << 12;
  }
  unsigned bits = 0;
  for (int j = 0; j < 16; ++j) {
    if (k0 + j < n_flags && __ldg(differs + k0 + j) != 0) bits |= 1u << j;
  }
  return bits;
}

// The flags of the warp's 512 elements from `seg`: lane l reads elements
// 16 l .. 16 l + 15; the result's even lane 2 r holds the 32-bit mask of
// elements 32 r .. 32 r + 31 (bit i: element 32 r + i is flagged).
__device__ __forceinline__ unsigned warp_flags(const uint8_t* __restrict__ differs,
                                               int64_t n_flags, int64_t seg,
                                               int lane, bool aligned) {
  const unsigned bits = flag_bits(differs, n_flags, seg + 16 * lane, aligned);
  return bits | __shfl_down_sync(kFull, bits, 1) << 16;
}

// The warp's last start (0 if none) and first flagged k (n_flags if none),
// as positions.
__device__ __forceinline__ void warp_summary(unsigned pair, int64_t seg,
                                             int64_t n_flags, int lane,
                                             int64_t* last, int64_t* first) {
  const bool mine = (lane & 1) == 0 && pair != 0;
  const unsigned at = 16 * lane;  // == 32 * (lane / 2) on even lanes
  const unsigned l = __reduce_max_sync(
      kFull, mine ? at + 32 - __clz(static_cast<int>(pair)) : 0u);
  const unsigned f = __reduce_min_sync(
      kFull, mine ? at + __ffs(static_cast<int>(pair)) - 1 : 1u << 30);
  *last = l ? seg + l : 0;
  *first = f < (1u << 30) ? seg + f : n_flags;
}

__device__ __forceinline__ bool is_aligned(const uint8_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void tile_summary_kernel(const uint8_t* __restrict__ differs,
                                    int64_t n_flags,
                                    int64_t* __restrict__ tile_last,
                                    int64_t* __restrict__ tile_first) {
  __shared__ int64_t s_last[kWarps];
  __shared__ int64_t s_first[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kTile
                      + int64_t{kWarpSpan} * warp;
  const unsigned pair = warp_flags(differs, n_flags, seg, lane,
                                   is_aligned(differs));
  int64_t last, first;
  warp_summary(pair, seg, n_flags, lane, &last, &first);
  if (lane == 0) {
    s_last[warp] = last;
    s_first[warp] = first;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      last = s_last[w] > last ? s_last[w] : last;
      first = s_first[w] < first ? s_first[w] : first;
    }
    tile_last[blockIdx.x] = last;
    tile_first[blockIdx.x] = first;
  }
}

__global__ void run_bounds_kernel(const uint8_t* __restrict__ differs,
                                  int64_t n_flags, int64_t tiles,
                                  const int64_t* __restrict__ tile_last,
                                  const int64_t* __restrict__ tile_first,
                                  int64_t* __restrict__ first_out,
                                  int64_t* __restrict__ last_out) {
  __shared__ int64_t s_last[kWarps];
  __shared__ int64_t s_first[kWarps];
  __shared__ int64_t s_carry[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tile = blockIdx.x;
  const int64_t n = n_flags + 1;  // T
  const int64_t seg = tile * kTile + int64_t{kWarpSpan} * warp;
  const unsigned pair = warp_flags(differs, n_flags, seg, lane,
                                   is_aligned(differs));

  if (warp == 0) {
    // Forward carry: the last start of the nearest earlier tile with one.
    int64_t carry = 0;
    for (int64_t t0 = tile - 1; t0 >= 0; t0 -= 32) {
      const int64_t t = t0 - lane;
      const int64_t v = t >= 0 ? tile_last[t] : 0;
      const unsigned hit = __ballot_sync(kFull, v > 0);
      if (hit) {
        carry = __shfl_sync(kFull, v, __ffs(static_cast<int>(hit)) - 1);
        break;
      }
    }
    if (lane == 0) s_carry[0] = carry;
  } else if (warp == 1) {
    // Backward carry: the first flag of the nearest later tile with one.
    int64_t carry = n_flags;
    for (int64_t t0 = tile + 1; t0 < tiles; t0 += 32) {
      const int64_t t = t0 + lane;
      const int64_t v = t < tiles ? tile_first[t] : n_flags;
      const unsigned hit = __ballot_sync(kFull, v < n_flags);
      if (hit) {
        carry = __shfl_sync(kFull, v, __ffs(static_cast<int>(hit)) - 1);
        break;
      }
    }
    if (lane == 0) s_carry[1] = carry;
  }

  int64_t last, first;
  warp_summary(pair, seg, n_flags, lane, &last, &first);
  if (lane == 0) {
    s_last[warp] = last;
    s_first[warp] = first;
  }
  __syncthreads();
  int64_t fwd = s_carry[0], bwd = s_carry[1];
  for (int w = 0; w < warp; ++w) fwd = s_last[w] > fwd ? s_last[w] : fwd;
  for (int w = warp + 1; w < kWarps; ++w) {
    bwd = s_first[w] < bwd ? s_first[w] : bwd;
  }

  // Round r: elements seg + 32 r + lane, one 256-byte store per output.
  const unsigned below = (1u << lane) - 1u;  // lanes < this lane
  const unsigned at_or_above = kFull << lane;
#pragma unroll
  for (int r = 0; r < kWarpSpan / 32; ++r) {
    const int64_t base = seg + 32 * r;
    const unsigned mask = __shfl_sync(kFull, pair, 2 * r);
    const unsigned m = mask & below;
    const int64_t v = m ? base + (32 - __clz(static_cast<int>(m))) : fwd;
    if (base + lane < n) first_out[base + lane] = v;
    if (mask) fwd = base + (32 - __clz(static_cast<int>(mask)));
  }
#pragma unroll
  for (int r = kWarpSpan / 32 - 1; r >= 0; --r) {
    const int64_t base = seg + 32 * r;
    const unsigned mask = __shfl_sync(kFull, pair, 2 * r);
    const unsigned m = mask & at_or_above;
    const int64_t v = m ? base + (__ffs(static_cast<int>(m)) - 1) : bwd;
    if (base + lane < n) last_out[base + lane] = v;
    if (mask) bwd = base + (__ffs(static_cast<int>(mask)) - 1);
  }
}

}  // namespace

extern "C" long long hs_run_bounds_tiles(long long n) {
  return (n + kTile - 1) / kTile;
}

// differs: n - 1 bytes. out: 2 n + 2 tiles int64, laid out as first[n],
// last[n], then the scratch (tile_last[tiles], tile_first[tiles]).
extern "C" int hs_run_bounds(const void* differs, long long n, void* out,
                             void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = hs_run_bounds_tiles(n);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(differs);
  auto* first = static_cast<int64_t*>(out);
  auto* last = first + n;
  auto* tile_last = last + n;
  auto* tile_first = tile_last + tiles;
  const int64_t n_flags = n - 1;
  tile_summary_kernel<<<static_cast<int>(tiles), kThreads, 0, s>>>(
      d, n_flags, tile_last, tile_first);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_bounds_kernel<<<static_cast<int>(tiles), kThreads, 0, s>>>(
      d, n_flags, tiles, tile_last, tile_first, first, last);
  return static_cast<int>(cudaGetLastError());
}
