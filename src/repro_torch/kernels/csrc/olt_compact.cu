// The OLT scan: exclusive prefix sum of insert flags plus their total.
//
// Replaces repro/kernels/olt_compact.py::compact_ranks_kernel (one VMEM
// block, N <= 65536) and ::compact_ranks_blocked (a sequential grid whose
// running total is carried in SMEM from one step to the next). CUDA blocks
// run in no order, so that carry does not carry over. This is a two-pass
// reduce-then-scan that is right for any N:
//
//   1. tile_sums: block b sums tile b (kTile flags) into partials[b];
//   2. scan_partials: one block turns partials into exclusive tile offsets,
//      looping over them kThreads at a time with a running carry, and
//      writes the grand total to count[0];
//   3. tile_scan: block b scans tile b (each thread sums kItems consecutive
//      flags, the block scans the thread sums with __shfl_up_sync inside
//      each warp and once more across the warps) and adds its offset.
//
// A single tile (N <= kTile) takes pass 3 alone. Flags are bool or int32;
// an int32 flag adds its value, as the plain version's cumsum does. Bound on
// the card: bytes, each flag read twice (once per pass) and each rank
// written once; there is no arithmetic to speak of.
#include <cstdint>

#include "escape_time.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of v across the block; every thread gets its own prefix
// and the block's total. `warp_sums` holds kWarps ints of shared memory; the
// function ends with a barrier, so the caller may call it again at once.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];  // kWarps == 32
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int prefix = warp > 0 ? warp_sums[warp - 1] : 0;
  total = warp_sums[kWarps - 1];
  __syncthreads();
  return prefix + v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_sums(const T* __restrict__ flags, long long n,
              int* __restrict__ partials) {
  __shared__ int warp_sums[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {  // coalesced: the order of a sum is free
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) s += static_cast<int>(flags[i]);
  }
  int total;
  block_inclusive_scan(s, warp_sums, total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    scan_partials(int* __restrict__ partials, int num_tiles,
                  int* __restrict__ count) {
  __shared__ int warp_sums[kWarps];
  int carry = 0;
  for (int start = 0; start < num_tiles; start += kThreads) {
    const int i = start + threadIdx.x;
    const int v = i < num_tiles ? partials[i] : 0;
    int total;
    const int inc = block_inclusive_scan(v, warp_sums, total);
    if (i < num_tiles) partials[i] = carry + inc - v;
    carry += total;
  }
  if (threadIdx.x == 0) count[0] = carry;
}

// offsets == nullptr: the only tile, which also writes the total.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_scan(const T* __restrict__ flags, long long n,
              const int* __restrict__ offsets, int* __restrict__ ranks,
              int* __restrict__ count) {
  __shared__ int warp_sums[kWarps];
  const long long first = static_cast<long long>(blockIdx.x) * kTile +
                          static_cast<long long>(threadIdx.x) * kItems;
  int f[kItems];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    f[k] = first + k < n ? static_cast<int>(flags[first + k]) : 0;
    s += f[k];
  }
  int total;
  int r = block_inclusive_scan(s, warp_sums, total) - s;
  if (offsets != nullptr) r += offsets[blockIdx.x];
  if (first + kItems <= n) {  // 16-byte aligned: ranks is, first % 4 == 0
    int4 out;
    out.x = r;
    out.y = out.x + f[0];
    out.z = out.y + f[1];
    out.w = out.z + f[2];
    *reinterpret_cast<int4*>(ranks + first) = out;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) ranks[first + k] = r;
      r += f[k];
    }
  }
  if (offsets == nullptr && threadIdx.x == 0) count[0] = total;
}

template <typename T>
int launch(const T* flags, long long n, int* ranks, int* count, int* partials,
           cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles <= 1) {
    tile_scan<T><<<1, kThreads, 0, s>>>(flags, n, nullptr, ranks, count);
    return static_cast<int>(cudaGetLastError());
  }
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int t = static_cast<int>(tiles);
  tile_sums<T><<<t, kThreads, 0, s>>>(flags, n, partials);
  scan_partials<<<1, kThreads, 0, s>>>(partials, t, count);
  tile_scan<T><<<t, kThreads, 0, s>>>(flags, n, partials, ranks, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: one int per tile of kTile flags (TILE in olt_compact.py).
// is_bool: flags are one byte each (torch.bool), else int32.
extern "C" int olt_compact_launch(const void* flags, long long n, int is_bool,
                                  int* ranks, int* count, int* partials,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bool) {
    return launch(static_cast<const uint8_t*>(flags), n, ranks, count,
                  partials, s);
  }
  return launch(static_cast<const int*>(flags), n, ranks, count, partials, s);
}
