// The OLT scan: exclusive prefix sum of insert flags plus their total.
//
// Replaces repro/kernels/olt_compact.py::compact_ranks_kernel (one VMEM
// block, N <= 65536) and ::compact_ranks_blocked (a sequential grid whose
// running total is carried in SMEM from one step to the next). CUDA blocks
// run in no order, so that carry does not carry over; this is one launch
// at every N that reads each flag once:
//
//   * N within one tile (kTile = 4096 flags): one block sized to N (a warp
//     for up to 512 flags), no look-back and no scratch;
//   * larger N: a single-pass scan with decoupled look-back over tiles of
//     kTile flags, one block a tile, from lookback.cuh (tickets, one
//     epoch-tagged status word a tile in a scratch that no call clears).
//
// A thread owns kItems = 16 consecutive flags: one 16-byte load of bool
// flags, or four of int32, when the flags and ranks are 16-byte aligned
// (`vec`), and four 16-byte stores of its ranks. The block scans its
// threads' sums with warp shuffles and once across its (at most 8) warps
// through shared memory; warp 0 of a chained tile publishes the tile's
// total, looks back and publishes its inclusive prefix. The tile that owns
// the last flag writes the total. Flags are bool or int32; an int32 flag
// adds its value, as the plain version's cumsum does (sums wrap in 32
// bits, as there).
//
// Bound on the card: bytes (each flag read once, each rank written once);
// at the engines' sizes (16 to 524,288 flags) that is under 1 us, below a
// launch's own floor, so what the design saves is launches and barriers:
// one launch a call where the reduce-then-scan took three, one barrier in
// a one-tile block where it took three of 1024 threads. One block of 1024
// threads for up to 16384 flags was measured and lost to chained tiles of
// 4096 above 4096 flags (PERF.md).
#include <cstdint>

#include "escape_time.cuh"
#include "lookback.cuh"

namespace {

using repro::lookback::draw_ticket;
using repro::lookback::kFull;
using repro::lookback::kState;
using repro::lookback::look_back;
using repro::lookback::status;
using repro::lookback::store_relaxed;

constexpr int kItems = 16;    // flags a thread
constexpr int kThreads = 256;  // threads of a full tile's block
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;

// kItems flags from `p` (16-byte aligned) in 16-byte loads
__device__ __forceinline__ void load_vec(const uint8_t* p, unsigned* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < kItems; ++k) f[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

__device__ __forceinline__ void load_vec(const int* p, unsigned* f) {
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) {
    const int4 v = reinterpret_cast<const int4*>(p)[j];
    f[4 * j] = static_cast<unsigned>(v.x);
    f[4 * j + 1] = static_cast<unsigned>(v.y);
    f[4 * j + 2] = static_cast<unsigned>(v.z);
    f[4 * j + 3] = static_cast<unsigned>(v.w);
  }
}

// One tile per block; a one-tile call is a grid of one block of up to
// kThreads threads, a chained call one of kThreads a tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ flags, long long n, int vec,
                int* __restrict__ ranks, int* __restrict__ count,
                unsigned long long* __restrict__ scratch, long long num_words) {
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned long long ticket;
  __shared__ unsigned epoch_s;
  __shared__ unsigned prefix_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool chained = gridDim.x > 1;
  long long t = 0;
  unsigned epoch = 0;
  if (chained) {
    if (threadIdx.x == 0) draw_ticket<1>(scratch, num_words, ticket, epoch_s);
    __syncthreads();
    t = static_cast<long long>(ticket);
    epoch = epoch_s;
  }
  const long long first = t * kTile + static_cast<long long>(threadIdx.x) * kItems;
  const bool whole = first + kItems <= n;
  unsigned f[kItems];
  if (vec && whole) {
    load_vec(flags + first, f);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      f[k] = first + k < n ? static_cast<unsigned>(flags[first + k]) : 0u;
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += f[k];
  unsigned inc = s;  // the warp's inclusive scan of the thread sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  unsigned before = 0, total = 0;  // the warps before this one; the tile
  for (int w = 0; w < warps; ++w) {
    const unsigned v = warp_sums[w];
    before += w < warp ? v : 0u;
    total += v;
  }
  unsigned prefix = 0;  // the tiles before this one
  if (chained) {
    if (warp == 0) {
      unsigned long long* const words = scratch + kState;
      if (lane == 0) store_relaxed(words + t, status(epoch, t == 0, total));
      if (t > 0) {
        prefix = look_back<1>(words, t, epoch);
        if (lane == 0) store_relaxed(words + t, status(epoch, true, prefix + total));
      }
      if (lane == 0) prefix_s = prefix;
    }
    __syncthreads();
    prefix = prefix_s;
  }
  if (threadIdx.x == 0 && t == gridDim.x - 1ll) {
    count[0] = static_cast<int>(prefix + total);
  }
  unsigned r = prefix + before + inc - s;
  if (vec && whole) {
    int4* const out = reinterpret_cast<int4*>(ranks + first);
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      int4 v;
      v.x = static_cast<int>(r);
      r += f[4 * j];
      v.y = static_cast<int>(r);
      r += f[4 * j + 1];
      v.z = static_cast<int>(r);
      r += f[4 * j + 2];
      v.w = static_cast<int>(r);
      r += f[4 * j + 3];
      out[j] = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) ranks[first + k] = static_cast<int>(r);
      r += f[k];
    }
  }
}

template <typename T>
int launch(const T* flags, long long n, int vec, int* ranks, int* count,
           unsigned long long* scratch, long long num_words, cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (n <= 0 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 1) {  // one block sized to n: whole warps of kItems a thread
    const long long threads = ((n + kItems - 1) / kItems + 31) / 32 * 32;
    scan_kernel<T><<<1, static_cast<unsigned>(threads), 0, s>>>(
        flags, n, vec, ranks, count, nullptr, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || num_words < tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scan_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      flags, n, vec, ranks, count, scratch, num_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flags [n] (is_bool: one byte each, else int32), ranks [n] and count [1]
// int32; vec: flags and ranks 16-byte aligned. scratch: kState words of
// state, then num_words (>= the tiles of kTile flags) status words, zeroed
// when it was made and kept from call to call on one stream; null when n
// fits one tile.
extern "C" int olt_compact_launch(const void* flags, long long n, int is_bool,
                                  int vec, int* ranks, int* count,
                                  void* scratch, long long num_words,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* state = static_cast<unsigned long long*>(scratch);
  if (is_bool) {
    return launch(static_cast<const uint8_t*>(flags), n, vec, ranks, count,
                  state, num_words, s);
  }
  return launch(static_cast<const int*>(flags), n, vec, ranks, count, state,
                num_words, s);
}
