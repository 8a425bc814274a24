// Batched OLT ranks: the MoE position_in_expert compaction.
//
// Replaces repro/kernels/moe_dispatch.py::batched_ranks_kernel, which holds
// one [N, E] int32 tile in VMEM and takes a column-wise cumsum on the VPU.
// Here flags are [G, N, E] (G token groups, one launch): for each (g, e),
// ranks[g, :, e] is the exclusive prefix sum of flags[g, :, e] along N and
// counts[g, e] its total -- G*E independent OLT compactions (paper
// Sec. 5.3.1), the atomicAdd-per-expert replacement.
//
// One kernel, column_scan, does all the work. A block owns 32 columns of one
// group and a run of rows. Its 32x32 threads take the rows in chunks of 128:
// thread (x, y) holds rows 4y..4y+3 of column x (a warp reads one row
// segment, so loads coalesce over E), the chunk's per-thread sums go to
// shared memory, and warp w scans column w of them with __shfl_up_sync,
// adding the column's running carry. CUDA blocks run in no order, so a
// scan longer than one block's rows is a reduce-then-scan of three launches
// of the same kernel:
//
//   1. per tile of kTileRows rows, each column's total -> partials[g, t, e];
//   2. one block per (g, 32 columns) scans partials along t in place (the
//      tile offsets) and writes counts;
//   3. per tile, the scan again, starting from its offset, writing ranks.
//
// N <= kTileRows is launch 3 alone, which also writes counts (MoE decode).
// Bound on the card: bytes (each flag read once, each rank written once;
// the three-launch form reads the flags twice); there is no arithmetic to
// speak of. Flags are bool (one byte) or int32; an int32 flag adds its
// value, as the plain version's cumsum does.
#include <cstdint>

#include "escape_time.cuh"

namespace {

constexpr int kCols = 32;                 // columns per block (threadIdx.x)
constexpr int kLanes = 32;                // row lanes per block (threadIdx.y)
constexpr int kItems = 4;                 // rows per thread per chunk
constexpr int kChunk = kLanes * kItems;   // rows per chunk
constexpr int kTileRows = 4 * kChunk;     // rows per block in launches 1, 3
constexpr unsigned kFull = 0xffffffffu;

// in [G, n, e] -> out [G, n, e] exclusive scan along n (out may be null, or
// in itself: a thread writes only what it read), totals [G, tiles, e] each
// column's sum over the block's rows plus its offset (null: not written).
// offsets [G, tiles, e] (null: 0). Block (c, t, g): columns 32c.., rows
// [t*rows, min(n, (t+1)*rows)).
template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
    column_scan(const T* in, long long n, int e, long long rows, int tiles,
                const int* __restrict__ offsets, int* out, int* totals) {
  __shared__ int sums[kLanes][kCols + 1];  // +1: no bank conflicts
  __shared__ int carry[kCols];
  const int x = threadIdx.x, y = threadIdx.y;
  const int col = blockIdx.x * kCols + x;
  const long long t = blockIdx.y;
  const long long g = blockIdx.z;
  const bool live = col < e;
  const long long first = t * rows;
  const long long last = first + rows < n ? first + rows : n;
  const long long tile_col = (g * tiles + t) * e + col;  // [g, t, col]
  if (y == 0) carry[x] = live && offsets != nullptr ? offsets[tile_col] : 0;
  __syncthreads();
  for (long long r0 = first; r0 < last; r0 += kChunk) {
    int f[kItems];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long r = r0 + y * kItems + k;
      f[k] = live && r < last ? static_cast<int>(in[(g * n + r) * e + col]) : 0;
      s += f[k];
    }
    sums[y][x] = s;
    __syncthreads();
    {  // warp y scans column y of the chunk: lane l holds row-lane l
      const int lane = x, c = y;
      const int v = sums[lane][c];
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      const int base = carry[c];
      __syncwarp();
      sums[lane][c] = base + inc - v;
      if (lane == 31) carry[c] = base + inc;
    }
    __syncthreads();
    if (out != nullptr) {
      int r = sums[y][x];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long row = r0 + y * kItems + k;
        if (live && row < last) out[(g * n + row) * e + col] = r;
        r += f[k];
      }
    }
    __syncthreads();  // sums is rewritten by the next chunk
  }
  if (y == 0 && live && totals != nullptr) totals[tile_col] = carry[x];
}

template <typename T>
int launch(const T* flags, int g, long long n, int e, int* ranks, int* counts,
           int* partials, cudaStream_t s) {
  const dim3 block(kCols, kLanes);
  const unsigned col_blocks = static_cast<unsigned>((e + kCols - 1) / kCols);
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  if (tiles > 65535 || g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles <= 1) {
    column_scan<T><<<dim3(col_blocks, 1, g), block, 0, s>>>(
        flags, n, e, n, 1, nullptr, ranks, counts);
    return static_cast<int>(cudaGetLastError());
  }
  const int nt = static_cast<int>(tiles);
  // 1. tile totals
  column_scan<T><<<dim3(col_blocks, nt, g), block, 0, s>>>(
      flags, n, e, kTileRows, nt, nullptr, nullptr, partials);
  // 2. partials [g, nt, e] -> exclusive tile offsets, in place; counts
  column_scan<int><<<dim3(col_blocks, 1, g), block, 0, s>>>(
      partials, nt, e, nt, 1, nullptr, partials, counts);
  // 3. each tile from its offset
  column_scan<T><<<dim3(col_blocks, nt, g), block, 0, s>>>(
      flags, n, e, kTileRows, nt, partials, ranks, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flags [g, n, e] (is_bool: one byte each, else int32), ranks [g, n, e],
// counts [g, e], partials [g, ceil(n / kTileRows), e] int32 (unused when
// n <= kTileRows). TILE_ROWS in moe_dispatch.py is kTileRows.
extern "C" int batched_ranks_launch(const void* flags, int g, long long n,
                                    int e, int is_bool, int* ranks,
                                    int* counts, int* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bool) {
    return launch(static_cast<const uint8_t*>(flags), g, n, e, ranks, counts,
                  partials, s);
  }
  return launch(static_cast<const int*>(flags), g, n, e, ranks, counts,
                partials, s);
}
