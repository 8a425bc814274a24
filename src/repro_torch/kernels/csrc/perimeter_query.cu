// Q: the border query of each region of an OLT.
//
// Replaces repro/kernels/perimeter_query.py::perimeter_query (one Pallas
// grid step per region, coords through scalar prefetch). For each live row
// i: homog[i] = every one of the 4 * side border dwells, in the order of
// ref.perimeter_coords (top, bottom, left, right; the four corners twice,
// as the plain version computes them), equals f, the dwell of the region's
// (0, 0) pixel, border point k = 0; common[i] = f, exact also when homog[i]
// is false. Rows past the live count (read on the device) are (false, 0).
//
// Bound on the card: the issue rate of the escape loop under the rounding
// contract (8 slots a mandelbrot step, see escape_time.cuh); each region
// reads a few bytes and writes five. The answer needs far fewer steps than
// the whole border: a border that differs needs only f and one witness of
// the mismatch, and most borders differ (PERF.md: the exact-work bound is
// about a third of the whole borders' steps for mandelbrot at n=16384,
// about one percent for julia). The design:
//
// * Border points, not regions, spread over the card at every level. One
//   grid of as many 8-warp blocks as fit on the SMs; each warp takes items
//   from queues in device memory. An item is a run of one region's border
//   points: chunk 0 is the first L = 32 * ppl points (ppl 1 to 4 points a
//   lane, picked on the device from the live count so that the grid has
//   about 8 items a warp), every later chunk 32 points. Items run chunk by
//   chunk across the regions (item = chunk * live + row): every region's
//   chunk 0, which holds point 0 and finds most mismatches, goes first,
//   and the items handed out last are the smallest. So level 0's 16
//   regions of side 4096 use every SM, and nothing leaves the device.
// * Queues (query_rows): queue q holds items q, q + 32, q + 64, ..., with
//   its counter on a 128-byte line of its own, since thousands of warps
//   ask. A warp takes its block's queue's items one by one, asking for the
//   next when the last ends (asking ahead was 9-11% slower on mandelbrot
//   and multibrot, PERF.md), and when that queue is empty it reads the 32
//   counters at once and moves to a queue with items left.
// * Lane refill: each item runs repro::refill (escape_time.cuh), the loop
//   of the leaf kernels, with two hooks of its own: a stop test for running
//   points, and a settle step that updates the region's key where the leaf
//   kernels store a dwell.
// * An exact early exit. Each region has one int of scratch, its key:
//   max_dwell + 1 - v for the smallest finished dwell v, 0 while none has
//   finished, and kDiffers once the border is known to differ. The launch
//   sets every live homog to true; the only write to it is false, by a
//   warp that has proof of a mismatch: two of its finished points differ,
//   one differs from the smallest dwell it knows, a running point has run
//   past that dwell (its dwell must differ, so it stops), or the key its
//   atomicMax found was another dwell than the one it put (of two warps
//   that put differing first dwells, the later sees the earlier's). That
//   warp also sets the key to kDiffers; once a warp knows it, its running
//   points stop and its points not handed out are dropped, and a later
//   chunk of that border is dropped whole. A warp reads the key when it
//   takes an item and learns of no other warp's dwells while it runs one.
//   Point k = 0 never stops and is never dropped; its lane writes common.
//   This holds because every workload's homogeneity test is exact equality
//   (repro/workloads/spec.py; the port has no region_equal hook): a dwell
//   only matters through whether it equals f.
//
// No fence is needed: every write of homog is a false that a proof
// backs, after the launch's preset in stream order, and a warp's view of a
// key may be stale, which only delays an exit: the keys only grow toward
// kDiffers.
//
// The launch zeroes the scratch (the queues' counters and the keys) and
// presets homog with two cudaMemsetAsync on the stream, so a query stays
// one kernel launch with no host sync.
//
// A second launch function serves the pooled engine's frame-tagged rows
// (perimeter_query_pooled_launch): the same code with each row's plane
// taken from planes[frame]. JAX computes that query with jnp
// (ref.perimeter_query_dyn through ops.pooled_bounds), in no Pallas kernel;
// the port's plain version of it emulates each FMA in f64, too slow for the
// card's main path, so the query gets its own kernel here.
#include <climits>

#include "escape_time.cuh"

namespace {

// Steps per block of the escape loop: 16, the fastest of 4, 8 and 16
// (tools/escape_design.py builds copies at each; PERF.md). The default of
// the launch functions, which also hold the instances at 4 and 8 for the
// tuned tier (REPRO_DISPATCH_UNROLL).
constexpr int kUnroll = 16;
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kItemsPerWarp = 8;  // items a warp of the grid, at least
constexpr int kMaxPointsPerLane = 4;  // in chunk 0
constexpr int kQueues = 32;  // one a lane: a warp reads every counter at once
constexpr int kLineWords = 32;  // ints in a 128-byte line

// A region's key in scratch: max_dwell + 1 - v for the smallest finished
// dwell v of its border, 0 while none has finished (zeroed scratch), and
// kDiffers once the border is known to differ.
constexpr int kDiffers = INT_MAX;

// One region as the kernels see it: its plane and its pixel origin.
struct Region {
  repro::Plane plane;
  int py;
  int px;
};

// Border points [k0, end) of region r, by one warp (all 32 lanes call it
// together), with lane refill and the early exit described above. `key`:
// the region's key in scratch; `seen`: its value when the warp took the
// item.
template <int K, int U>
__device__ __forceinline__ void query_item(const Region& r, int side, int k0,
                                           int end, int* key, int seen,
                                           int max_dwell,
                                           const repro::Params& w,
                                           bool* homog, int* common) {
  const unsigned lane = threadIdx.x & 31u;
  const int last = side - 1;
  const int key_none = max_dwell + 1;  // the key of a dwell of -1
  int known = seen;  // the key as this warp knows it (the same in every lane)
  // lane 0: the last key it put with atomicMax, and the key it found there
  int put = 0, found = 0;
  // a mismatch this warp can prove: flag the region and answer it
  auto differ = [&]() {
    if (lane == 0 && known != kDiffers) {
      atomicMax(key, kDiffers);
      *homog = false;
    }
    known = kDiffers;
  };
  // the last atomicMax found another finished dwell than the one it put
  auto found_other = [&]() {
    return __shfl_sync(repro::kFullMask, found != 0 && found != put, 0);
  };
  struct Point {
    float cr, ci;
  };
  repro::refill<K, U>(
      k0, end, max_dwell, w,
      // border point k: row k / side of (top, bottom, left, right), column
      // k % side
      [&](int k) {
        Point p;
        const int row = (k >= side) + (k >= 2 * side) + (k >= 3 * side);
        const int j = k - row * side;
        const int y = row == 0 ? r.py : (row == 1 ? r.py + last : r.py + j);
        const int x = row < 2 ? r.px + j : (row == 2 ? r.px : r.px + last);
        repro::map_coords(r.plane, x, y, p.cr, p.ci);
        return p;
      },
      // a running point past the smallest finished dwell (its dwell, at
      // least d, exceeds it), or on a border known to differ, cannot change
      // the answer
      [&](int k, int d) { return k != 0 && known > key_none - d; },
      [&](const Point&, int k, bool finished, bool stopped, int v) {
        if (finished && k == 0) *common = v;
        // the keys of this block's finished points (a stopped one: the flag)
        const int mine = finished ? key_none - v : (stopped ? kDiffers : 0);
        const int most = __reduce_max_sync(repro::kFullMask, mine);
        const int least =
            __reduce_min_sync(repro::kFullMask, mine ? mine : INT_MAX);
        if (most != least || most == kDiffers || (known && most != known) ||
            found_other()) {
          differ();
        } else if (!known) {  // the first finished dwell this warp knows of
          if (lane == 0) {
            found = atomicMax(key, most);
            put = most;
          }
          known = most;
        }
        return known == kDiffers;  // drop the points not handed out
      });
  if (found_other()) differ();
}

// The shared body of both kernels: rows past the live count get
// (false, 0), the live rows' homog was set to true by the launch; the
// warps take items until none is left. region(i) gives live row i's plane
// and pixel origin.
template <int K, int U, class RegionOf>
__device__ __forceinline__ void query_rows(
    const RegionOf& region, const int* __restrict__ count, int N, int side,
    int max_dwell, const repro::Params& w, int* __restrict__ scratch,
    bool* __restrict__ homog, int* __restrict__ common) {
  static_assert(kQueues == 32, "one queue a lane");
  const int live = min(*count, N);
  for (int i = live + blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += gridDim.x * blockDim.x) {
    homog[i] = false;
    common[i] = 0;
  }
  const int points = 4 * side;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long spread = static_cast<long long>(live) * points /
                           (32ll * kItemsPerWarp * warps);
  const int L = 32 * static_cast<int>(
                         max(1ll, min(spread, (long long)kMaxPointsPerLane)));
  const int chunks = L >= points ? 1 : 1 + (points - L + 31) / 32;
  const long long items = static_cast<long long>(live) * chunks;
  int* const keys = scratch + kQueues * kLineWords;
  const unsigned lane = threadIdx.x & 31u;
  auto counter = [&](int q) {
    return reinterpret_cast<unsigned*>(scratch + q * kLineWords);
  };
  // queue q's item t, or `items` when the queue has none left
  auto item_of = [&](int q, unsigned t) {
    const long long item = static_cast<long long>(t) * kQueues + q;
    return item < items ? item : items;
  };
  int q = blockIdx.x % kQueues;
  for (;;) {
    const unsigned t = lane == 0 ? atomicAdd(counter(q), 1u) : 0;
    const long long item = __shfl_sync(repro::kFullMask, item_of(q, t), 0);
    if (item >= items) {  // uniform across the warp: find a queue with items
      const unsigned c = *reinterpret_cast<volatile unsigned*>(counter(lane));
      const unsigned has =
          __ballot_sync(repro::kFullMask, item_of(lane, c) < items);
      if (has == 0) return;
      const unsigned from_q = q ? (has >> q) | (has << (32 - q)) : has;
      q = (q + __ffs(from_q) - 1) % kQueues;
      continue;
    }
    const int i = static_cast<int>(item % live);
    const int c = static_cast<int>(item / live);
    const int k0 = c == 0 ? 0 : L + (c - 1) * 32;
    const int kend = min(c == 0 ? L : k0 + 32, points);
    int* const key = keys + i;
    const Region reg = region(i);
    const int seen = __shfl_sync(
        repro::kFullMask, lane == 0 ? *reinterpret_cast<volatile int*>(key) : 0,
        0);
    if (k0 == 0 || seen != kDiffers)
      query_item<K, U>(reg, side, k0, kend, key, seen, max_dwell, w, homog + i,
                    common + i);
  }
}

struct FrameRegion {  // coords [N, 2] (cy, cx), one plane
  const int* coords;
  repro::Plane plane;
  int side;
  __device__ Region operator()(int i) const {
    return Region{plane, coords[2 * i] * side, coords[2 * i + 1] * side};
  }
};

struct PooledRegion {  // rows [N, 3] (frame, cy, cx), planes [F, 4]
  const int* rows;
  const float* planes;
  int side;
  __device__ Region operator()(int i) const {
    const float* p = planes + 4 * rows[3 * i];
    return Region{repro::Plane{p[0], p[1], p[2], p[3]},
                  rows[3 * i + 1] * side, rows[3 * i + 2] * side};
  }
};

template <int K, int U>
__global__ void __launch_bounds__(kThreads) perimeter_query_kernel(
    const int* __restrict__ coords, const int* __restrict__ count, int N,
    int side, const float* __restrict__ plane, int max_dwell, repro::Params w,
    int* __restrict__ scratch, bool* __restrict__ homog,
    int* __restrict__ common) {
  query_rows<K, U>(FrameRegion{coords, repro::load_plane(plane), side}, count, N,
                side, max_dwell, w,
                scratch, homog, common);
}

template <int K, int U>
__global__ void __launch_bounds__(kThreads) perimeter_query_pooled_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const float* __restrict__ planes, int N, int side, int max_dwell,
    repro::Params w, int* __restrict__ scratch, bool* __restrict__ homog,
    int* __restrict__ common) {
  query_rows<K, U>(PooledRegion{rows, planes, side}, count, N, side, max_dwell, w,
                scratch, homog, common);
}

// Blocks of the grid: as many as fit on every SM at once. Each launch
// function asks once per kernel instance (a static): the grid sizes the
// work a warp takes, never the answer.
template <class Kernel>
int grid_of(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return max(sms, 1) * max(per_sm, 1);
}

// Ints of scratch a query of N rows needs: the queues' counters, then one
// key a row.
long long scratch_words(int N) {
  return kQueues * kLineWords + static_cast<long long>(N);
}

// Zero the scratch and set every homog to true, on the stream before the
// launch.
cudaError_t prepare(int* scratch, int N, bool* homog, cudaStream_t s) {
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, 4 * scratch_words(N), s);
  return e != cudaSuccess ? e : cudaMemsetAsync(homog, 1, N, s);
}

}  // namespace

extern "C" int perimeter_query_launch(const int* coords, const int* count,
                                      int N, int side, const float* plane,
                                      int max_dwell, int kind, float c_re,
                                      float c_im, int m, int* scratch,
                                      bool* homog, int* common, int unroll,
                                      void* stream) {
  const repro::Params w{c_re, c_im, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(scratch, N, homog, s);
  if (e != cudaSuccess) return static_cast<int>(e);
#define LAUNCH_KU(K, U)                                                   \
  {                                                                       \
    static const int grid = grid_of(perimeter_query_kernel<K, U>);        \
    perimeter_query_kernel<K, U><<<grid, kThreads, 0, s>>>(               \
        coords, count, N, side, plane, max_dwell, w, scratch, homog,      \
        common);                                                          \
  }
#define LAUNCH(K) REPRO_DISPATCH_UNROLL(unroll, kUnroll, K, LAUNCH_KU)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
#undef LAUNCH_KU
  return static_cast<int>(cudaGetLastError());
}

extern "C" int perimeter_query_pooled_launch(const int* rows, const int* count,
                                             const float* planes, int N,
                                             int side, int max_dwell, int kind,
                                             float c_re, float c_im, int m,
                                             int* scratch, bool* homog,
                                             int* common, int unroll,
                                             void* stream) {
  const repro::Params w{c_re, c_im, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare(scratch, N, homog, s);
  if (e != cudaSuccess) return static_cast<int>(e);
#define LAUNCH_KU(K, U)                                                   \
  {                                                                       \
    static const int grid = grid_of(perimeter_query_pooled_kernel<K, U>); \
    perimeter_query_pooled_kernel<K, U><<<grid, kThreads, 0, s>>>(        \
        rows, count, planes, N, side, max_dwell, w, scratch, homog,       \
        common);                                                          \
  }
#define LAUNCH(K) REPRO_DISPATCH_UNROLL(unroll, kUnroll, K, LAUNCH_KU)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
#undef LAUNCH_KU
  return static_cast<int>(cudaGetLastError());
}

// Ints of scratch the launch functions need for N rows (the wrapper
// allocates them).
extern "C" long long perimeter_query_scratch_words(int N) {
  return scratch_words(N);
}
