// Q: the border query of each region of an OLT.
//
// Replaces repro/kernels/perimeter_query.py::perimeter_query (one Pallas
// grid step per region, coords through scalar prefetch). One block per
// region: the block loads its own coords, its threads stride over the
// 4 * side border points in the order of ref.perimeter_coords (top,
// bottom, left, right; the four corners twice, as the plain version
// computes them) and keep the min and max dwell they saw. Thread 0's first
// point is the region's (0, 0) value. The block decides with
// __syncthreads_and whether every point equals it; thread 0 writes homog
// and common. The live row count is read on the device; a block past it
// writes (false, 0) and returns, so an OLT's power-of-two padding costs no
// escape loop. Bound on the card: the issue rate of the escape loop under
// the rounding contract (8 instructions a mandelbrot step, see
// escape_time.cuh; a few bytes per region in and out); nothing but the
// two results leaves the SM. Each border point runs the blocked loop of
// repro::escape_time.
//
// A second launch function serves the pooled engine's frame-tagged rows
// (perimeter_query_pooled_launch). JAX computes that query with jnp
// (ref.perimeter_query_dyn through ops.pooled_bounds), in no Pallas kernel;
// the port's plain version of it emulates each FMA in f64, too slow for the
// card's main path, so the query gets its own kernel here.
#include <climits>

#include "escape_time.cuh"

namespace {

// Steps per block of the escape loop (repro::escape_time): 8, as in
// mandelbrot_dwell.cu (one point per thread; PERF.md).
// tools/escape_design.py builds copies at 4, 8 and 16 to compare them.
constexpr int kUnroll = 8;

// The border test of one region whose pixel origin is (py, px), by the
// whole block; thread 0 writes the result. `first` is one int of shared
// memory. Every thread reads it before the closing __syncthreads_and, so
// the block may test its next region at once.
template <int K>
__device__ __forceinline__ void query_region(const repro::Plane& plane, int py,
                                             int px, int side, int max_dwell,
                                             const repro::Params& w, int* first,
                                             bool* homog, int* common) {
  const int last = side - 1;
  int vmin = INT_MAX, vmax = INT_MIN;
  for (int k = threadIdx.x; k < 4 * side; k += blockDim.x) {
    const int row = k / side;
    const int j = k - row * side;
    const int y = row == 0 ? py : (row == 1 ? py + last : py + j);
    const int x = row < 2 ? px + j : (row == 2 ? px : px + last);
    float cr, ci;
    repro::map_coords(plane, x, y, cr, ci);
    const int v = repro::escape_time<K, kUnroll>(cr, ci, max_dwell, w);
    if (k == 0) *first = v;
    vmin = min(vmin, v);
    vmax = max(vmax, v);
  }
  __syncthreads();
  const int f = *first;
  const bool mine = vmin == INT_MAX || (vmin == f && vmax == f);
  const int all = __syncthreads_and(mine);
  if (threadIdx.x == 0) {
    *homog = all != 0;
    *common = f;
  }
}

template <int K>
__global__ void perimeter_query_kernel(const int* __restrict__ coords,
                                       const int* __restrict__ count, int side,
                                       repro::Plane plane, int max_dwell,
                                       repro::Params w, bool* __restrict__ homog,
                                       int* __restrict__ common) {
  __shared__ int first;
  const int i = blockIdx.x;
  if (i >= *count) {  // uniform across the block
    if (threadIdx.x == 0) {
      homog[i] = false;
      common[i] = 0;
    }
    return;
  }
  query_region<K>(plane, coords[2 * i] * side, coords[2 * i + 1] * side, side,
                  max_dwell, w, &first, homog + i, common + i);
}

// The pooled query: frame-tagged rows (frame, cy, cx), each in its own
// frame's plane, planes[frame] = (re0, im0, step_re, step_im). A grid of at
// most a few blocks per SM strides over the live rows, so the capacity
// padding of the pooled ring launches no block; the wrapper zeroes the
// outputs, which leaves the rows past the count (false, 0).
template <int K>
__global__ void perimeter_query_pooled_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const float* __restrict__ planes, int side, int max_dwell, repro::Params w,
    bool* __restrict__ homog, int* __restrict__ common) {
  __shared__ int first;
  const int live = *count;
  for (int i = blockIdx.x; i < live; i += gridDim.x) {
    const float* p = planes + 4 * rows[3 * i];
    const repro::Plane plane{p[0], p[1], p[2], p[3]};
    query_region<K>(plane, rows[3 * i + 1] * side, rows[3 * i + 2] * side,
                    side, max_dwell, w, &first, homog + i, common + i);
  }
}

// one thread per border point up to 512, a multiple of the warp
int threads_for(int side) {
  const int t = ((4 * side + 31) / 32) * 32;
  return t > 512 ? 512 : t;
}

}  // namespace

extern "C" int perimeter_query_launch(const int* coords, const int* count,
                                      int num_regions, int side, float re0,
                                      float im0,
                                      float step_re, float step_im,
                                      int max_dwell, int kind, float c_re,
                                      float c_im, int m, bool* homog,
                                      int* common, void* stream) {
  const repro::Plane plane{re0, im0, step_re, step_im};
  const repro::Params w{c_re, c_im, m};
  const int threads = threads_for(side);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                          \
  perimeter_query_kernel<K><<<num_regions, threads, 0, s>>>(               \
      coords, count, side, plane, max_dwell, w, homog, common)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// grid: the wrapper's block count (at most the rows, a few per SM).
extern "C" int perimeter_query_pooled_launch(const int* rows, const int* count,
                                             const float* planes, int grid,
                                             int side, int max_dwell, int kind,
                                             float c_re, float c_im, int m,
                                             bool* homog, int* common,
                                             void* stream) {
  const repro::Params w{c_re, c_im, m};
  const int threads = threads_for(side);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                         \
  perimeter_query_pooled_kernel<K><<<grid, threads, 0, s>>>(              \
      rows, count, planes, side, max_dwell, w, homog, common)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
