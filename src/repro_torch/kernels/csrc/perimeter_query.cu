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
// escape loop. Bound on the card: the FP32 issue rate of the escape loop
// (a few bytes per region in and out); nothing but the two results leaves
// the SM.
#include <climits>

#include "escape_time.cuh"

namespace {

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
  const int py = coords[2 * i] * side;
  const int px = coords[2 * i + 1] * side;
  const int last = side - 1;
  int vmin = INT_MAX, vmax = INT_MIN;
  for (int k = threadIdx.x; k < 4 * side; k += blockDim.x) {
    const int row = k / side;
    const int j = k - row * side;
    const int y = row == 0 ? py : (row == 1 ? py + last : py + j);
    const int x = row < 2 ? px + j : (row == 2 ? px : px + last);
    float cr, ci;
    repro::map_coords(plane, x, y, cr, ci);
    const int v = repro::escape_time<K>(cr, ci, max_dwell, w);
    if (k == 0) first = v;
    vmin = min(vmin, v);
    vmax = max(vmax, v);
  }
  __syncthreads();
  const int f = first;
  const bool mine = vmin == INT_MAX || (vmin == f && vmax == f);
  const int all = __syncthreads_and(mine);
  if (threadIdx.x == 0) {
    homog[i] = all != 0;
    common[i] = f;
  }
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
  // one thread per border point up to 512, a multiple of the warp
  int threads = ((4 * side + 31) / 32) * 32;
  threads = threads > 512 ? 512 : threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                          \
  perimeter_query_kernel<K><<<num_regions, threads, 0, s>>>(               \
      coords, count, side, plane, max_dwell, w, homog, common)
  REPRO_DISPATCH_KIND(kind, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
