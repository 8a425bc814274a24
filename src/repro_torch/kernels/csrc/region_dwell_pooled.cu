// A on the banded cross-frame canvas: the per-pixel dwell of each
// frame-tagged leaf region, each in its own frame's plane.
//
// Replaces repro/kernels/region_dwell_pooled.py::region_dwell_pooled
// (Pallas: the per-frame windows staged through scalar prefetch, one grid
// step per row, canvas aliased in and out, duplicate-padded rows plus a
// `nonempty` flag). Here the windows arrive as planes [F, 4] f32 =
// (re0, im0, step_re, step_im), computed once per batch on the host in the
// traced spelling (ref.pooled_planes), and each row gathers its own by
// frame tag. The pixel map uses frame-local coordinates; only the store
// adds the band offset f*n. Offsets are 64-bit (F*n*n reaches 2^31).
//
// Items and grid as in region_fill_pooled.cu: an item is up to 4096 pixels
// of one region (a B=32 leaf is one item), and a grid of a few blocks per
// SM strides over count * chunks items, the live count read on the device,
// so the worst-case leaf capacity (2.1M rows at n=16384, F=8) launches no
// block for its padding. Bound on the card: the FP32 issue rate of the
// escape loop (escape_time<K>, shared with every kernel here); the orbit
// stays in registers and each pixel is stored once.
#include "escape_time.cuh"

namespace {

template <int K>
__global__ void region_dwell_pooled_kernel(int* __restrict__ canvas,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ count,
                                           const float* __restrict__ planes,
                                           int n, int side, int rows_per_item,
                                           int chunks, int max_dwell,
                                           repro::Params w) {
  const long long items = static_cast<long long>(*count) * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long i = item / chunks;
    const int c = static_cast<int>(item - i * chunks);
    const int r0 = c * rows_per_item;
    const int h = min(rows_per_item, side - r0);
    const int f = rows[3 * i];
    const int y0 = rows[3 * i + 1] * side + r0;  // frame-local
    const int x0 = rows[3 * i + 2] * side;
    const float* p = planes + 4 * f;
    const repro::Plane plane{p[0], p[1], p[2], p[3]};
    int* band = canvas + static_cast<long long>(f) * n * n;
    for (int k = threadIdx.x; k < h * side; k += blockDim.x) {
      const int yy = k / side;
      const int y = y0 + yy;
      const int x = x0 + (k - yy * side);
      float cr, ci;
      repro::map_coords(plane, x, y, cr, ci);
      band[static_cast<long long>(y) * n + x] =
          repro::escape_time<K>(cr, ci, max_dwell, w);
    }
  }
}

}  // namespace

extern "C" int region_dwell_pooled_launch(int* canvas, const int* rows,
                                          const int* count, const float* planes,
                                          int grid, int n, int side,
                                          int rows_per_item, int max_dwell,
                                          int kind, float c_re, float c_im,
                                          int m, void* stream) {
  const repro::Params w{c_re, c_im, m};
  const int chunks = (side + rows_per_item - 1) / rows_per_item;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                          \
  region_dwell_pooled_kernel<K><<<grid, 256, 0, s>>>(                      \
      canvas, rows, count, planes, n, side, rows_per_item, chunks,         \
      max_dwell, w)
  REPRO_DISPATCH_KIND(kind, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
