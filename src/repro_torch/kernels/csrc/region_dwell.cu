// A: the per-pixel dwell of each leaf region, written into the canvas.
//
// Replaces repro/kernels/region_dwell.py::region_dwell (Pallas, canvas
// aliased in and out, duplicate-padded OLT plus a `nonempty` flag). Block
// (i, t) computes tile t of leaf region i (SBR: tile == side, MBR:
// (side / tile)^2 tiles per region); 256 threads stride over the tile's
// pixels row by row (B=32 gives 4 pixels per thread) and store each dwell
// straight into the canvas. The live row count is read on the device, so
// padding rows cost nothing. Bound on the card: the FP32 issue rate of the
// escape loop; the orbit stays in registers and each pixel is stored once.
#include "escape_time.cuh"

namespace {

template <int K>
__global__ void region_dwell_kernel(int* __restrict__ canvas,
                                    const int* __restrict__ coords,
                                    const int* __restrict__ count, int n,
                                    int side, int tile, repro::Plane plane,
                                    int max_dwell, repro::Params w) {
  const int i = blockIdx.x;
  if (i >= *count) return;
  const int per_side = side / tile;
  const int ty = blockIdx.y / per_side;
  const int tx = blockIdx.y - ty * per_side;
  const int y0 = coords[2 * i] * side + ty * tile;
  const int x0 = coords[2 * i + 1] * side + tx * tile;
  for (int k = threadIdx.x; k < tile * tile; k += blockDim.x) {
    const int yy = k / tile;
    const int y = y0 + yy;
    const int x = x0 + (k - yy * tile);
    float cr, ci;
    repro::map_coords(plane, x, y, cr, ci);
    canvas[static_cast<size_t>(y) * n + x] =
        repro::escape_time<K>(cr, ci, max_dwell, w);
  }
}

}  // namespace

extern "C" int region_dwell_launch(int* canvas, const int* coords,
                                   const int* count, int num_rows, int n,
                                   int side, int tile, float re0, float im0,
                                   float step_re, float step_im, int max_dwell,
                                   int kind, float c_re, float c_im, int m,
                                   void* stream) {
  const repro::Plane plane{re0, im0, step_re, step_im};
  const repro::Params w{c_re, c_im, m};
  const int per_side = side / tile;
  const dim3 grid(num_rows, per_side * per_side);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                  \
  region_dwell_kernel<K><<<grid, 256, 0, s>>>(canvas, coords, count, n, \
                                               side, tile, plane, max_dwell, w)
  REPRO_DISPATCH_KIND(kind, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
