// T: fill each homogeneous region with its border's value, in place.
//
// Replaces repro/kernels/region_fill.py::region_fill (Pallas, canvas
// aliased in and out, duplicate-padded OLT plus a `nonempty` flag). Here
// block (i, t) fills tile t of region i; SBR has one tile per region
// (tile == side), MBR (side / tile)^2. The live row count is read on the
// device and blocks past it return at once, so padding rows are never
// written. Bound on the card: store bandwidth (4 * side^2 bytes per
// region, nothing read but the row); stores are 16-byte int4 along a row,
// so a warp writes 512 contiguous bytes.
#include "escape_time.cuh"

namespace {

__global__ void region_fill_kernel(int* __restrict__ canvas,
                                   const int* __restrict__ coords,
                                   const int* __restrict__ values,
                                   const int* __restrict__ count, int n,
                                   int side, int tile, int vec4) {
  const int i = blockIdx.x;
  if (i >= *count) return;
  const int per_side = side / tile;
  const int ty = blockIdx.y / per_side;
  const int tx = blockIdx.y - ty * per_side;
  const size_t y0 = static_cast<size_t>(coords[2 * i]) * side + ty * tile;
  const size_t x0 = static_cast<size_t>(coords[2 * i + 1]) * side + tx * tile;
  const int v = values[i];
  if (vec4) {
    const int4 v4 = make_int4(v, v, v, v);
    const int q = tile / 4;
    for (int k = threadIdx.x; k < tile * q; k += blockDim.x) {
      const int yy = k / q;
      const int xx = (k - yy * q) * 4;
      *reinterpret_cast<int4*>(canvas + (y0 + yy) * n + x0 + xx) = v4;
    }
  } else {
    for (int k = threadIdx.x; k < tile * tile; k += blockDim.x) {
      const int yy = k / tile;
      canvas[(y0 + yy) * n + x0 + (k - yy * tile)] = v;
    }
  }
}

}  // namespace

extern "C" int region_fill_launch(int* canvas, const int* coords,
                                  const int* values, const int* count,
                                  int num_rows, int n, int side, int tile,
                                  int vec4, void* stream) {
  const int per_side = side / tile;
  const dim3 grid(num_rows, per_side * per_side);
  region_fill_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas, coords, values, count, n, side, tile, vec4);
  return static_cast<int>(cudaGetLastError());
}
