// T on the banded cross-frame canvas: fill each homogeneous frame-tagged
// region with its border's value, in place.
//
// Replaces repro/kernels/region_fill_pooled.py::region_fill_pooled (Pallas:
// one grid step per row, the frame tag folded into the BlockSpec row-block
// index, canvas aliased in and out, duplicate-padded rows plus a `nonempty`
// flag). The canvas is [F*n, n] int32 and frame f owns rows [f*n, (f+1)*n),
// so row (f, cy, cx) lands at canvas row f*n + cy*side, column cx*side.
// F*n*n reaches 2^31 at F=8, n=16384: every offset is 64-bit.
//
// Work is cut into items: one item is `rows_per_item` canvas rows of one
// region (the whole region once it holds no more than 4096 pixels), so a
// level-0 region of 16M pixels spreads over many blocks. A grid of a few
// blocks per SM strides over the live items, count * chunks, with the live
// row count read on the device: the capacity padding of the pooled ring
// launches no block. SBR only, as in JAX. Bound on the card: store
// bandwidth (4 * side^2 bytes per region, 16 bytes of row and value read);
// stores are 16-byte int4 along a row where side and n allow.
#include "escape_time.cuh"

namespace {

__global__ void region_fill_pooled_kernel(int* __restrict__ canvas,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ values,
                                          const int* __restrict__ count, int n,
                                          int side, int rows_per_item,
                                          int chunks, int vec4) {
  const long long items = static_cast<long long>(*count) * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long i = item / chunks;
    const int c = static_cast<int>(item - i * chunks);
    const int r0 = c * rows_per_item;
    const int h = min(rows_per_item, side - r0);
    const long long y0 = static_cast<long long>(rows[3 * i]) * n +
                         static_cast<long long>(rows[3 * i + 1]) * side + r0;
    const long long x0 = static_cast<long long>(rows[3 * i + 2]) * side;
    const int v = values[i];
    if (vec4) {
      const int4 v4 = make_int4(v, v, v, v);
      const int q = side / 4;
      for (int k = threadIdx.x; k < h * q; k += blockDim.x) {
        const int yy = k / q;
        const int xx = (k - yy * q) * 4;
        *reinterpret_cast<int4*>(canvas + (y0 + yy) * n + x0 + xx) = v4;
      }
    } else {
      for (int k = threadIdx.x; k < h * side; k += blockDim.x) {
        const int yy = k / side;
        canvas[(y0 + yy) * n + x0 + (k - yy * side)] = v;
      }
    }
  }
}

}  // namespace

extern "C" int region_fill_pooled_launch(int* canvas, const int* rows,
                                         const int* values, const int* count,
                                         int grid, int n, int side,
                                         int rows_per_item, int vec4,
                                         void* stream) {
  const int chunks = (side + rows_per_item - 1) / rows_per_item;
  region_fill_pooled_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas, rows, values, count, n, side, rows_per_item, chunks, vec4);
  return static_cast<int>(cudaGetLastError());
}
