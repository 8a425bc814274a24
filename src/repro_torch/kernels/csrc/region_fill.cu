// T: fill each homogeneous region with its border's value, in place. One
// body serves both fills:
//
//   region_fill_launch         coords [N, 2] = (cy, cx) on one [n, n] canvas;
//   region_fill_pooled_launch  frame-tagged rows [N, 3] = (f, cy, cx) on the
//                              banded [F*n, n] canvas, where frame f owns
//                              rows [f*n, (f+1)*n).
//
// Replaces repro/kernels/region_fill.py::region_fill and
// repro/kernels/region_fill_pooled.py::region_fill_pooled (Pallas: one grid
// step per row, or per MBR tile; the frame tag folded into the BlockSpec
// row-block index; canvas aliased in and out; duplicate-padded rows plus a
// `nonempty` flag). A fill writes the same pixels whatever the MBR tile, so
// the tile shapes nothing here.
//
// Bound on the card: store bandwidth, 4 * side^2 bytes a region, with 16
// bytes of row and value read. What kept the single-frame fill from it was
// its grid, one 256-thread block per region (or tile) over the capacity N:
// mandelbrot's first level wrote 128 MiB from 2 blocks on 2 of 132 SMs. So
// work is cut into items: one item is `rows_per_item` canvas rows of one
// region (the whole region once it holds no more than 4096 pixels), and a
// grid of a few blocks per SM strides over the live items, count * chunks,
// with the live row count read on the device: the capacity padding launches
// no work, and a 16M-pixel region spreads over every SM. Stores are 16-byte
// int4 along a row where side, n and the canvas allow, scalar otherwise.
// The int4 stores are streaming (__stcs: evict first), which summed a
// little below plain int4 stores over the four workloads' fills; a TMA
// bulk copy (cp.async.bulk) of a shared-memory line of the value was never
// the faster (PERF.md).
// Offsets are 64-bit: 8 frames at n=16384 hold 2^31 pixels.
#include "escape_time.cuh"

namespace {

constexpr int kThreads = 256;  // _THREADS in region_fill.py

struct Frame {  // coords [N, 2] = (cy, cx)
  static constexpr int kCols = 2;
  __device__ static long long y0(const int* r, int, int side) {
    return static_cast<long long>(r[0]) * side;
  }
};

struct Band {  // rows [N, 3] = (f, cy, cx); frame f's band starts at f*n
  static constexpr int kCols = 3;
  __device__ static long long y0(const int* r, int n, int side) {
    return static_cast<long long>(r[0]) * n +
           static_cast<long long>(r[1]) * side;
  }
};

template <class Layout>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(int* __restrict__ canvas, const int* __restrict__ rows,
                const int* __restrict__ values, const int* __restrict__ count,
                int n, int side, int rows_per_item, int chunks, int vec4) {
  const long long items = static_cast<long long>(*count) * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long i = item / chunks;
    const int c = static_cast<int>(item - i * chunks);
    const int r0 = c * rows_per_item;
    const int h = min(rows_per_item, side - r0);
    const int* row = rows + Layout::kCols * i;
    const long long y0 = Layout::y0(row, n, side) + r0;
    const long long x0 = static_cast<long long>(row[Layout::kCols - 1]) * side;
    int* const at = canvas + (y0 * n + x0);
    const int v = values[i];
    if (vec4) {
      const int4 v4 = make_int4(v, v, v, v);
      const int q = side / 4;
      for (int k = threadIdx.x; k < h * q; k += kThreads) {
        const int yy = k / q;
        const int xx = (k - yy * q) * 4;
        // streaming: the fill is never read back on the path
        __stcs(reinterpret_cast<int4*>(at + static_cast<long long>(yy) * n + xx),
               v4);
      }
    } else {
      for (int k = threadIdx.x; k < h * side; k += kThreads) {
        const int yy = k / side;
        at[static_cast<long long>(yy) * n + (k - yy * side)] = v;
      }
    }
  }
}

template <class Layout>
int launch(int* canvas, const int* rows, const int* values, const int* count,
           int grid, int n, int side, int rows_per_item, int vec4,
           void* stream) {
  const int chunks = (side + rows_per_item - 1) / rows_per_item;
  fill_kernel<Layout><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas, rows, values, count, n, side, rows_per_item, chunks, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid: blocks of the grid-stride launch (region_fill.py asks
// _build.grid_for); vec4: side, n and the canvas allow 16-byte stores.
extern "C" int region_fill_launch(int* canvas, const int* coords,
                                  const int* values, const int* count,
                                  int grid, int n, int side, int rows_per_item,
                                  int vec4, void* stream) {
  return launch<Frame>(canvas, coords, values, count, grid, n, side,
                       rows_per_item, vec4, stream);
}

extern "C" int region_fill_pooled_launch(int* canvas, const int* rows,
                                         const int* values, const int* count,
                                         int grid, int n, int side,
                                         int rows_per_item, int vec4,
                                         void* stream) {
  return launch<Band>(canvas, rows, values, count, grid, n, side,
                      rows_per_item, vec4, stream);
}
