// A: the per-pixel dwell of each leaf region, written into the canvas.
//
// Replaces repro/kernels/region_dwell.py::region_dwell (Pallas, canvas
// aliased in and out, duplicate-padded OLT plus a `nonempty` flag). The
// unit of work is an item: up to 4096 pixels of one tile of one live leaf
// row (SBR: tile == side, MBR: (side / tile)^2 tiles per region), whole
// rows of the tile (_build.rows_per_item), and one warp owns it. The items
// are one flat index over (live row, tile, piece) across the warps of
// blocks of 4, with the live row count read on the device, so padding rows
// cost nothing and no count of tiles or leaf side meets a grid limit. A
// leaf of B = 32 or 64 (1024 or 4096 pixels) is one item and keeps its own
// kernel, region_dwell_kernel, as before the cut: warp w of block b takes
// row 4b + w, and its step loop compiles as it did. Each warp
// computes its item by lane refill (repro::dwell_item: a lane that
// finishes a pixel stores its dwell straight into the canvas and takes the
// item's next pixel); no item holds 2^24 pixels, where dwell_item's f32
// pixel index would stop being exact.
//
// Bound on the card: the issue rate of the escape loop under the rounding
// contract (8 slots a mandelbrot step, see escape_time.cuh); the orbit
// stays in registers and each pixel is stored once. Leaves are by
// construction the regions whose dwell is not uniform, so a warp that ran
// one row of 32 pixels to its slowest lane (the mapping before lane
// refill) left a third to a half of its lanes idle; with refill a lane
// idles only in the item's last blocks. What refill costs is its
// bookkeeping: a leaf pixel takes about 60 steps at B=32, so nearly every
// block has a lane that finishes, and the warp then spends about as many
// slots on the count, the store and the next pixel as on the block's steps
// (PERF.md). Blocks of 16 steps (kUnroll) pay it half as
// often. Blocks of 4 warps keep a block's slowest leaf from holding many
// finished warps' slots, and many resident warps hide each step's
// dependent chain of about 4 FP ops.
#include "escape_time.cuh"

namespace {

constexpr int kWarps = 4;

// Steps per block of the escape loop (repro::escape_time): 16, the fastest
// of 4, 8 and 16 here on the H100, as lane refill pays its bookkeeping
// once a block (PERF.md).
// tools/escape_design.py builds copies at 4, 8 and 16 to compare them.
constexpr int kUnroll = 16;

// A leaf that is one item (tile == side <= 64, the main path's B = 32):
// warp w of block b takes leaf row 4b + w. This is the kernel as it was
// before items (blockIdx.y picked the MBR tile), kept to the instruction:
// its step loop compiles to the same SASS only in this shape. It now runs
// with tile == side on a 1-D grid, so ty = tx = 0.
template <int K>
__global__ void region_dwell_kernel(int* __restrict__ canvas,
                                    const int* __restrict__ coords,
                                    const int* __restrict__ count, int n,
                                    int side, int tile,
                                    const float* __restrict__ plane,
                                    int max_dwell, repro::Params w) {
  const int i = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (i >= *count) return;  // uniform across the warp
  const int per_side = side / tile;
  const int ty = blockIdx.y / per_side;
  const int tx = blockIdx.y - ty * per_side;
  const int y0 = coords[2 * i] * side + ty * tile;
  const int x0 = coords[2 * i + 1] * side + tx * tile;
  repro::dwell_item<K, kUnroll>(canvas, n, x0, y0, tile, tile * tile,
                                repro::load_plane(plane), max_dwell, w);
}

// Any other leaf: items of `rows_per_item` rows of one tile, one flat
// index over (row, tile, piece) across a 2-D grid (blockIdx.y * gridDim.x
// + blockIdx.x), a warp an item.
template <int K>
__global__ void region_dwell_items_kernel(int* __restrict__ canvas,
                                          const int* __restrict__ coords,
                                          const int* __restrict__ count, int n,
                                          int side, int tile, int rows_per_item,
                                          int chunks,
                                          const float* __restrict__ plane,
                                          int max_dwell, repro::Params w) {
  const int per_side = side / tile;
  const long long per_row =
      static_cast<long long>(per_side) * per_side * chunks;
  const long long item =
      (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kWarps +
      static_cast<int>(threadIdx.x >> 5);
  if (item >= static_cast<long long>(*count) * per_row) return;  // warp-uniform
  const long long i = item / per_row;
  const long long j = item - i * per_row;
  const long long t = j / chunks;
  const int r0 = static_cast<int>(j - t * chunks) * rows_per_item;
  const int ty = static_cast<int>(t / per_side);
  const int tx = static_cast<int>(t - static_cast<long long>(ty) * per_side);
  const int h = min(rows_per_item, tile - r0);
  const int y0 = coords[2 * i] * side + ty * tile + r0;
  const int x0 = coords[2 * i + 1] * side + tx * tile;
  repro::dwell_item<K, kUnroll>(canvas, n, x0, y0, tile, h * tile,
                                repro::load_plane(plane), max_dwell, w);
}

}  // namespace

// grid_x, grid_y: blocks of kWarps warps, one warp per item of the
// capacity's rows (region_dwell.py); blocks past the live items return at
// once. A leaf of one item (tile == side, rows_per_item == side) takes
// region_dwell_kernel on grid_x alone.
extern "C" int region_dwell_launch(int* canvas, const int* coords,
                                   const int* count, int grid_x, int grid_y,
                                   int n, int side, int tile, int rows_per_item,
                                   const float* plane, int max_dwell,
                                   int kind, float c_re, float c_im, int m,
                                   void* stream) {
  const repro::Params w{c_re, c_im, m};
  const int chunks = (tile + rows_per_item - 1) / rows_per_item;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == side && chunks == 1) {
#define LAUNCH(K)                                                    \
  region_dwell_kernel<K><<<grid_x, 32 * kWarps, 0, s>>>(             \
      canvas, coords, count, n, side, side, plane, max_dwell, w)
    REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  } else {
#define LAUNCH(K)                                                       \
  region_dwell_items_kernel<K><<<dim3(grid_x, grid_y), 32 * kWarps, 0, s>>>( \
      canvas, coords, count, n, side, tile, rows_per_item, chunks, plane,   \
      max_dwell, w)
    REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
