// A: the per-pixel dwell of each leaf region, written into the canvas.
//
// Replaces repro/kernels/region_dwell.py::region_dwell (Pallas, canvas
// aliased in and out, duplicate-padded OLT plus a `nonempty` flag). The
// unit of work is one tile of one live leaf row (SBR: tile == side, MBR:
// (side / tile)^2 tiles per region), and one warp owns it: block
// (b, t) of 4 warps computes tile t of rows 4b .. 4b + 3, each warp by
// lane refill (repro::dwell_item: a lane that finishes a pixel stores its
// dwell straight into the canvas and takes the tile's next pixel). The
// live row count is read on the device, so padding rows cost nothing.
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

template <int K>
__global__ void region_dwell_kernel(int* __restrict__ canvas,
                                    const int* __restrict__ coords,
                                    const int* __restrict__ count, int n,
                                    int side, int tile, repro::Plane plane,
                                    int max_dwell, repro::Params w) {
  const int i = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (i >= *count) return;  // uniform across the warp
  const int per_side = side / tile;
  const int ty = blockIdx.y / per_side;
  const int tx = blockIdx.y - ty * per_side;
  const int y0 = coords[2 * i] * side + ty * tile;
  const int x0 = coords[2 * i + 1] * side + tx * tile;
  repro::dwell_item<K, kUnroll>(canvas, n, x0, y0, tile, tile * tile, plane,
                                max_dwell, w);
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
  const dim3 grid((num_rows + kWarps - 1) / kWarps, per_side * per_side);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                    \
  region_dwell_kernel<K><<<grid, 32 * kWarps, 0, s>>>(               \
      canvas, coords, count, n, side, tile, plane, max_dwell, w)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
