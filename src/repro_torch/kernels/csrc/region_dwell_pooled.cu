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
// The unit of work is an item, as in region_fill_pooled.cu: up to 4096
// pixels of one region (a B=32 leaf is one item of 1024). One warp owns an
// item and computes it by lane refill (repro::dwell_item: a lane that
// finishes a pixel stores its dwell and takes the item's next pixel). The
// warps of a grid of a few blocks per SM take items from one counter in
// device memory (atomicAdd by lane 0), which the launch zeroes with a
// cudaMemsetAsync on the same stream; the live count is read on the
// device, so the worst-case leaf capacity (2.1M rows at n=16384, F=8)
// costs no work for its padding, and no host sync is needed. Leaves
// differ in cost by orders of magnitude (a leaf at the set's edge against
// one mostly inside it), so a fixed stride of items over the warps would
// leave the slowest warps running alone at the end.
//
// Bound on the card: the issue rate of the escape loop under the rounding
// contract (8 slots a mandelbrot step, see escape_time.cuh; shared with
// every kernel here); the orbit stays in registers and each pixel is
// stored once. The refill's bookkeeping is what keeps it from that bound,
// as in region_dwell.cu.
#include "escape_time.cuh"

namespace {

constexpr int kWarps = 8;

// Steps per block of the escape loop (repro::escape_time): 16, as in
// region_dwell.cu (PERF.md).
// tools/escape_design.py builds copies at 4, 8 and 16 to compare them.
constexpr int kUnroll = 16;

template <int K>
__global__ void region_dwell_pooled_kernel(
    int* __restrict__ canvas, const int* __restrict__ rows,
    const int* __restrict__ count, const float* __restrict__ planes,
    unsigned long long* __restrict__ next_item, int n, int side,
    int rows_per_item, int chunks, int max_dwell, repro::Params w) {
  const unsigned long long items =
      static_cast<unsigned long long>(*count) * chunks;
  for (;;) {
    unsigned long long item = 0;
    if ((threadIdx.x & 31u) == 0) item = atomicAdd(next_item, 1ull);
    item = __shfl_sync(repro::kFullMask, item, 0);
    if (item >= items) return;  // uniform across the warp
    const long long i = static_cast<long long>(item / chunks);
    const int c = static_cast<int>(item % chunks);
    const int r0 = c * rows_per_item;
    const int h = min(rows_per_item, side - r0);
    const int f = rows[3 * i];
    const int y0 = rows[3 * i + 1] * side + r0;  // frame-local
    const int x0 = rows[3 * i + 2] * side;
    const float* p = planes + 4 * f;
    const repro::Plane plane{p[0], p[1], p[2], p[3]};
    int* band = canvas + static_cast<long long>(f) * n * n;
    repro::dwell_item<K, kUnroll>(band, n, x0, y0, side, h * side, plane,
                                  max_dwell, w);
  }
}

}  // namespace

// next_item: one unsigned 64-bit word of scratch on the device (zeroed
// here, before the launch, on the same stream).
extern "C" int region_dwell_pooled_launch(int* canvas, const int* rows,
                                          const int* count, const float* planes,
                                          void* next_item, int grid, int n,
                                          int side, int rows_per_item,
                                          int max_dwell, int kind, float c_re,
                                          float c_im, int m, void* stream) {
  const repro::Params w{c_re, c_im, m};
  const int chunks = (side + rows_per_item - 1) / rows_per_item;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* counter = static_cast<unsigned long long*>(next_item);
  const cudaError_t zeroed =
      cudaMemsetAsync(counter, 0, sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
#define LAUNCH(K)                                                       \
  region_dwell_pooled_kernel<K><<<grid, 32 * kWarps, 0, s>>>(           \
      canvas, rows, count, planes, counter, n, side, rows_per_item, chunks, \
      max_dwell, w)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
