// Ex: the dwell of every pixel of an n x n frame.
//
// Replaces repro/kernels/mandelbrot_dwell.py::mandelbrot_dwell (a Pallas
// grid of 256 x 256 tiles). One thread per pixel in a 2-D grid of 16 x 16
// blocks: the paper's basic exhaustive implementation, the baseline that
// ASK's speedups are quoted against, so it keeps this mapping. Bound on the
// card: the issue rate of the escape loop under the rounding contract (8
// instructions a mandelbrot step, none fused, against one 4-byte store per
// pixel; see escape_time.cuh). The loop runs in blocks of U steps with no
// per-step branch (repro::escape_time), the orbit stays in registers and
// each pixel is written once.
//
// The tuned tier's schedules (kernels/autotune.py): U = 4, 8 or 16 and a
// block of 16 x 16 (the default), 8 x 32 or 4 x 32 threads (rows x
// columns), still one thread per pixel; the launch function picks the
// instance at run time.
#include "escape_time.cuh"

namespace {

constexpr int kBlock = 16;

// Steps per block of the escape loop (repro::escape_time): 8, the fastest
// of 4, 8 and 16 for one point per thread on the H100 (PERF.md).
// tools/escape_design.py builds copies at 4, 8 and 16 to compare them.
constexpr int kUnroll = 8;

// BY x BX threads a block (rows x columns).
template <int K, int U, int BY, int BX>
__global__ void mandelbrot_dwell_kernel(int* __restrict__ out, int n,
                                        repro::Plane plane, int max_dwell,
                                        repro::Params w) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= n || y >= n) return;
  float cr, ci;
  repro::map_coords(plane, x, y, cr, ci);
  out[static_cast<size_t>(y) * n + x] =
      repro::escape_time<K, U>(cr, ci, max_dwell, w);
}

}  // namespace

// unroll: steps per block (0: kUnroll); block_rows x block_cols: the
// threads of a block (0 x 0: kBlock x kBlock), 16 x 16, 8 x 32 or 4 x 32.
extern "C" int mandelbrot_dwell_launch(int* out, int n, float re0, float im0,
                                       float step_re, float step_im,
                                       int max_dwell, int kind, float c_re,
                                       float c_im, int m, int unroll,
                                       int block_rows, int block_cols,
                                       void* stream) {
  const repro::Plane plane{re0, im0, step_re, step_im};
  const repro::Params w{c_re, c_im, m};
  int shape;
  if ((block_rows == 0 && block_cols == 0) ||
      (block_rows == kBlock && block_cols == kBlock)) {
    shape = 0;
  } else if (block_rows == 8 && block_cols == 32) {
    shape = 1;
  } else if (block_rows == 4 && block_cols == 32) {
    shape = 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_B(K, U, BY, BX)                                         \
  mandelbrot_dwell_kernel<K, U, BY, BX>                                \
      <<<dim3((n + BX - 1) / BX, (n + BY - 1) / BY), dim3(BX, BY), 0, \
         s>>>(out, n, plane, max_dwell, w)
#define LAUNCH_KU(K, U)                              \
  switch (shape) {                                   \
    case 0: LAUNCH_B(K, U, kBlock, kBlock); break;   \
    case 1: LAUNCH_B(K, U, 8, 32); break;            \
    default: LAUNCH_B(K, U, 4, 32); break;           \
  }
#define LAUNCH(K) REPRO_DISPATCH_UNROLL(unroll, kUnroll, K, LAUNCH_KU)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
#undef LAUNCH_KU
#undef LAUNCH_B
  return static_cast<int>(cudaGetLastError());
}
