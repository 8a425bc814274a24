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
#include "escape_time.cuh"

namespace {

constexpr int kBlock = 16;

// Steps per block of the escape loop (repro::escape_time): 8, the fastest
// of 4, 8 and 16 for one point per thread on the H100 (PERF.md).
// tools/escape_design.py builds copies at 4, 8 and 16 to compare them.
constexpr int kUnroll = 8;

template <int K>
__global__ void mandelbrot_dwell_kernel(int* __restrict__ out, int n,
                                        repro::Plane plane, int max_dwell,
                                        repro::Params w) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  if (x >= n || y >= n) return;
  float cr, ci;
  repro::map_coords(plane, x, y, cr, ci);
  out[static_cast<size_t>(y) * n + x] =
      repro::escape_time<K, kUnroll>(cr, ci, max_dwell, w);
}

}  // namespace

extern "C" int mandelbrot_dwell_launch(int* out, int n, float re0, float im0,
                                       float step_re, float step_im,
                                       int max_dwell, int kind, float c_re,
                                       float c_im, int m, void* stream) {
  const repro::Plane plane{re0, im0, step_re, step_im};
  const repro::Params w{c_re, c_im, m};
  const dim3 block(kBlock, kBlock);
  const dim3 grid((n + kBlock - 1) / kBlock, (n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K) \
  mandelbrot_dwell_kernel<K><<<grid, block, 0, s>>>(out, n, plane, max_dwell, w)
  REPRO_DISPATCH_KIND(kind, m, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
