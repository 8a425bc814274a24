// Ex: the dwell of every pixel of an n x n frame.
//
// Replaces repro/kernels/mandelbrot_dwell.py::mandelbrot_dwell (a Pallas
// grid of 256 x 256 tiles). One thread per pixel in a 2-D grid of 16 x 16
// blocks. Bound on the card: the FP32 issue rate (about 8 flops per escape
// step, one 4-byte store per pixel); the design keeps the whole orbit in
// registers and writes each pixel once.
#include "escape_time.cuh"

namespace {

constexpr int kBlock = 16;

template <int K>
__global__ void mandelbrot_dwell_kernel(int* __restrict__ out, int n,
                                        repro::Plane plane, int max_dwell,
                                        repro::Params w) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  if (x >= n || y >= n) return;
  float cr, ci;
  repro::map_coords(plane, x, y, cr, ci);
  out[static_cast<size_t>(y) * n + x] = repro::escape_time<K>(cr, ci, max_dwell, w);
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
  REPRO_DISPATCH_KIND(kind, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
