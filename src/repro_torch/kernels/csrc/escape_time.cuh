// Shared device code of the four escape-time kernels.
//
// escape_time<Kind>(cr, ci, max_dwell, params) is the per-point function
// of every kernel in this directory. It follows the rounding contract of
// kernels/ref.py operation by operation: __fmaf_rn where the plain version
// computes one FMA, __fmul_rn / __fadd_rn / __fsub_rn everywhere else, and
// the library is built with -fmad=false so that nvcc contracts nothing on
// its own. The loop leaves as soon as |z|^2 >= 4; an escaped point keeps
// its z in the masked fixed-trip loop of the plain version, so the dwell is
// the same.
//
// Each library built from this directory exports one launch function with
// a plain C interface (bound with ctypes). It returns cudaGetLastError()
// right after the launch, and the Python wrapper raises if that is not 0.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Workload ids: keep in step with KINDS in kernels/ref.py.
enum Kind : int { kMandelbrot = 0, kJulia = 1, kBurningShip = 2, kMultibrot = 3 };

// Run-time parameters of a workload: julia's constant, multibrot's power.
struct Params {
  float c_re;
  float c_im;
  int m;
};

// Pixel -> plane map: re0, im0 and the steps are exact f32 values that
// the wrapper computes in either bounds spelling (ref.plane).
struct Plane {
  float re0;
  float im0;
  float step_re;
  float step_im;
};

__device__ __forceinline__ void map_coords(const Plane& p, int x, int y,
                                           float& cr, float& ci) {
  cr = __fmaf_rn(static_cast<float>(x), p.step_re, p.re0);
  ci = __fmaf_rn(static_cast<float>(y), p.step_im, p.im0);
}

template <int K>
__device__ __forceinline__ int escape_time(float cr, float ci, int max_dwell,
                                           const Params& w) {
  float zr = cr, zi = ci;
  int d = 0;
  for (; d < max_dwell; ++d) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) < 4.0f)) break;
    float nzr, nzi;
    if (K == kMandelbrot) {
      nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
      nzi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, ci);
    } else if (K == kJulia) {
      nzr = __fadd_rn(__fsub_rn(zr2, zi2), w.c_re);
      nzi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, w.c_im);
    } else if (K == kBurningShip) {
      nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
      nzi = __fmaf_rn(__fmul_rn(2.0f, fabsf(zr)), fabsf(zi), ci);
    } else {  // kMultibrot: z^m by repeated multiplication
      const float x = __fmul_rn(zr, zi);
      float wr = __fsub_rn(zr2, zi2);
      float wi = __fadd_rn(x, x);
      for (int k = 2; k < w.m; ++k) {
        const float nwr = __fmaf_rn(wr, zr, -__fmul_rn(wi, zi));
        const float nwi = __fmaf_rn(wr, zi, __fmul_rn(wi, zr));
        wr = nwr;
        wi = nwi;
      }
      nzr = __fadd_rn(wr, cr);
      nzi = __fadd_rn(wi, ci);
    }
    zr = nzr;
    zi = nzi;
  }
  return d;
}

}  // namespace repro

// Launches kernel<K> for the run-time workload id; returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown id.
#define REPRO_DISPATCH_KIND(kind, LAUNCH)                         \
  switch (kind) {                                                 \
    case repro::kMandelbrot: LAUNCH(repro::kMandelbrot); break;   \
    case repro::kJulia: LAUNCH(repro::kJulia); break;             \
    case repro::kBurningShip: LAUNCH(repro::kBurningShip); break; \
    case repro::kMultibrot: LAUNCH(repro::kMultibrot); break;     \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
