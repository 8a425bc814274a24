// Shared device code of the escape-time kernels.
//
// Every kernel in this directory that computes a dwell runs the steps
// below. They follow the rounding contract of kernels/ref.py operation by
// operation: __fmaf_rn where the plain version computes one FMA,
// __fmul_rn / __fadd_rn / __fsub_rn everywhere else, and the library is
// built with -fmad=false so that nvcc contracts nothing on its own.
//
// What bounds an escape kernel on the card under that contract is the issue
// rate, not the f32 flop rate: every operation is its own instruction
// (nothing may fuse into an FMA but the one the contract places), so a
// mandelbrot, julia or burning_ship step is 7 arithmetic instructions and
// one compare, and a multibrot step 9 + 4(m-2). Each takes one issue slot
// per lane: 132 SMs x 128 lanes x the SM clock.
//
// The loop therefore runs the steps in blocks of U with no per-step
// control: each step folds its test |z|^2 < 4 into a sticky predicate
// (alive &= test) and z goes on updating in every lane. U is a
// compile-time constant of each kernel instance: each library holds the
// instances U = 4, 8 and 16, and its launch function picks one at run time
// (REPRO_DISPATCH_UNROLL; 0 asks for kUnroll of the .cu, its default, the
// fastest of the three measured on the H100, see PERF.md). The tuned tier
// (kernels/autotune.py) times the others. Keeping the per-step test matters: an orbit may reach
// |z|^2 = 4.0 exactly and come back below it within a block, and the
// plain version freezes z at the first failing step, so the dwell is the
// index of that step. A z that overflows after escaping (inf, or NaN from
// inf - inf) is harmless: its predicate is already false. A lane whose
// block failed rolls back to the block's checkpoint and replays it with a
// count (counted_steps); the replay's arithmetic is the block's own, so
// the compiler reuses the block's results and the replay costs one compare
// and one select a step, once per point. A block that every lane survives
// costs 8 slots a mandelbrot step plus the loop's few (69 instructions for
// U = 8 in the SASS). A lane may step past max_dwell inside its last
// block; the dwell is capped, so a max_dwell that is no multiple of U needs
// no partial block.
//
// Each library built from this directory exports one launch function with
// a plain C interface (bound with ctypes). It returns cudaGetLastError()
// right after the launch, and the Python wrapper raises if that is not 0.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Workload ids: keep the first four in step with KINDS in kernels/ref.py.
// kMultibrot3 is multibrot with the power fixed at compile time to the
// registered default m = 3; REPRO_DISPATCH_KIND picks it for m == 3.
enum Kind : int {
  kMandelbrot = 0,
  kJulia = 1,
  kBurningShip = 2,
  kMultibrot = 3,
  kMultibrot3 = 4,
};

constexpr unsigned kFullMask = 0xffffffffu;

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

// A plane as the single-frame query and leaf kernels take it: four f32
// values in device memory, so that a captured CUDA graph of them reads
// its window at each replay (core/graphs.py).
__device__ __forceinline__ Plane load_plane(const float* __restrict__ p) {
  return Plane{p[0], p[1], p[2], p[3]};
}

__device__ __forceinline__ void map_coords(const Plane& p, int x, int y,
                                           float& cr, float& ci) {
  cr = __fmaf_rn(static_cast<float>(x), p.step_re, p.re0);
  ci = __fmaf_rn(static_cast<float>(y), p.step_im, p.im0);
}

// One step: folds the test |z|^2 < 4 into `alive`, then updates z
// whatever the test said.
template <int K>
__device__ __forceinline__ void step(float& zr, float& zi, float cr, float ci,
                                     const Params& w, bool& alive) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  alive &= __fadd_rn(zr2, zi2) < 4.0f;
  float nzr, nzi;
  if constexpr (K == kMandelbrot) {
    nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    nzi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, ci);
  } else if constexpr (K == kJulia) {
    nzr = __fadd_rn(__fsub_rn(zr2, zi2), w.c_re);
    nzi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, w.c_im);
  } else if constexpr (K == kBurningShip) {
    nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    nzi = __fmaf_rn(__fmul_rn(2.0f, fabsf(zr)), fabsf(zi), ci);
  } else {  // multibrot: z^m by repeated multiplication
    const float x = __fmul_rn(zr, zi);
    float wr = __fsub_rn(zr2, zi2);
    float wi = __fadd_rn(x, x);
    if constexpr (K == kMultibrot3) {
      const float nwr = __fmaf_rn(wr, zr, -__fmul_rn(wi, zi));
      wi = __fmaf_rn(wr, zi, __fmul_rn(wi, zr));
      wr = nwr;
    } else {
      for (int k = 2; k < w.m; ++k) {
        const float nwr = __fmaf_rn(wr, zr, -__fmul_rn(wi, zi));
        wi = __fmaf_rn(wr, zi, __fmul_rn(wi, zr));
        wr = nwr;
      }
    }
    nzr = __fadd_rn(wr, cr);
    nzi = __fadd_rn(wi, ci);
  }
  zr = nzr;
  zi = nzi;
}

// U steps from z; returns how many passed their test before the first
// that failed (U when none failed). z ends U steps on. The index of the
// first failing test is picked from the last test back, one select each.
template <int K, int U>
__device__ __forceinline__ int counted_steps(float& zr, float& zi, float cr,
                                             float ci, const Params& w) {
  bool pass[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    pass[j] = true;
    step<K>(zr, zi, cr, ci, w, pass[j]);
  }
  int passed = U;
#pragma unroll
  for (int j = U - 1; j >= 0; --j) passed = pass[j] ? passed : j;
  return passed;
}

// The dwell of the point c = (cr, ci): blocks of U steps, a checkpoint at
// each block's start, and one counted replay of the block that fails.
template <int K, int U>
__device__ __forceinline__ int escape_time(float cr, float ci, int max_dwell,
                                           const Params& w) {
  float zr = cr, zi = ci;
  for (int d = 0; d < max_dwell; d += U) {
    const float zr0 = zr, zi0 = zi;
    bool alive = true;
#pragma unroll
    for (int j = 0; j < U; ++j) step<K>(zr, zi, cr, ci, w, alive);
    if (!alive) {
      zr = zr0;
      zi = zi0;
      return min(d + counted_steps<K, U>(zr, zi, cr, ci, w), max_dwell);
    }
  }
  return max_dwell;
}

// Lane refill over the points [k0, end) of one work item, by one warp (all
// 32 lanes call it together). Each lane starts on point k0 + lane; after
// every block of U steps the lanes that are done take the next points not
// yet handed out, in lane order. So the warp's time on an item is its work
// divided over 32 lanes, not the sum of its slowest points. The warp leaves
// when every point is handed out and every lane is done.
//
// Nearly every block of a leaf has a lane that finishes (a leaf pixel takes
// about 60 steps on average at B=32), so the bookkeeping is kept short: a
// block runs as in escape_time (the dwell of a lane that failed comes from
// a counted replay, which the compiler folds into the block's own tests),
// one vote says whether any lane is done, and only then do the lanes settle
// their points and take their next ones (computed by every lane and kept by
// the done ones, with no branch) and vote on the exit.
//
// The caller's three hooks:
// * locate(k): point k, an object whose cr and ci are its plane point,
//   with whatever else settle needs; called for any k, also k >= end;
// * stop(k, d): whether running point k, d steps in and unescaped, may
//   stop unfinished (its dwell no longer matters); a plain `false` costs
//   nothing;
// * settle(point, k, finished, stopped, v): called by all 32 lanes together
//   after each block in which some lane is done; a finished lane's v is its
//   dwell. Returns true to drop the points not yet handed out.
template <int K, int U, class Locate, class Stop, class Settle>
__device__ __forceinline__ void refill(int k0, int end, int max_dwell,
                                       const Params& w, Locate locate,
                                       Stop stop, Settle settle) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  int k = k0 + static_cast<int>(lane);  // this lane's point; k >= end: none
  int next = k0 + 32;                   // the first point not handed out
  int d = 0;
  auto p = locate(k);
  float zr = p.cr, zi = p.ci;
  unsigned live = __ballot_sync(kFullMask, k < end);
  while (live) {
    const float zr0 = zr, zi0 = zi;
    bool alive = true;
#pragma unroll
    for (int j = 0; j < U; ++j) step<K>(zr, zi, p.cr, p.ci, w, alive);
    d += U;
    const bool mine = k < end;
    const bool finished = mine && (!alive || d >= max_dwell);
    const bool stopped = mine && !finished && stop(k, d);
    const unsigned done = __ballot_sync(kFullMask, finished || stopped);
    if (done == 0) continue;  // uniform across the warp
    int v = 0;
    if (finished) {
      if (!alive) {
        float a = zr0, b = zi0;
        d += counted_steps<K, U>(a, b, p.cr, p.ci, w) - U;
      }
      v = min(d, max_dwell);
    }
    if (settle(p, k, finished, stopped, v)) next = end;
    const int kn = next + __popc(done & below);
    next += __popc(done);
    const auto q = locate(kn);
    if (finished || stopped) {
      k = kn;
      p = q;
      zr = p.cr;
      zi = p.ci;
      d = 0;
    }
    live = __ballot_sync(kFullMask, k < end);
  }
}

// The dwell of every pixel of one work item, by one warp (all 32 lanes
// call it together), with lane refill: the P = h * width pixels of the
// rectangle whose top left pixel is (x0, y0), in row-major order, stored
// at out[y * stride + x].
template <int K, int U>
__device__ __forceinline__ void dwell_item(int* __restrict__ out,
                                           long long stride, int x0, int y0,
                                           int width, int P, const Plane& plane,
                                           int max_dwell, const Params& w) {
  // pixel k is (k / width, k % width) of the item: a float product
  // corrected by one either way, exact for k < 2^24 (the wrappers keep an
  // item under 2^24 pixels) and cheaper than an integer division
  const float inv_width = 1.0f / static_cast<float>(width);
  int* const base = out + (static_cast<long long>(y0) * stride + x0);
  struct Pixel {  // the plane point and canvas address of a pixel
    float cr, ci;
    int* at;
  };
  refill<K, U>(
      0, P, max_dwell, w,
      [&](int k) {
        Pixel p;
        int row = __float2int_rz(__fmul_rn(static_cast<float>(k), inv_width));
        row += (k - row * width >= width) - (k - row * width < 0);
        const int col = k - row * width;
        map_coords(plane, x0 + col, y0 + row, p.cr, p.ci);
        p.at = base + (static_cast<long long>(row) * stride + col);
        return p;
      },
      [](int, int) { return false; },
      [](const Pixel& p, int, bool finished, bool, int v) {
        if (finished) *p.at = v;
        return false;
      });
}

}  // namespace repro

// Launches kernel<K> for the run-time workload id and multibrot power
// through LAUNCH(K); returns cudaErrorInvalidValue for an unknown id.
#define REPRO_DISPATCH_KIND(kind, m, LAUNCH)                   \
  switch (kind) {                                              \
    case repro::kMandelbrot: LAUNCH(repro::kMandelbrot); break; \
    case repro::kJulia: LAUNCH(repro::kJulia); break;          \
    case repro::kBurningShip: LAUNCH(repro::kBurningShip); break; \
    case repro::kMultibrot:                                    \
      if ((m) == 3) {                                          \
        LAUNCH(repro::kMultibrot3);                            \
      } else {                                                 \
        LAUNCH(repro::kMultibrot);                             \
      }                                                        \
      break;                                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }

// Within a case of REPRO_DISPATCH_KIND: launches LAUNCH_KU(K, U) for the
// run-time steps per block `unroll` (0: kDefault, the .cu's kUnroll);
// returns cudaErrorInvalidValue for any other value than 0, 4, 8 and 16.
#define REPRO_DISPATCH_UNROLL(unroll, kDefault, K, LAUNCH_KU)  \
  switch (unroll) {                                            \
    case 0: LAUNCH_KU(K, kDefault); break;                     \
    case 4: LAUNCH_KU(K, 4); break;                            \
    case 8: LAUNCH_KU(K, 8); break;                            \
    case 16: LAUNCH_KU(K, 16); break;                          \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
