// Batched OLT ranks: the MoE position_in_expert compaction.
//
// Replaces repro/kernels/moe_dispatch.py::batched_ranks_kernel, which holds
// one [N, E] int32 tile in VMEM and takes a column-wise cumsum on the VPU.
// Here flags are [G, N, E] (G token groups, one launch): for each (g, e),
// ranks[g, :, e] is the exclusive prefix sum of flags[g, :, e] along N and
// counts[g, e] its total -- G*E independent OLT compactions (paper
// Sec. 5.3.1), the atomicAdd-per-expert replacement. Flags are bool (one
// byte) or int32; an int32 flag adds its value, as the plain version's
// cumsum does (sums wrap in 32 bits, as there).
//
// Bound on the card: bytes (each flag read once, each rank and count
// written once); there is no arithmetic to speak of. So it is one launch
// that reads each flag once, at every shape: a single-pass scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016), one scan per column.
//
// A tile is R = L * V * K rows of 32 columns of one group, V = 4; a block
// of L warps owns it, and thread (x, y) the V columns V*x .. V*x + V - 1 of
// rows yK .. yK + K - 1 (a warp's loads are whole row segments, so they
// coalesce over E; each is one 16-byte load of int32 flags, or 4 bytes of
// bool, when E % 4 == 0). The grid is flat over (g, column block, tile), so
// no grid dimension limits G or N. The block sums its rows, scans each
// column over its L * V row lanes in shared memory, and, when a column
// spans more than one tile (`chained`):
//
//   1. publishes each column's tile total at once (the aggregate; tile 0
//      publishes it as its inclusive prefix);
//   2. warp y takes the look-back of columns y, y + L, ...: it reads the
//      status words of the 32 tiles before it in one go, waits until those
//      up to the nearest inclusive prefix are valid, sums them, and steps
//      32 tiles back if there was none; then publishes its own inclusive
//      prefix;
//   3. writes each rank from the column's prefix.
//
// The look-back itself, the status words, the ticket counter and the
// epoch-tagged scratch that no call clears are lookback.cuh's, shared with
// the OLT scan (olt_compact.cu); here a tile owns 32 words, one a column.
//
// A column within one tile (N <= R, MoE decode) needs none of it: no
// ticket, no words, no counter. There are two tiles, R = 128 rows (8 warps
// of K = 4 rows, for columns of up to 128 rows: MoE decode) and R = 512
// (K = 16: the prefill); moe_dispatch.py picks by N. The prefill's tiles
// of 512 rows and 4 columns a thread beat a build of 256 rows and one
// column a thread: fewer tiles wait on each other, and a quarter of the
// loads and stores carry the same bytes (PERF.md).
#include <cstdint>

#include "escape_time.cuh"
#include "lookback.cuh"

namespace {

using repro::lookback::draw_ticket;
using repro::lookback::kFull;
using repro::lookback::kState;
using repro::lookback::look_back;
using repro::lookback::status;
using repro::lookback::store_relaxed;

constexpr int V = 4;  // columns a thread

// V flags of type T in one load: 16 bytes of int32, 4 of bool
template <typename T> struct Pack;
template <> struct Pack<int> { using type = int4; };
template <> struct Pack<uint8_t> { using type = uchar4; };

template <class P>
__device__ __forceinline__ void unpack(const P& v, unsigned* f) {
  f[0] = static_cast<unsigned>(v.x);
  f[1] = static_cast<unsigned>(v.y);
  f[2] = static_cast<unsigned>(v.z);
  f[3] = static_cast<unsigned>(v.w);
}

// One tile per block (see the header). With `vec` (E % V == 0, aligned)
// each row's V flags are one load and its V ranks one store, else V scalar
// ones.
template <typename T, int L, int K>
__global__ void __launch_bounds__(32 * L)
    ranks_kernel(const T* __restrict__ flags, long long n, int e,
                 int col_blocks, long long tiles, int* __restrict__ ranks,
                 int* __restrict__ counts,
                 unsigned long long* __restrict__ scratch,
                 long long num_words, int vec) {
  constexpr int TPR = 32 / V;    // threads across the tile's 32 columns
  constexpr int LANES = L * V;   // row lanes
  constexpr int R = LANES * K;
  constexpr int J = 32 / L;      // columns a warp scans
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0, "L: 2 .. 32 warps");
  static_assert(LANES <= 32, "a column's lanes are scanned by one warp");
  __shared__ unsigned sums[LANES][33];  // +1: no bank conflicts
  __shared__ unsigned long long ticket;
  __shared__ unsigned epoch_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = threadIdx.x % TPR, y = threadIdx.x / TPR;
  const bool chained = tiles > 1;
  long long id = blockIdx.x;
  unsigned epoch = 0;
  if (chained) {
    if (threadIdx.x == 0) draw_ticket<32>(scratch, num_words, ticket, epoch_s);
    __syncthreads();
    id = static_cast<long long>(ticket);
    epoch = epoch_s;
  }
  const long long t = id % tiles;
  const long long gc = id / tiles;
  const long long g = gc / col_blocks;
  const int col0 = static_cast<int>(gc - g * col_blocks) * 32;
  const int col = col0 + V * x;
  const long long first = t * R + static_cast<long long>(y) * K;
  const long long base = g * n * e + col;  // [g, 0, col]
  using P = typename Pack<T>::type;
  unsigned f[K][V];
  unsigned s[V] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long r = first + k;
    const bool row = r < n;
    if (vec) {
      if (row && col < e) {
        unpack(*reinterpret_cast<const P*>(flags + base + r * e), f[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[k][i] = 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[k][i] = row && col + i < e
                      ? static_cast<unsigned>(flags[base + r * e + i]) : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += f[k][i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sums[y][V * x + i] = s[i];
  __syncthreads();
  unsigned long long* const words =
      chained ? scratch + kState + gc * tiles * 32 : nullptr;
  unsigned total[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {  // 1. scan the columns; publish totals
    const int c = warp + j * L;
    const unsigned v = lane < LANES ? sums[lane][c] : 0u;
    unsigned inc = v;
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    total[j] = __shfl_sync(kFull, inc, LANES - 1);
    if (lane < LANES) sums[lane][c] = inc - v;
    if (chained && lane == 0) {
      store_relaxed(words + t * 32 + c, status(epoch, t == 0, total[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {  // 2. look back; publish the prefix
    const int c = warp + j * L;
    unsigned prefix = 0;
    if (chained && t > 0) {
      prefix = look_back<32>(words + c, t, epoch);
      if (lane == 0) {
        store_relaxed(words + t * 32 + c,
                      status(epoch, true, prefix + total[j]));
      }
    }
    if (lane < LANES) sums[lane][c] += prefix;
    if (t == tiles - 1 && lane == 0 && col0 + c < e) {
      counts[g * e + col0 + c] = static_cast<int>(prefix + total[j]);
    }
  }
  __syncthreads();
  unsigned r[V];  // 3. the ranks
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = sums[y][V * x + i];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long row = first + k;
    int* const out = ranks + base + row * e;
    if (vec) {
      if (row < n && col < e) {
        *reinterpret_cast<int4*>(out) =
            make_int4(static_cast<int>(r[0]), static_cast<int>(r[1]),
                      static_cast<int>(r[2]), static_cast<int>(r[3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (row < n && col + i < e) out[i] = static_cast<int>(r[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] += f[k][i];
  }
}

template <typename T, int L, int K>
int launch(const T* flags, long long g, long long n, int e, int* ranks,
           int* counts, unsigned long long* scratch, long long num_words,
           int vec, cudaStream_t s) {
  constexpr long long R = L * V * K;
  const int col_blocks = (e + 31) / 32;
  const long long tiles = (n + R - 1) / R;
  const long long blocks = g * col_blocks * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 1 && (scratch == nullptr || num_words < blocks * 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ranks_kernel<T, L, K>
      <<<static_cast<unsigned>(blocks), 32 * L, 0, s>>>(
          flags, n, e, col_blocks, tiles, ranks, counts, scratch, num_words,
          vec);
  return static_cast<int>(cudaGetLastError());
}

// The two tiles (see the header): 8 warps of 4 or 16 rows a thread.
template <typename T>
int launch_tile(int tile_rows, const T* flags, long long g, long long n,
                int e, int* ranks, int* counts, unsigned long long* scratch,
                long long num_words, int vec, cudaStream_t s) {
  switch (tile_rows) {
    case 128:
      return launch<T, 8, 4>(flags, g, n, e, ranks, counts, scratch,
                             num_words, vec, s);
    case 512:
      return launch<T, 8, 16>(flags, g, n, e, ranks, counts, scratch,
                              num_words, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// flags [g, n, e] (is_bool: one byte each, else int32), ranks [g, n, e],
// counts [g, e] int32. tile_rows: 128 or 512, the rows of a tile; vec:
// e % 4 == 0 and flags and ranks aligned to a 4-flag load. scratch: kState
// words of state, then num_words status words, zeroed when it was made and
// kept from call to call on one stream; null when n fits one tile.
extern "C" int batched_ranks_launch(const void* flags, long long g,
                                    long long n, int e, int is_bool,
                                    int tile_rows, int vec, int* ranks,
                                    int* counts, void* scratch,
                                    long long num_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* state = static_cast<unsigned long long*>(scratch);
  if (is_bool) {
    return launch_tile(tile_rows, static_cast<const uint8_t*>(flags), g, n,
                       e, ranks, counts, state, num_words, vec, s);
  }
  return launch_tile(tile_rows, static_cast<const int*>(flags), g, n, e,
                     ranks, counts, state, num_words, vec, s);
}
