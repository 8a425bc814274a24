// Decoupled look-back: the cross-block half of a single-pass scan.
//
// A single-pass exclusive scan (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016) reads each input once: a
// block scans its tile, publishes the tile's total at once (the
// aggregate), sums the published words of the tiles before it back to the
// nearest inclusive prefix, and publishes its own inclusive prefix. Two
// kernels use it: the batched ranks (moe_dispatch.cu, one scan per column
// of 32) and the OLT scan (olt_compact.cu, one column).
//
// A status word is 64 bits, written and read whole (relaxed, at GPU scope):
// (epoch << 1 | inclusive) << 32 | value. A block takes its tile from a
// ticket counter, not from blockIdx, so every tile it waits on took its
// ticket earlier, is running, and publishes its aggregate without waiting
// on anything: no tile waits on one not yet scheduled.
//
// The look-back state must not leak from one call to the next. The words
// are epoch-tagged, in a scratch that outlives the call (each wrapper
// keeps one per device and stream, zeroed once when made): a word counts
// only if its epoch is this launch's. Zeroing the scratch each call would
// cost a launch a call, and a counter of finished blocks (to find the last
// one, which would advance the epoch) an atomic round trip at every
// block's end, where the launch waits for it. So one 64-bit counter
// serves: its high half is the epoch (stored 0 .. 2^31 - 2, tagged one
// more), its low half the tickets taken. One atomicAdd gives a block its
// tile and the epoch; the block that draws the last ticket knows every
// block has drawn its own, and resets the counter to the next epoch with
// no tickets. It also refreshes one word, the epoch's own modulo the
// scratch's W words: a word of this launch's range [0, kWords * blocks) is
// rewritten by its tile anyway, and one beyond it, which no block of this
// launch reads, is zeroed. So every word is rewritten or zeroed at least
// once in any 2W launches: a stale tag is at most 2W - 1 epochs old, and
// never this launch's while 2W < 2^31 - 1 (the wrappers keep W below
// 2^30). The counter lives in device memory, so a CUDA graph that replays
// the launch advances it too.
//
// The scratch must be made before a CUDA graph captures a call: made under
// capture, its zeroing would be recorded into the graph and not run, so the
// wrappers refuse to make one then (kernels/_build.py lookback_scratch).
#pragma once

#include <cstdint>

namespace repro::lookback {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEpochs = 0x7fffffffULL;  // stored 0 .. kEpochs-1
constexpr int kState = 1;  // scratch words before the status words: the
                           // counter, (stored epoch << 32) | tickets taken

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status(unsigned epoch,
                                                     bool inclusive,
                                                     unsigned value) {
  return (static_cast<unsigned long long>((epoch << 1) | (inclusive ? 1u : 0u))
          << 32) | value;
}

// One thread of a chained block draws its ticket (the tile it owns) and
// learns the launch's epoch; the block that draws the last ticket resets
// the counter and refreshes one word (see the header). kWords: the status
// words a block owns, which the launch's range spans.
template <unsigned long long kWords>
__device__ __forceinline__ void draw_ticket(unsigned long long* scratch,
                                            long long num_words,
                                            unsigned long long& ticket,
                                            unsigned& epoch) {
  const unsigned long long drawn = atomicAdd(scratch, 1ull);
  const unsigned long long stored = drawn >> 32;
  ticket = drawn & 0xffffffffull;
  epoch = static_cast<unsigned>(stored) + 1u;
  if (ticket == gridDim.x - 1ull) {  // the last ticket: reset, refresh
    store_relaxed(scratch, ((stored + 1) % kEpochs) << 32);
    const unsigned long long q = stored % num_words;
    if (q >= kWords * gridDim.x) store_relaxed(scratch + kState + q, 0ull);
  }
}

// The exclusive prefix of tile t in one column: the sum of the tiles
// before it, read back from their status words, `words[p * kStride]` for
// tile p. Warp-wide; every lane returns it.
template <int kStride>
__device__ unsigned look_back(const unsigned long long* words, long long t,
                              unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0;
  for (long long last = t - 1;; last -= 32) {
    const long long p = last - lane;  // tiles before tile 0 count as 0
    unsigned long long w;
    unsigned incl, need;
    for (;;) {
      w = p >= 0 ? load_relaxed(words + p * kStride) : status(epoch, true, 0);
      const unsigned tag = static_cast<unsigned>(w >> 32);
      const bool ok = (tag >> 1) == epoch;
      incl = __ballot_sync(kFull, ok && (tag & 1u));
      const unsigned valid = __ballot_sync(kFull, ok);
      // lanes up to the nearest inclusive prefix, or all 32 if none
      need = incl ? ((incl & (0u - incl)) << 1) - 1u : kFull;
      if ((valid & need) == need) break;
    }
    prefix += __reduce_add_sync(
        kFull, (need >> lane) & 1u ? static_cast<unsigned>(w) : 0u);
    if (incl) return prefix;
  }
}

}  // namespace repro::lookback
