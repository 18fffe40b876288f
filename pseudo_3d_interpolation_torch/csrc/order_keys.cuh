// The percentile route's keys as the selection orders them, and the
// histogram of their first digit that the subband kernels' pass 1 counts
// as it writes them (subband.cu), for band_percentile.cu to start from.
//
// A float orders as its bits do once they are mapped to an unsigned order
// key: a non-negative float's bits with the sign bit set, a negative
// float's bits flipped. The first digit is the order key's top 11 bits
// (bits 21-31: the sign, the exponent and two mantissa bits). A segment's
// histogram is a row of HIST_COLS uint32 in device memory: the KEY_BINS
// digit counts of all its keys, NaNs included, then the count of its NaNs.
// A block counts its keys in shared memory, two 16-bit counts a word (a
// block holds fewer than 65536 keys), each run of neighbouring lanes that
// hold the same digit adding once, and then adds its nonzero counts to the
// row.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KEY_BINS = 2048;            // values of the first digit
constexpr int KEY_SHIFT = 21;             // its lowest bit in the order key
constexpr int HIST_COLS = KEY_BINS + 1;   // a segment's row: bins, NaNs
constexpr int HIST_WORDS = KEY_BINS / 2 + 1;  // a block's packed counts

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Zero the block's packed histogram; every thread calls it, and a
// __syncthreads must follow before the first hist_add.
__device__ __forceinline__ void hist_zero(unsigned* bins) {
  for (int i = threadIdx.x; i < HIST_WORDS; i += blockDim.x) bins[i] = 0u;
}

// Count `key` (when `valid`) into the block's packed histogram. The lanes
// of `mask`, a group of t lanes of fft_lines.cuh (t a power of two, the
// whole warp when t >= 32), call it together, converged, each holding a
// neighbour of the line (its neighbouring lanes hold neighbouring
// elements, whose magnitudes often share a digit): each run of
// neighbouring lanes holding the same digit adds once, from its first
// lane, at the cost of a shuffle and a ballot.
__device__ __forceinline__ void hist_add(unsigned* bins, float key, bool valid,
                                         unsigned mask, int t) {
  const int w = t < 32 ? t : 32;
  const int lane = threadIdx.x & 31, pos = lane & (w - 1);
  const uint32_t d = valid ? order_key(key) >> KEY_SHIFT : 0xffffffffu;
  const uint32_t prev = __shfl_up_sync(mask, d, 1, w);
  const bool head = pos == 0 || prev != d;
  const unsigned heads = __ballot_sync(mask, head);
  if (valid && head) {
    // the run ends at the group's next head, or at the group's end
    const unsigned after = heads & ~((2u << lane) - 1u);
    const int end = after ? __ffs(after) - 1 : lane - pos + w;
    atomicAdd(&bins[d >> 1], (unsigned)(end - lane) << ((d & 1u) << 4));
  }
  if (valid && isnan(key)) atomicAdd(&bins[KEY_BINS / 2], 1u);
}

// Add the block's nonzero counts to its segment's row (HIST_COLS words);
// every thread calls it after a __syncthreads that ends the counting.
__device__ __forceinline__ void hist_flush(const unsigned* bins,
                                           unsigned* __restrict__ row) {
  for (int i = threadIdx.x; i < HIST_WORDS; i += blockDim.x) {
    const unsigned v = bins[i];
    if (i == KEY_BINS / 2) {
      if (v) atomicAdd(&row[KEY_BINS], v);
    } else {
      if (v & 0xffffu) atomicAdd(&row[2 * i], v & 0xffffu);
      if (v >> 16) atomicAdd(&row[2 * i + 1], v >> 16);
    }
  }
}

}  // namespace
