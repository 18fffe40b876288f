// Per-band percentile thresholds of the spectral-stack (SHEARLET, CURVELET)
// POCS iteration with a `*-percentile` threshold, for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (ops/kernels/percentile.py).
//
// p3d_band_percentile has no TPU kernel to replace: the JAX package takes
// this percentile in XLA (pseudo_3d_interpolation_tpu/ops/threshold.py ::
// _percentile_from_mag, jnp.percentile's linear rule) on the coefficients
// of its plain streamed apply (ops/shearlet.py :: pocs_subband_apply). For
// segment s of n non-negative float32 keys (one band's |c| over the slice's
// H·W, from the subband kernels' pass 1) and its percentile q[s]:
//
//   pos = q/100·top (top = n − 1 rounded to float32, given by the caller)
//   lo, hi = floor(pos), ceil(pos), clamped to [0, top] and then n − 1
//   t[s] = sorted[lo]·(1 − (pos − lo)) + sorted[hi]·(pos − lo)
//
// every step rounded in float32 as the plain version (and jnp.percentile)
// rounds it, and NaN for a segment holding a NaN, so that t is bit-equal
// to the plain version on the same keys.
//
// One block per segment runs an exact radix select for rank lo on the
// keys' bits: a float orders as its bits do once they are mapped to an
// unsigned key (a non-negative float's bits with the sign bit set; a
// negative float's bits flipped). Three passes over the segment, digits of
// 11, 11 and 10 bits from the top, each build a shared-memory histogram of
// the keys that match the digits chosen so far (the lanes of a warp that
// hold the same digit add once, through __match_any_sync), and a block scan
// of the histogram picks the digit whose bin holds the rank. After the
// third pass the key is exact and the bin's count is the number of keys
// equal to it; rank hi lies in that run of equal keys or is the least key
// above it, found by one more pass (a min reduction) when needed. No sort
// runs, and nothing is written but t.
// What bounds it: the keys are read once per pass (three or four passes of
// 4·n bytes where the bound counts one), a segment's 1 MB at 512² being too
// large for one block's shared memory; the histogram's shared-memory
// atomics come next. At 32 slices × 48 bands of 512² the reads are about
// 4.8-6.4 GB a call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEL_NT = 1024;        // threads of a block
constexpr int SEL_BINS = 2048;      // bins of the widest digit (11 bits)
constexpr int SEL_WARPS = SEL_NT / 32;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The block's histogram of the digit (k >> shift) & (bins − 1) of the keys
// k whose bits under `mask` equal `prefix`; with `any_nan`, also whether any
// key is a NaN (*any_nan set). Every thread calls it; hist is zeroed here.
__device__ void digit_histogram(const float* __restrict__ keys, long long n,
                                uint32_t prefix, uint32_t mask, int shift,
                                int bins, unsigned* hist, int* any_nan) {
  for (int i = threadIdx.x; i < SEL_BINS; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = blockDim.x;
  bool seen_nan = false;
  // the warp walks whole rows of 32 keys together, so every lane takes
  // part in each ballot and match
  for (long long base = threadIdx.x - lane; base < n; base += stride) {
    const long long i = base + lane;
    const float f = i < n ? __ldg(keys + i) : 0.0f;
    const uint32_t k = order_key(f);
    seen_nan |= i < n && isnan(f);
    const bool ok = i < n && (k & mask) == prefix;
    const unsigned want = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const unsigned d = (k >> shift) & (unsigned)(bins - 1);
      const unsigned peers = __match_any_sync(want, d);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
  }
  if (any_nan != nullptr && __syncthreads_or(seen_nan) && threadIdx.x == 0)
    *any_nan = 1;
  __syncthreads();
}

// The bin of the block's histogram that holds rank `rank` (0-based over
// the counted keys): *digit, and in *below the count of the bins before
// it. Every thread calls it. Each thread sums two bins; a warp scan, then
// a scan of the warps' totals, gives each pair its exclusive prefix.
__device__ void find_bin(const unsigned* hist, unsigned long long rank,
                         unsigned* warp_tot, unsigned* digit,
                         unsigned long long* below) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned a = hist[2 * threadIdx.x], b = hist[2 * threadIdx.x + 1];
  unsigned incl = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned t = lane < SEL_WARPS ? warp_tot[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += v;
    }
    warp_tot[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  const unsigned long long excl =
      (unsigned long long)(warp > 0 ? warp_tot[warp - 1] : 0u) + incl - a - b;
  if (rank >= excl && rank < excl + a) {
    *digit = 2 * threadIdx.x;
    *below = excl;
  } else if (rank >= excl + a && rank < excl + a + b) {
    *digit = 2 * threadIdx.x + 1;
    *below = excl + a;
  }
  __syncthreads();
}

// The least key above `above` among the segment's keys (its order key).
__device__ uint32_t least_above(const float* __restrict__ keys, long long n,
                                uint32_t above, unsigned* slot) {
  if (threadIdx.x == 0) *slot = 0xffffffffu;
  __syncthreads();
  uint32_t best = 0xffffffffu;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t k = order_key(__ldg(keys + i));
    if (k > above && k < best) best = k;
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) atomicMin(slot, best);
  __syncthreads();
  return *slot;
}

__global__ void __launch_bounds__(SEL_NT)
band_percentile_kernel(const float* __restrict__ keys,  // (segments, n)
                       const float* __restrict__ q,     // (segments,)
                       float* __restrict__ t,           // (segments,)
                       long long n, float top) {
  __shared__ unsigned hist[SEL_BINS];
  __shared__ unsigned warp_tot[32];
  __shared__ unsigned digit, slot;
  __shared__ unsigned long long below;
  __shared__ int has_nan;
  const long long seg = blockIdx.x;
  const float* k = keys + seg * n;
  // the rank and the weights, each step rounded as the plain version's
  const float pos = __fmul_rn(__fdiv_rn(q[seg], 100.0f), top);
  const float lo_f = floorf(pos), hi_f = ceilf(pos);
  const float hw = __fsub_rn(pos, lo_f);
  const float lw = __fsub_rn(1.0f, hw);
  long long lo = (long long)fminf(fmaxf(lo_f, 0.0f), top);
  long long hi = (long long)fminf(fmaxf(hi_f, 0.0f), top);
  lo = lo < n - 1 ? lo : n - 1;
  hi = hi < n - 1 ? hi : n - 1;
  if (threadIdx.x == 0) has_nan = 0;
  __syncthreads();

  uint32_t prefix = 0, mask = 0;
  unsigned long long rank = (unsigned long long)lo;
  const int shifts[3] = {21, 10, 0}, widths[3] = {11, 11, 10};
  unsigned equal = 0;
  for (int p = 0; p < 3; ++p) {
    const int bins = 1 << widths[p];
    digit_histogram(k, n, prefix, mask, shifts[p], bins, hist,
                    p == 0 ? &has_nan : nullptr);
    find_bin(hist, rank, warp_tot, &digit, &below);
    rank -= below;
    prefix |= digit << shifts[p];
    mask |= (uint32_t)(bins - 1) << shifts[p];
    equal = hist[digit];
    __syncthreads();  // hist and digit are rewritten by the next pass
  }
  const float v_lo = from_order(prefix);
  float v_hi = v_lo;
  // rank hi = lo + 1 lies past the run of keys equal to v_lo
  if (hi > lo && rank + 1 >= equal)
    v_hi = from_order(least_above(k, n, prefix, &slot));
  if (threadIdx.x == 0)
    t[seg] = has_nan ? __uint_as_float(0x7fc00000u)
                 : __fadd_rn(__fmul_rn(v_lo, lw), __fmul_rn(v_hi, hw));
}

}  // namespace

extern "C" {

// t[s] = the percentile q[s] of the n keys of segment s, for `segments`
// segments of keys (segments, n) float32, contiguous. `top` is n − 1
// rounded to float32. Returns 0, -3 (ERR_SHAPE) for n < 1, or the CUDA
// error of the launch; nothing is synchronised, the launch goes to
// `stream`.
int p3d_band_percentile(const float* keys, const float* q, float* t,
                        int segments, long long n, float top,
                        void* stream_handle) {
  if (n < 1 || segments < 0) return -3;
  if (segments == 0) return 0;
  band_percentile_kernel<<<segments, SEL_NT, 0,
                           static_cast<cudaStream_t>(stream_handle)>>>(
      keys, q, t, n, top);
  return (int)cudaGetLastError();
}

}  // extern "C"
