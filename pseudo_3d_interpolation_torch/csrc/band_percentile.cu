// Per-band percentile thresholds of the spectral-stack (SHEARLET, CURVELET)
// POCS iteration with a `*-percentile` threshold, for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (ops/kernels/percentile.py).
//
// p3d_band_percentile has no TPU kernel to replace: the JAX package takes
// this percentile in XLA (pseudo_3d_interpolation_tpu/ops/threshold.py ::
// _percentile_from_mag, jnp.percentile's linear rule) on the coefficients
// of its plain streamed apply (ops/shearlet.py :: pocs_subband_apply). For
// segment s of n float32 keys (one band's |c| over the slice's H·W, from
// the subband kernels' pass 1) and its percentile q[s]:
//
//   pos = q/100·top (top = n − 1 rounded to float32, given by the caller)
//   lo, hi = floor(pos), ceil(pos), clamped to [0, top] and then n − 1
//   t[s] = sorted[lo]·(1 − (pos − lo)) + sorted[hi]·(pos − lo)
//
// every step rounded in float32 as the plain version (and jnp.percentile)
// rounds it, and NaN for a segment holding a NaN, so that t is bit-equal
// to the plain version on the same keys.
//
// An exact radix select on the keys' order keys (order_keys.cuh), digits
// of 11, 11 and 10 bits from the top, that reads each segment's keys once:
//   (1) the first digit's histogram comes with the keys: the kernels that
//       write them count it as they write (subband.cu's pass 1 epilogues);
//       select_plan_kernel, one block per segment, scans it for the digit
//       whose bin holds rank lo, the rank inside that bin, and whether
//       rank hi lies past the bin (rank lo its last key);
//   (2) select_gather_kernel, blocks of GATHER_KEYS keys each, reads the
//       keys once with 16-byte loads, appends those of the chosen bin to
//       the segment's candidate buffer (one atomic per warp and round, the
//       lanes' offsets from a warp scan) and, when rank hi lies past the
//       bin, takes the least order key above it (a warp min, one atomic);
//   (3) select_finish_kernel, one block per segment, runs digits 2 and 3
//       over the candidates, copied into shared memory when they fit
//       (FIN_SMEM_KEYS), from the buffer otherwise, 16-byte loads with
//       FIN_UNROLL in flight a thread; the digit-3 pass also takes the
//       least candidate above digit 2's group, so that rank hi is the run
//       of keys equal to rank lo's, the next key of digit 3's histogram,
//       that least candidate, or the least key above the bin from (2).
// The candidate buffer holds `cap` keys a segment (the wrapper's choice:
// half the segment, a multiple of 4). A segment whose chosen bin holds
// more, such as all-equal keys or keys inside one quarter of an exponent,
// appends nothing; its finishing block runs digits 2 and 3 over the
// segment's keys themselves, two reads more. Nothing is sorted, and
// nothing is written but t and the scratch.
// What bounds it: one read of the keys (4·n bytes a segment), at the
// memory rate; the candidates add a write and a read of the chosen bin's
// keys (about a tenth of a segment on the SHEARLET bands of plane waves at
// 512², chip_smoke.py phase 17a). On an H100 SXM at 700 W, the 48 bands of
// a 32×512² call: the gather 0.65 ms (2.5 TB/s; two loads in flight a
// thread timed faster than four or eight), the finish 0.38 ms (plain
// shared-memory atomics timed twice as fast as __match_any_sync's
// aggregation there), the plan 0.013 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_keys.cuh"

namespace {

constexpr int PLAN_NT = 256;
constexpr int GATHER_NT = 256;
constexpr int GATHER_VEC = 4;                  // keys a 16-byte load holds
constexpr int GATHER_UNROLL = 2;               // loads a thread keeps in flight
constexpr int GATHER_KEYS = 16384;             // keys a gather block reads
constexpr int FIN_NT = 1024;
constexpr int FIN_UNROLL = 4;                  // 16-byte loads in flight a thread
constexpr int FIN_SMEM_KEYS = 49152;           // candidates held in shared memory
constexpr unsigned FLAG_NAN = 1u;              // the segment holds a NaN
constexpr unsigned FLAG_ABOVE = 2u;            // rank hi lies past the bin
constexpr int ERR_SHAPE = -3;

// A segment's selection state, written by select_plan_kernel.
struct SelectState {
  unsigned digit;    // the first digit of rank lo's key
  unsigned rank;     // rank lo among the keys of that digit
  unsigned count;    // the keys of that digit (the histogram's count)
  unsigned flags;    // FLAG_NAN, FLAG_ABOVE
  unsigned taken;    // candidates appended by select_gather_kernel
  unsigned above_c;  // ~(least order key above the digit); 0 while none
  unsigned pad[2];
};

// The two ranks and their weights, each step rounded as the plain
// version's.
struct Ranks {
  long long lo, hi;
  float lw, hw;
};

__device__ __forceinline__ Ranks ranks_of(float q, float top, long long n) {
  const float pos = __fmul_rn(__fdiv_rn(q, 100.0f), top);
  const float lo_f = floorf(pos), hi_f = ceilf(pos);
  Ranks r;
  r.hw = __fsub_rn(pos, lo_f);
  r.lw = __fsub_rn(1.0f, r.hw);
  const long long lo = (long long)fminf(fmaxf(lo_f, 0.0f), top);
  const long long hi = (long long)fminf(fmaxf(hi_f, 0.0f), top);
  r.lo = lo < n - 1 ? lo : n - 1;
  r.hi = hi < n - 1 ? hi : n - 1;
  return r;
}

// The bin of `hist` (KEY_BINS counts, NT threads reading KEY_BINS / NT
// consecutive bins each) that holds rank `rank`: *digit, and in *below the
// count of the bins before it. Every thread calls it. A warp scan of the
// threads' sums, then a scan of the warps' totals, gives each thread its
// bins' exclusive prefix.
template <int NT>
__device__ void find_bin(const unsigned* hist, unsigned rank,
                         unsigned* warp_tot, unsigned* digit,
                         unsigned* below) {
  constexpr int PER = KEY_BINS / NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned c[PER];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    c[i] = hist[threadIdx.x * PER + i];
    sum += c[i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned t = lane < NT / 32 ? warp_tot[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += v;
    }
    warp_tot[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  unsigned excl = (warp > 0 ? warp_tot[warp - 1] : 0u) + incl - sum;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (rank >= excl && rank - excl < c[i]) {
      *digit = threadIdx.x * PER + i;
      *below = excl;
    }
    excl += c[i];
  }
  __syncthreads();
}

// (1) per segment: the bin of rank lo in the first digit's histogram.
__global__ void __launch_bounds__(PLAN_NT)
select_plan_kernel(const unsigned* __restrict__ hist,  // (segments, HIST_COLS)
                   const float* __restrict__ q, SelectState* __restrict__ st,
                   long long n, float top) {
  __shared__ unsigned warp_tot[32];
  __shared__ unsigned digit, below;
  const long long seg = blockIdx.x;
  const unsigned* row = hist + seg * HIST_COLS;
  const Ranks r = ranks_of(q[seg], top, n);
  SelectState s = {};
  if (row[KEY_BINS] != 0u) {
    s.flags = FLAG_NAN;
  } else {
    if (threadIdx.x == 0) {
      digit = KEY_BINS - 1;  // kept only by a histogram short of n keys
      below = 0;
    }
    find_bin<PLAN_NT>(row, (unsigned)r.lo, warp_tot, &digit, &below);
    s.digit = digit;
    s.rank = (unsigned)r.lo - below;
    s.count = row[digit];
    if (r.hi > r.lo && s.rank + 1 >= s.count) s.flags = FLAG_ABOVE;
  }
  if (threadIdx.x == 0) st[seg] = s;
}

// (2) per block of GATHER_KEYS keys of a segment: the chosen bin's keys
// appended to the segment's candidates (unless they would overflow `cap`),
// and with FLAG_ABOVE the least order key above the bin. VEC: 16-byte
// loads (n a multiple of 4, the keys 16-byte aligned). grid (segments,
// blocks of a segment).
template <bool VEC>
__global__ void __launch_bounds__(GATHER_NT)
select_gather_kernel(const float* __restrict__ keys,
                     SelectState* __restrict__ st, unsigned* __restrict__ cand,
                     long long n, unsigned cap) {
  constexpr int W = VEC ? GATHER_VEC : 1;
  const long long seg = blockIdx.x;
  const SelectState s = st[seg];
  const bool append = s.count <= cap;
  const bool above = (s.flags & FLAG_ABOVE) != 0;
  if ((s.flags & FLAG_NAN) || !(append || above)) return;
  const float* k = keys + seg * n;
  unsigned* out = cand + seg * (long long)cap;
  const long long a = (long long)blockIdx.y * GATHER_KEYS;
  const long long e = a + GATHER_KEYS < n ? a + GATHER_KEYS : n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t d = s.digit;
  uint32_t best = 0xffffffffu;
  // a warp's round covers GATHER_UNROLL rows of 32·W neighbouring keys
  for (long long base = a + (long long)warp * 32 * W * GATHER_UNROLL; base < e;
       base += (long long)GATHER_NT * W * GATHER_UNROLL) {
    uint32_t o[GATHER_UNROLL][W];
    bool in[GATHER_UNROLL][W];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
      const long long i = base + (long long)(u * 32 + lane) * W;
      if constexpr (VEC) {
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < e) f = __ldg(reinterpret_cast<const float4*>(k + i));
        o[u][0] = order_key(f.x);
        o[u][1] = order_key(f.y);
        o[u][2] = order_key(f.z);
        o[u][3] = order_key(f.w);
      } else {
        o[u][0] = order_key(i < e ? __ldg(k + i) : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) in[u][j] = i < e;  // i < e: the whole load
    }
    unsigned m = 0;
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint32_t dj = o[u][j] >> KEY_SHIFT;
        m += in[u][j] && dj == d;
        if (above && in[u][j] && dj > d && o[u][j] < best) best = o[u][j];
      }
    }
    if (!append) continue;
    unsigned incl = m;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, sh);
      if (lane >= sh) incl += v;
    }
    const unsigned total = __shfl_sync(0xffffffffu, incl, 31);
    if (total == 0) continue;
    unsigned p = 0;
    if (lane == 31) p = atomicAdd(&st[seg].taken, total);
    p = __shfl_sync(0xffffffffu, p, 31) + incl - m;
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (in[u][j] && (o[u][j] >> KEY_SHIFT) == d) {
          if (p < cap) out[p] = o[u][j];
          ++p;
        }
      }
    }
  }
  if (above) {
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0 && best != 0xffffffffu) atomicMax(&st[seg].above_c, ~best);
  }
}

// The order keys of a finishing source: the segment's float keys (FLOAT)
// or candidates' order keys; one entry, or four from one 16-byte load.
template <bool FLOAT>
__device__ __forceinline__ uint32_t key_at(const void* src, long long i) {
  if (FLOAT) return order_key(static_cast<const float*>(src)[i]);
  return static_cast<const unsigned*>(src)[i];
}

template <bool FLOAT>
__device__ __forceinline__ void keys4_at(const void* src, long long i4,
                                         uint32_t (&k)[4]) {
  if constexpr (FLOAT) {
    const float4 f = static_cast<const float4*>(src)[i4];
    k[0] = order_key(f.x);
    k[1] = order_key(f.y);
    k[2] = order_key(f.z);
    k[3] = order_key(f.w);
  } else {
    const uint4 u = static_cast<const uint4*>(src)[i4];
    k[0] = u.x;
    k[1] = u.y;
    k[2] = u.z;
    k[3] = u.w;
  }
}

// Call visit(k, valid) for the `count` entries of `src`, every thread of
// the block, a warp's lanes together (so that visit may use the warp's
// votes). VEC: 16-byte loads (src 16-byte aligned), FIN_UNROLL of them in
// flight a thread, the last count % 4 entries by warp 0.
template <bool FLOAT, bool VEC, typename Visit>
__device__ __forceinline__ void for_keys(const void* src, long long count,
                                         Visit visit) {
  const int lane = threadIdx.x & 31;
  if constexpr (VEC) {
    const long long q4 = count / 4;
    for (long long base = threadIdx.x - lane; base < q4;
         base += (long long)blockDim.x * FIN_UNROLL) {
      uint32_t k[FIN_UNROLL][4];
      bool in[FIN_UNROLL];
#pragma unroll
      for (int u = 0; u < FIN_UNROLL; ++u) {
        const long long i = base + (long long)u * blockDim.x + lane;
        in[u] = i < q4;
        if (in[u]) {
          keys4_at<FLOAT>(src, i, k[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) k[u][j] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < FIN_UNROLL; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) visit(k[u][j], in[u]);
      }
    }
    if (threadIdx.x < 32) {
      const long long i = q4 * 4 + lane;
      visit(i < count ? key_at<FLOAT>(src, i) : 0u, i < count);
    }
  } else {
    for (long long base = threadIdx.x - lane; base < count;
         base += blockDim.x) {
      const long long i = base + lane;
      visit(i < count ? key_at<FLOAT>(src, i) : 0u, i < count);
    }
  }
}

// The block's histogram of the digit (k >> shift) & (bins − 1) of the
// entries k of `src` whose bits under `mask` equal `prefix` (shared-memory
// atomics; a warp whose entries share one digit adds once, which
// __match_any_sync did at twice the cost); with `above` < ~0u, also the
// least entry above `above` into *least. hist (KEY_BINS) is zeroed here;
// every thread calls it.
template <bool FLOAT, bool VEC>
__device__ void digit_pass(const void* src, long long count, uint32_t prefix,
                           uint32_t mask, int shift, int bins, uint32_t above,
                           unsigned* hist, unsigned* least) {
  for (int i = threadIdx.x; i < KEY_BINS; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) *least = 0xffffffffu;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t best = 0xffffffffu;
  for_keys<FLOAT, VEC>(src, count, [&](uint32_t k, bool in) {
    const bool ok = in && (k & mask) == prefix;
    const unsigned dg = (k >> shift) & (unsigned)(bins - 1);
    // a warp whose counted entries share one digit (ties, a narrow bin)
    // adds once; otherwise each entry adds its own
    const unsigned d0 = __shfl_sync(0xffffffffu, dg, 0);
    const unsigned want = __ballot_sync(0xffffffffu, ok);
    if (__all_sync(0xffffffffu, !ok || dg == d0)) {
      if (lane == 0 && want) atomicAdd(&hist[d0], __popc(want));
    } else if (ok) {
      atomicAdd(&hist[dg], 1u);
    }
    if (in && k > above && k < best) best = k;
  });
  if (above != 0xffffffffu) {
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0 && best != 0xffffffffu) atomicMin(least, best);
  }
  __syncthreads();
}

// (3) per segment: digits 2 and 3 over its candidates (or, past `cap`,
// its keys), then t. The candidates are copied into shared memory when
// they fit (FIN_SMEM_KEYS), so that the two passes read device memory
// once. Rank hi, when it lies past the run of keys equal to rank lo's, is
// the next key of digit 3's histogram, or else the least entry above
// digit 2's group (taken by the digit-3 pass), or else (rank lo the last
// key of its first digit) the least key above the bin from (2).
template <bool VEC>
__global__ void __launch_bounds__(FIN_NT)
select_finish_kernel(const float* __restrict__ keys,
                     const float* __restrict__ q,
                     const SelectState* __restrict__ st,
                     const unsigned* __restrict__ cand, float* __restrict__ t,
                     long long n, float top, unsigned cap) {
  extern __shared__ unsigned fin[];
  unsigned* hist = fin;              // KEY_BINS
  unsigned* held = fin + KEY_BINS;   // FIN_SMEM_KEYS candidates
  __shared__ unsigned warp_tot[32];
  __shared__ unsigned digit, below, least, next;
  const long long seg = blockIdx.x;
  const SelectState s = st[seg];
  if (s.flags & FLAG_NAN) {
    if (threadIdx.x == 0) t[seg] = __uint_as_float(0x7fc00000u);
    return;
  }
  const Ranks r = ranks_of(q[seg], top, n);
  const bool from_keys = s.count > cap;
  const long long count = s.taken < cap ? s.taken : cap;
  const unsigned* c = cand + seg * (long long)cap;  // cap: a multiple of 4
  const unsigned* src = c;
  if (!from_keys && count <= FIN_SMEM_KEYS) {
    for (long long i = threadIdx.x; i < (count + 3) / 4; i += FIN_NT)
      reinterpret_cast<uint4*>(held)[i] = reinterpret_cast<const uint4*>(c)[i];
    __syncthreads();
    src = held;
  }
  uint32_t prefix = s.digit << KEY_SHIFT;
  uint32_t mask = 0xffffffffu << KEY_SHIFT;
  unsigned rank = s.rank, equal = s.count;
  const int shifts[2] = {10, 0}, widths[2] = {11, 10};
  for (int p = 0; p < 2; ++p) {
    const int bins = 1 << widths[p];
    // the digit-3 pass also takes the least entry above digit 2's group
    const uint32_t above = p == 1 ? prefix | ((1u << shifts[0]) - 1u)
                                  : 0xffffffffu;
    if (from_keys && VEC)
      digit_pass<true, VEC>(keys + seg * n, n, prefix, mask, shifts[p], bins,
                            above, hist, &least);
    else if (from_keys)
      digit_pass<true, false>(keys + seg * n, n, prefix, mask, shifts[p],
                              bins, above, hist, &least);
    else
      digit_pass<false, true>(src, count, prefix, mask, shifts[p], bins,
                              above, hist, &least);
    find_bin<FIN_NT>(hist, rank, warp_tot, &digit, &below);
    rank -= below;
    prefix |= digit << shifts[p];
    mask |= (uint32_t)(bins - 1) << shifts[p];
    equal = hist[digit];
    if (p == 0) __syncthreads();  // hist and digit are rewritten by pass 2
  }
  const float v_lo = from_order(prefix);
  float v_hi = v_lo;
  // rank hi = lo + 1 lies past the run of keys equal to v_lo
  if (r.hi > r.lo && rank + 1 >= equal) {
    if (threadIdx.x == 0) next = 0xffffffffu;
    __syncthreads();
    const unsigned d3 = prefix & 1023u;
    for (unsigned i = threadIdx.x; i < 1024u; i += FIN_NT)
      if (i > d3 && hist[i] != 0u) atomicMin(&next, i);
    __syncthreads();
    if (next != 0xffffffffu)
      v_hi = from_order((prefix & ~1023u) | next);
    else if (least != 0xffffffffu)
      v_hi = from_order(least);
    else
      v_hi = from_order(~s.above_c);
  }
  if (threadIdx.x == 0)
    t[seg] = __fadd_rn(__fmul_rn(v_lo, r.lw), __fmul_rn(v_hi, r.hw));
}

}  // namespace

extern "C" {

// t[s] = the percentile q[s] of the n keys of segment s, for `segments`
// segments of keys (segments, n) float32, contiguous, whose first-digit
// histogram `hist` (segments, HIST_COLS) uint32 the keys' writer counted
// (order_keys.cuh). `top` is n − 1 rounded to float32; `state` holds 32
// bytes a segment and `cand` `cap` uint32 a segment, both scratch. Returns
// 0, -3 (ERR_SHAPE) for n out of [1, 2^32) or cap < 1, or the CUDA error
// of the launches; nothing is synchronised, the launches go to `stream`.
int p3d_band_percentile(const float* keys, const float* q,
                        const unsigned* hist, float* t, void* state,
                        unsigned* cand, int segments, long long n, float top,
                        long long cap, void* stream_handle) {
  if (n < 1 || n >= (1ll << 32) || segments < 0 || cap < 1 || cap % 4 ||
      cap >= (1ll << 32) || (n + GATHER_KEYS - 1) / GATHER_KEYS > 65535)
    return ERR_SHAPE;
  if (segments == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  SelectState* st = static_cast<SelectState*>(state);
  const size_t fin_smem = sizeof(unsigned) * (KEY_BINS + FIN_SMEM_KEYS);
  const bool vec =
      n % GATHER_VEC == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  int err = (int)cudaFuncSetAttribute(
      vec ? select_finish_kernel<true> : select_finish_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fin_smem);
  if (err != 0) return err;
  select_plan_kernel<<<segments, PLAN_NT, 0, stream>>>(hist, q, st, n, top);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 grid(segments, (unsigned)((n + GATHER_KEYS - 1) / GATHER_KEYS));
  if (vec)
    select_gather_kernel<true><<<grid, GATHER_NT, 0, stream>>>(
        keys, st, cand, n, (unsigned)cap);
  else
    select_gather_kernel<false><<<grid, GATHER_NT, 0, stream>>>(
        keys, st, cand, n, (unsigned)cap);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (vec)
    select_finish_kernel<true><<<segments, FIN_NT, fin_smem, stream>>>(
        keys, q, st, cand, t, n, top, (unsigned)cap);
  else
    select_finish_kernel<false><<<segments, FIN_NT, fin_smem, stream>>>(
        keys, q, st, cand, t, n, top, (unsigned)cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
