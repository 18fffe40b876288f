// Fixed-iteration POCS solves (FFT, DCT and WAVELET bases) and the single
// FFT-basis POCS iteration, for a batch of complex slices, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (ops/kernels/pocs_solve.py).
//
// Replaces pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py ::
// pocs_solve_fused (body _solve_kernel, bases 'fft', 'dct' and 'wavelet')
// and pocs_iteration_fused (body _kernel). Per iteration j and slice b of
// a solve, with the basis' transform T:
//
//   X   = T(y)                                  forward transform
//   X^  = X · shrink(|X|², tau)                 hard / soft / garrote
//   new = T⁻¹(X^) · scale · (1 − α·mask) + α·obs
//   cost = (Σ|new| − Σ|x|)² / (Σ|new|)²         (Gao et al. 2013)
//   FPOCS: restart on cost increase, Nesterov extrapolation
//   y' = new + f·(new − x_prev')
//
//   FFT:     T = fft2, T⁻¹ the unscaled ifft2, scale 1/(H·W); tau[j, b]
//   DCT:     T(y) = C_H @ y @ C_Wᵀ, the orthonormal DCT-II (real: re and
//            im transform alone), T⁻¹ = C_Hᵀ @ · @ C_W; tau[j, b]
//   WAVELET: per level lv < L, nj = n >> lv, the top-left nj×nj block
//            becomes A_lv @ block @ A_lvᵀ (A_lv the orthogonal periodized
//            analysis matrix of the filters h, g: A[i, (2i+k) mod nj] =
//            h[k] for the low rows i < nj/2, g[k] for the high rows); the
//            inverse runs A_lvᵀ @ block @ A_lv deepest first; scale 1;
//            tau per Mallat quadrant, tau[j, b, 3·d + band] with d the
//            level counted deepest first and band cH (high rows, low
//            columns), cV (low rows, high columns), cD (both high); the
//            approximation block keeps everything.
//
// The single iteration (pocs_iteration_fused) is the FFT solve's iteration
// once, from a given iterate x to the reinserted result, with tau[b] and no
// cost.
//
// Design. The TPU kernels keep one whole slice in VMEM; a 512² complex
// slice is 2 MB and a block here has at most 227 KB of shared memory, so a
// solve is a chain of launches over the whole batch instead, one iteration
// after another, with one per-slice state kernel per iteration, all on the
// caller's stream, with no host synchronisation inside the solve (the
// restart decision is taken on the device).
//
// The FFT and DCT solves and the single iteration run each iteration as
// three line passes on the fft_lines.cuh engine (each line in the registers
// of its own group of threads, twiddles from a float64-built table),
// through one (B, H, W) complex scratch t:
//   (a) per (b, block of rows): FFT along W of each row of y into t;
//   (b) per (b, tile of 16 columns): the columns of t into shared memory
//       (128-byte row segments); per column FFT along H, shrink with
//       tau[j, b], inverse FFT along H; back into t;
//   (c) per (b, block of rows): inverse FFT along W of each row of t,
//       scale by 1/(H·W), reinsertion new = v·scale·(1 − α·mask) + α·obs
//       into y, and (the solves only) the block's Σ|new| and Σ(|new| −
//       |x|) in a fixed order.
// What bounds it: memory. A solve's iteration moves about 100 bytes per
// (slice, pixel) through device memory (y read, t written, read and
// written, read, obs and x read, y written, and the state kernel's x and
// y), about 26 MB per 512² slice, against 5·H·W·log2(H·W) flops each way;
// the column pass's transforms run at the engine's throughput.
//
// The DCT solve runs the same passes with Makhoul's fast DCT (IEEE Trans.
// ASSP 28(1), 1980) around each line FFT of length n. A line z is loaded
// reordered, v[m] = z[2m] and v[n − 1 − m] = z[2m + 1], and transformed;
// then X_k = f_k·V_k + conj(f_k)·V_{n−k} with f_k = (c_k/2)·exp(−iπk/2n),
// c_k the orthonormal scale: one complex FFT transforms re and im
// together, the DCT being real. The inverse takes V_k = g_k·(X_k −
// i·X_{n−k}) (no second term at k = 0) with g_k = exp(iπk/2n)/c_k, the
// unscaled inverse FFT, and stores v[m] back at the sample it came from: n
// times the DCT-III, so pass (c)'s scale is 1/(H·W) as the FFT's. Pairing
// k with n − k exchanges the line once through the group's buffer; the
// column pass derives X_k, X_{n−k} and the inverse's V_k from one
// exchange. The reordering is a stride-2 gather from device memory in
// pass (a), from the tile in pass (b), and pass (c) reinserts at the
// reordered samples. f and g come from a table built in float64 on the
// host. The DCT's extra work is one exchange and a few complex products a
// point and pass: it moves the FFT solve's bytes.
//
// The WAVELET solve runs each level as one fused 2-D filter pass per
// direction, through shared-memory tiles, not as products with the dense
// nj×nj matrices (whose rows hold L nonzeros of nj). A forward block owns
// 16×16 coefficient positions of each quadrant: it loads the input region
// of rows and columns [2·r0, 2·r0 + 32 + L − 2), wrapped modulo nj, filters
// it along W (low and high columns) and then along H (low and high rows),
// shrinks the three detail quadrants, which are final at this level, and
// writes all four. An inverse block owns 32×32 output samples: it loads
// the 16 + L/2 − 1 low and as many high coefficient rows and columns that
// reach them (the halo wrapped modulo nj/2), and filters along W, then
// along H. A level cannot work in place (a tile's halo is another tile's
// output), so the levels alternate between two plane pairs: forward level
// lv reads P_lv and writes P_lv+1, inverse level lv reads P_lv+1 and
// writes P_lv, with P_even the iterate y (free once level 0 has read it)
// and P_odd the coefficient pair t; every write of a level lands inside
// the block its partner level no longer reads. The deepest approximation
// block is never shrunk (tau 0 keeps it). Level 0's inverse epilogue
// reinserts into y and writes the block's cost sums. What bounds it:
// memory again, about 90 bytes per (slice, pixel) an iteration; the
// filters take 4·L flops per complex output and pass, reading taps
// broadcast from shared memory. The blocks are small (22 KB of shared
// memory for db4) and held to 32 registers a thread, so that 8 blocks
// share an SM and keep their loads in flight: 16×16 tiles measured faster
// than 32×32 ones on an H100, though they re-read more halo (PERF.md).

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "fft_lines.cuh"
#include "shrink.cuh"

namespace {

constexpr int STATE_THREADS = 256;

// Reinsertion on whole planes: new = v·scale·(1 − α·mask) + α·obs; with
// the cost also each block's Σ|new| and Σ(|new| − |x|).
struct ReinsertArgs {
  const float* mask;                   // (M, N)
  const float* obr; const float* obi;  // (B, M, N) observed slices
  const float* xr; const float* xi;    // (B, M, N) current iterate
  float alpha, scale;
  float* psum; float* pdiff;           // (B, blocks per slice)
};

// Sums two per-thread partial sums over the block in a fixed order (warp
// shuffles, then the warps in order) and writes them to psum / pdiff[slot].
// Every thread of the block calls it.
__device__ __forceinline__ void block_cost_sums(float local_s, float local_d,
                                                const ReinsertArgs& ri,
                                                long long slot) {
  __shared__ float red_s[32];
  __shared__ float red_d[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local_s += __shfl_down_sync(0xffffffffu, local_s, off);
    local_d += __shfl_down_sync(0xffffffffu, local_d, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red_s[threadIdx.x >> 5] = local_s;
    red_d[threadIdx.x >> 5] = local_d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f, d = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      s += red_s[i];
      d += red_d[i];
    }
    ri.psum[slot] = s;
    ri.pdiff[slot] = d;
  }
}

// The reinsertion of one complex value v at element o of plane offset m
// (within a slice): returns new and adds to the cost sums.
__device__ __forceinline__ float2 reinsert(float2 v, long long o, long long m,
                                           const ReinsertArgs& ri,
                                           float& local_s, float& local_d) {
  const float keep = 1.0f - ri.alpha * ri.mask[m];
  const float vr = v.x * ri.scale * keep + ri.alpha * ri.obr[o];
  const float vi = v.y * ri.scale * keep + ri.alpha * ri.obi[o];
  const float xr = ri.xr[o], xi = ri.xi[o];
  const float mag_new = sqrtf(vr * vr + vi * vi);
  local_s += mag_new;
  local_d += mag_new - sqrtf(xr * xr + xi * xi);
  return make_float2(vr, vi);
}

// x = y = obs, v = 1, cost_prev = +inf (pocs_iter.py:767)
__global__ void init_kernel(const float* __restrict__ obr,
                            const float* __restrict__ obi,
                            float* xr, float* xi, float* yr, float* yi,
                            float* v, float* cprev, float* cost,
                            long long total, int batch) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const float r = obr[e], i = obi[e];
    xr[e] = r; xi[e] = i;
    yr[e] = r; yi[e] = i;
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < batch; b += blockDim.x) {
      v[b] = 1.0f;
      cprev[b] = INFINITY;
      cost[b] = INFINITY;
    }
  }
}

// Per-slice state after iteration j (pocs_iter.py:671-765): cost from the
// partial sums, FPOCS restart test, Nesterov counter, then x_prev/x and the
// next extrapolated input y. On entry y holds the new iterate. v and
// cost_prev are double-buffered by iteration parity so that every block of
// a slice reads the same old values while block 0 writes the new ones.
__global__ void __launch_bounds__(STATE_THREADS)
state_kernel(float* xr, float* xi, float* yr, float* yi,
             const float* __restrict__ psum, const float* __restrict__ pdiff,
             int nblk, float* v, float* cprev, float* cost_out,
             int parity, int fast, int batch, long long plane) {
  const int b = blockIdx.y;
  __shared__ int s_restart;
  __shared__ float s_f;
  if (threadIdx.x == 0) {
    float s = 0.0f, d = 0.0f;
    for (int i = 0; i < nblk; ++i) {
      s += psum[b * nblk + i];
      d += pdiff[b * nblk + i];
    }
    const float cost = (d * d) / (s == 0.0f ? 1.0f : s * s);
    const float vv = v[parity * batch + b];
    const float v1 = (1.0f + sqrtf(1.0f + 4.0f * vv * vv)) / 2.0f;
    const int restart = fast && (cost > cprev[parity * batch + b]);
    const float v_next = restart ? 1.0f : v1;
    const float v1_next = (1.0f + sqrtf(1.0f + 4.0f * v_next * v_next)) / 2.0f;
    s_restart = restart;
    s_f = fast ? (v_next - 1.0f) / (v1_next + 1.0f) : 0.0f;
    if (blockIdx.x == 0) {
      v[(parity ^ 1) * batch + b] = v_next;
      cprev[(parity ^ 1) * batch + b] = cost;
      cost_out[b] = cost;
    }
  }
  __syncthreads();
  const int restart = s_restart;
  const float f = s_f;
  const long long base = b * plane;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < plane; e += stride) {
    const long long o = base + e;
    const float nr = yr[o], ni = yi[o];
    const float pr = restart ? nr : xr[o];
    const float pi = restart ? ni : xi[o];
    xr[o] = nr;
    xi[o] = ni;
    yr[o] = nr + f * (nr - pr);
    yi[o] = ni + f * (ni - pi);
  }
}

// Makhoul's order: element e of a DCT line's FFT is its sample makhoul(e).
__device__ __forceinline__ int makhoul(int e, int n) {
  return 2 * e < n ? 2 * e : 2 * (n - e) - 1;
}

// n-entry twiddle tables a line kernel holds: the FFT's and, with the DCT,
// a row pass its f or g, the column pass both
template <bool DCT>
__host__ __device__ constexpr int row_tables() {
  return DCT ? 2 : 1;
}
template <bool DCT>
__host__ __device__ constexpr int col_tables() {
  return DCT ? 3 : 1;
}

// For each element e < n that the thread holds, v[s] = op(e, v[s], the
// group's element (n − e) mod n). Through the group's buffer, free on entry
// and on return; every thread of the group calls it.
template <class Op>
__device__ __forceinline__ void with_mirror(float2 (&v)[8], float2* buf,
                                            int n, const Group& g, Op op) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < n) buf[line_pad(e)] = v[s];
  }
  g.sync();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < n) v[s] = op(e, v[s], buf[line_pad(e == 0 ? 0 : n - e)]);
  }
  g.sync();
}

// The DCT's forward step after the FFT: X_k = f_k·V_k + conj(f_k)·V_{n−k}
__device__ __forceinline__ void dct_forward_step(float2 (&v)[8], float2* buf,
                                                 const float2* f, int n,
                                                 const Group& g) {
  with_mirror(v, buf, n, g, [f](int e, float2 own, float2 mirror) {
    return cadd(cmul(f[e], own), cmul_conj(mirror, f[e]));
  });
}

// The DCT's inverse step before the FFT: V_k = g_k·(X_k − i·X_{n−k}), and
// V_0 = g_0·X_0
__device__ __forceinline__ void dct_inverse_step(float2 (&v)[8], float2* buf,
                                                 const float2* gi, int n,
                                                 const Group& g) {
  with_mirror(v, buf, n, g, [gi](int e, float2 own, float2 mirror) {
    const float2 u =
        e == 0 ? own : make_float2(own.x + mirror.y, own.y - mirror.x);
    return cmul(gi[e], u);
  });
}

// The column pass's DCT step between the FFTs: from A = f_k·V_k and B =
// conj(f_k)·V_{n−k}, X_k = A + B and X_{n−k} = i·(A − B) (f_{n−k} =
// −i·conj(f_k) for k > 0); both shrunk, s_k and s_{n−k}, the inverse's
// input is g_k·(X^_k − i·X^_{n−k}) = g_k·((s_k + s_{n−k})·A + (s_k −
// s_{n−k})·B). At k = 0 the mirror is the element itself, A = B, and the
// result g_0·s_0·X_0 holds whatever s_{n−k} is.
__device__ __forceinline__ void dct_shrink_step(float2 (&v)[8], float2* buf,
                                                const float2* f,
                                                const float2* gi, int n,
                                                float thr, int op,
                                                const Group& g) {
  with_mirror(v, buf, n, g, [=](int e, float2 own, float2 mirror) {
    const float2 a = cmul(f[e], own), b = cmul_conj(mirror, f[e]);
    const float2 x = cadd(a, b), y = csub(a, b);
    const float sk = shrink_factor(x.x * x.x + x.y * x.y, thr, op);
    const float sm = shrink_factor(y.x * y.x + y.y * y.y, thr, op);
    const float p = sk + sm, q = sk - sm;
    return cmul(gi[e], make_float2(p * a.x + q * b.x, p * a.y + q * b.y));
  });
}

// Pass (a): t[b, r] = the FFT (DCT: the DCT-II) along W of row r of y_b,
// one group per row. grid (row blocks, batch).
template <bool DCT>
__global__ void __launch_bounds__(LINE_NT_MAX)
solve_rows_forward_kernel(const float* __restrict__ yr,
                          const float* __restrict__ yi,
                          float2* __restrict__ t,
                          const float2* __restrict__ tw_w,
                          const float2* __restrict__ dct_w, LineShape L,
                          int h) {
  extern __shared__ float2 smem[];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + row_tables<DCT>() * w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w, dct_w, DCT ? w : 0);  // f
  const int r = blockIdx.x * g.count + g.index;
  if (r >= h) return;
  const long long o = ((long long)blockIdx.y * h + r) * w;
  float2 v[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    const int m = DCT ? makhoul(e, w) : e;
    v[s] = e < w ? make_float2(yr[o + m], yi[o + m]) : make_float2(0.0f, 0.0f);
  }
  line_fft<false>(v, buf, tw, L, g);
  if (DCT) dct_forward_step(v, buf, tw + w, w, g);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < w) t[o + e] = v[s];
  }
}

// Pass (b): per column of t_b, the FFT along H, shrink with tau[b], the
// unscaled inverse FFT along H (DCT: the DCT-II, the shrink and n times
// the DCT-III), in place through a shared-memory tile of columns. grid
// (column blocks, batch).
template <bool DCT>
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
solve_cols_shrink_kernel(float2* __restrict__ t,
                         const float* __restrict__ tau,  // (B,)
                         const float2* __restrict__ tw_h,
                         const float2* __restrict__ dct_h, LineShape L, int w,
                         int cols, int op) {
  extern __shared__ float2 smem[];
  const int h = L.n;
  const int ls = h + 1;  // padded column stride: the transposing stores of
                         // a row's 16 columns land in 16 banks
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + col_tables<DCT>() * h;  // column c at tile[c·ls]
  float2* buf = tile + cols * ls + g.index * line_buf(h);
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  float2* s = t + (long long)b * h * w + c0;
  const TileWalk tl(cols, nc);
  if (tl.active) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step)
      tile[tl.c * ls + r] = tl.in ? s[(long long)r * w + tl.c]
                                  : make_float2(0.0f, 0.0f);
  }
  load_twiddles(tw, tw_h, h, dct_h, DCT ? 2 * h : 0);  // f, g
  const float thr = tau[b];
  for (int c = g.index; c < nc; c += g.count) {
    float2* col = tile + c * ls;
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      v[q] = e < h ? col[DCT ? makhoul(e, h) : e] : make_float2(0.0f, 0.0f);
    }
    line_fft<false>(v, buf, tw, L, g);
    if (DCT) {
      dct_shrink_step(v, buf, tw + h, tw + 2 * h, h, thr, op, g);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float f = shrink_factor(v[q].x * v[q].x + v[q].y * v[q].y, thr,
                                      op);
        v[q] = make_float2(v[q].x * f, v[q].y * f);
      }
    }
    line_fft<true>(v, buf, tw, L, g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      if (e < h) col[DCT ? makhoul(e, h) : e] = v[q];
    }
  }
  __syncthreads();
  if (tl.active && tl.in) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step)
      s[(long long)r * w + tl.c] = tile[tl.c * ls + r];
  }
}

// Pass (c): per row r of slice b, the inverse FFT along W of t (DCT: n
// times the DCT-III, its samples back in their places), then y =
// v·scale·(1 − α·mask) + α·obs; with COST (the solves) also the block's
// Σ|new| and Σ(|new| − |x|) into ri.psum / ri.pdiff[b, blockIdx.x], summed
// in a fixed order; without (the single iteration) x is not read. One group
// per row. grid (row blocks, batch); blockDim.x is LINE_NT_MAX.
template <bool DCT, bool COST>
__global__ void __launch_bounds__(LINE_NT_MAX)
solve_rows_inverse_kernel(const float2* __restrict__ t,
                          const float2* __restrict__ tw_w,
                          const float2* __restrict__ dct_w, ReinsertArgs ri,
                          float* __restrict__ yr, float* __restrict__ yi,
                          LineShape L, int h) {
  extern __shared__ float2 smem[];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + row_tables<DCT>() * w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w, DCT ? dct_w + w : dct_w, DCT ? w : 0);  // g
  const int r = blockIdx.x * g.count + g.index;
  const int b = blockIdx.y;
  float local_s = 0.0f, local_d = 0.0f;
  if (r < h) {  // every thread goes on to the block's sum
    const long long m0 = (long long)r * w;
    const long long o = (long long)b * h * w + m0;
    float2 v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      v[s] = e < w ? t[o + e] : make_float2(0.0f, 0.0f);
    }
    if (DCT) dct_inverse_step(v, buf, tw + w, w, g);
    line_fft<true>(v, buf, tw, L, g);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      if (e < w) {
        const int m = DCT ? makhoul(e, w) : e;
        float2 nv;
        if (COST) {
          nv = reinsert(v[s], o + m, m0 + m, ri, local_s, local_d);
        } else {
          const float keep = 1.0f - ri.alpha * ri.mask[m0 + m];
          nv = make_float2(v[s].x * ri.scale * keep + ri.alpha * ri.obr[o + m],
                           v[s].y * ri.scale * keep + ri.alpha * ri.obi[o + m]);
        }
        yr[o + m] = nv.x;
        yi[o + m] = nv.y;
      }
    }
  }
  if (COST)
    block_cost_sums(local_s, local_d, ri,
                    (long long)b * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------------
// The wavelet levels' filter passes (the file's header). A block owns WT×WT
// coefficient positions of each quadrant of a level; S = 2·WT + L − 2 is
// the side of the shared-memory region it filters.

constexpr int WT = 16;    // coefficient positions a tile side, each half
constexpr int WNT = 256;  // threads of a filter block (8 warps)
constexpr int WBLOCKS = 8;  // filter blocks an SM: 32 registers a thread

__host__ __device__ __forceinline__ int wavelet_region(int taps) {
  return 2 * WT + taps - 2;
}

// Dynamic shared memory of a filter block: the packed taps, the region,
// the once-filtered region, and the region's row and column indices.
inline size_t wavelet_smem(int taps) {
  const size_t s = wavelet_region(taps);
  return sizeof(float4) * (taps / 2) + sizeof(float2) * (s * s + s * 2 * WT) +
         sizeof(int) * 2 * s;
}

// Coefficient tiles a side of level block nj (nj/2 positions a half)
inline int wavelet_tiles(int nj) { return ceil_div(nj / 2, WT); }

__device__ __forceinline__ int wrap(int i, int m) {
  const int r = i % m;
  return r < 0 ? r + m : r;
}

// x += a·v for a real a and complex x, v
__device__ __forceinline__ void axpy(float2& x, float a, float2 v) {
  x.x = fmaf(a, v.x, x.x);
  x.y = fmaf(a, v.y, x.y);
}

// The level's shrink of one detail coefficient and its store.
__device__ __forceinline__ void store_band(float* dr, float* di, long long o,
                                           float2 v, const float* tau,
                                           int band, int op) {
  if (band >= 0) {
    const float f = shrink_factor(v.x * v.x + v.y * v.y, tau[band], op);
    v.x *= f;
    v.y *= f;
  }
  dr[o] = v.x;
  di[o] = v.y;
}

// Forward level: the top-left nj×nj block of src (planes of n×n, batch
// stride n²) -> its four quadrants in dst, the detail quadrants shrunk
// with tau_b = this slice's thresholds of this level (cH, cV, cD). taps:
// h[0..L) then g[0..L). grid (tiles, tiles, batch).
__global__ void __launch_bounds__(WNT, WBLOCKS)
wavelet_forward_kernel(const float* __restrict__ sr,
                       const float* __restrict__ si, float* __restrict__ dr,
                       float* __restrict__ di, const float* __restrict__ taps,
                       int L, int nj, int n, const float* __restrict__ tau,
                       int ntau, int d, int op) {
  extern __shared__ float4 wsm[];
  const int l2 = L / 2, S = wavelet_region(L), sw = S / 2, h2 = nj / 2;
  float4* tq = wsm;                    // (h[2p], h[2p+1], g[2p], g[2p+1])
  float2* re = reinterpret_cast<float2*>(tq + l2);  // even columns [S][sw]
  float2* ro = re + S * sw;                         // odd columns [S][sw]
  float2* mid = ro + S * sw;           // [S][2·WT]: low | high columns
  int* ridx = reinterpret_cast<int*>(mid + S * 2 * WT);
  int* cidx = ridx + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * WT, c0 = blockIdx.x * WT, b = blockIdx.z;
  for (int p = tid; p < l2; p += WNT)
    tq[p] = make_float4(taps[2 * p], taps[2 * p + 1], taps[L + 2 * p],
                        taps[L + 2 * p + 1]);
  for (int e = tid; e < S; e += WNT) {
    ridx[e] = wrap(2 * r0 + e, nj);
    cidx[e] = wrap(2 * c0 + e, nj);
  }
  __syncthreads();
  const long long base = (long long)b * n * n;
  for (int a = warp; a < S; a += WNT / 32) {
    const long long row = base + (long long)ridx[a] * n;
    for (int c = lane; c < S; c += 32) {
      const float2 v = make_float2(sr[row + cidx[c]], si[row + cidx[c]]);
      ((c & 1) ? ro : re)[a * sw + (c >> 1)] = v;
    }
  }
  __syncthreads();
  // along W: low and high column c of every region row
  for (int e = tid; e < S * WT; e += WNT) {
    const int a = e / WT, c = e % WT;
    const float2* xe = re + a * sw + c;
    const float2* xo = ro + a * sw + c;
    float2 lo = make_float2(0.0f, 0.0f), hi = lo;
    for (int p = 0; p < l2; ++p) {
      const float4 k = tq[p];
      const float2 ve = xe[p], vo = xo[p];
      axpy(lo, k.x, ve);
      axpy(lo, k.y, vo);
      axpy(hi, k.z, ve);
      axpy(hi, k.w, vo);
    }
    mid[a * 2 * WT + c] = lo;
    mid[a * 2 * WT + WT + c] = hi;
  }
  __syncthreads();
  // along H: low and high row r of every filtered column, and the store
  const float* tb = tau + (long long)b * ntau + 3 * d;
  for (int e = tid; e < WT * 2 * WT; e += WNT) {
    const int r = e / (2 * WT), q = e % (2 * WT);
    const float2* x = mid + 2 * r * 2 * WT + q;
    float2 lo = make_float2(0.0f, 0.0f), hi = lo;
    for (int p = 0; p < l2; ++p) {
      const float4 k = tq[p];
      const float2 v0 = x[2 * p * 2 * WT], v1 = x[(2 * p + 1) * 2 * WT];
      axpy(lo, k.x, v0);
      axpy(lo, k.y, v1);
      axpy(hi, k.z, v0);
      axpy(hi, k.w, v1);
    }
    const int rr = r0 + r, cc = c0 + (q % WT);
    if (rr >= h2 || cc >= h2) continue;
    const bool high_col = q >= WT;
    const long long col = high_col ? h2 + cc : cc;
    // low rows: the approximation (kept) or cV; high rows: cH or cD
    store_band(dr, di, base + (long long)rr * n + col, lo, tb,
               high_col ? 1 : -1, op);
    store_band(dr, di, base + (long long)(h2 + rr) * n + col, hi, tb,
               high_col ? 2 : 0, op);
  }
}

// Inverse level: the nj×nj coefficient block of src -> the top-left nj×nj
// block of dst; with REINSERT (level 0, nj = n) dst is y, reinserted, and
// the block's cost sums go to ri.psum / ri.pdiff[b, tile]. grid (tiles,
// tiles, batch): a block owns 2·WT × 2·WT output samples.
template <bool REINSERT>
__global__ void __launch_bounds__(WNT, WBLOCKS)
wavelet_inverse_kernel(const float* __restrict__ sr,
                       const float* __restrict__ si, float* __restrict__ dr,
                       float* __restrict__ di, const float* __restrict__ taps,
                       int L, int nj, int n, ReinsertArgs ri) {
  extern __shared__ float4 wsm[];
  const int l2 = L / 2, S = wavelet_region(L), u = S / 2, h2 = nj / 2;
  // output 2i + s of a tile takes the taps k = L − 2 − 2p (s even) and
  // L − 1 − 2p (s odd) of the coefficients i0 − l2 + 1 + (i + p)
  float4* tq = wsm;  // (h[L-2-2p], h[L-1-2p], g[L-2-2p], g[L-1-2p])
  float2* cf = reinterpret_cast<float2*>(tq + l2);  // [S][S]: low | high
  float2* mid = cf + S * S;            // [S][2·WT]: output columns
  int* ridx = reinterpret_cast<int*>(mid + S * 2 * WT);
  int* cidx = ridx + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * WT, j0 = blockIdx.x * WT, b = blockIdx.z;
  for (int p = tid; p < l2; p += WNT)
    tq[p] = make_float4(taps[L - 2 - 2 * p], taps[L - 1 - 2 * p],
                        taps[2 * L - 2 - 2 * p], taps[2 * L - 1 - 2 * p]);
  for (int e = tid; e < S; e += WNT) {
    const int half = e < u ? 0 : h2, k = e < u ? e : e - u;
    ridx[e] = half + wrap(i0 - l2 + 1 + k, h2);
    cidx[e] = half + wrap(j0 - l2 + 1 + k, h2);
  }
  __syncthreads();
  const long long base = (long long)b * n * n;
  for (int a = warp; a < S; a += WNT / 32) {
    const long long row = base + (long long)ridx[a] * n;
    for (int c = lane; c < S; c += 32)
      cf[a * S + c] = make_float2(sr[row + cidx[c]], si[row + cidx[c]]);
  }
  __syncthreads();
  // along W: output columns 2c and 2c + 1 of every region row
  for (int e = tid; e < S * WT; e += WNT) {
    const int a = e / WT, c = e % WT;
    const float2* lo = cf + a * S + c;
    const float2* hi = lo + u;
    float2 even = make_float2(0.0f, 0.0f), odd = even;
    for (int p = 0; p < l2; ++p) {
      const float4 k = tq[p];
      const float2 vl = lo[p], vh = hi[p];
      axpy(even, k.x, vl);
      axpy(even, k.z, vh);
      axpy(odd, k.y, vl);
      axpy(odd, k.w, vh);
    }
    reinterpret_cast<float4*>(mid + a * 2 * WT)[c] =
        make_float4(even.x, even.y, odd.x, odd.y);
  }
  __syncthreads();
  // along H: output rows 2r and 2r + 1 of every output column
  float local_s = 0.0f, local_d = 0.0f;
  for (int e = tid; e < WT * 2 * WT; e += WNT) {
    const int r = e / (2 * WT), s = e % (2 * WT);
    const float2* lo = mid + r * 2 * WT + s;
    const float2* hi = lo + u * 2 * WT;
    float2 even = make_float2(0.0f, 0.0f), odd = even;
    for (int p = 0; p < l2; ++p) {
      const float4 k = tq[p];
      const float2 vl = lo[p * 2 * WT], vh = hi[p * 2 * WT];
      axpy(even, k.x, vl);
      axpy(even, k.z, vh);
      axpy(odd, k.y, vl);
      axpy(odd, k.w, vh);
    }
    const int row = 2 * (i0 + r), col = 2 * j0 + s;
    if (i0 + r >= h2 || col >= nj) continue;
    const long long m = (long long)row * n + col;
    if (REINSERT) {
      even = reinsert(even, base + m, m, ri, local_s, local_d);
      odd = reinsert(odd, base + m + n, m + n, ri, local_s, local_d);
    }
    dr[base + m] = even.x;
    di[base + m] = even.y;
    dr[base + m + n] = odd.x;
    di[base + m + n] = odd.y;
  }
  if (REINSERT)
    block_cost_sums(local_s, local_d, ri,
                    (long long)b * gridDim.x * gridDim.y +
                        blockIdx.y * gridDim.x + blockIdx.x);
}

// Row blocks of pass (c): the FFT and DCT solves' partial sums per slice
inline int row_blocks(int h, int w) {
  const LineShape lw = line_shape(w);
  const int threads = lw.t > LINE_NT_MAX ? lw.t : LINE_NT_MAX;
  return ceil_div(h, threads / lw.t);
}

// Level 0's inverse tiles of an n × n slice: the wavelet solve's partial
// sums
inline int wavelet_blocks(int n) {
  const int t = wavelet_tiles(n);
  return t * t;
}

inline int plane_chunks(long long plane) {
  const int c = ceil_div(plane, (long long)STATE_THREADS * 8);
  return c < 64 ? c : 64;
}

const ReinsertArgs kNoReinsert{};

// Complex plane pairs of the batch; plane = rows·columns of one slice.
struct Planes {
  float* re; float* im;
};

// Solve workspace, carved from the caller's float buffer: the plane pairs
// y and t, then the partial sums.
struct Work {
  Planes y, t;
  float* psum; float* pdiff; float* v; float* cprev;
};

// Plane pairs of every solve's workspace (y, t)
constexpr int PLANES = 2;
enum Basis { BASIS_FFT = 0, BASIS_DCT = 1, BASIS_WAVELET = 2 };

Work carve(float* work, int batch, long long plane, int nblk) {
  const long long total = plane * batch;
  Work k;
  k.y = {work, work + total};
  k.t = {work + 2 * total, work + 3 * total};
  k.psum = work + 2 * PLANES * total;
  k.pdiff = k.psum + (long long)batch * nblk;
  k.v = k.pdiff + (long long)batch * nblk;   // [2][batch]
  k.cprev = k.v + 2 * batch;                 // [2][batch]
  return k;
}

size_t work_floats(int batch, int h, int w, int nblk) {
  return 2 * (size_t)PLANES * batch * h * w + 2 * (size_t)batch * nblk +
         4 * (size_t)batch;
}

// The FPOCS loop around a basis' chain. chain(j, work, reinsert) enqueues
// iteration j's forward transform of y, threshold, and inverse with the
// reinsertion and cost sums (nblk per slice) back into y.
template <class Chain>
int run_solve(const float* obs_re, const float* obs_im, const float* mask,
              float* out_re, float* out_im, float* cost, float* work,
              int batch, int h, int w, int niter, float alpha, float scale,
              int fast, int nblk, cudaStream_t stream, Chain chain) {
  const long long plane = (long long)h * w;
  const long long total = plane * batch;
  const Work k = carve(work, batch, plane, nblk);

  const int ew_blocks = ceil_div(total, STATE_THREADS) < 4096
                            ? ceil_div(total, STATE_THREADS) : 4096;
  init_kernel<<<ew_blocks, STATE_THREADS, 0, stream>>>(
      obs_re, obs_im, out_re, out_im, k.y.re, k.y.im, k.v, k.cprev, cost,
      total, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const ReinsertArgs reinsert{mask, obs_re, obs_im, out_re, out_im, alpha,
                              scale, k.psum, k.pdiff};
  const dim3 state_grid(plane_chunks(plane), batch);
  for (int j = 0; j < niter; ++j) {
    if ((err = chain(j, k, reinsert)) != cudaSuccess) return (int)err;
    state_kernel<<<state_grid, STATE_THREADS, 0, stream>>>(
        out_re, out_im, k.y.re, k.y.im, k.psum, k.pdiff, nblk, k.v, k.cprev,
        cost, j & 1, fast, batch, plane);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The line geometry of the passes for an h × w slice, with the shared
// memory each pass kernel needs allowed; 0, ERR_SHAPE or ERR_SMEM.
template <bool DCT, bool COST>
int line_passes_for(int h, int w, Lines* s) {
  int err;
  if ((err = lines_for(h, w, LINE_NT_MAX, 0, s, row_tables<DCT>(),
                       col_tables<DCT>())) != 0)
    return err;
  if ((err = allow_smem(solve_rows_forward_kernel<DCT>, s->smem_rows)) != 0)
    return err;
  if ((err = allow_smem(solve_cols_shrink_kernel<DCT>, s->smem_cols)) != 0)
    return err;
  return allow_smem(solve_rows_inverse_kernel<DCT, COST>, s->smem_rows);
}

// The twiddle tables of the passes: the FFT's along H and W and, for the
// DCT, its f and g along H and W
struct LineTwiddles {
  const float2* fft_h; const float2* fft_w;
  const float2* dct_h; const float2* dct_w;
};

// One iteration's passes (a)-(c): y -> t -> t -> out, with the thresholds
// tau (B,) and, with COST, the cost sums of ri.
template <bool DCT, bool COST>
cudaError_t line_passes(const float* y_re, const float* y_im, float2* t,
                        float* out_re, float* out_im, const float* tau,
                        const LineTwiddles& tw, const ReinsertArgs& ri,
                        const Lines& s, int batch, int h, int w, int op,
                        cudaStream_t stream) {
  const dim3 row_grid(row_blocks(h, w), batch);
  const dim3 col_grid(ceil_div(w, s.cols), batch);
  solve_rows_forward_kernel<DCT><<<row_grid, s.nt_w, s.smem_rows, stream>>>(
      y_re, y_im, t, tw.fft_w, tw.dct_w, s.lw, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  solve_cols_shrink_kernel<DCT><<<col_grid, s.nt_h, s.smem_cols, stream>>>(
      t, tau, tw.fft_h, tw.dct_h, s.lh, w, s.cols, op);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  solve_rows_inverse_kernel<DCT, COST>
      <<<row_grid, s.nt_w, s.smem_rows, stream>>>(t, tw.fft_w, tw.dct_w, ri,
                                                  out_re, out_im, s.lw, h);
  return cudaGetLastError();
}

// The FFT or DCT solve: the passes of each iteration in run_solve's loop.
template <bool DCT>
int line_solve(const float* obs_re, const float* obs_im, const float* mask,
               const float* decay, const LineTwiddles& tw, float* out_re,
               float* out_im, float* cost, float* work, int batch, int h,
               int w, int niter, float alpha, int op, int fast,
               cudaStream_t stream) {
  Lines s;
  int err;
  if ((err = line_passes_for<DCT, true>(h, w, &s)) != 0) return err;
  const float scale = 1.0f / (float)((double)h * (double)w);
  return run_solve(
      obs_re, obs_im, mask, out_re, out_im, cost, work, batch, h, w, niter,
      alpha, scale, fast, row_blocks(h, w), stream,
      [=](int j, const Work& k, const ReinsertArgs& ri) {
        // t's (re, im) planes hold one (B, H, W) complex array
        return line_passes<DCT, true>(
            k.y.re, k.y.im, reinterpret_cast<float2*>(k.t.re), k.y.re,
            k.y.im, decay + (long long)j * batch, tw, ri, s, batch, h, w, op,
            stream);
      });
}

}  // namespace

extern "C" {

// Floats of scratch a solve needs: its two plane pairs (y and t), the
// per-block partial sums of its cost (the FFT and DCT solves' pass (c) row
// blocks; the wavelet's level-0 inverse tiles), and the double-buffered v
// / cost_prev. basis: 0 FFT, 1 DCT, 2 WAVELET (square slices, h = w).
size_t p3d_pocs_solve_work_floats(int batch, int h, int w, int basis) {
  return work_floats(batch, h, w,
                     basis == BASIS_WAVELET ? wavelet_blocks(w)
                                            : row_blocks(h, w));
}

// FFT basis, for h and w up to MAX_LINE: three line passes an iteration
// (the file's header). Returns 0, ERR_SHAPE, ERR_SMEM or the first CUDA
// error met while enqueuing. tw_h and tw_w are the (n, 2) twiddle tables
// exp(-2πi m/n). Nothing is synchronised; every launch goes to `stream`.
int p3d_pocs_solve(const float* obs_re, const float* obs_im, const float* mask,
                   const float* decay,  // (niter, batch)
                   const float* tw_h, const float* tw_w,
                   float* out_re, float* out_im, float* cost, float* work,
                   int batch, int h, int w, int niter, float alpha, int op,
                   int fast, void* stream_handle) {
  const LineTwiddles tw{reinterpret_cast<const float2*>(tw_h),
                        reinterpret_cast<const float2*>(tw_w), nullptr,
                        nullptr};
  return line_solve<false>(obs_re, obs_im, mask, decay, tw, out_re, out_im,
                           cost, work, batch, h, w, niter, alpha, op, fast,
                           static_cast<cudaStream_t>(stream_handle));
}

// DCT basis, for h and w up to MAX_LINE: the FFT solve's three line passes
// with Makhoul's steps around each line FFT (the file's header). tw_h and
// tw_w are the FFT's tables; dct_h and dct_w the (2n, 2) tables of f_k =
// (c_k/2)·exp(−iπk/2n) then g_k = exp(iπk/2n)/c_k. Returns as
// p3d_pocs_solve.
int p3d_pocs_solve_dct(const float* obs_re, const float* obs_im,
                       const float* mask, const float* decay,  // (niter, batch)
                       const float* tw_h, const float* tw_w,
                       const float* dct_h, const float* dct_w, float* out_re,
                       float* out_im, float* cost, float* work, int batch,
                       int h, int w, int niter, float alpha, int op, int fast,
                       void* stream_handle) {
  const LineTwiddles tw{reinterpret_cast<const float2*>(tw_h),
                        reinterpret_cast<const float2*>(tw_w),
                        reinterpret_cast<const float2*>(dct_h),
                        reinterpret_cast<const float2*>(dct_w)};
  return line_solve<true>(obs_re, obs_im, mask, decay, tw, out_re, out_im,
                          cost, work, batch, h, w, niter, alpha, op, fast,
                          static_cast<cudaStream_t>(stream_handle));
}

// WAVELET basis on square n×n slices, n divisible by 2^level, the deepest
// block n >> (level − 1) at least the filter length L (even). taps: h[0..L)
// then g[0..L), the analysis filters of the periodized matrices. decay:
// (niter, batch, 3·level). Returns 0, ERR_SMEM or the first CUDA error met
// while enqueuing (cudaErrorInvalidValue for a shape outside these).
int p3d_pocs_solve_wavelet(const float* obs_re, const float* obs_im,
                           const float* mask, const float* decay,
                           const float* taps, int L, float* out_re,
                           float* out_im, float* cost, float* work,
                           int batch, int n, int level, int niter,
                           float alpha, int op, int fast,
                           void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (level < 1 || level > 30 || L < 2 || L % 2 || n % (1 << level) ||
      (n >> (level - 1)) < L)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wavelet_smem(L);
  int err;
  if ((err = allow_smem(wavelet_forward_kernel, smem)) != 0) return err;
  if ((err = allow_smem(wavelet_inverse_kernel<true>, smem)) != 0) return err;
  if ((err = allow_smem(wavelet_inverse_kernel<false>, smem)) != 0)
    return err;
  const int ntau = 3 * level;
  return run_solve(
      obs_re, obs_im, mask, out_re, out_im, cost, work, batch, n, n, niter,
      alpha, 1.0f, fast, wavelet_blocks(n), stream,
      [=](int j, const Work& k, const ReinsertArgs& ri) {
        // level lv reads P_lv and writes P_lv+1 forward, the reverse back:
        // P_even is y, P_odd is t
        const Planes p[2] = {k.y, k.t};
        const float* tau = decay + (long long)j * batch * ntau;
        for (int lv = 0; lv < level; ++lv) {
          const int nj = n >> lv, tiles = wavelet_tiles(nj);
          const Planes src = p[lv & 1], dst = p[(lv + 1) & 1];
          wavelet_forward_kernel<<<dim3(tiles, tiles, batch), WNT, smem,
                                   stream>>>(src.re, src.im, dst.re, dst.im,
                                             taps, L, nj, n, tau, ntau,
                                             level - 1 - lv, op);
          const cudaError_t e = cudaGetLastError();
          if (e != cudaSuccess) return e;
        }
        for (int lv = level - 1; lv >= 0; --lv) {
          const int nj = n >> lv, tiles = wavelet_tiles(nj);
          const Planes src = p[(lv + 1) & 1], dst = p[lv & 1];
          const dim3 grid(tiles, tiles, batch);
          if (lv == 0)
            wavelet_inverse_kernel<true><<<grid, WNT, smem, stream>>>(
                src.re, src.im, dst.re, dst.im, taps, L, nj, n, ri);
          else
            wavelet_inverse_kernel<false><<<grid, WNT, smem, stream>>>(
                src.re, src.im, dst.re, dst.im, taps, L, nj, n, kNoReinsert);
          const cudaError_t e = cudaGetLastError();
          if (e != cudaSuccess) return e;
        }
        return cudaSuccess;
      });
}

// Floats of scratch one FFT-basis iteration needs: the t plane.
size_t p3d_pocs_iteration_work_floats(int batch, int h, int w) {
  return 2 * (size_t)batch * h * w;
}

// One FFT-basis POCS iteration, for h and w up to MAX_LINE: out =
// ifft2(shrink(fft2(x), tau[b])) · (1 − α·mask) + α·obs, no cost, as the
// FFT solve's three line passes. out must not alias x. Returns 0,
// ERR_SHAPE, ERR_SMEM or the first CUDA error met while enqueuing.
int p3d_pocs_iteration(const float* x_re, const float* x_im,
                       const float* obs_re, const float* obs_im,
                       const float* mask, const float* tau,  // (batch,)
                       const float* tw_h, const float* tw_w,
                       float* out_re, float* out_im, float* work, int batch,
                       int h, int w, float alpha, int op,
                       void* stream_handle) {
  Lines s;
  int err;
  if ((err = line_passes_for<false, false>(h, w, &s)) != 0) return err;
  const ReinsertArgs ri{mask, obs_re, obs_im, nullptr, nullptr, alpha,
                        1.0f / (float)((double)h * (double)w), nullptr,
                        nullptr};
  const LineTwiddles tw{reinterpret_cast<const float2*>(tw_h),
                        reinterpret_cast<const float2*>(tw_w), nullptr,
                        nullptr};
  return (int)line_passes<false, false>(
      x_re, x_im, reinterpret_cast<float2*>(work), out_re, out_im, tau, tw,
      ri, s, batch, h, w, op, static_cast<cudaStream_t>(stream_handle));
}

}  // extern "C"
