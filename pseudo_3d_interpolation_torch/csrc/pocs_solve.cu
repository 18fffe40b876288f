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
//   FFT:     T(y) = F_H @ y @ F_W (fft2), T⁻¹ = conj(F_H) @ · @ conj(F_W)
//            (the unscaled ifft2), scale 1/(H·W); tau[j, b]
//   DCT:     T(y) = C_H @ y @ C_Wᵀ, T⁻¹ = C_Hᵀ @ · @ C_W, scale 1 (the
//            orthonormal DCT-II is real: re and im transform alone);
//            tau[j, b]
//   WAVELET: per level lv < L, nj = n >> lv, the top-left nj×nj block
//            becomes A_lv @ block @ A_lvᵀ (A_lv the orthogonal periodized
//            analysis matrix, real), the rest of the plane passes through;
//            the inverse runs A_lvᵀ @ block @ A_lv deepest first; scale 1;
//            tau per Mallat quadrant, tau[j, b, 3·d + band] with d the
//            level counted deepest first and band cH (high rows, low
//            columns), cV (low rows, high columns), cD (both high); the
//            approximation block keeps everything.
//
// The single iteration (pocs_iteration_fused) is the FFT chain of DFT
// GEMMs once, from a given iterate x to the reinserted result, with tau[b]
// and no cost.
//
// Design. The TPU kernels keep one whole slice in VMEM; a 512² complex
// slice is 2 MB and a block here has at most 227 KB of shared memory, so a
// solve is a chain of launches over the whole batch instead, one iteration
// after another, with one per-slice state kernel per iteration, all on the
// caller's stream, with no host synchronisation inside the solve (the
// restart decision is taken on the device).
//
// The FFT solve runs each iteration as three line passes on the
// fft_lines.cuh engine (each line in the registers of its own group of
// threads, twiddles from a float64-built table), through one (B, H, W)
// complex scratch t:
//   (a) per (b, block of rows): FFT along W of each row of y into t;
//   (b) per (b, tile of 16 columns): the columns of t into shared memory
//       (128-byte row segments); per column FFT along H, shrink with
//       tau[j, b], inverse FFT along H; back into t;
//   (c) per (b, block of rows): inverse FFT along W of each row of t,
//       scale by 1/(H·W), reinsertion new = v·scale·(1 − α·mask) + α·obs
//       into y, and the block's Σ|new| and Σ(|new| − |x|) in a fixed order.
// What bounds it: memory. An iteration moves about 100 bytes per (slice,
// pixel) through device memory (y read, t written, read and written,
// read, obs and x read, y written, and the state kernel's x and y), about
// 26 MB per 512² slice, against 5·H·W·log2(H·W) flops each way; the
// column pass's transforms run at the engine's throughput.
//
// The DCT and WAVELET solves, and the single FFT-basis iteration, run
// batched complex GEMMs with the basis' dense matrices instead. They are
// bound by those products, in full fp32 FMA on the CUDA cores (67 TFLOP/s
// peak on an H100 SXM): the DFT products are complex × complex,
// 16·H·W·(H+W) real flops per slice-iteration; the DCT and wavelet
// matrices are real, so their products take a real operand and do two
// FMAs per complex output element and depth step, not four: 8·H·W·(H+W)
// for the DCT, 16·n³·Σ_lv 8^-lv for the wavelet cascade. Each GEMM tile is
// 64×64 complex outputs per 256-thread block, 4×4 complex accumulators in
// registers per thread, 16-deep K tiles staged in shared memory; row
// strides let a product work on the top-left block of a plane. The
// iteration's and the DCT's thresholds live in the forward right-product's
// epilogue; the wavelet's in one elementwise pass over the finished
// coefficient plane (its bands are finished level by level). Scale,
// reinsertion and the cost's partial sums live in the last inverse
// product's epilogue, so the unscaled inverse never makes an extra pass
// through device memory. The partial sums are per block, reduced in a
// fixed order: the result does not depend on scheduling. A fast DCT, the
// filter cascade as convolutions, and tensor cores (3xTF32 / bf16x3
// wgmma), are later work.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "fft_lines.cuh"
#include "shrink.cuh"

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TM = 4;    // complex rows per thread (strided by 16)
constexpr int TN = 4;    // complex columns per thread (strided by 16)
constexpr int NT = 256;  // threads per GEMM block
constexpr int A_PAD = 2; // keeps the transposed A stores free of bank conflicts
constexpr int STATE_THREADS = 256;

// EPI_REINSERT also writes each block's cost sums; EPI_REINSERT_ONLY
// (the single iteration) does not
enum Epilogue {
  EPI_STORE = 0, EPI_SHRINK = 1, EPI_REINSERT = 2, EPI_REINSERT_ONLY = 3
};
// which operand is a real matrix (its imaginary pointer is unused)
enum Operands { CPLX = 0, REAL_A = 1, REAL_B = 2 };

// C[b] = A[b] @ B[b] for row-major complex planes with row strides
// ld*; a batch stride of 0 shares an operand (a transform matrix) across
// the batch. sign_* = -1 conjugates that operand.
struct Gemm {
  const float* ar; const float* ai; long long sa; int lda; float sign_a;
  const float* br; const float* bi; long long sb; int ldb; float sign_b;
  float* cr; float* ci; long long sc; int ldc;
  int m, n, k;
};

struct ShrinkArgs {
  const float* tau;  // (B,) thresholds of this iteration
  int op;
};

// Reinsertion on whole planes (ldc == n): new = v·scale·(1 − α·mask) +
// α·obs; under EPI_REINSERT also each block's Σ|new| and Σ(|new| − |x|).
struct ReinsertArgs {
  const float* mask;                   // (M, N)
  const float* obr; const float* obi;  // (B, M, N) observed slices
  const float* xr; const float* xi;    // (B, M, N) current iterate
  float alpha, scale;
  float* psum; float* pdiff;           // (B, blocks per slice)
};

// STRIDED reads the row strides from ld*; otherwise every plane is whole
// (lda = k, ldb = ldc = n): whole-plane products index with their own
// widths, since the row strides cost the FFT solve about 0.4% (PERF.md).
template <int EPI, int OPS, bool STRIDED>
__global__ void __launch_bounds__(NT)
cgemm_kernel(Gemm g, ShrinkArgs sh, ReinsertArgs ri) {
  __shared__ float as_r[BK][BM + A_PAD];
  __shared__ float as_i[BK][BM + A_PAD];
  __shared__ float bs_r[BK][BN];
  __shared__ float bs_i[BK][BN];
  __shared__ float red_s[NT / 32];
  __shared__ float red_d[NT / 32];

  const int lda = STRIDED ? g.lda : g.k;
  const int ldb = STRIDED ? g.ldb : g.n;
  const int ldc = STRIDED ? g.ldc : g.n;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  const float* ar = g.ar + b * g.sa;
  const float* ai = OPS == REAL_A ? nullptr : g.ai + b * g.sa;
  const float* br = g.br + b * g.sb;
  const float* bi = OPS == REAL_B ? nullptr : g.bi + b * g.sb;

  // tile-load coordinates: A as 16 rows x 16 k per pass (4 passes),
  // B as 4 k-rows x 64 columns per pass (4 passes)
  const int a_k = t % 16, a_m = t / 16;
  const int b_n = t % 64, b_k = t / 64;

  float acc_r[TM][TN];
  float acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_r[i][j] = acc_i[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
#pragma unroll
    for (int p = 0; p < BM / 16; ++p) {
      const int m = m0 + a_m + 16 * p;
      const int k = k0 + a_k;
      float vr = 0.0f, vi = 0.0f;
      if (m < g.m && k < g.k) {
        const long long off = (long long)m * lda + k;
        vr = ar[off];
        if (OPS != REAL_A) vi = g.sign_a * ai[off];
      }
      as_r[a_k][a_m + 16 * p] = vr;
      if (OPS != REAL_A) as_i[a_k][a_m + 16 * p] = vi;
    }
#pragma unroll
    for (int p = 0; p < BK / 4; ++p) {
      const int k = k0 + b_k + 4 * p;
      const int n = n0 + b_n;
      float vr = 0.0f, vi = 0.0f;
      if (k < g.k && n < g.n) {
        const long long off = (long long)k * ldb + n;
        vr = br[off];
        if (OPS != REAL_B) vi = g.sign_b * bi[off];
      }
      bs_r[b_k + 4 * p][b_n] = vr;
      if (OPS != REAL_B) bs_i[b_k + 4 * p][b_n] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = as_r[kk][ty + 16 * i];
        a_i[i] = OPS == REAL_A ? 0.0f : as_i[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = bs_r[kk][tx + 16 * j];
        b_i[j] = OPS == REAL_B ? 0.0f : bs_i[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (OPS == CPLX) {
            acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
            acc_r[i][j] = fmaf(-a_i[i], b_i[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
            acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
          } else if (OPS == REAL_A) {  // real A times complex B
            acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
          } else {  // complex A times real B
            acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
          }
        }
    }
    __syncthreads();
  }

  float local_s = 0.0f, local_d = 0.0f;
  float* cr = g.cr + b * g.sc;
  float* ci = g.ci + b * g.sc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m >= g.m || n >= g.n) continue;
      const long long off = (long long)m * ldc + n;
      float vr = acc_r[i][j], vi = acc_i[i][j];
      if (EPI == EPI_SHRINK) {
        const float s = shrink_factor(vr * vr + vi * vi, sh.tau[b], sh.op);
        vr *= s;
        vi *= s;
      } else if (EPI == EPI_REINSERT || EPI == EPI_REINSERT_ONLY) {
        const long long boff = b * g.sc + off;
        const float keep = 1.0f - ri.alpha * ri.mask[off];
        vr = vr * ri.scale * keep + ri.alpha * ri.obr[boff];
        vi = vi * ri.scale * keep + ri.alpha * ri.obi[boff];
        if (EPI == EPI_REINSERT) {
          const float xr = ri.xr[boff], xi = ri.xi[boff];
          const float mag_new = sqrtf(vr * vr + vi * vi);
          local_s += mag_new;
          local_d += mag_new - sqrtf(xr * xr + xi * xi);
        }
      }
      cr[off] = vr;
      ci[off] = vi;
    }
  }

  if (EPI == EPI_REINSERT) {
    // block sum in a fixed order (warp shuffles, then warps in order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      local_s += __shfl_down_sync(0xffffffffu, local_s, off);
      local_d += __shfl_down_sync(0xffffffffu, local_d, off);
    }
    if (t % 32 == 0) {
      red_s[t / 32] = local_s;
      red_d[t / 32] = local_d;
    }
    __syncthreads();
    if (t == 0) {
      float s = 0.0f, d = 0.0f;
      for (int w = 0; w < NT / 32; ++w) {
        s += red_s[w];
        d += red_d[w];
      }
      const int nblk = gridDim.x * gridDim.y;
      const int blk = blockIdx.y * gridDim.x + blockIdx.x;
      ri.psum[b * nblk + blk] = s;
      ri.pdiff[b * nblk + blk] = d;
    }
  }
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

// The wavelet threshold over finished n×n coefficient planes: the band of
// (r, c) follows from m = max(r, c) (pocs_iter.py:654-666). tau: this
// iteration's (batch, 3·level) thresholds, deepest level first.
__global__ void __launch_bounds__(STATE_THREADS)
wavelet_shrink_kernel(float* sr, float* si, const float* __restrict__ tau,
                      int n, int level, int op, long long plane) {
  const int b = blockIdx.y;
  const float* tb = tau + (long long)b * 3 * level;
  const long long base = b * plane;
  const int s0 = n >> level;  // side of the approximation block
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < plane; e += stride) {
    const int r = (int)(e / n), c = (int)(e % n);
    const int m = r > c ? r : c;
    if (m < s0) continue;  // approximation: tau 0 keeps every coefficient
    int d = 0, s = s0;
    while (m >= 2 * s) {
      s <<= 1;
      ++d;
    }
    const int band = r >= s ? (c >= s ? 2 : 0) : 1;  // cH 0, cV 1, cD 2
    const long long o = base + e;
    const float vr = sr[o], vi = si[o];
    const float f = shrink_factor(vr * vr + vi * vi, tb[3 * d + band], op);
    sr[o] = vr * f;
    si[o] = vi * f;
  }
}

// FFT solve, pass (a): t[b, r] = FFT along W of row r of y_b, one group per
// row. grid (row blocks, batch).
__global__ void __launch_bounds__(LINE_NT_MAX)
solve_rows_forward_kernel(const float* __restrict__ yr,
                          const float* __restrict__ yi,
                          float2* __restrict__ t,
                          const float2* __restrict__ tw_w, LineShape L,
                          int h) {
  extern __shared__ float2 smem[];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w);
  const int r = blockIdx.x * g.count + g.index;
  if (r >= h) return;
  const long long o = ((long long)blockIdx.y * h + r) * w;
  float2 v[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    v[s] = e < w ? make_float2(yr[o + e], yi[o + e]) : make_float2(0.0f, 0.0f);
  }
  line_fft<false>(v, buf, tw, L, g);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < w) t[o + e] = v[s];
  }
}

// FFT solve, pass (b): per column of t_b, FFT along H, shrink with tau[b],
// inverse FFT along H (unscaled), in place through a shared-memory tile of
// columns. grid (column blocks, batch).
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
solve_cols_shrink_kernel(float2* __restrict__ t,
                         const float* __restrict__ tau,  // (B,)
                         const float2* __restrict__ tw_h, LineShape L, int w,
                         int cols, int op) {
  extern __shared__ float2 smem[];
  const int h = L.n;
  const int ls = h + 1;  // padded column stride: the transposing stores of
                         // a row's 16 columns land in 16 banks
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + h;  // column c at tile[c·ls]
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
  load_twiddles(tw, tw_h, h);
  const float thr = tau[b];
  for (int c = g.index; c < nc; c += g.count) {
    float2* col = tile + c * ls;
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      v[q] = e < h ? col[e] : make_float2(0.0f, 0.0f);
    }
    line_fft<false>(v, buf, tw, L, g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float f = shrink_factor(v[q].x * v[q].x + v[q].y * v[q].y, thr,
                                    op);
      v[q] = make_float2(v[q].x * f, v[q].y * f);
    }
    line_fft<true>(v, buf, tw, L, g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      if (e < h) col[e] = v[q];
    }
  }
  __syncthreads();
  if (tl.active && tl.in) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step)
      s[(long long)r * w + tl.c] = tile[tl.c * ls + r];
  }
}

// FFT solve, pass (c): per row r of slice b, inverse FFT along W of t,
// then y = v·scale·(1 − α·mask) + α·obs, and the block's Σ|new| and
// Σ(|new| − |x|) into ri.psum / ri.pdiff[b, blockIdx.x], summed in a fixed
// order (warp shuffles, then the warps in order). One group per row. grid
// (row blocks, batch); blockDim.x is LINE_NT_MAX.
__global__ void __launch_bounds__(LINE_NT_MAX)
solve_rows_inverse_kernel(const float2* __restrict__ t,
                          const float2* __restrict__ tw_w, ReinsertArgs ri,
                          float* __restrict__ yr, float* __restrict__ yi,
                          LineShape L, int h) {
  extern __shared__ float2 smem[];
  __shared__ float red_s[LINE_NT_MAX / 32];
  __shared__ float red_d[LINE_NT_MAX / 32];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w);
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
    line_fft<true>(v, buf, tw, L, g);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      if (e < w) {
        const float keep = 1.0f - ri.alpha * ri.mask[m0 + e];
        const float vr = v[s].x * ri.scale * keep + ri.alpha * ri.obr[o + e];
        const float vi = v[s].y * ri.scale * keep + ri.alpha * ri.obi[o + e];
        const float xr = ri.xr[o + e], xi = ri.xi[o + e];
        const float mag_new = sqrtf(vr * vr + vi * vi);
        local_s += mag_new;
        local_d += mag_new - sqrtf(xr * xr + xi * xi);
        yr[o + e] = vr;
        yi[o + e] = vi;
      }
    }
  }
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
    ri.psum[(long long)b * gridDim.x + blockIdx.x] = s;
    ri.pdiff[(long long)b * gridDim.x + blockIdx.x] = d;
  }
}

// GEMM tiles of an h × w plane: the DCT and WAVELET solves' partial sums
inline int blocks_per_slice(int h, int w) { return ceil_div(w, BN) * ceil_div(h, BM); }

// Row blocks of the FFT solve's pass (c): its partial sums per slice
inline int row_blocks(int h, int w) {
  const LineShape lw = line_shape(w);
  const int threads = lw.t > LINE_NT_MAX ? lw.t : LINE_NT_MAX;
  return ceil_div(h, threads / lw.t);
}

inline int plane_chunks(long long plane) {
  const int c = ceil_div(plane, (long long)STATE_THREADS * 8);
  return c < 64 ? c : 64;
}

template <int EPI, int OPS, bool STRIDED = false>
cudaError_t launch_gemm(const Gemm& g, const ShrinkArgs& sh,
                        const ReinsertArgs& ri, int batch, cudaStream_t stream) {
  dim3 grid(ceil_div(g.n, BN), ceil_div(g.m, BM), batch);
  cgemm_kernel<EPI, OPS, STRIDED><<<grid, NT, 0, stream>>>(g, sh, ri);
  return cudaGetLastError();
}

const ShrinkArgs kNoShrink{nullptr, 0};
const ReinsertArgs kNoReinsert{};

// Complex plane pairs of the batch; plane = rows·columns of one slice.
struct Planes {
  float* re; float* im;
};

// One FFT-basis pass: out = reinsert(ifft2(shrink(fft2(in), tau))),
// through t and s; tau holds one threshold per slice. REINSERT is the last
// product's epilogue: with or without the cost sums.
template <int REINSERT>
cudaError_t fft_chain(const float* in_re, const float* in_im, Planes t,
                      Planes s, float* out_re, float* out_im,
                      const float* fh_re, const float* fh_im,
                      const float* fw_re, const float* fw_im,
                      const ShrinkArgs& shrink, const ReinsertArgs& ri,
                      int batch, int h, int w, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  cudaError_t err;
  // forward: t = F_H @ in, then s = shrink(t @ F_W)
  const Gemm fwd_left{fh_re, fh_im, 0, h, 1.0f, in_re, in_im, plane, w, 1.0f,
                      t.re, t.im, plane, w, h, w, h};
  if ((err = launch_gemm<EPI_STORE, CPLX>(fwd_left, kNoShrink, kNoReinsert,
                                          batch, stream)) != cudaSuccess)
    return err;
  const Gemm fwd_right{t.re, t.im, plane, w, 1.0f, fw_re, fw_im, 0, w, 1.0f,
                       s.re, s.im, plane, w, h, w, w};
  if ((err = launch_gemm<EPI_SHRINK, CPLX>(fwd_right, shrink, kNoReinsert,
                                           batch, stream)) != cudaSuccess)
    return err;
  // inverse: t = conj(F_H) @ s, then out = reinsert((t @ conj(F_W)) / HW)
  const Gemm inv_left{fh_re, fh_im, 0, h, -1.0f, s.re, s.im, plane, w, 1.0f,
                      t.re, t.im, plane, w, h, w, h};
  if ((err = launch_gemm<EPI_STORE, CPLX>(inv_left, kNoShrink, kNoReinsert,
                                          batch, stream)) != cudaSuccess)
    return err;
  const Gemm inv_right{t.re, t.im, plane, w, 1.0f, fw_re, fw_im, 0, w, -1.0f,
                       out_re, out_im, plane, w, h, w, w};
  return launch_gemm<REINSERT, CPLX>(inv_right, kNoShrink, ri, batch, stream);
}

// Solve workspace, carved from the caller's float buffer: `planes` plane
// pairs (y, t and, for the GEMM chains, s), then the partial sums.
struct Work {
  Planes y, t, s;
  float* psum; float* pdiff; float* v; float* cprev;
};

Work carve(float* work, int batch, long long plane, int nblk, int planes) {
  const long long total = plane * batch;
  Work k;
  k.y = {work, work + total};
  k.t = {work + 2 * total, work + 3 * total};
  k.s = planes > 2 ? Planes{work + 4 * total, work + 5 * total}
                   : Planes{nullptr, nullptr};
  k.psum = work + 2 * planes * total;
  k.pdiff = k.psum + (long long)batch * nblk;
  k.v = k.pdiff + (long long)batch * nblk;   // [2][batch]
  k.cprev = k.v + 2 * batch;                 // [2][batch]
  return k;
}

// The FFT solve's plane pairs and partial sums per slice, and the GEMM
// chains'
constexpr int FFT_PLANES = 2;
constexpr int GEMM_PLANES = 3;

size_t work_floats(int batch, int h, int w, int planes, int nblk) {
  return 2 * (size_t)planes * batch * h * w + 2 * (size_t)batch * nblk +
         4 * (size_t)batch;
}

// The FPOCS loop around a basis' chain. chain(j, work, reinsert) enqueues
// iteration j's forward transform of y, threshold, and inverse with the
// reinsertion and cost sums (nblk per slice) back into y.
template <class Chain>
int run_solve(const float* obs_re, const float* obs_im, const float* mask,
              float* out_re, float* out_im, float* cost, float* work,
              int batch, int h, int w, int niter, float alpha, float scale,
              int fast, int nblk, int planes, cudaStream_t stream,
              Chain chain) {
  const long long plane = (long long)h * w;
  const long long total = plane * batch;
  const Work k = carve(work, batch, plane, nblk, planes);

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

}  // namespace

extern "C" {

// Floats of scratch a solve needs: its plane pairs (the FFT solve's y and
// t; the GEMM chains' y, t and s), the per-block partial sums of its cost
// (pass (c)'s row blocks; the GEMM tiles), and the double-buffered v /
// cost_prev. `fft` selects the FFT solve.
size_t p3d_pocs_solve_work_floats(int batch, int h, int w, int fft) {
  return fft ? work_floats(batch, h, w, FFT_PLANES, row_blocks(h, w))
             : work_floats(batch, h, w, GEMM_PLANES, blocks_per_slice(h, w));
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
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  Lines s;
  int err;
  if ((err = lines_for(h, w, LINE_NT_MAX, 0, &s)) != 0) return err;
  if ((err = allow_smem(solve_rows_forward_kernel, s.smem_rows)) != 0)
    return err;
  if ((err = allow_smem(solve_cols_shrink_kernel, s.smem_cols)) != 0)
    return err;
  if ((err = allow_smem(solve_rows_inverse_kernel, s.smem_rows)) != 0)
    return err;
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  const int nblk = row_blocks(h, w);
  const dim3 row_grid(nblk, batch);
  const dim3 col_grid(ceil_div(w, s.cols), batch);
  const float scale = 1.0f / (float)((double)h * (double)w);
  return run_solve(
      obs_re, obs_im, mask, out_re, out_im, cost, work, batch, h, w, niter,
      alpha, scale, fast, nblk, FFT_PLANES, stream,
      [=](int j, const Work& k, const ReinsertArgs& ri) {
        // t's (re, im) planes hold one (B, H, W) complex array
        float2* t = reinterpret_cast<float2*>(k.t.re);
        solve_rows_forward_kernel<<<row_grid, s.nt_w, s.smem_rows, stream>>>(
            k.y.re, k.y.im, t, tww, s.lw, h);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        solve_cols_shrink_kernel<<<col_grid, s.nt_h, s.smem_cols, stream>>>(
            t, decay + (long long)j * batch, twh, s.lh, w, s.cols, op);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        solve_rows_inverse_kernel<<<row_grid, s.nt_w, s.smem_rows, stream>>>(
            t, tww, ri, k.y.re, k.y.im, s.lw, h);
        return cudaGetLastError();
      });
}

// DCT basis: ch = C_H, cht = C_Hᵀ (h, h); cw = C_W, cwt = C_Wᵀ (w, w).
int p3d_pocs_solve_dct(const float* obs_re, const float* obs_im,
                       const float* mask, const float* decay,  // (niter, batch)
                       const float* ch, const float* cht, const float* cw,
                       const float* cwt, float* out_re, float* out_im,
                       float* cost, float* work, int batch, int h, int w,
                       int niter, float alpha, int op, int fast,
                       void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long plane = (long long)h * w;
  return run_solve(
      obs_re, obs_im, mask, out_re, out_im, cost, work, batch, h, w, niter,
      alpha, 1.0f, fast, blocks_per_slice(h, w), GEMM_PLANES, stream,
      [=](int j, const Work& k, const ReinsertArgs& ri) {
        cudaError_t err;
        // forward: t = C_H @ y, then s = shrink(t @ C_Wᵀ)
        const Gemm fwd_left{ch, nullptr, 0, h, 1.0f, k.y.re, k.y.im, plane,
                            w, 1.0f, k.t.re, k.t.im, plane, w, h, w, h};
        if ((err = launch_gemm<EPI_STORE, REAL_A>(
                 fwd_left, kNoShrink, kNoReinsert, batch, stream))
            != cudaSuccess)
          return err;
        const Gemm fwd_right{k.t.re, k.t.im, plane, w, 1.0f, cwt, nullptr, 0,
                             w, 1.0f, k.s.re, k.s.im, plane, w, h, w, w};
        const ShrinkArgs shrink{decay + (long long)j * batch, op};
        if ((err = launch_gemm<EPI_SHRINK, REAL_B>(
                 fwd_right, shrink, kNoReinsert, batch, stream))
            != cudaSuccess)
          return err;
        // inverse: t = C_Hᵀ @ s, then y = reinsert(t @ C_W), scale 1
        const Gemm inv_left{cht, nullptr, 0, h, 1.0f, k.s.re, k.s.im, plane,
                            w, 1.0f, k.t.re, k.t.im, plane, w, h, w, h};
        if ((err = launch_gemm<EPI_STORE, REAL_A>(
                 inv_left, kNoShrink, kNoReinsert, batch, stream))
            != cudaSuccess)
          return err;
        const Gemm inv_right{k.t.re, k.t.im, plane, w, 1.0f, cw, nullptr, 0,
                             w, 1.0f, k.y.re, k.y.im, plane, w, h, w, w};
        return launch_gemm<EPI_REINSERT, REAL_B>(inv_right, kNoShrink, ri,
                                                 batch, stream);
      });
}

// WAVELET basis on square n×n slices, n divisible by 2^level. mats holds,
// level by level from the finest, A_lv then A_lvᵀ, each (n >> lv)².
// decay: (niter, batch, 3·level).
int p3d_pocs_solve_wavelet(const float* obs_re, const float* obs_im,
                           const float* mask, const float* decay,
                           const float* mats, float* out_re, float* out_im,
                           float* cost, float* work, int batch, int n,
                           int level, int niter, float alpha, int op, int fast,
                           void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long plane = (long long)n * n;
  const float* a[32];
  const float* at[32];
  if (level < 1 || level > 31) return (int)cudaErrorInvalidValue;
  long long off = 0;
  for (int lv = 0; lv < level; ++lv) {
    const long long nj = n >> lv;
    a[lv] = mats + off;
    at[lv] = mats + off + nj * nj;
    off += 2 * nj * nj;
  }
  const dim3 shrink_grid(plane_chunks(plane), batch);
  return run_solve(
      obs_re, obs_im, mask, out_re, out_im, cost, work, batch, n, n, niter,
      alpha, 1.0f, fast, blocks_per_slice(n, n), GEMM_PLANES, stream,
      [=](int j, const Work& k, const ReinsertArgs& ri) {
        cudaError_t err;
        // forward, finest level first: t = A @ block, block = t @ Aᵀ; level
        // 0 reads y, deeper levels the top-left block of s, in place
        for (int lv = 0; lv < level; ++lv) {
          const int nj = n >> lv;
          const Planes src = lv == 0 ? k.y : k.s;
          const Gemm left{a[lv], nullptr, 0, nj, 1.0f, src.re, src.im, plane,
                          n, 1.0f, k.t.re, k.t.im, plane, n, nj, nj, nj};
          const Gemm right{k.t.re, k.t.im, plane, n, 1.0f, at[lv], nullptr, 0,
                           nj, 1.0f, k.s.re, k.s.im, plane, n, nj, nj, nj};
          if ((err = lv == 0 ? launch_gemm<EPI_STORE, REAL_A>(
                                   left, kNoShrink, kNoReinsert, batch,
                                   stream)
                             : launch_gemm<EPI_STORE, REAL_A, true>(
                                   left, kNoShrink, kNoReinsert, batch,
                                   stream)) != cudaSuccess)
            return err;
          if ((err = lv == 0 ? launch_gemm<EPI_STORE, REAL_B>(
                                   right, kNoShrink, kNoReinsert, batch,
                                   stream)
                             : launch_gemm<EPI_STORE, REAL_B, true>(
                                   right, kNoShrink, kNoReinsert, batch,
                                   stream)) != cudaSuccess)
            return err;
        }
        wavelet_shrink_kernel<<<shrink_grid, STATE_THREADS, 0, stream>>>(
            k.s.re, k.s.im, decay + (long long)j * batch * 3 * level, n,
            level, op, plane);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        // inverse, deepest level first: t = Aᵀ @ block, block = t @ A; the
        // level-0 right product reinserts into y
        for (int lv = level - 1; lv >= 0; --lv) {
          const int nj = n >> lv;
          const Gemm left{at[lv], nullptr, 0, nj, 1.0f, k.s.re, k.s.im, plane,
                          n, 1.0f, k.t.re, k.t.im, plane, n, nj, nj, nj};
          const Planes dst = lv == 0 ? k.y : k.s;
          const Gemm right{k.t.re, k.t.im, plane, n, 1.0f, a[lv], nullptr, 0,
                           nj, 1.0f, dst.re, dst.im, plane, n, nj, nj, nj};
          if (lv == 0) {
            if ((err = launch_gemm<EPI_STORE, REAL_A>(
                     left, kNoShrink, kNoReinsert, batch, stream))
                != cudaSuccess)
              return err;
            err = launch_gemm<EPI_REINSERT, REAL_B>(right, kNoShrink, ri,
                                                    batch, stream);
          } else {
            if ((err = launch_gemm<EPI_STORE, REAL_A, true>(
                     left, kNoShrink, kNoReinsert, batch, stream))
                != cudaSuccess)
              return err;
            err = launch_gemm<EPI_STORE, REAL_B, true>(
                right, kNoShrink, kNoReinsert, batch, stream);
          }
          if (err != cudaSuccess) return err;
        }
        return cudaSuccess;
      });
}

// Floats of scratch one FFT-basis iteration needs: the t and s planes.
size_t p3d_pocs_iteration_work_floats(int batch, int h, int w) {
  return 4 * (size_t)batch * h * w;
}

// One FFT-basis POCS iteration: out = ifft2(shrink(fft2(x), tau[b])) ·
// (1 − α·mask) + α·obs, no cost. out must not alias x.
int p3d_pocs_iteration(const float* x_re, const float* x_im,
                       const float* obs_re, const float* obs_im,
                       const float* mask, const float* tau,  // (batch,)
                       const float* fh_re, const float* fh_im,  // (h, h)
                       const float* fw_re, const float* fw_im,  // (w, w)
                       float* out_re, float* out_im, float* work, int batch,
                       int h, int w, float alpha, int op,
                       void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long total = (long long)batch * h * w;
  const Planes t{work, work + total};
  const Planes s{work + 2 * total, work + 3 * total};
  const ReinsertArgs ri{mask, obs_re, obs_im, nullptr, nullptr, alpha,
                        1.0f / (float)((double)h * (double)w), nullptr,
                        nullptr};
  return (int)fft_chain<EPI_REINSERT_ONLY>(
      x_re, x_im, t, s, out_re, out_im, fh_re, fh_im, fw_re, fw_im,
      ShrinkArgs{tau, op}, ri, batch, h, w, stream);
}

}  // extern "C"
