// Subband updates of the spectral-stack (SHEARLET, CURVELET) POCS
// iteration, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (ops/kernels/subband.py).
//
// Kernel A, p3d_subband_update, replaces
// pseudo_3d_interpolation_tpu/ops/pallas/subband.py :: subband_update_fused
// (bodies _kernel and _kernel_dense). For slice b, with X_b its spectrum in
// natural order and psi_l the real full-size windows:
//
//   acc_b = Σ_l fft2(shrink(ifft2(X_b·psi_l), tau[b, l]))·psi_l
//
// The TPU kernel holds one slice in VMEM across its (B, L) grid; a 512²
// complex slice is 2 MB and a block here has at most 227 KB of shared
// memory. So each 2-D transform is split into line FFTs in shared memory,
// with one pass through a device-memory scratch between the two axes:
//   (a) per (b, l, block of rows): load X·psi_l, inverse FFT along W;
//   (b) per (b, l, block of columns): inverse FFT along H, scale by
//       1/(H·W), shrink with the kernel's |c|² >= tau² form, forward FFT
//       along H;
//   (c) per (b, block of rows): for l in order, forward FFT along W,
//       multiply by psi_l and accumulate: the sum over l has a fixed order,
//       with no atomics, so the result does not depend on scheduling.
// The scratch holds a chunk of bands, (B, chunk, H, W) (the caller chooses
// the chunk); pass (c) of a later chunk adds to the accumulator of the
// earlier ones.
// Power-of-two lines use an iterative radix-2 FFT, other lengths a direct
// DFT of the line; both read a twiddle table exp(-2πi m/n) built in float64
// on the host. What bounds it: device memory, about 48 bytes moved per
// (slice, band, pixel) over the three passes (the windows, the scratch
// written and read twice, the spectrum), against about 5·log2(H·W)·2 flops
// of FFT per (slice, band, pixel) done from shared memory.
//
// Kernel C, p3d_subband_update_spatial, replaces subband.py ::
// subband_update_fused(spatial_io=True) (body _kernel_spatial): kernel A
// with the top-level transforms inside, spatial x in and spatial out,
//
//   out_b = ifft2(Σ_l fft2(shrink(ifft2(fft2(x_b)·psi_l), tau[b, l]))·psi_l)
//
// for any H×W in natural order. The TPU kernel keeps the slice's spectrum
// and accumulator in VMEM across its (B, L) grid; here both live in device
// memory and the transforms are line passes like kernel A's:
//   (0) per (b, block of columns): forward FFT along H of x into a
//       (B, H, W) spectrum scratch; per (b, block of rows): forward FFT
//       along W in place;
//   (a)-(c) kernel A's passes on that spectrum, the accumulator in the
//       output planes; pass (c) of the last band chunk, whose row blocks
//       hold the complete sum over the bands, also takes the inverse FFT
//       along W in shared memory before it writes;
//   (d) per (b, block of columns): inverse FFT along H, scaled by
//       1/(H·W), in place in the output planes.
// The sum over the bands keeps kernel A's fixed order. What bounds it:
// device memory as kernel A, about 48 bytes per (slice, band, pixel), plus
// about 64 per (slice, pixel) for the new passes (x read, the spectrum
// written, read and written, the output read and written), against
// 5·log2(H·W) flops per pixel of each of the 2·L + 2 2-D FFTs per slice.
//
// Kernel B, p3d_box_group_update, replaces subband.py ::
// box_group_update_fused (body _box_kernel). For one support-cropped group
// with box spectrum xb_b (sr × sc), windows psi_l (sr × sc) and the partial
// DFT rows A_h = F[idx_h] (sr × N_h), A_w = F[idx_w] (sc × N_w):
//
//   c   = A_hᴴ (xb·psi_l) conj(A_w) / (N_h·N_w)     full N_h × N_w field
//   M_b = Σ_l psi_l · (A_h shrink(c, tau[b, l]) A_wᵀ)
//
// The N_h × N_w field of a subband never makes a pass through device
// memory: a block takes (b, l, a range of field rows), forms those rows of
// c 16 at a time in shared memory (each thread two field columns), shrinks
// them, projects them back through A_wᵀ (each warp two box columns) and
// A_h[:, rows], and keeps a partial (sr × sc) sum of its own; a
// second kernel sums the partials and the bands in a fixed order, weighted
// by psi_l. It is bound by the partial-DFT products on the CUDA cores,
// about 2·N_h·N_w·sc complex multiply-adds per (slice, band).

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "shrink.cuh"

namespace {

constexpr int NT = 256;            // threads per block
// complex elements of rows, and of columns, per line block: small enough
// that six blocks share an SM
constexpr int ROW_ELEMS = 2048;
constexpr int COL_ELEMS = 4096;
constexpr int RB = 16;             // field rows per chunk of the box kernel
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use
constexpr int ERR_SMEM = -2;       // the shape needs more shared memory

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a · conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// In-place DFT of `nlines` lines of length n held in shared memory, element
// k of line q at buf[q * ls + k]; tw[m] = exp(-2πi m / n), conjugated for
// the inverse (which is left unscaled). logn >= 0 when n is a power of two
// (radix 2: bit reversal, then the log2 n butterfly stages, two per pass
// through shared memory); otherwise -1, and each output is a direct sum
// into tmp (nlines·n elements), copied back. Every thread of the block
// calls it.
__device__ void fft_lines(float2* buf, float2* tmp, int nlines, int n,
                          int logn, int ls, const float2* tw, bool inv) {
  const int t = threadIdx.x;
  if (n == 1) return;
  if (logn > 0) {
    const int total = nlines << logn;
    for (int e = t; e < total; e += NT) {
      const int q = e >> logn, k = e & (n - 1);
      const int r = __brev(k) >> (32 - logn);
      if (k < r) {
        float2* row = buf + q * ls;
        const float2 a = row[k];
        row[k] = row[r];
        row[r] = a;
      }
    }
    __syncthreads();
    int s = 1;
    // stages s and s + 1 in one round trip: each thread takes the four
    // elements i0 + {0, h, 2h, 3h} through both stages' butterflies
    const int quarter = n >> 2;
    for (; s + 1 <= logn; s += 2) {
      const int h = 1 << (s - 1);
      const int step1 = n >> s, step2 = n >> (s + 1);
      for (int e = t; e < nlines * quarter; e += NT) {
        const int q = e >> (logn - 2);
        const int u = e & (quarter - 1);
        const int j = u & (h - 1);
        const int i0 = ((u >> (s - 1)) << (s + 1)) + j;
        float2 w1 = tw[j * step1], w2 = tw[j * step2];
        float2 w3 = tw[(j + h) * step2];
        if (inv) {
          w1.y = -w1.y;
          w2.y = -w2.y;
          w3.y = -w3.y;
        }
        float2* row = buf + q * ls;
        const float2 a0 = row[i0], a1 = cmul(row[i0 + h], w1);
        const float2 a2 = row[i0 + 2 * h], a3 = cmul(row[i0 + 3 * h], w1);
        const float2 b0 = cadd(a0, a1), b1 = csub(a0, a1);
        const float2 b2 = cmul(cadd(a2, a3), w2);
        const float2 b3 = cmul(csub(a2, a3), w3);
        row[i0] = cadd(b0, b2);
        row[i0 + h] = cadd(b1, b3);
        row[i0 + 2 * h] = csub(b0, b2);
        row[i0 + 3 * h] = csub(b1, b3);
      }
      __syncthreads();
    }
    if (s == logn) {  // the last stage alone when log2 n is odd
      const int half = 1 << (s - 1);
      const int halfn = n >> 1;
      for (int e = t; e < nlines * halfn; e += NT) {
        const int q = e >> (logn - 1);
        const int u = e & (halfn - 1);
        const int j = u & (half - 1);
        const int i0 = ((u >> (s - 1)) << s) + j;
        float2 w = tw[j];  // n >> s == 1 at the last stage
        if (inv) w.y = -w.y;
        float2* row = buf + q * ls;
        const float2 a = row[i0];
        const float2 b = cmul(row[i0 + half], w);
        row[i0] = cadd(a, b);
        row[i0 + half] = csub(a, b);
      }
      __syncthreads();
    }
    return;
  }
  const int total = nlines * n;
  for (int e = t; e < total; e += NT) {
    const int q = e / n, k = e - q * n;
    const float2* row = buf + q * ls;
    float2 acc = make_float2(0.0f, 0.0f);
    int m = 0;  // (j·k) mod n
    for (int j = 0; j < n; ++j) {
      const float2 w = tw[m];
      acc = cadd(acc, inv ? cmul_conj(row[j], w) : cmul(row[j], w));
      m += k;
      if (m >= n) m -= n;
    }
    tmp[e] = acc;
  }
  __syncthreads();
  for (int e = t; e < total; e += NT) {
    const int q = e / n, k = e - q * n;
    buf[q * ls + k] = tmp[e];
  }
  __syncthreads();
}

// (a) rows: scratch[b, l] = inverse FFT along W of X_b·psi_l, for `rows`
// rows per block. grid (row blocks, bands of the chunk, batch).
__global__ void __launch_bounds__(NT)
rows_inverse_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ psi,  // (bands of chunk, H, W)
                    const float2* __restrict__ tw_w,
                    float2* __restrict__ scratch,   // (B, lc, H, W)
                    int h, int w, int logw, int rows, int lc) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + w;
  float2* tmp = buf + rows * w;
  const int b = blockIdx.z, l = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, h - r0);
  const int n = nr * w;
  const long long plane = (long long)h * w;
  for (int e = threadIdx.x; e < w; e += NT) tw[e] = tw_w[e];
  const long long xo = b * plane + (long long)r0 * w;
  const float* p = psi + l * plane + (long long)r0 * w;
  for (int e = threadIdx.x; e < n; e += NT) {
    const float pv = p[e];
    buf[e] = make_float2(xr[xo + e] * pv, xi[xo + e] * pv);
  }
  __syncthreads();
  fft_lines(buf, tmp, nr, w, logw, w, tw, true);
  float2* out = scratch + ((long long)b * lc + l) * plane + (long long)r0 * w;
  for (int e = threadIdx.x; e < n; e += NT) out[e] = buf[e];
}

// (b) columns: inverse FFT along H, scale, shrink, forward FFT along H, in
// place in the scratch. grid (column blocks, bands of the chunk, batch).
__global__ void __launch_bounds__(NT)
cols_shrink_kernel(float2* __restrict__ scratch,
                   const float* __restrict__ tau,  // (B, nbands)
                   const float2* __restrict__ tw_h, int h, int w, int logh,
                   int cols, int lc, int nbands, int l0, float scale, int op) {
  extern __shared__ float2 smem[];
  const int ls = h + 1;  // padded column stride: the transposing stores
                         // of neighbouring columns land in other banks
  float2* tw = smem;
  float2* buf = tw + h;
  float2* tmp = buf + cols * ls;
  const int b = blockIdx.z, l = blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const int n = h * nc;
  const long long plane = (long long)h * w;
  for (int e = threadIdx.x; e < h; e += NT) tw[e] = tw_h[e];
  float2* s = scratch + ((long long)b * lc + l) * plane + c0;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / nc, c = e - r * nc;
    buf[c * ls + r] = s[(long long)r * w + c];
  }
  __syncthreads();
  fft_lines(buf, tmp, nc, h, logh, ls, tw, true);
  const float t = tau[(long long)b * nbands + l0 + l];
  for (int e = threadIdx.x; e < n; e += NT) {
    const int c = e / h, r = e - c * h;
    float2 v = buf[c * ls + r];
    v.x *= scale;
    v.y *= scale;
    const float f = shrink_factor(v.x * v.x + v.y * v.y, t, op);
    buf[c * ls + r] = make_float2(v.x * f, v.y * f);
  }
  __syncthreads();
  fft_lines(buf, tmp, nc, h, logh, ls, tw, false);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / nc, c = e - r * nc;
    s[(long long)r * w + c] = buf[c * ls + r];
  }
}

// (c) rows: acc_b (+)= Σ_l (forward FFT along W of scratch[b, l])·psi_l,
// the bands of the chunk in order. grid (row blocks, batch). With INV_W
// (kernel C's last chunk) the block holds the complete sum of its rows and
// writes their inverse FFT along W instead.
template <bool INV_W>
__global__ void __launch_bounds__(NT)
rows_forward_acc_kernel(const float2* __restrict__ scratch,
                        const float* __restrict__ psi,
                        const float2* __restrict__ tw_w,
                        float* __restrict__ accr, float* __restrict__ acci,
                        int h, int w, int logw, int rows, int lc, int first) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + w;
  float2* acc = buf + rows * w;
  float2* tmp = acc + rows * w;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, h - r0);
  const int n = nr * w;
  const long long plane = (long long)h * w;
  for (int e = threadIdx.x; e < w; e += NT) tw[e] = tw_w[e];
  const long long ao = b * plane + (long long)r0 * w;
  // each thread owns the same accumulator elements for every band
  for (int e = threadIdx.x; e < n; e += NT)
    acc[e] = first ? make_float2(0.0f, 0.0f)
                   : make_float2(accr[ao + e], acci[ao + e]);
  for (int l = 0; l < lc; ++l) {
    const float2* s =
        scratch + ((long long)b * lc + l) * plane + (long long)r0 * w;
    for (int e = threadIdx.x; e < n; e += NT) buf[e] = s[e];
    __syncthreads();
    fft_lines(buf, tmp, nr, w, logw, w, tw, false);
    const float* p = psi + l * plane + (long long)r0 * w;
    for (int e = threadIdx.x; e < n; e += NT) {
      const float pv = p[e];
      const float2 v = buf[e];
      acc[e] = make_float2(acc[e].x + v.x * pv, acc[e].y + v.y * pv);
    }
    __syncthreads();
  }
  if (INV_W) fft_lines(acc, tmp, nr, w, logw, w, tw, true);
  for (int e = threadIdx.x; e < n; e += NT) {
    accr[ao + e] = acc[e].x;
    acci[ao + e] = acc[e].y;
  }
}

// Kernel C's column passes: FFT along H (inverse when `inv`) of the
// (re, im) planes `in`, times `scale`, into the planes `out`, which may be
// `in` (a block reads and writes only its own columns). grid (column
// blocks, batch).
__global__ void __launch_bounds__(NT)
cols_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw_h, int h, int w,
                int logh, int cols, int inv, float scale) {
  extern __shared__ float2 smem[];
  const int ls = h + 1;  // padded column stride, as in cols_shrink_kernel
  float2* tw = smem;
  float2* buf = tw + h;
  float2* tmp = buf + cols * ls;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const int n = h * nc;
  const long long off = (long long)b * h * w + c0;
  for (int e = threadIdx.x; e < h; e += NT) tw[e] = tw_h[e];
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / nc, c = e - r * nc;
    const long long o = off + (long long)r * w + c;
    buf[c * ls + r] = make_float2(in_re[o], in_im[o]);
  }
  __syncthreads();
  fft_lines(buf, tmp, nc, h, logh, ls, tw, inv != 0);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / nc, c = e - r * nc;
    const long long o = off + (long long)r * w + c;
    const float2 v = buf[c * ls + r];
    out_re[o] = v.x * scale;
    out_im[o] = v.y * scale;
  }
}

// Kernel C's row pass: forward FFT along W of the (re, im) planes, in
// place. grid (row blocks, batch).
__global__ void __launch_bounds__(NT)
rows_fft_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ tw_w, int h, int w, int logw,
                int rows) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + w;
  float2* tmp = buf + rows * w;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, h - r0);
  const int n = nr * w;
  const long long o = (long long)b * h * w + (long long)r0 * w;
  for (int e = threadIdx.x; e < w; e += NT) tw[e] = tw_w[e];
  for (int e = threadIdx.x; e < n; e += NT)
    buf[e] = make_float2(re[o + e], im[o + e]);
  __syncthreads();
  fft_lines(buf, tmp, nr, w, logw, w, tw, false);
  for (int e = threadIdx.x; e < n; e += NT) {
    re[o + e] = buf[e].x;
    im[o + e] = buf[e].y;
  }
}

// Kernel B, first pass. grid (row splits, lg, batch): the block of split s
// owns field rows [s·rows_per_split, ...) of subband l of slice b and
// writes its own partial (sr × sc) sum.
__global__ void __launch_bounds__(NT)
box_partial_kernel(const float* __restrict__ xbr,
                   const float* __restrict__ xbi,  // (B, sr, sc)
                   const float* __restrict__ psi,  // (lg, sr, sc)
                   const float* __restrict__ tau,  // (B, lg)
                   const float* __restrict__ ahr,
                   const float* __restrict__ ahi,  // (sr, nh)
                   const float* __restrict__ awr,
                   const float* __restrict__ awi,  // (sc, nw)
                   float2* __restrict__ part,      // (B, lg, nsplit, sr, sc)
                   int sr, int sc, int nh, int nw, int rb, int rows_per_split,
                   float scale, int op) {
  extern __shared__ float2 smem[];
  float2* ahc = smem;           // sr × rb: A_h[i, r0 + r]
  float2* y = ahc + sr * rb;    // rb × sc: rows of A_hᴴ (xb·psi_l)
  float2* crow = y + rb * sc;   // rb × nw: shrunk rows of the field
  float2* tt = crow + rb * nw;  // rb × sc: those rows through A_wᵀ
  const int b = blockIdx.z, l = blockIdx.y, s = blockIdx.x;
  const int lg = gridDim.y, nsplit = gridDim.x;
  const int area = sr * sc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = xbr + (long long)b * area;
  const float* xi = xbi + (long long)b * area;
  const float* p = psi + (long long)l * area;
  float2* out = part + (((long long)b * lg + l) * nsplit + s) * area;
  const float t = tau[(long long)b * lg + l];
  const int r_begin = s * rows_per_split;
  const int r_end = min(nh, r_begin + rows_per_split);
  // the partial sum lives in `out`, each element owned by one thread
  for (int e = tid; e < area; e += NT) out[e] = make_float2(0.0f, 0.0f);
  for (int r0 = r_begin; r0 < r_end; r0 += rb) {
    const int nr = min(rb, r_end - r0);
    for (int e = tid; e < sr * nr; e += NT) {
      const int i = e / nr, r = e - i * nr;
      const long long o = (long long)i * nh + r0 + r;
      ahc[i * rb + r] = make_float2(ahr[o], ahi[o]);
    }
    __syncthreads();
    for (int e = tid; e < nr * sc; e += NT) {
      const int r = e / sc, j = e - r * sc;
      float2 acc = make_float2(0.0f, 0.0f);
      for (int i = 0; i < sr; ++i) {
        const float pv = p[i * sc + j];
        const float2 v = make_float2(xr[i * sc + j] * pv, xi[i * sc + j] * pv);
        acc = cadd(acc, cmul_conj(v, ahc[i * rb + r]));
      }
      y[r * sc + j] = acc;
    }
    __syncthreads();
    // each thread forms two field columns, n0 and n0 + NT, so that every
    // row value of y read from shared memory feeds both
    for (int n0 = tid; n0 < nw; n0 += 2 * NT) {
      const int n1 = n0 + NT;
      const bool has1 = n1 < nw;
      float2 c0[RB], c1[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        c0[r] = c1[r] = make_float2(0.0f, 0.0f);
      for (int j = 0; j < sc; ++j) {
        const long long o = (long long)j * nw;
        const float2 a0 = make_float2(awr[o + n0], awi[o + n0]);
        const float2 a1 = has1 ? make_float2(awr[o + n1], awi[o + n1])
                               : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const float2 yv = y[r * sc + j];
            c0[r] = cadd(c0[r], cmul_conj(yv, a0));
            c1[r] = cadd(c1[r], cmul_conj(yv, a1));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          float2 v = make_float2(c0[r].x * scale, c0[r].y * scale);
          float f = shrink_factor(v.x * v.x + v.y * v.y, t, op);
          crow[r * nw + n0] = make_float2(v.x * f, v.y * f);
          if (has1) {
            v = make_float2(c1[r].x * scale, c1[r].y * scale);
            f = shrink_factor(v.x * v.x + v.y * v.y, t, op);
            crow[r * nw + n1] = make_float2(v.x * f, v.y * f);
          }
        }
      }
    }
    __syncthreads();
    // one warp per pair of box columns j0, j0 + 1, lanes over the field
    // columns, then a fixed-order shuffle reduction
    for (int j0 = 2 * warp; j0 < sc; j0 += 2 * (NT / 32)) {
      const int j1 = j0 + 1;
      const bool has1 = j1 < sc;
      float2 acc0[RB], acc1[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc0[r] = acc1[r] = make_float2(0.0f, 0.0f);
      for (int n = lane; n < nw; n += 32) {
        const long long o0 = (long long)j0 * nw + n;
        const long long o1 = o0 + nw;
        const float2 a0 = make_float2(awr[o0], awi[o0]);
        const float2 a1 = has1 ? make_float2(awr[o1], awi[o1])
                               : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const float2 cv = crow[r * nw + n];
            acc0[r] = cadd(acc0[r], cmul(cv, a0));
            acc1[r] = cadd(acc1[r], cmul(cv, a1));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          float2 v0 = acc0[r], v1 = acc1[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v0.x += __shfl_xor_sync(0xffffffffu, v0.x, off);
            v0.y += __shfl_xor_sync(0xffffffffu, v0.y, off);
            v1.x += __shfl_xor_sync(0xffffffffu, v1.x, off);
            v1.y += __shfl_xor_sync(0xffffffffu, v1.y, off);
          }
          if (lane == 0) {
            tt[r * sc + j0] = v0;
            if (has1) tt[r * sc + j1] = v1;
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < area; e += NT) {
      const int i = e / sc, j = e - i * sc;
      float2 acc = out[e];
      for (int r = 0; r < nr; ++r)
        acc = cadd(acc, cmul(ahc[i * rb + r], tt[r * sc + j]));
      out[e] = acc;
    }
    __syncthreads();
  }
}

// Kernel B, second pass: M[b] = Σ_l psi_l · Σ_s part[b, l, s], both sums in
// index order.
__global__ void __launch_bounds__(NT)
box_reduce_kernel(const float2* __restrict__ part,
                  const float* __restrict__ psi, float* __restrict__ mr,
                  float* __restrict__ mi, int batch, int lg, int nsplit,
                  int area) {
  const long long total = (long long)batch * area;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < total;
       e += (long long)gridDim.x * NT) {
    const int b = (int)(e / area), k = (int)(e - (long long)b * area);
    float2 m = make_float2(0.0f, 0.0f);
    for (int l = 0; l < lg; ++l) {
      const float2* pl = part + ((long long)b * lg + l) * nsplit * area + k;
      float2 s = make_float2(0.0f, 0.0f);
      for (int q = 0; q < nsplit; ++q) s = cadd(s, pl[(long long)q * area]);
      const float pv = psi[(long long)l * area + k];
      m = make_float2(m.x + s.x * pv, m.y + s.y * pv);
    }
    mr[e] = m.x;
    mi[e] = m.y;
  }
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// log2 n for a power of two, else -1
inline int log2_or_neg(int n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Lets `kernel` use `bytes` of dynamic shared memory; ERR_SMEM when a
// block cannot have that much.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return ERR_SMEM;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The line blocks of kernels A and C for an h × w slice: rows per row
// block, columns per column block, and the shared memory of the row
// passes (a), the column passes (b) and the accumulating row pass (c).
struct Lines {
  int logh, logw, rows, cols;
  size_t smem_a, smem_b, smem_c;
};

Lines lines_for(int h, int w) {
  Lines s;
  s.logh = log2_or_neg(h);
  s.logw = log2_or_neg(w);
  s.rows = h < ROW_ELEMS / w ? h : (ROW_ELEMS / w > 0 ? ROW_ELEMS / w : 1);
  s.cols = w < COL_ELEMS / h ? w : (COL_ELEMS / h > 0 ? COL_ELEMS / h : 1);
  const size_t c8 = sizeof(float2);
  s.smem_a = c8 * (w + (size_t)s.rows * w * (s.logw < 0 ? 2 : 1));
  s.smem_b = c8 * (h + (size_t)s.cols * (h + 1)
                   + (s.logh < 0 ? (size_t)s.cols * h : 0));
  s.smem_c = c8 * (w + (size_t)s.rows * w * (s.logw < 0 ? 3 : 2));
  return s;
}

// Passes (a)-(c) over every band chunk: acc = Σ_l fft2(shrink(ifft2(
// X·psi_l)))·psi_l from the spectrum planes (xr, xi); with `inv_last` the
// last chunk's pass (c) also takes the inverse FFT along W.
int band_passes(const Lines& s, const float* xr, const float* xi,
                const float* psi, const float* tau, const float2* twh,
                const float2* tww, float* acc_re, float* acc_im,
                float2* scratch, int batch, int h, int w, int nbands, int lc,
                int op, bool inv_last, cudaStream_t stream) {
  int err;
  if ((err = allow_smem(rows_inverse_kernel, s.smem_a)) != 0) return err;
  if ((err = allow_smem(cols_shrink_kernel, s.smem_b)) != 0) return err;
  if ((err = allow_smem(rows_forward_acc_kernel<false>, s.smem_c)) != 0)
    return err;
  if (inv_last &&
      (err = allow_smem(rows_forward_acc_kernel<true>, s.smem_c)) != 0)
    return err;
  const long long plane = (long long)h * w;
  const float scale = 1.0f / (float)((double)h * (double)w);
  for (int l0 = 0; l0 < nbands; l0 += lc) {
    const int nl = lc < nbands - l0 ? lc : nbands - l0;
    const float* p = psi + (long long)l0 * plane;
    rows_inverse_kernel<<<dim3(ceil_div(h, s.rows), nl, batch), NT,
                          s.smem_a, stream>>>(xr, xi, p, tww, scratch, h, w,
                                              s.logw, s.rows, nl);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    cols_shrink_kernel<<<dim3(ceil_div(w, s.cols), nl, batch), NT, s.smem_b,
                         stream>>>(scratch, tau, twh, h, w, s.logh, s.cols,
                                   nl, nbands, l0, scale, op);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const dim3 grid(ceil_div(h, s.rows), batch);
    if (inv_last && l0 + nl >= nbands)
      rows_forward_acc_kernel<true><<<grid, NT, s.smem_c, stream>>>(
          scratch, p, tww, acc_re, acc_im, h, w, s.logw, s.rows, nl,
          l0 == 0);
    else
      rows_forward_acc_kernel<false><<<grid, NT, s.smem_c, stream>>>(
          scratch, p, tww, acc_re, acc_im, h, w, s.logw, s.rows, nl,
          l0 == 0);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0, ERR_SMEM when a line does not fit a block's shared memory, or
// the first CUDA error met while enqueuing. `work` holds batch·lc·h·w
// complex values (2 floats each), lc <= nbands the bands per chunk. Nothing
// is synchronised; every launch goes to `stream`.
int p3d_subband_update(const float* x_re, const float* x_im,
                       const float* psi,  // (nbands, h, w)
                       const float* tau,  // (batch, nbands)
                       const float* tw_h, const float* tw_w,  // (n, 2)
                       float* acc_re, float* acc_im, float* work, int batch,
                       int h, int w, int nbands, int lc, int op,
                       void* stream_handle) {
  return band_passes(lines_for(h, w), x_re, x_im, psi, tau,
                     reinterpret_cast<const float2*>(tw_h),
                     reinterpret_cast<const float2*>(tw_w), acc_re, acc_im,
                     reinterpret_cast<float2*>(work), batch, h, w, nbands, lc,
                     op, false, static_cast<cudaStream_t>(stream_handle));
}

// Kernel C. Returns as p3d_subband_update. `spec` holds the spectrum's
// (re, im) planes, 2·batch·h·w floats; `work` as p3d_subband_update's;
// (out_re, out_im) take the spatial result and serve as the accumulator
// until the last pass. nbands >= 1.
int p3d_subband_update_spatial(const float* x_re, const float* x_im,
                               const float* psi,  // (nbands, h, w)
                               const float* tau,  // (batch, nbands)
                               const float* tw_h, const float* tw_w,
                               float* out_re, float* out_im, float* spec,
                               float* work, int batch, int h, int w,
                               int nbands, int lc, int op,
                               void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Lines s = lines_for(h, w);
  int err;
  if ((err = allow_smem(cols_fft_kernel, s.smem_b)) != 0) return err;
  if ((err = allow_smem(rows_fft_kernel, s.smem_a)) != 0) return err;
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  float* spec_re = spec;
  float* spec_im = spec + (long long)batch * h * w;
  const dim3 col_grid(ceil_div(w, s.cols), batch);
  cols_fft_kernel<<<col_grid, NT, s.smem_b, stream>>>(
      x_re, x_im, spec_re, spec_im, twh, h, w, s.logh, s.cols, 0, 1.0f);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  rows_fft_kernel<<<dim3(ceil_div(h, s.rows), batch), NT, s.smem_a,
                    stream>>>(spec_re, spec_im, tww, h, w, s.logw, s.rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = band_passes(s, spec_re, spec_im, psi, tau, twh, tww, out_re,
                         out_im, reinterpret_cast<float2*>(work), batch, h,
                         w, nbands, lc, op, true, stream)) != 0)
    return err;
  cols_fft_kernel<<<col_grid, NT, s.smem_b, stream>>>(
      out_re, out_im, out_re, out_im, twh, h, w, s.logh, s.cols, 1,
      1.0f / (float)((double)h * (double)w));
  return (int)cudaGetLastError();
}

// Returns 0, ERR_SMEM, or the first CUDA error met while enqueuing. `work`
// holds batch·lg·nsplit·sr·sc complex partial sums (2 floats each).
int p3d_box_group_update(const float* xb_re, const float* xb_im,
                         const float* psi,  // (lg, sr, sc)
                         const float* tau,  // (batch, lg)
                         const float* ah_re, const float* ah_im,  // (sr, nh)
                         const float* aw_re, const float* aw_im,  // (sc, nw)
                         float* m_re, float* m_im, float* work, int batch,
                         int lg, int sr, int sc, int nh, int nw, int nsplit,
                         int op, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  int rb = RB;
  size_t smem = 0;
  for (; rb > 0; rb /= 2) {
    smem = sizeof(float2) * ((size_t)sr * rb + 2 * (size_t)rb * sc +
                             (size_t)rb * nw);
    if (smem <= (size_t)MAX_SMEM) break;
  }
  if (rb == 0) return ERR_SMEM;
  int err;
  if ((err = allow_smem(box_partial_kernel, smem)) != 0) return err;
  const int per_split = ceil_div(ceil_div(nh, nsplit), rb) * rb;
  float2* part = reinterpret_cast<float2*>(work);
  box_partial_kernel<<<dim3(nsplit, lg, batch), NT, smem, stream>>>(
      xb_re, xb_im, psi, tau, ah_re, ah_im, aw_re, aw_im, part, sr, sc, nh,
      nw, rb, per_split, 1.0f / (float)((double)nh * (double)nw), op);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long total = (long long)batch * sr * sc;
  const int blocks = ceil_div(total, NT) < 4096 ? ceil_div(total, NT) : 4096;
  box_reduce_kernel<<<blocks, NT, 0, stream>>>(part, psi, m_re, m_im, batch,
                                               lg, nsplit, sr * sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
