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
// memory. So each 2-D transform is split into line FFTs, with one pass
// through a device-memory scratch between the two axes. The line FFTs are
// fft_lines.cuh's: each line in the registers of its own group of threads,
// which synchronises only itself, so a line can be skipped alone.
//
// Most of each window is zero (at 512² the SHEARLET windows are nonzero on
// about half their rows, the CURVELET ones a little less), and a row of
// X·psi_l whose window row is zero is a zero line both where it is inverted
// along W and where its forward transform is weighted by psi_l. So the
// passes take only each band's support rows, listed once per window stack
// on the host (a CSR list, and a (band, row) -> packed row table), and the
// scratch stores only those rows, (B, support rows of the chunk, W):
//   (a) per (b, block of support rows): load X·psi_l, inverse FFT along W;
//   (b) per (b, l, block of 16 columns): load the band's support rows of
//       the columns (128-byte row segments) into shared memory, zeros
//       elsewhere; per column inverse FFT along H, scale by 1/(H·W), shrink
//       with the kernel's |c|² >= tau² form, forward FFT along H; store the
//       support rows back;
//   (c) per (b, block of rows): for l in order, where row r is in band l's
//       support, forward FFT along W, multiply by psi_l and accumulate in
//       registers: the sum over l has a fixed order, with no atomics, so the
//       result does not depend on scheduling.
// The caller cuts the bands into chunks whose support rows fit the scratch;
// pass (c) of a later chunk adds to the accumulator of the earlier ones.
// What bounds it: the column pass, whose transforms stay dense (two H-line
// FFTs of every column of every band) and run at about 8 TFLOP/s, bound by
// the engine's throughput at two 512-thread blocks an SM (64 registers a
// thread); it takes about 60% of a call at 32×512² on an H100 SXM
// (700 W). The row passes move about 20 and 12 bytes per (slice, support
// pixel) and run near the memory rate (2.3-2.5 TB/s there).
//
// Kernel C, p3d_subband_update_spatial, replaces subband.py ::
// subband_update_fused(spatial_io=True) (body _kernel_spatial): kernel A
// with the top-level transforms inside, spatial x in and spatial out,
//
//   out_b = ifft2(Σ_l fft2(shrink(ifft2(fft2(x_b)·psi_l), tau[b, l]))·psi_l)
//
// for any H×W in natural order. The TPU kernel keeps the slice's spectrum
// and accumulator in VMEM across its (B, L) grid; here both live in device
// memory and the transforms are line passes on the same engine:
//   (0) per (b, block of columns): forward FFT along H of x into a
//       (B, H, W) spectrum scratch; per (b, block of rows): forward FFT
//       along W in place;
//   (a)-(c) kernel A's passes on that spectrum, the accumulator in the
//       output planes; pass (c) of the last band chunk, whose rows hold the
//       complete sum over the bands, also takes the inverse FFT along W of
//       every row, whatever the bands cover, before it writes;
//   (d) per (b, block of columns): inverse FFT along H, scaled by
//       1/(H·W), in place in the output planes.
// The sum over the bands keeps kernel A's fixed order. What bounds it:
// kernel A's passes; the new passes move about 64 bytes per (slice,
// pixel) (x read, the spectrum written, read and written, the output read
// and written) and add about 3% to a call at 32×512².
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

#include "fft_lines.cuh"
#include "shrink.cuh"

namespace {

constexpr int NT = 256;           // threads per block (line kernels: at least)
constexpr int LINE_NT_MAX = 512;  // a line kernel's block: one 4096 line
constexpr int COL_TILE = 16;      // columns of a column block: 128-byte rows
constexpr int RB = 16;            // field rows per chunk of the box kernel
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int ERR_SMEM = -2;      // the shape needs more shared memory
constexpr int ERR_SHAPE = -3;     // a side is longer than MAX_LINE

// The twiddle table of the block's lines into shared memory; every thread
// of the block calls it.
__device__ __forceinline__ void load_twiddles(float2* tw, const float2* src,
                                              int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) tw[e] = src[e];
  __syncthreads();
}

// A column block's walk over its tile: thread c + cols·i (i < step) takes
// column c of rows i, i + step, ...; neighbouring threads read neighbouring
// columns of a row (one 128-byte segment for 16 columns). `in`: the column
// lies inside the slice (the last block may hold fewer than cols).
struct TileWalk {
  int c, r0, step;
  bool active, in;
  __device__ __forceinline__ TileWalk(int cols, int nc) {
    step = blockDim.x / cols;
    r0 = threadIdx.x / cols;
    c = threadIdx.x - r0 * cols;
    active = r0 < step;
    in = c < nc;
  }
};

// (a) support rows: scratch[b, q] = inverse FFT along W of row rows[q] of
// X_b·psi_{bands[q]}, one group per row. grid (row blocks, batch).
__global__ void __launch_bounds__(LINE_NT_MAX)
rows_inverse_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ psi,  // (nbands, H, W)
                    const int* __restrict__ rows,   // the chunk's support rows
                    const int* __restrict__ bands,  // and their bands
                    const float2* __restrict__ tw_w,
                    float2* __restrict__ scratch,   // (B, nrows, W)
                    LineShape L, int h, int nrows) {
  extern __shared__ float2 smem[];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w);
  const int q = blockIdx.x * g.count + g.index;
  if (q >= nrows) return;
  const int b = blockIdx.y, r = rows[q];
  const long long plane = (long long)h * w;
  const long long xo = b * plane + (long long)r * w;
  const float* p = psi + bands[q] * plane + (long long)r * w;
  float2 v[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    v[s] = make_float2(0.0f, 0.0f);
    if (e < w) {
      const float pv = p[e];
      v[s] = make_float2(xr[xo + e] * pv, xi[xo + e] * pv);
    }
  }
  line_fft<true>(v, buf, tw, L, g);
  float2* out = scratch + ((long long)b * nrows + q) * w;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < w) out[e] = v[s];
  }
}

// (b) columns of band l0 + blockIdx.y: inverse FFT along H, scale, shrink,
// forward FFT along H, the band's support rows in place in the scratch.
// grid (column blocks, bands of the chunk, batch).
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
cols_shrink_kernel(float2* __restrict__ scratch,  // (B, nrows, W)
                   const int* __restrict__ slot,  // (nbands, H)
                   const float* __restrict__ tau,  // (B, nbands)
                   const float2* __restrict__ tw_h, LineShape L, int w,
                   int cols, int nrows, int p0, int nbands, int l0,
                   float scale, int op) {
  extern __shared__ float2 smem[];
  const int h = L.n;
  const int ls = h + 1;  // padded column stride: the transposing stores of
                         // a row's 16 columns land in 16 banks
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + h;  // column c at tile[c·ls]
  float2* bufs = tile + cols * ls;
  float2* buf = bufs + g.index * line_buf(h);
  int* rs = reinterpret_cast<int*>(bufs + g.count * line_buf(h));
  const int b = blockIdx.z, l = l0 + blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const int* sl = slot + (long long)l * h;  // packed row of row r, or -1
  float2* s = scratch + (long long)b * nrows * w + c0;
  for (int r = threadIdx.x; r < h; r += blockDim.x) rs[r] = sl[r];
  __syncthreads();
  const TileWalk tl(cols, nc);
  if (tl.active) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step) {
      const int k = rs[r];
      tile[tl.c * ls + r] = k >= 0 && tl.in ? s[(long long)(k - p0) * w + tl.c]
                                            : make_float2(0.0f, 0.0f);
    }
  }
  load_twiddles(tw, tw_h, h);
  const float t = tau[(long long)b * nbands + l];
  for (int c = g.index; c < nc; c += g.count) {
    float2* col = tile + c * ls;
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      v[q] = e < h ? col[e] : make_float2(0.0f, 0.0f);
    }
    line_fft<true>(v, buf, tw, L, g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 u = make_float2(v[q].x * scale, v[q].y * scale);
      const float f = shrink_factor(u.x * u.x + u.y * u.y, t, op);
      v[q] = make_float2(u.x * f, u.y * f);
    }
    line_fft<false>(v, buf, tw, L, g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      if (e < h) col[e] = v[q];
    }
  }
  __syncthreads();
  if (tl.active && tl.in) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step) {
      const int k = rs[r];
      if (k >= 0) s[(long long)(k - p0) * w + tl.c] = tile[tl.c * ls + r];
    }
  }
}

// (c) rows: acc_b (+)= Σ_l (forward FFT along W of scratch row)·psi_l over
// the bands [l0, l1) in order, for the bands whose support holds the row;
// one group per row, its sum in registers. grid (row blocks, batch). With
// INV_W (kernel C's last chunk) the group holds the complete sum of its row
// and writes its inverse FFT along W instead.
template <bool INV_W>
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
rows_forward_acc_kernel(const float2* __restrict__ scratch,
                        const int* __restrict__ slot,
                        const float* __restrict__ psi,
                        const float2* __restrict__ tw_w,
                        float* __restrict__ accr, float* __restrict__ acci,
                        LineShape L, int h, int nrows, int p0, int l0, int l1,
                        int first) {
  extern __shared__ float2 smem[];
  const int w = L.n;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + w + g.index * line_buf(w);
  load_twiddles(tw, tw_w, w);
  const int r = blockIdx.x * g.count + g.index;
  if (r >= h) return;
  const int b = blockIdx.y;
  const long long plane = (long long)h * w;
  const long long ao = b * plane + (long long)r * w;
  float2 acc[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    acc[s] = first || e >= w ? make_float2(0.0f, 0.0f)
                             : make_float2(accr[ao + e], acci[ao + e]);
  }
  for (int l = l0; l < l1; ++l) {
    const int k = slot[(long long)l * h + r];
    if (k < 0) continue;
    const float2* row = scratch + ((long long)b * nrows + (k - p0)) * w;
    float2 v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      v[s] = e < w ? row[e] : make_float2(0.0f, 0.0f);
    }
    line_fft<false>(v, buf, tw, L, g);
    const float* p = psi + l * plane + (long long)r * w;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      if (e < w) {
        const float pv = p[e];
        acc[s] = make_float2(acc[s].x + v[s].x * pv, acc[s].y + v[s].y * pv);
      }
    }
  }
  if (INV_W) line_fft<true>(acc, buf, tw, L, g);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < w) {
      accr[ao + e] = acc[s].x;
      acci[ao + e] = acc[s].y;
    }
  }
}

// Kernel C's column passes: FFT along H (inverse when `inv`) of the
// (re, im) planes `in`, times `scale`, into the planes `out`, which may be
// `in` (a block reads all of its columns before it writes them). grid
// (column blocks, batch).
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
cols_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw_h, LineShape L,
                int w, int cols, int inv, float scale) {
  extern __shared__ float2 smem[];
  const int h = L.n, ls = h + 1;  // padded as in cols_shrink_kernel
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + h;
  float2* buf = tile + cols * ls + g.index * line_buf(h);
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const long long off = (long long)b * h * w + c0;
  const TileWalk tl(cols, nc);
  if (tl.active) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step) {
      const long long o = off + (long long)r * w + tl.c;
      tile[tl.c * ls + r] = tl.in ? make_float2(in_re[o], in_im[o])
                                  : make_float2(0.0f, 0.0f);
    }
  }
  load_twiddles(tw, tw_h, h);
  for (int c = g.index; c < nc; c += g.count) {
    float2* col = tile + c * ls;
    float2 v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      v[s] = e < h ? col[e] : make_float2(0.0f, 0.0f);
    }
    if (inv)
      line_fft<true>(v, buf, tw, L, g);
    else
      line_fft<false>(v, buf, tw, L, g);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;
      if (e < h) col[e] = make_float2(v[s].x * scale, v[s].y * scale);
    }
  }
  __syncthreads();
  if (tl.active && tl.in) {
#pragma unroll 4
    for (int r = tl.r0; r < h; r += tl.step) {
      const long long o = off + (long long)r * w + tl.c;
      const float2 v = tile[tl.c * ls + r];
      out_re[o] = v.x;
      out_im[o] = v.y;
    }
  }
}

// Kernel C's row pass, and the line engine's own entry: FFT along W
// (inverse, unscaled, with INV) of the (re, im) planes, in place, one group
// per row. grid (row blocks, batch).
template <bool INV>
__global__ void __launch_bounds__(LINE_NT_MAX)
rows_fft_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ tw_w, LineShape L, int h) {
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
    v[s] = e < w ? make_float2(re[o + e], im[o + e]) : make_float2(0.0f, 0.0f);
  }
  line_fft<INV>(v, buf, tw, L, g);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < w) {
      re[o + e] = v[s].x;
      im[o + e] = v[s].y;
    }
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

// Lets `kernel` use `bytes` of dynamic shared memory; ERR_SMEM when a
// block cannot have that much.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return ERR_SMEM;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// threads of a line kernel's block: NT, or one whole group of a long line
inline int line_threads(const LineShape& L) { return L.t > NT ? L.t : NT; }

// The line blocks of kernels A and C for an h × w slice: the lines along H
// and W, the threads of the column and row blocks, the columns of a column
// block, and the shared memory of the row and column kernels.
struct Lines {
  LineShape lh, lw;
  int nt_h, nt_w, cols;
  size_t smem_rows, smem_cols;
};

// 0, ERR_SHAPE for a side out of [1, MAX_LINE], or ERR_SMEM
int lines_for(int h, int w, Lines* s) {
  if (h < 1 || w < 1 || h > MAX_LINE || w > MAX_LINE) return ERR_SHAPE;
  s->lh = line_shape(h);
  s->lw = line_shape(w);
  s->nt_w = line_threads(s->lw);
  const size_t c8 = sizeof(float2);
  s->smem_rows = c8 * (w + (size_t)(s->nt_w / s->lw.t) * line_buf(w));
  // a column block: one group per column of its tile, up to LINE_NT_MAX
  // threads (whole warps), its columns' tile, the groups' buffers and the
  // band's row table
  const int t = s->lh.t;
  const size_t col = c8 * (h + 1);
  int cols = COL_TILE < w ? COL_TILE : w;
  for (;; --cols) {
    int nt = cols * t < LINE_NT_MAX ? cols * t : LINE_NT_MAX;
    nt = nt > t ? nt : t;
    s->nt_h = (nt + 31) / 32 * 32;
    s->smem_cols = c8 * (h + (size_t)(s->nt_h / t) * line_buf(h)) +
                   cols * col + sizeof(int) * (size_t)h;
    if (cols == 1 || s->smem_cols <= (size_t)MAX_SMEM) break;
  }
  s->cols = cols;
  return s->smem_cols > (size_t)MAX_SMEM ? ERR_SMEM : 0;
}

// Passes (a)-(c) over every band chunk: acc = Σ_l fft2(shrink(ifft2(
// X·psi_l)))·psi_l from the spectrum planes (xr, xi); with `inv_last` the
// last chunk's pass (c) also takes the inverse FFT along W. `support`
// (device) holds the support rows in band order, their bands (nnz each)
// and the (nbands, h) table of packed rows; `offsets` (host, nbands + 1)
// the CSR offsets; `chunks` (host, nchunks + 1) the chunks' first bands.
int band_passes(const Lines& s, const float* xr, const float* xi,
                const float* psi, const float* tau, const float2* twh,
                const float2* tww, const int* support, const int* offsets,
                const int* chunks, int nchunks, float* acc_re, float* acc_im,
                float2* scratch, int batch, int h, int w, int nbands, int op,
                bool inv_last, cudaStream_t stream) {
  int err;
  if ((err = allow_smem(rows_inverse_kernel, s.smem_rows)) != 0) return err;
  if ((err = allow_smem(cols_shrink_kernel, s.smem_cols)) != 0) return err;
  if ((err = allow_smem(rows_forward_acc_kernel<false>, s.smem_rows)) != 0)
    return err;
  if (inv_last &&
      (err = allow_smem(rows_forward_acc_kernel<true>, s.smem_rows)) != 0)
    return err;
  const int nnz = offsets[nbands];
  const int* rows = support;
  const int* bands = support + nnz;
  const int* slot = support + 2 * (long long)nnz;
  const float scale = 1.0f / (float)((double)h * (double)w);
  const int per_block = s.nt_w / s.lw.t;  // rows of a row block
  for (int ci = 0; ci < nchunks; ++ci) {
    const int l0 = chunks[ci], l1 = chunks[ci + 1];
    const int p0 = offsets[l0], nrows = offsets[l1] - p0;
    if (nrows > 0) {
      rows_inverse_kernel<<<dim3(ceil_div(nrows, per_block), batch), s.nt_w,
                            s.smem_rows, stream>>>(xr, xi, psi, rows + p0,
                                                   bands + p0, tww, scratch,
                                                   s.lw, h, nrows);
      if ((err = (int)cudaGetLastError()) != 0) return err;
      cols_shrink_kernel<<<dim3(ceil_div(w, s.cols), l1 - l0, batch), s.nt_h,
                           s.smem_cols, stream>>>(scratch, slot, tau, twh,
                                                  s.lh, w, s.cols, nrows, p0,
                                                  nbands, l0, scale, op);
      if ((err = (int)cudaGetLastError()) != 0) return err;
    }
    const dim3 grid(ceil_div(h, per_block), batch);
    if (inv_last && ci == nchunks - 1)
      rows_forward_acc_kernel<true><<<grid, s.nt_w, s.smem_rows, stream>>>(
          scratch, slot, psi, tww, acc_re, acc_im, s.lw, h, nrows, p0, l0, l1,
          ci == 0);
    else
      rows_forward_acc_kernel<false><<<grid, s.nt_w, s.smem_rows, stream>>>(
          scratch, slot, psi, tww, acc_re, acc_im, s.lw, h, nrows, p0, l0, l1,
          ci == 0);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0, ERR_SMEM or ERR_SHAPE for a shape the line blocks do not take,
// or the first CUDA error met while enqueuing. `support`, `offsets` and
// `chunks` as band_passes takes them (nchunks >= 1, the last chunk ending
// at nbands); `work` holds batch·(the most support rows of a chunk)·w
// complex values (2 floats each). Nothing is synchronised; every launch
// goes to `stream`.
int p3d_subband_update(const float* x_re, const float* x_im,
                       const float* psi,  // (nbands, h, w)
                       const float* tau,  // (batch, nbands)
                       const float* tw_h, const float* tw_w,  // (n, 2)
                       const int* support, const int* offsets,
                       const int* chunks, float* acc_re, float* acc_im,
                       float* work, int batch, int h, int w, int nbands,
                       int nchunks, int op, void* stream_handle) {
  Lines s;
  const int err = lines_for(h, w, &s);
  if (err != 0) return err;
  return band_passes(s, x_re, x_im, psi, tau,
                     reinterpret_cast<const float2*>(tw_h),
                     reinterpret_cast<const float2*>(tw_w), support, offsets,
                     chunks, nchunks, acc_re, acc_im,
                     reinterpret_cast<float2*>(work), batch, h, w, nbands, op,
                     false, static_cast<cudaStream_t>(stream_handle));
}

// Kernel C. Returns as p3d_subband_update. `spec` holds the spectrum's
// (re, im) planes, 2·batch·h·w floats; `work` and the support as
// p3d_subband_update's; (out_re, out_im) take the spatial result and serve
// as the accumulator until the last pass. nbands >= 1.
int p3d_subband_update_spatial(const float* x_re, const float* x_im,
                               const float* psi,  // (nbands, h, w)
                               const float* tau,  // (batch, nbands)
                               const float* tw_h, const float* tw_w,
                               const int* support, const int* offsets,
                               const int* chunks, float* out_re,
                               float* out_im, float* spec, float* work,
                               int batch, int h, int w, int nbands,
                               int nchunks, int op, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  Lines s;
  int err;
  if ((err = lines_for(h, w, &s)) != 0) return err;
  if ((err = allow_smem(cols_fft_kernel, s.smem_cols)) != 0) return err;
  if ((err = allow_smem(rows_fft_kernel<false>, s.smem_rows)) != 0)
    return err;
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  float* spec_re = spec;
  float* spec_im = spec + (long long)batch * h * w;
  const dim3 col_grid(ceil_div(w, s.cols), batch);
  cols_fft_kernel<<<col_grid, s.nt_h, s.smem_cols, stream>>>(
      x_re, x_im, spec_re, spec_im, twh, s.lh, w, s.cols, 0, 1.0f);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  rows_fft_kernel<false><<<dim3(ceil_div(h, s.nt_w / s.lw.t), batch), s.nt_w,
                           s.smem_rows, stream>>>(spec_re, spec_im, tww, s.lw,
                                                  h);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = band_passes(s, spec_re, spec_im, psi, tau, twh, tww, support,
                         offsets, chunks, nchunks, out_re, out_im,
                         reinterpret_cast<float2*>(work), batch, h, w,
                         nbands, op, true, stream)) != 0)
    return err;
  cols_fft_kernel<<<col_grid, s.nt_h, s.smem_cols, stream>>>(
      out_re, out_im, out_re, out_im, twh, s.lh, w, s.cols, 1,
      1.0f / (float)((double)h * (double)w));
  return (int)cudaGetLastError();
}

// The line engine alone: the FFT (inverse, unscaled, when `inv`) of each of
// `nlines` lines of length n of the (re, im) planes, in place. Returns as
// p3d_subband_update.
int p3d_line_fft(float* re, float* im, const float* tw, int nlines, int n,
                 int inv, void* stream_handle) {
  if (n < 1 || n > MAX_LINE) return ERR_SHAPE;
  const LineShape L = line_shape(n);
  const int nt = line_threads(L);
  const size_t smem = sizeof(float2) * (n + (size_t)(nt / L.t) * line_buf(n));
  const dim3 grid(ceil_div(nlines, nt / L.t), 1);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const float2* t = reinterpret_cast<const float2*>(tw);
  int err;
  if (inv) {
    if ((err = allow_smem(rows_fft_kernel<true>, smem)) != 0) return err;
    rows_fft_kernel<true><<<grid, nt, smem, stream>>>(re, im, t, L, nlines);
  } else {
    if ((err = allow_smem(rows_fft_kernel<false>, smem)) != 0) return err;
    rows_fft_kernel<false><<<grid, nt, smem, stream>>>(re, im, t, L, nlines);
  }
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
