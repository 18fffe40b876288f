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
// with box spectrum xb_b (sr × sc), windows psi_l (sr × sc) and the box's
// fft-layout indices idx_h (sr) and idx_w (sc) into the N_h × N_w grid,
// with A_h = F[idx_h] and A_w = F[idx_w] the partial DFT rows:
//
//   c   = A_hᴴ (xb·psi_l) conj(A_w) / (N_h·N_w)     full N_h × N_w field
//   M_b = Σ_l psi_l · (A_h shrink(c, tau[b, l]) A_wᵀ)
//
// A_hᴴ v is the unscaled inverse DFT of a zero N_h-line that holds v at
// idx_h, and A_h u the DFT of u read at idx_h (the same along W). So the
// products are pruned line FFTs of the full field, the box scattered in
// and gathered out, in three passes on the fft_lines.cuh engine through one
// scratch G of (B, lg, sc, N_h) complex values (each box column's field
// column contiguous):
//   (1) per (b, l, box column k): xb[:, k]·psi_l[:, k] scattered into a
//       zero N_h-line at idx_h, inverse FFT, into G[b, l, k];
//   (2) per (b, l, field row n): G[b, l, :, n] scattered into a zero
//       N_w-line at idx_w, inverse FFT, scaled by 1/(N_h·N_w), shrunk,
//       forward FFT, gathered at idx_w back into G[b, l, :, n] (in place:
//       those sc values belong to the row's group alone);
//   (3) per (b, k): for l in order, forward FFT of G[b, l, k], gathered at
//       idx_h, times psi_l[:, k], summed in registers; M[b, :, k] is
//       written once. The sum over the bands has a fixed order, with no
//       atomics, so the result does not depend on scheduling.
// The plan's box indices are distinct (the range around 0, wrapped, and a
// padded tail just above +bound), so each scatter and gather is exact.
//
// The percentile route (p3d_subband_keys / p3d_subband_shrink for kernel
// A, p3d_box_keys / p3d_box_shrink for kernel B): with a `*-percentile`
// threshold, tau[b, l] is a percentile of |c_l| over the whole field
// (JAX ops/shearlet.py :: pocs_subband_apply, its plain apply, which no
// Pallas kernel takes), so no coefficient can be shrunk before c_l is
// whole. Each kernel is split at the threshold: pass 1 runs the passes up
// to c_l and writes |c_l| (sqrt of abs2_rn, as Cplx.abs rounds it) of
// every pixel of the band into a float32 key buffer, straight from the
// registers of the line FFT, and counts the keys' first digit into the
// band's histogram as it writes them (order_keys.cuh), so that
// band_percentile.cu reads the keys once; pass 2 shrinks c_l testing
// abs2_rn against tau² (the coefficient that sets tau is judged as its
// key was) and runs the rest of the kernel. For kernel A, c_l is kept:
// pass 1 (cols_keys_kernel) writes it, column by column beside the keys,
// into a (B, chunk bands, W, H) complex buffer, and pass 2
// (cols_kept_kernel) loads it and runs only the forward column FFT: 8
// bytes written and read per (slice, band, pixel) in place of one inverse
// H-line FFT of every column (1.8 ms less a 32×512² SHEARLET call on an
// H100 than computing c_l again from pass 1's scratch).
// For kernel B, pass 2 computes c_l again from G: keeping c would move 8
// bytes each way per (slice, band, field pixel), more than a pruned
// recompute costs. Where the box's W indices are a wrapped range of s
// frequencies and the host found a power of two s' >= s for it
// (box_line_plan), the row pass takes its pruned form (below: P = N_w/s'
// s'-point lines a row in place of one N_w-point line, tiles of 64 rows,
// one histogram flush a tile); elsewhere (the split plans' narrow groups,
// a side no such s' divides) the general form, box_rows_kernel, whose
// two N_w-line FFTs of every field row run at the engine's throughput
// (about 9 TFLOP/s, 80-90% of a call at batch 32 on 512² on an H100 SXM
// at 700 W). The column passes add 2·sc·5·N_h·log2 N_h, and G moves
// about 32·N_h·sc bytes per (slice, band). The general row pass and the
// summing column pass keep two blocks an SM (64 registers a thread), as
// the subband kernels' heavy passes do.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "fft_lines.cuh"
#include "order_keys.cuh"
#include "shrink.cuh"

namespace {

constexpr int NT = 256;  // threads per block (line kernels: at least)

// the box row pass's forms (box_rows_kernel)
enum LinePass { PASS_SHRINK = 0, PASS_SHRINK_RN = 1, PASS_KEYS = 2 };

// threads of a line kernel's block: NT, or one whole group of a long line
inline int line_threads(const LineShape& L) { return L.t > NT ? L.t : NT; }

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
// grid (column blocks, bands of the chunk, batch). tau[b·tau_ld +
// blockIdx.y] is the band's threshold.
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
cols_shrink_kernel(float2* __restrict__ scratch,  // (B, nrows, W)
                   const int* __restrict__ slot,  // (nbands, H)
                   const float* __restrict__ tau,  // (B, tau_ld), from l0
                   const float2* __restrict__ tw_h, LineShape L, int w,
                   int cols, int nrows, int p0, int tau_ld, int l0,
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
  const float t = tau[(long long)b * tau_ld + blockIdx.y];
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

// (b) of the percentile route's pass 1, band l0 + blockIdx.y: the inverse
// FFT along H of its columns and the scale, as cols_shrink_kernel takes
// them, then from each group's registers: |c| of every (row, column) into
// keys, column by column, (B, gridDim.y, W, H) (a segment's keys serve the
// selection in any order, and a column's are one coalesced run), their
// first digits into the band's row of hist (B, gridDim.y, HIST_COLS), and
// c itself into cl, laid out as the keys, for cols_kept_kernel. The
// scratch is left as it was. grid as cols_shrink_kernel's; shared memory
// as its, and the block's packed histogram after the slot table (its
// column tile sized with it, so it may hold fewer columns).
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
cols_keys_kernel(const float2* __restrict__ scratch,  // (B, nrows, W)
                 const int* __restrict__ slot,        // (nbands, H)
                 const float2* __restrict__ tw_h, LineShape L, int w,
                 int cols, int nrows, int p0, int l0, float scale,
                 float* __restrict__ keys, unsigned* __restrict__ hist,
                 float2* __restrict__ cl) {
  extern __shared__ float2 smem[];
  const int h = L.n;
  const int ls = h + 1;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + h;
  float2* bufs = tile + cols * ls;
  float2* buf = bufs + g.index * line_buf(h);
  int* rs = reinterpret_cast<int*>(bufs + g.count * line_buf(h));
  unsigned* bins = reinterpret_cast<unsigned*>(rs + h);
  const int b = blockIdx.z, l = l0 + blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const int* sl = slot + (long long)l * h;
  const float2* s = scratch + (long long)b * nrows * w + c0;
  for (int r = threadIdx.x; r < h; r += blockDim.x) rs[r] = sl[r];
  hist_zero(bins);
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
  const long long seg = (long long)b * gridDim.y + blockIdx.y;
  for (int c = g.index; c < nc; c += g.count) {
    const float2* col = tile + c * ls;
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      v[q] = e < h ? col[e] : make_float2(0.0f, 0.0f);
    }
    line_fft<true>(v, buf, tw, L, g);
    const long long o = (seg * w + c0 + c) * h;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      const float2 u = make_float2(v[q].x * scale, v[q].y * scale);
      const float key = __fsqrt_rn(abs2_rn(u));
      if (e < h) {
        keys[o + e] = key;
        cl[o + e] = u;
      }
      hist_add(bins, key, e < h, g.mask, g.t);
    }
  }
  __syncthreads();
  hist_flush(bins, hist + seg * HIST_COLS);
}

// (b) of the percentile route's pass 2 with c_l kept, band l0 +
// blockIdx.y: c of its columns loaded from cl (cols_keys_kernel's),
// shrunk with tau[b·tau_ld + blockIdx.y] testing |c|² as abs2_rn rounds it,
// forward FFT along H, the band's support rows stored into the scratch.
// grid and shared memory as cols_shrink_kernel's.
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
cols_kept_kernel(float2* __restrict__ scratch,  // (B, nrows, W)
                 const int* __restrict__ slot,  // (nbands, H)
                 const float* __restrict__ tau,  // (B, tau_ld), from l0
                 const float2* __restrict__ tw_h, LineShape L, int w,
                 int cols, int nrows, int p0, int tau_ld, int l0, int op,
                 const float2* __restrict__ cl) {
  extern __shared__ float2 smem[];
  const int h = L.n;
  const int ls = h + 1;
  const Group g = make_group(L.t);
  float2* tw = smem;
  float2* tile = tw + h;
  float2* bufs = tile + cols * ls;
  float2* buf = bufs + g.index * line_buf(h);
  int* rs = reinterpret_cast<int*>(bufs + g.count * line_buf(h));
  const int b = blockIdx.z, l = l0 + blockIdx.y;
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const int* sl = slot + (long long)l * h;
  for (int r = threadIdx.x; r < h; r += blockDim.x) rs[r] = sl[r];
  load_twiddles(tw, tw_h, h);
  const float t = tau[(long long)b * tau_ld + blockIdx.y];
  const long long seg = (long long)b * gridDim.y + blockIdx.y;
  for (int c = g.index; c < nc; c += g.count) {
    const float2* cc = cl + (seg * w + c0 + c) * h;
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      const float2 u = e < h ? cc[e] : make_float2(0.0f, 0.0f);
      const float f = shrink_factor(abs2_rn(u), t, op);
      v[q] = make_float2(u.x * f, u.y * f);
    }
    line_fft<false>(v, buf, tw, L, g);
    float2* col = tile + c * ls;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = g.j + q * g.t;
      if (e < h) col[e] = v[q];
    }
  }
  __syncthreads();
  const TileWalk tl(cols, nc);
  if (tl.active && tl.in) {
    float2* s = scratch + (long long)b * nrows * w + c0;
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

// Kernel B's position table: pos[e] = i where idx[i] = e, else -1, for the
// n elements of a line; every thread of the block calls it. An index
// outside the line is dropped rather than written past the table (the
// wrapper's indices are checked once on the host, not per call).
__device__ __forceinline__ void box_positions(int* pos,
                                              const int* __restrict__ idx,
                                              int n, int count) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) pos[e] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int e = idx[i];
    if (e >= 0 && e < n) pos[e] = i;
  }
  __syncthreads();
}

// Kernel B, pass (1): G[b, l, k] = inverse FFT along H of box column k of
// xb_b·psi_l scattered at idx_h, one group per box column. grid (column
// blocks, lg, batch).
__global__ void __launch_bounds__(LINE_NT_MAX)
box_cols_inverse_kernel(const float* __restrict__ xbr,
                        const float* __restrict__ xbi,  // (B, sr, sc)
                        const float* __restrict__ psi,  // (lg, sr, sc)
                        const int* __restrict__ idx_h,  // (sr,)
                        const float2* __restrict__ tw_h,
                        float2* __restrict__ g,         // (B, lg, sc, nh)
                        LineShape L, int sr, int sc) {
  extern __shared__ float2 smem[];
  const int nh = L.n;
  const Group grp = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + nh + grp.index * line_buf(nh);
  int* pos = reinterpret_cast<int*>(tw + nh + grp.count * line_buf(nh));
  box_positions(pos, idx_h, nh, sr);
  load_twiddles(tw, tw_h, nh);
  const int k = blockIdx.x * grp.count + grp.index;
  if (k >= sc) return;
  const int l = blockIdx.y, b = blockIdx.z;
  const long long area = (long long)sr * sc;
  const float* xr = xbr + b * area + k;
  const float* xi = xbi + b * area + k;
  const float* p = psi + l * area + k;
  float2 v[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = grp.j + s * grp.t;
    const int i = e < nh ? pos[e] : -1;
    v[s] = make_float2(0.0f, 0.0f);
    if (i >= 0) {
      const float pv = p[(long long)i * sc];
      v[s] = make_float2(xr[(long long)i * sc] * pv,
                         xi[(long long)i * sc] * pv);
    }
  }
  line_fft<true>(v, buf, tw, L, grp);
  float2* out = g + (((long long)b * gridDim.y + l) * sc + k) * nh;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = grp.j + s * grp.t;
    if (e < nh) out[e] = v[s];
  }
}

// Kernel B, pass (2): field row n of band l of slice b, in place in G:
// scatter at idx_w, inverse FFT along W, scale, shrink, forward FFT along
// W, gather at idx_w; one group per row. grid (row blocks, lg, batch).
// MODE (LinePass): PASS_SHRINK is kernel B's; PASS_KEYS (the percentile
// route's pass 1) writes |c| of the row's N_w field values into keys (B,
// lg, N_h, N_w), counts their first digits into the band's row of hist
// (B, lg, HIST_COLS; the block's packed histogram after the shared memory
// of the other forms) and leaves G as it was; PASS_SHRINK_RN (its pass 2) tests
// |c|² as abs2_rn rounds it.
template <int MODE>
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
box_rows_kernel(float2* __restrict__ g,          // (B, lg, sc, nh)
                const int* __restrict__ idx_w,   // (sc,)
                const float* __restrict__ tau,   // (B, lg)
                const float2* __restrict__ tw_w, LineShape L, int nh, int sc,
                float scale, int op, float* __restrict__ keys,
                unsigned* __restrict__ hist) {
  extern __shared__ float2 smem[];
  const int nw = L.n;
  const Group grp = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + nw + grp.index * line_buf(nw);
  int* pos = reinterpret_cast<int*>(tw + nw + grp.count * line_buf(nw));
  unsigned* bins = reinterpret_cast<unsigned*>(pos + nw);
  if (MODE == PASS_KEYS) hist_zero(bins);
  box_positions(pos, idx_w, nw, sc);
  load_twiddles(tw, tw_w, nw);
  const int n = blockIdx.x * grp.count + grp.index;
  const int l = blockIdx.y, b = blockIdx.z, lg = gridDim.y;
  if (MODE == PASS_KEYS) {
    // every thread stays for the histogram's flush
    if (n < nh) {
      const float2* row = g + ((long long)b * lg + l) * sc * nh + n;
      float2 v[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int e = grp.j + s * grp.t;
        const int k = e < nw ? pos[e] : -1;
        v[s] = k >= 0 ? row[(long long)k * nh] : make_float2(0.0f, 0.0f);
      }
      line_fft<true>(v, buf, tw, L, grp);
      float* kr = keys + (((long long)b * lg + l) * nh + n) * nw;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int e = grp.j + s * grp.t;
        const float2 u = make_float2(v[s].x * scale, v[s].y * scale);
        const float key = __fsqrt_rn(abs2_rn(u));
        if (e < nw) kr[e] = key;
        hist_add(bins, key, e < nw, grp.mask, grp.t);
      }
    }
    __syncthreads();
    hist_flush(bins, hist + ((long long)b * lg + l) * HIST_COLS);
    return;
  }
  if (n >= nh) return;
  float2* row = g + ((long long)b * lg + l) * sc * nh + n;  // k at k·nh
  const float t = tau[(long long)b * lg + l];
  int ks[8];
  float2 v[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = grp.j + s * grp.t;
    ks[s] = e < nw ? pos[e] : -1;
    v[s] = ks[s] >= 0 ? row[(long long)ks[s] * nh] : make_float2(0.0f, 0.0f);
  }
  line_fft<true>(v, buf, tw, L, grp);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float2 u = make_float2(v[s].x * scale, v[s].y * scale);
    const float f = shrink_factor(
        MODE == PASS_SHRINK_RN ? abs2_rn(u) : u.x * u.x + u.y * u.y, t, op);
    v[s] = make_float2(u.x * f, u.y * f);
  }
  line_fft<false>(v, buf, tw, L, grp);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (ks[s] >= 0) row[(long long)ks[s] * nh] = v[s];
}

// Kernel B, pass (3): M[b, :, k] = Σ_l psi_l[:, k] · (forward FFT along H
// of G[b, l, k]) at idx_h, the bands in order, the sum in registers; one
// group per box column. grid (column blocks, batch).
__global__ void __launch_bounds__(LINE_NT_MAX, 2)
box_cols_forward_kernel(const float2* __restrict__ g,   // (B, lg, sc, nh)
                        const float* __restrict__ psi,  // (lg, sr, sc)
                        const int* __restrict__ idx_h,
                        const float2* __restrict__ tw_h,
                        float* __restrict__ mr, float* __restrict__ mi,
                        LineShape L, int lg, int sr, int sc) {
  extern __shared__ float2 smem[];
  const int nh = L.n;
  const Group grp = make_group(L.t);
  float2* tw = smem;
  float2* buf = tw + nh + grp.index * line_buf(nh);
  int* pos = reinterpret_cast<int*>(tw + nh + grp.count * line_buf(nh));
  box_positions(pos, idx_h, nh, sr);
  load_twiddles(tw, tw_h, nh);
  const int k = blockIdx.x * grp.count + grp.index;
  if (k >= sc) return;
  const int b = blockIdx.y;
  const long long area = (long long)sr * sc;
  int is[8];
  float2 acc[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = grp.j + s * grp.t;
    is[s] = e < nh ? pos[e] : -1;
    acc[s] = make_float2(0.0f, 0.0f);
  }
  for (int l = 0; l < lg; ++l) {
    const float2* col = g + (((long long)b * lg + l) * sc + k) * nh;
    float2 v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = grp.j + s * grp.t;
      v[s] = e < nh ? col[e] : make_float2(0.0f, 0.0f);
    }
    line_fft<false>(v, buf, tw, L, grp);
    const float* p = psi + l * area + k;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (is[s] >= 0) {
        const float pv = p[(long long)is[s] * sc];
        acc[s] = make_float2(acc[s].x + v[s].x * pv, acc[s].y + v[s].y * pv);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (is[s] >= 0) {
      const long long o = b * area + (long long)is[s] * sc + k;
      mr[o] = acc[s].x;
      mi[o] = acc[s].y;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel B's pruned row pass: the percentile route's form (box_keys,
// box_shrink) for a box whose W indices are a wrapped range of s
// frequencies, with s' the power of two the host chose for it
// (ops/kernels/subband.py :: box_line_plan: s <= s', 16 <= s' <=
// min(N_w / 4, 256), s' divides N_w). With N_w = P·s' and x_j the row's
// box value at the signed frequency j,
//
//   c[P·q + r] = Σ_j x_j ω^{j·(P·q + r)} = IFFT_s'(y_r)[q],
//   y_r[j mod s'] = x_j ω^{j·r}                      (ω = exp(2πi/N_w)),
//
// so a row's inverse is P s'-point transforms of pre-twiddled classes r,
// and the s frequencies land on distinct slots j mod s' = idx mod s' of
// each class's line. A class's line belongs to t = s'/16 threads, thread j
// holding its elements j + t·e (e < 16): a 16-point DFT of its own
// elements in registers, the line's twiddles, one exchange through shared
// memory and t-point DFTs (none for t = 1), after which thread j holds the
// outputs j + t·e. The N_w/16 threads of a row are numbered i = r + P·j,
// so thread i holds the row's pixels i + (N_w/16)·e: neighbouring lanes
// hold neighbouring pixels, and the keys are written coalesced from the
// registers, their first digits counted as they are (order_keys.cuh).
// box_shrink runs the transpose: the same lines forward on the shrunk row,
// class by class, then each box column k sums the P classes' outputs at
// its slot, twiddled by ω^{-idx_k·r}, in class order (no atomics). At 512
// a row is one warp (t = 1, 4, 8 for the 16-, 40- and 72-side groups; P =
// 32, 8, 4), so an exchange syncs the warp alone; a row whose N_w/16
// threads do not divide 32 syncs the block.
//
// A block takes a tile of up to PRUNE_ROWS field rows of one (slice, band)
// (fewer than 65536 keys, which the packed histogram's counts allow),
// PRUNE_NT / (N_w/16) rows at a time: it loads the tile's box columns from
// G once, coalesced along the rows, builds its tables (the classes'
// twiddles ω^{-idx_k·r}, the line's twiddles, the box column of each
// slot), and flushes its histogram once. Both kernels compute c with
// pruned_row_c, the same code on the same inputs, so box_shrink's |c|²
// (abs2_rn) is the square of box_keys's key bit for bit and the
// coefficient that sets tau is judged as its key was.
// What bounds it: box_keys must write 4 bytes a field pixel (the keys),
// beside 5·log2 s' + 6 flops a pixel of lines and twiddles; box_shrink
// moves only G's box columns and runs the lines both ways, 2·(P·5·s'·
// log2 s' + 6·N_w) flops a row. On an H100 both run at several times those
// bounds (PERF.md §6, row 4b): each key's correctly rounded square root
// and first-digit count (a shuffle, a ballot and a shared atomic a run)
// cost about as much as its share of the lines, and the lines wait on
// shared memory, so the kernels run three blocks an SM.

constexpr int PE = 16;          // elements of a pruned line a thread holds
constexpr int PRUNE_NT = 256;   // threads of a pruned row block
constexpr int PRUNE_ROWS = 64;  // field rows of a block's tile, at most
// The pruned kernels run three blocks an SM (80 registers a thread at
// most): their lines wait on shared memory, and two blocks leave the
// schedulers idle. A tile is cut (to 32 rows at least) while its block
// would take more than a third of the SM's 228 KB of shared memory, 1 KB
// of each block reserved.
constexpr int PRUNE_BLOCKS = 3;
constexpr size_t PRUNE_SMEM = 233472 / PRUNE_BLOCKS - 1024;

// The pruned row pass's shape: a row of n = N_w pixels, lines of sl = s',
// p = n / sl classes of t = sl / 16 threads, tr = n / 16 threads a row, w
// rows at a time, tiles of `rows` rows, sc box columns; the places of the
// block's shared tables in float2 (the tile, stride rs; the classes'
// twiddles, stride tws; the line's twiddles; nbuf row buffers of buf,
// the last a spare for the idle threads of a block whose rows leave
// some), then the ints (each slot's box column, the box indices) and,
// for box_keys, the packed histogram.
struct Pruned {
  int n, sl, p, t, tr, w, rows, sc;
  int rs, tws, buf, nbuf, o_twc, o_twl, o_buf, n_f2;
  bool warp;   // a row's threads lie inside one warp
  size_t smem;
};

// 0, ERR_SHAPE for a line the pruned pass does not take, or ERR_SMEM.
inline int pruned_rows(int nw, int line, int sc, bool keys, Pruned* q) {
  if (line < PE || line > PE * PE || (line & (line - 1)) != 0 ||
      nw % line != 0 || 4 * line > nw || sc < 1 || sc > line ||
      nw / PE > PRUNE_NT)
    return ERR_SHAPE;
  q->n = nw;
  q->sl = line;
  q->p = nw / line;
  q->t = line / PE;
  q->tr = nw / PE;
  q->w = PRUNE_NT / q->tr;
  q->nbuf = q->w + (PRUNE_NT % q->tr != 0 ? 1 : 0);
  q->warp = 32 % q->tr == 0;
  q->sc = sc;
  q->tws = q->p + 1;
  const int xbuf = q->t > 1 ? PE * (q->tr + q->p) : 0;  // the exchange
  const int zbuf = keys ? 0 : line * (q->p + 1);       // the class sums
  q->buf = xbuf > zbuf ? xbuf : zbuf;
  for (q->rows = PRUNE_ROWS < 65535 / nw ? PRUNE_ROWS : 65535 / nw;;
       q->rows -= 8) {
    q->rs = q->rows + 1;  // the tile's columns padded: a row's gathers
                          // from neighbouring columns land in other banks
    q->o_twc = sc * q->rs;
    q->o_twl = q->o_twc + sc * q->tws;
    q->o_buf = q->o_twl + line;
    q->n_f2 = q->o_buf + q->nbuf * q->buf;
    q->smem = sizeof(float2) * (size_t)q->n_f2 + sizeof(int) * (line + sc) +
              (keys ? sizeof(unsigned) * HIST_WORDS : 0);
    if (q->smem <= PRUNE_SMEM || q->rows <= 32) break;
  }
  return q->smem > (size_t)MAX_SMEM ? ERR_SMEM : 0;
}

// 16-point DFT (INV: unscaled inverse) of a thread's elements, in place,
// in natural order: two 8-point DFTs and the twiddles exp(∓2πi k/16).
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&a)[16]) {
  float2 ev[8], od[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ev[k] = a[2 * k];
    od[k] = a[2 * k + 1];
  }
  dft8<INV>(ev);
  dft8<INV>(od);
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f;
  const float h = 0.70710678118654752f;
  const float wr[8] = {1.0f, c1, h, s1, 0.0f, -s1, -h, -c1};
  const float wi[8] = {0.0f, s1, h, c1, 1.0f, c1, h, s1};  // sin(πk/8)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float2 t = od[k];
    if (k == 4)
      t = rot90<INV>(t);
    else if (k != 0)
      t = cmul(t, make_float2(wr[k], INV ? wi[k] : -wi[k]));
    a[k] = cadd(ev[k], t);
    a[k + 8] = csub(ev[k], t);
  }
}

// N-point DFT of a small register array, natural order.
template <int N, bool INV>
__device__ __forceinline__ void dft_small(float2 (&a)[N]) {
  if constexpr (N == 2) {
    dft2<INV>(a[0], a[1]);
  } else if constexpr (N == 4) {
    dft4<INV>(a[0], a[1], a[2], a[3]);
  } else if constexpr (N == 8) {
    dft8<INV>(a);
  } else if constexpr (N == 16) {
    dft16<INV>(a);
  }
}

// a uniform branch: every thread of the block calls it
__device__ __forceinline__ void pruned_sync(bool warp) {
  if (warp)
    __syncwarp();
  else
    __syncthreads();
}

// The s'-point DFT (INV: unscaled inverse) of class r's line, thread j of
// its TT holding elements j + TT·e in u, in place: a 16-point DFT of the
// thread's elements, the line's twiddles twl[k1·TT + j] =
// exp(-2πi j·k1/s') (conjugated for INV), an exchange through the row's
// buffer xb (slot k1·(tr + p) + i) and 16/TT TT-point DFTs; thread j then
// holds the outputs j + TT·e. Every thread of the block calls it.
template <int TT, bool INV>
__device__ __forceinline__ void pruned_line(float2 (&u)[PE],
                                            const float2* twl, float2* xb,
                                            const Pruned& q, int r, int j,
                                            int i) {
  dft16<INV>(u);
  if constexpr (TT > 1) {
    const int stride = q.tr + q.p;  // padded: conflict-free reads
#pragma unroll
    for (int k1 = 0; k1 < PE; ++k1) {
      const float2 w = twl[k1 * TT + j];
      xb[k1 * stride + i] = INV ? cmul_conj(u[k1], w) : cmul(u[k1], w);
    }
    pruned_sync(q.warp);
    constexpr int F = PE / TT;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float2 c[TT];
#pragma unroll
      for (int jj = 0; jj < TT; ++jj)
        c[jj] = xb[(j + TT * f) * stride + jj * q.p + r];
      dft_small<TT, INV>(c);
#pragma unroll
      for (int k2 = 0; k2 < TT; ++k2) u[f + F * k2] = c[k2];
    }
    pruned_sync(q.warp);
  }
}

// c of one field row of the tile, scaled, in thread i = r + p·j's
// registers: u[e] = c[i + tr·e]. The thread gathers the box columns that
// land on its slots j + TT·e of class r's line, each times ω^{idx_k·r},
// and runs the line's inverse. Both pruned kernels call it: the same code
// on the same inputs rounds alike. An inactive thread gathers zeros.
template <int TT>
__device__ __forceinline__ void pruned_row_c(
    float2 (&u)[PE], const float2* xt, int row, const float2* twc,
    const float2* twl, const int* kslot, float2* xb, const Pruned& q, int r,
    int j, int i, bool active, float scale) {
#pragma unroll
  for (int e = 0; e < PE; ++e) {
    const int k = active ? kslot[j + TT * e] : -1;
    u[e] = k >= 0 ? cmul_conj(xt[k * q.rs + row], twc[k * q.tws + r])
                  : make_float2(0.0f, 0.0f);
  }
  pruned_line<TT, true>(u, twl, xb, q, r, j, i);
#pragma unroll
  for (int e = 0; e < PE; ++e)
    u[e] = make_float2(__fmul_rn(u[e].x, scale), __fmul_rn(u[e].y, scale));
}

// A pruned row block's prologue: its tables and its tile of G, box column
// k of field rows n0 + row at xt[k·rs + row] (G's columns from col0). Every
// thread calls it; it ends with a __syncthreads.
__device__ __forceinline__ void pruned_prologue(
    const float2* __restrict__ g, const int* __restrict__ idx_w,
    const float2* __restrict__ tw_w, const Pruned& q, int nh, int n0,
    long long col0, float2* xt, float2* twc, float2* twl, int* kslot,
    int* idxs) {
  const int nt = blockDim.x;
  for (int p = threadIdx.x; p < q.sl; p += nt) {
    kslot[p] = -1;
    const int k1 = p / q.t, jj = p - k1 * q.t;
    twl[p] = tw_w[((jj * k1) & (q.sl - 1)) * q.p];  // exp(-2πi jj·k1/s')
  }
  for (int k = threadIdx.x; k < q.sc; k += nt) idxs[k] = idx_w[k];
  for (int e = threadIdx.x; e < q.sc * q.p; e += nt) {
    const int k = e / q.p, r = e - k * q.p;
    twc[k * q.tws + r] = tw_w[(int)((long long)idx_w[k] * r % q.n)];
  }
  for (int e = threadIdx.x; e < q.sc * q.rows; e += nt) {
    const int k = e / q.rows, row = e - k * q.rows;
    if (n0 + row < nh)
      xt[k * q.rs + row] = g[col0 + (long long)k * nh + n0 + row];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < q.sc; k += nt) kslot[idxs[k] & (q.sl - 1)] = k;
  __syncthreads();
}

// The percentile route's pass 1 in the pruned form: |c| of every pixel of
// the tile's field rows into keys (B, lg, N_h, N_w), their first digits
// into hist (B, lg, HIST_COLS) once a block; G is only read. grid (row
// tiles, lg, batch), PRUNE_NT threads.
template <int TT>
__global__ void __launch_bounds__(PRUNE_NT, PRUNE_BLOCKS)
box_keys_pruned_kernel(const float2* __restrict__ g,  // (B, lg, sc, nh)
                       const int* __restrict__ idx_w,  // (sc,)
                       const float2* __restrict__ tw_w, Pruned q, int nh,
                       float scale, float* __restrict__ keys,
                       unsigned* __restrict__ hist) {
  extern __shared__ float2 smem[];
  float2* xt = smem;
  float2* twc = smem + q.o_twc;
  float2* twl = smem + q.o_twl;
  int* kslot = reinterpret_cast<int*>(smem + q.n_f2);
  int* idxs = kslot + q.sl;
  unsigned* bins = reinterpret_cast<unsigned*>(idxs + q.sc);
  const long long seg = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int n0 = blockIdx.x * q.rows;
  hist_zero(bins);
  pruned_prologue(g, idx_w, tw_w, q, nh, n0, seg * q.sc * nh, xt, twc, twl,
                  kslot, idxs);
  const int slot = threadIdx.x / q.tr, i = threadIdx.x - slot * q.tr;
  const int r = i % q.p, j = i / q.p;
  float2* xb = smem + q.o_buf + slot * q.buf;  // idle threads: the spare
  for (int r0 = 0; r0 < q.rows; r0 += q.w) {
    const int row = r0 + slot;
    const bool active = slot < q.w && row < q.rows && n0 + row < nh;
    float2 u[PE];
    pruned_row_c<TT>(u, xt, row, twc, twl, kslot, xb, q, r, j, i, active,
                     scale);
    float* kr = keys + (seg * nh + n0 + row) * q.n + i;
#pragma unroll
    for (int e = 0; e < PE; ++e) {
      const float key = __fsqrt_rn(abs2_rn(u[e]));
      if (active) kr[e * q.tr] = key;
      hist_add(bins, key, active, 0xffffffffu, 32);
    }
  }
  __syncthreads();
  hist_flush(bins, hist + seg * HIST_COLS);
}

// The percentile route's pass 2 in the pruned form: c of the tile's field
// rows again (pruned_row_c), shrunk by tau[b, l] with |c|² as abs2_rn
// rounds it, the lines forward, the classes summed at each box column,
// and the tile written back into G in place. grid (row tiles, lg, batch),
// PRUNE_NT threads.
template <int TT>
__global__ void __launch_bounds__(PRUNE_NT, PRUNE_BLOCKS)
box_shrink_pruned_kernel(float2* __restrict__ g,  // (B, lg, sc, nh)
                         const int* __restrict__ idx_w,
                         const float* __restrict__ tau,  // (B, lg)
                         const float2* __restrict__ tw_w, Pruned q, int nh,
                         float scale, int op) {
  extern __shared__ float2 smem[];
  float2* xt = smem;
  float2* twc = smem + q.o_twc;
  float2* twl = smem + q.o_twl;
  int* kslot = reinterpret_cast<int*>(smem + q.n_f2);
  int* idxs = kslot + q.sl;
  const long long seg = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int n0 = blockIdx.x * q.rows;
  const long long col0 = seg * q.sc * nh;
  pruned_prologue(g, idx_w, tw_w, q, nh, n0, col0, xt, twc, twl, kslot,
                  idxs);
  const int slot = threadIdx.x / q.tr, i = threadIdx.x - slot * q.tr;
  const int r = i % q.p, j = i / q.p;
  float2* xb = smem + q.o_buf + slot * q.buf;  // idle threads: the spare
  const float tl = tau[seg];
  for (int r0 = 0; r0 < q.rows; r0 += q.w) {
    const int row = r0 + slot;
    const bool active = slot < q.w && row < q.rows && n0 + row < nh;
    float2 u[PE];
    pruned_row_c<TT>(u, xt, row, twc, twl, kslot, xb, q, r, j, i, active,
                     scale);
#pragma unroll
    for (int e = 0; e < PE; ++e) {
      const float f = shrink_factor(abs2_rn(u[e]), tl, op);
      u[e] = make_float2(u[e].x * f, u[e].y * f);
    }
    pruned_line<TT, false>(u, twl, xb, q, r, j, i);
    // class r's outputs j + TT·e at (slot, class) of the row's buffer
#pragma unroll
    for (int e = 0; e < PE; ++e) xb[(j + TT * e) * (q.p + 1) + r] = u[e];
    pruned_sync(q.warp);
    if (active) {
      for (int k = i; k < q.sc; k += q.tr) {
        const float2* z = xb + (idxs[k] & (q.sl - 1)) * (q.p + 1);
        const float2* w = twc + k * q.tws;
        float2 acc = make_float2(0.0f, 0.0f);
        for (int c = 0; c < q.p; ++c) acc = cadd(acc, cmul(z[c], w[c]));
        xt[k * q.rs + row] = acc;
      }
    }
    pruned_sync(q.warp);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < q.sc * q.rows; e += blockDim.x) {
    const int k = e / q.rows, row = e - k * q.rows;
    if (n0 + row < nh)
      g[col0 + (long long)k * nh + n0 + row] = xt[k * q.rs + row];
  }
}

// One launch of a pruned kernel for lines of t = TT threads a class.
template <int TT>
int pruned_launch(const Pruned& q, bool keys, float2* g, const int* idx_w,
                  const float* tau, const float2* tww, int batch, int lg,
                  int nh, float scale, int op, float* kout, unsigned* hist,
                  cudaStream_t stream) {
  const dim3 grid(ceil_div(nh, q.rows), lg, batch);
  int err;
  if (keys) {
    if ((err = allow_smem(box_keys_pruned_kernel<TT>, q.smem)) != 0)
      return err;
    box_keys_pruned_kernel<TT><<<grid, PRUNE_NT, q.smem, stream>>>(
        g, idx_w, tww, q, nh, scale, kout, hist);
  } else {
    if ((err = allow_smem(box_shrink_pruned_kernel<TT>, q.smem)) != 0)
      return err;
    box_shrink_pruned_kernel<TT><<<grid, PRUNE_NT, q.smem, stream>>>(
        g, idx_w, tau, tww, q, nh, scale, op);
  }
  return (int)cudaGetLastError();
}

// The pruned row pass of box_keys (keys) or box_shrink, by the line's
// threads a class.
inline int pruned_pass(const Pruned& q, bool keys, float2* g,
                       const int* idx_w, const float* tau, const float2* tww,
                       int batch, int lg, int nh, float scale, int op,
                       float* kout, unsigned* hist, cudaStream_t stream) {
  switch (q.t) {
    case 1:
      return pruned_launch<1>(q, keys, g, idx_w, tau, tww, batch, lg, nh,
                              scale, op, kout, hist, stream);
    case 2:
      return pruned_launch<2>(q, keys, g, idx_w, tau, tww, batch, lg, nh,
                              scale, op, kout, hist, stream);
    case 4:
      return pruned_launch<4>(q, keys, g, idx_w, tau, tww, batch, lg, nh,
                              scale, op, kout, hist, stream);
    case 8:
      return pruned_launch<8>(q, keys, g, idx_w, tau, tww, batch, lg, nh,
                              scale, op, kout, hist, stream);
    case 16:
      return pruned_launch<16>(q, keys, g, idx_w, tau, tww, batch, lg, nh,
                               scale, op, kout, hist, stream);
    default:
      return ERR_SHAPE;
  }
}

// Kernel B's line blocks for a box of sr × sc in an nh × nw grid: the
// column passes' lines along H, the row pass's along W, the lines of a
// block and the shared memory (twiddles, the groups' buffers and the
// position table).
struct BoxLines {
  LineShape lh, lw;
  int nt_h, nt_w, per_h, per_w;
  size_t smem_h, smem_w;
  float scale;  // 1/(nh·nw), the unscaled inverse's
};

// 0, or ERR_SHAPE for a grid side out of [1, MAX_LINE] or a box larger than
// its grid; the column passes' shared memory allowed (ERR_SMEM if too much).
inline int box_lines(int sr, int sc, int nh, int nw, BoxLines* s) {
  if (nh < 1 || nw < 1 || nh > MAX_LINE || nw > MAX_LINE || sr < 1 ||
      sc < 1 || sr > nh || sc > nw)
    return ERR_SHAPE;
  s->lh = line_shape(nh);
  s->lw = line_shape(nw);
  s->nt_h = line_threads(s->lh);
  s->nt_w = line_threads(s->lw);
  s->per_h = s->nt_h / s->lh.t;
  s->per_w = s->nt_w / s->lw.t;
  const size_t c8 = sizeof(float2);
  s->smem_h = c8 * (nh + (size_t)s->per_h * line_buf(nh)) +
              sizeof(int) * (size_t)nh;
  s->smem_w = c8 * (nw + (size_t)s->per_w * line_buf(nw)) +
              sizeof(int) * (size_t)nw;
  s->scale = 1.0f / (float)((double)nh * (double)nw);
  int err;
  if ((err = allow_smem(box_cols_inverse_kernel, s->smem_h)) != 0) return err;
  return allow_smem(box_cols_forward_kernel, s->smem_h);
}

// Kernel B's pass (1) into G.
inline int box_inverse_columns(const BoxLines& s, const float* xb_re,
                               const float* xb_im, const float* psi,
                               const int* idx_h, const float2* twh, float2* g,
                               int batch, int lg, int sr, int sc,
                               cudaStream_t stream) {
  box_cols_inverse_kernel<<<dim3(ceil_div(sc, s.per_h), lg, batch), s.nt_h,
                            s.smem_h, stream>>>(xb_re, xb_im, psi, idx_h, twh,
                                                g, s.lh, sr, sc);
  return (int)cudaGetLastError();
}

// Kernel B's pass (3) from G into (m_re, m_im).
inline int box_forward_columns(const BoxLines& s, const float2* g,
                               const float* psi, const int* idx_h,
                               const float2* twh, float* m_re, float* m_im,
                               int batch, int lg, int sr, int sc,
                               cudaStream_t stream) {
  box_cols_forward_kernel<<<dim3(ceil_div(sc, s.per_h), batch), s.nt_h,
                            s.smem_h, stream>>>(g, psi, idx_h, twh, m_re, m_im,
                                                s.lh, lg, sr, sc);
  return (int)cudaGetLastError();
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
  const int per_block = s.rows_per_block();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int l0 = chunks[ci], l1 = chunks[ci + 1];
    const int p0 = offsets[l0], nrows = offsets[l1] - p0;
    if (nrows > 0) {
      rows_inverse_kernel<<<dim3(ceil_div(nrows, per_block), batch), s.nt_w,
                            s.smem_rows, stream>>>(xr, xi, psi, rows + p0,
                                                   bands + p0, tww, scratch,
                                                   s.lw, h, nrows);
      if ((err = (int)cudaGetLastError()) != 0) return err;
      cols_shrink_kernel
          <<<dim3(ceil_div(w, s.cols), l1 - l0, batch), s.nt_h, s.smem_cols,
             stream>>>(scratch, slot, tau + l0, twh, s.lh, w, s.cols, nrows,
                       p0, nbands, l0, scale, op);
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
  const int err = lines_for(h, w, NT, h, &s);
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
  if ((err = lines_for(h, w, NT, h, &s)) != 0) return err;
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
  rows_fft_kernel<false><<<dim3(ceil_div(h, s.rows_per_block()), batch), s.nt_w,
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

// Kernel B. Returns 0, ERR_SHAPE for a grid side out of [1, MAX_LINE] or a
// box larger than its grid, ERR_SMEM, or the first CUDA error met while
// enqueuing. idx_h (sr) and idx_w (sc) are the box's distinct fft-layout
// indices into the nh × nw grid (int32, on the device); `work` holds
// batch·lg·sc·nh complex values (2 floats each). Nothing is synchronised;
// every launch goes to `stream`.
int p3d_box_group_update(const float* xb_re, const float* xb_im,
                         const float* psi,  // (lg, sr, sc)
                         const float* tau,  // (batch, lg)
                         const int* idx_h, const int* idx_w,
                         const float* tw_h, const float* tw_w,  // (n, 2)
                         float* m_re, float* m_im, float* work, int batch,
                         int lg, int sr, int sc, int nh, int nw, int op,
                         void* stream_handle) {
  BoxLines s;
  int err;
  if ((err = box_lines(sr, sc, nh, nw, &s)) != 0) return err;
  if ((err = allow_smem(box_rows_kernel<PASS_SHRINK>, s.smem_w)) != 0)
    return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  float2* g = reinterpret_cast<float2*>(work);
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  if ((err = box_inverse_columns(s, xb_re, xb_im, psi, idx_h, twh, g, batch,
                                 lg, sr, sc, stream)) != 0)
    return err;
  box_rows_kernel<PASS_SHRINK>
      <<<dim3(ceil_div(nh, s.per_w), lg, batch), s.nt_w, s.smem_w, stream>>>(
          g, idx_w, tau, tww, s.lw, nh, sc, s.scale, op, nullptr, nullptr);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return box_forward_columns(s, g, psi, idx_h, twh, m_re, m_im, batch, lg, sr,
                             sc, stream);
}

// The percentile route's pass 1 for kernel A, on the band chunk [l0, l1):
// pass (a) into `work`, then cols_keys_kernel, which writes |c_l| of every
// pixel of each band of the chunk into keys (batch, l1 - l0, w, h), column
// by column, adds their first digits to hist (batch, l1 - l0, HIST_COLS),
// zeroed by the caller, and writes c_l itself into cl (batch, l1 - l0, w,
// h) complex values; `work` is left for p3d_subband_shrink. Returns as
// p3d_subband_update; `support` and `offsets` as it takes them, `work` as
// large as for the chunk's support rows.
int p3d_subband_keys(const float* x_re, const float* x_im, const float* psi,
                     const float* tw_h, const float* tw_w, const int* support,
                     const int* offsets, int l0, int l1, float* keys,
                     unsigned* hist, float* work, float* cl, int batch, int h,
                     int w, int nbands, void* stream_handle) {
  Lines s;
  int err;
  // the column tile sized with the block's packed histogram after the
  // slot table (pass 2 sizes its own, without it)
  if ((err = lines_for(h, w, NT, h + HIST_WORDS, &s)) != 0) return err;
  if ((err = allow_smem(rows_inverse_kernel, s.smem_rows)) != 0) return err;
  if ((err = allow_smem(cols_keys_kernel, s.smem_cols)) != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int nnz = offsets[nbands];
  const int p0 = offsets[l0], nrows = offsets[l1] - p0;
  float2* scratch = reinterpret_cast<float2*>(work);
  if (nrows > 0) {
    rows_inverse_kernel<<<dim3(ceil_div(nrows, s.rows_per_block()), batch),
                          s.nt_w, s.smem_rows, stream>>>(
        x_re, x_im, psi, support + p0, support + nnz + p0,
        reinterpret_cast<const float2*>(tw_w), scratch, s.lw, h, nrows);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  // a column with no support row of the band is a zero line: its keys are 0
  const dim3 grid(ceil_div(w, s.cols), l1 - l0, batch);
  const int* slot = support + 2 * (long long)nnz;
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float scale = 1.0f / (float)((double)h * (double)w);
  cols_keys_kernel<<<grid, s.nt_h, s.smem_cols, stream>>>(
      scratch, slot, twh, s.lh, w, s.cols, nrows, p0, l0, scale, keys, hist,
      reinterpret_cast<float2*>(cl));
  return (int)cudaGetLastError();
}

// The percentile route's pass 2 for kernel A, on the band chunk [l0, l1)
// whose pass 1 left `work` and `cl`: the column pass on the kept c_l
// (cols_kept_kernel) with tau (batch, l1 - l0), the thresholds
// p3d_band_percentile selected, |c|² rounded as the keys were, then pass
// (c) into (acc_re, acc_im), written when `first`, else added to. Returns
// as p3d_subband_update.
int p3d_subband_shrink(const float* psi, const float* tau, const float* tw_h,
                       const float* tw_w, const int* support,
                       const int* offsets, int l0, int l1, float* acc_re,
                       float* acc_im, float* work, const float* cl, int batch,
                       int h, int w, int nbands, int op, int first,
                       void* stream_handle) {
  Lines s;
  int err;
  if ((err = lines_for(h, w, NT, h, &s)) != 0) return err;
  if ((err = allow_smem(cols_kept_kernel, s.smem_cols)) != 0) return err;
  if ((err = allow_smem(rows_forward_acc_kernel<false>, s.smem_rows)) != 0)
    return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int* slot = support + 2 * (long long)offsets[nbands];
  const int p0 = offsets[l0], nrows = offsets[l1] - p0;
  float2* scratch = reinterpret_cast<float2*>(work);
  const float2* twh = reinterpret_cast<const float2*>(tw_h);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  if (nrows > 0) {
    const dim3 grid(ceil_div(w, s.cols), l1 - l0, batch);
    cols_kept_kernel<<<grid, s.nt_h, s.smem_cols, stream>>>(
        scratch, slot, tau, twh, s.lh, w, s.cols, nrows, p0, l1 - l0, l0, op,
        reinterpret_cast<const float2*>(cl));
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  rows_forward_acc_kernel<false>
      <<<dim3(ceil_div(h, s.rows_per_block()), batch), s.nt_w, s.smem_rows,
         stream>>>(scratch, slot, psi, tww, acc_re, acc_im, s.lw, h, nrows, p0,
                   l0, l1, first);
  return (int)cudaGetLastError();
}

// The percentile route's pass 1 for kernel B: pass (1) into `work`, then
// the row pass up to c, which writes |c| of the full N_h × N_w field of
// every band into keys (batch, lg, nh, nw), adds their first digits to
// hist (batch, lg, HIST_COLS), zeroed by the caller, and leaves `work` for
// p3d_box_shrink. `line`: the pruned form's s' (box_line_plan; idx_w then
// a wrapped range of at most s' frequencies), or 0 for the general form
// (box_rows_kernel's PASS_KEYS). Returns and takes the rest as
// p3d_box_group_update; ERR_SHAPE also for a line the pruned form does not
// take.
int p3d_box_keys(const float* xb_re, const float* xb_im, const float* psi,
                 const int* idx_h, const int* idx_w, const float* tw_h,
                 const float* tw_w, float* keys, unsigned* hist, float* work,
                 int batch, int lg, int sr, int sc, int nh, int nw, int line,
                 void* stream_handle) {
  BoxLines s;
  Pruned q;
  int err;
  if ((err = box_lines(sr, sc, nh, nw, &s)) != 0) return err;
  if (line != 0 && (err = pruned_rows(nw, line, sc, true, &q)) != 0)
    return err;
  const size_t smem = s.smem_w + sizeof(unsigned) * HIST_WORDS;
  if (line == 0 &&
      (err = allow_smem(box_rows_kernel<PASS_KEYS>, smem)) != 0)
    return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  float2* g = reinterpret_cast<float2*>(work);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  if ((err = box_inverse_columns(s, xb_re, xb_im, psi, idx_h,
                                 reinterpret_cast<const float2*>(tw_h), g,
                                 batch, lg, sr, sc, stream)) != 0)
    return err;
  if (line != 0)
    return pruned_pass(q, true, g, idx_w, nullptr, tww, batch, lg, nh,
                       s.scale, 0, keys, hist, stream);
  box_rows_kernel<PASS_KEYS>
      <<<dim3(ceil_div(nh, s.per_w), lg, batch), s.nt_w, smem, stream>>>(
          g, idx_w, nullptr, tww, s.lw, nh, sc, s.scale, 0, keys, hist);
  return (int)cudaGetLastError();
}

// The percentile route's pass 2 for kernel B on the `work` its pass 1
// left: the row pass with tau (batch, lg) from p3d_band_percentile, |c|²
// rounded as the keys were, in the form pass 1 took (`line` as
// p3d_box_keys takes it: pruned, or PASS_SHRINK_RN), then pass (3) into
// (m_re, m_im). Returns as p3d_box_keys.
int p3d_box_shrink(const float* psi, const float* tau, const int* idx_h,
                   const int* idx_w, const float* tw_h, const float* tw_w,
                   float* m_re, float* m_im, float* work, int batch, int lg,
                   int sr, int sc, int nh, int nw, int op, int line,
                   void* stream_handle) {
  BoxLines s;
  Pruned q;
  int err;
  if ((err = box_lines(sr, sc, nh, nw, &s)) != 0) return err;
  if (line != 0 && (err = pruned_rows(nw, line, sc, false, &q)) != 0)
    return err;
  if (line == 0 &&
      (err = allow_smem(box_rows_kernel<PASS_SHRINK_RN>, s.smem_w)) != 0)
    return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  float2* g = reinterpret_cast<float2*>(work);
  const float2* tww = reinterpret_cast<const float2*>(tw_w);
  if (line != 0) {
    err = pruned_pass(q, false, g, idx_w, tau, tww, batch, lg, nh, s.scale,
                      op, nullptr, nullptr, stream);
  } else {
    box_rows_kernel<PASS_SHRINK_RN>
        <<<dim3(ceil_div(nh, s.per_w), lg, batch), s.nt_w, s.smem_w,
           stream>>>(g, idx_w, tau, tww, s.lw, nh, sc, s.scale, op, nullptr,
                     nullptr);
    err = (int)cudaGetLastError();
  }
  if (err != 0) return err;
  return box_forward_columns(s, g, psi, idx_h,
                             reinterpret_cast<const float2*>(tw_h), m_re,
                             m_im, batch, lg, sr, sc, stream);
}

}  // extern "C"
