// Fixed-iteration POCS solve (FFT basis) for a batch of complex slices, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (ops/kernels/pocs_solve.py).
//
// Replaces pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py ::
// pocs_solve_fused (basis='fft', body _solve_kernel). Per iteration j and
// slice b, with F the dense DFT matrices of ops/dft.py::dft_matrices:
//
//   X   = F_H @ y @ F_W                         forward 2D DFT
//   X^  = X · shrink(|X|², tau[j, b])           hard / soft / garrote
//   new = (conj(F_H) @ X^ @ conj(F_W)) / (H·W) · (1 − α·mask) + α·obs
//   cost = (Σ|new| − Σ|x|)² / (Σ|new|)²         (Gao et al. 2013)
//   FPOCS: restart on cost increase, Nesterov extrapolation
//   y' = new + f·(new − x_prev')
//
// Design. The TPU kernel keeps one whole slice in VMEM for all iterations;
// a 512² complex slice is 2 MB and a block here has at most 227 KB of shared
// memory, so the solve is a chain of launches over the whole batch instead:
// four batched complex GEMMs and one per-slice state kernel per iteration,
// all on the caller's stream, with no host synchronisation inside the solve
// (the restart decision is taken on the device).
//
// What bounds it: the dense DFT products, 16·H·W·(H+W) real flops per
// slice-iteration (4.3 GFLOP at 512²), run in full fp32 FMA on the CUDA
// cores (67 TFLOP/s peak on an H100 SXM). Each GEMM tile is 64×64 complex
// outputs per 256-thread block, 4×4 complex accumulators in registers per
// thread, 16-deep K tiles staged in shared memory. The threshold lives in
// the forward right-product's epilogue and the scale, reinsertion and the
// cost's partial sums in the inverse right-product's epilogue, so the
// spectrum and the unscaled inverse never make an extra pass through device
// memory. The partial sums are per block, reduced in a fixed order: the
// result does not depend on scheduling. A radix split or an FFT, and tensor
// cores (3xTF32 / bf16x3 wgmma), are later work.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

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

enum Epilogue { EPI_STORE = 0, EPI_SHRINK = 1, EPI_REINSERT = 2 };

// C[b] = A[b] @ B[b] for row-major complex planes; a batch stride of 0
// shares an operand (the DFT matrix) across the batch. sign_* = -1
// conjugates that operand.
struct Gemm {
  const float* ar; const float* ai; long long sa; float sign_a;  // M x K
  const float* br; const float* bi; long long sb; float sign_b;  // K x N
  float* cr; float* ci; long long sc;                            // M x N
  int m, n, k;
};

struct ShrinkArgs {
  const float* tau;  // (B,) thresholds of this iteration
  int op;
};

struct ReinsertArgs {
  const float* mask;                 // (M, N)
  const float* obr; const float* obi;  // (B, M, N) observed slices
  const float* xr; const float* xi;    // (B, M, N) current iterate
  float alpha, scale;
  float* psum; float* pdiff;         // (B, blocks per slice) partial sums
};

template <int EPI>
__global__ void __launch_bounds__(NT)
cgemm_kernel(Gemm g, ShrinkArgs sh, ReinsertArgs ri) {
  __shared__ float as_r[BK][BM + A_PAD];
  __shared__ float as_i[BK][BM + A_PAD];
  __shared__ float bs_r[BK][BN];
  __shared__ float bs_i[BK][BN];
  __shared__ float red_s[NT / 32];
  __shared__ float red_d[NT / 32];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  const float* ar = g.ar + b * g.sa;
  const float* ai = g.ai + b * g.sa;
  const float* br = g.br + b * g.sb;
  const float* bi = g.bi + b * g.sb;

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
        const long long off = (long long)m * g.k + k;
        vr = ar[off];
        vi = g.sign_a * ai[off];
      }
      as_r[a_k][a_m + 16 * p] = vr;
      as_i[a_k][a_m + 16 * p] = vi;
    }
#pragma unroll
    for (int p = 0; p < BK / 4; ++p) {
      const int k = k0 + b_k + 4 * p;
      const int n = n0 + b_n;
      float vr = 0.0f, vi = 0.0f;
      if (k < g.k && n < g.n) {
        const long long off = (long long)k * g.n + n;
        vr = br[off];
        vi = g.sign_b * bi[off];
      }
      bs_r[b_k + 4 * p][b_n] = vr;
      bs_i[b_k + 4 * p][b_n] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = as_r[kk][ty + 16 * i];
        a_i[i] = as_i[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = bs_r[kk][tx + 16 * j];
        b_i[j] = bs_i[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-a_i[i], b_i[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
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
      const long long off = (long long)m * g.n + n;
      float vr = acc_r[i][j], vi = acc_i[i][j];
      if (EPI == EPI_SHRINK) {
        const float s = shrink_factor(vr * vr + vi * vi, sh.tau[b], sh.op);
        vr *= s;
        vi *= s;
      } else if (EPI == EPI_REINSERT) {
        const long long boff = b * g.sc + off;
        const float keep = 1.0f - ri.alpha * ri.mask[off];
        vr = vr * ri.scale * keep + ri.alpha * ri.obr[boff];
        vi = vi * ri.scale * keep + ri.alpha * ri.obi[boff];
        const float xr = ri.xr[boff], xi = ri.xi[boff];
        const float mag_new = sqrtf(vr * vr + vi * vi);
        local_s += mag_new;
        local_d += mag_new - sqrtf(xr * xr + xi * xi);
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

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

inline int blocks_per_slice(int h, int w) { return ceil_div(w, BN) * ceil_div(h, BM); }

template <int EPI>
cudaError_t launch_gemm(const Gemm& g, const ShrinkArgs& sh,
                        const ReinsertArgs& ri, int batch, cudaStream_t stream) {
  dim3 grid(ceil_div(g.n, BN), ceil_div(g.m, BM), batch);
  cgemm_kernel<EPI><<<grid, NT, 0, stream>>>(g, sh, ri);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the solve needs: y, t, s planes (pairs), the per-block
// partial sums, and the double-buffered v / cost_prev.
size_t p3d_pocs_solve_work_floats(int batch, int h, int w) {
  const size_t plane = (size_t)h * w;
  return 6 * (size_t)batch * plane
         + 2 * (size_t)batch * blocks_per_slice(h, w)
         + 4 * (size_t)batch;
}

// Returns 0 or the first CUDA error met while enqueuing. Nothing is
// synchronised; every launch goes to `stream`.
int p3d_pocs_solve(const float* obs_re, const float* obs_im, const float* mask,
                   const float* decay,  // (niter, batch)
                   const float* fh_re, const float* fh_im,  // (h, h)
                   const float* fw_re, const float* fw_im,  // (w, w)
                   float* out_re, float* out_im, float* cost, float* work,
                   int batch, int h, int w, int niter, float alpha, int op,
                   int fast, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long plane = (long long)h * w;
  const long long total = plane * batch;
  const int nblk = blocks_per_slice(h, w);
  float* y_re = work;
  float* y_im = y_re + total;
  float* t_re = y_im + total;
  float* t_im = t_re + total;
  float* s_re = t_im + total;
  float* s_im = s_re + total;
  float* psum = s_im + total;
  float* pdiff = psum + (long long)batch * nblk;
  float* v = pdiff + (long long)batch * nblk;   // [2][batch]
  float* cprev = v + 2 * batch;                 // [2][batch]

  const int ew_blocks = ceil_div(total, STATE_THREADS) < 4096
                            ? ceil_div(total, STATE_THREADS) : 4096;
  init_kernel<<<ew_blocks, STATE_THREADS, 0, stream>>>(
      obs_re, obs_im, out_re, out_im, y_re, y_im, v, cprev, cost, total, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const ShrinkArgs no_shrink{nullptr, 0};
  const ReinsertArgs no_reinsert{};
  ReinsertArgs reinsert{mask, obs_re, obs_im, out_re, out_im, alpha,
                        1.0f / (float)((double)h * (double)w), psum, pdiff};
  const int chunks = ceil_div(plane, (long long)STATE_THREADS * 8) < 64
                         ? ceil_div(plane, (long long)STATE_THREADS * 8) : 64;
  const dim3 state_grid(chunks, batch);

  for (int j = 0; j < niter; ++j) {
    // forward: t = F_H @ y, then s = shrink(t @ F_W)
    const Gemm fwd_left{fh_re, fh_im, 0, 1.0f, y_re, y_im, plane, 1.0f,
                        t_re, t_im, plane, h, w, h};
    if ((err = launch_gemm<EPI_STORE>(fwd_left, no_shrink, no_reinsert, batch,
                                      stream)) != cudaSuccess)
      return (int)err;
    const Gemm fwd_right{t_re, t_im, plane, 1.0f, fw_re, fw_im, 0, 1.0f,
                         s_re, s_im, plane, h, w, w};
    const ShrinkArgs shrink{decay + (long long)j * batch, op};
    if ((err = launch_gemm<EPI_SHRINK>(fwd_right, shrink, no_reinsert, batch,
                                       stream)) != cudaSuccess)
      return (int)err;
    // inverse: t = conj(F_H) @ s, then y = reinsert((t @ conj(F_W)) / HW)
    const Gemm inv_left{fh_re, fh_im, 0, -1.0f, s_re, s_im, plane, 1.0f,
                        t_re, t_im, plane, h, w, h};
    if ((err = launch_gemm<EPI_STORE>(inv_left, no_shrink, no_reinsert, batch,
                                      stream)) != cudaSuccess)
      return (int)err;
    const Gemm inv_right{t_re, t_im, plane, 1.0f, fw_re, fw_im, 0, -1.0f,
                         y_re, y_im, plane, h, w, w};
    if ((err = launch_gemm<EPI_REINSERT>(inv_right, no_shrink, reinsert, batch,
                                         stream)) != cudaSuccess)
      return (int)err;
    state_kernel<<<state_grid, STATE_THREADS, 0, stream>>>(
        out_re, out_im, y_re, y_im, psum, pdiff, nblk, v, cprev, cost,
        j & 1, fast, batch, plane);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
