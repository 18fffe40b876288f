// Line FFTs for Hopper with each line's elements in registers: the engine of
// the subband and box kernels (subband.cu) and of the FFT- and DCT-basis
// solves and the FFT iteration (pocs_solve.cu), with the line kernels'
// block geometry they share.
//
// A line of length n belongs to a group of t threads, which synchronises
// only itself (a warp's lanes, or a named barrier of whole warps), so a
// group may skip its line while the rest of the block goes on. Thread j of
// the group holds the eight elements j + s·t (s < 8, those below n) in
// registers, before and after a transform; loads and stores of those
// elements from a row in device memory are coalesced.
//
// Powers of two from 8 to 4096 (t = n/8): a Stockham (autosort) FFT, radix
// 8 stages and at most one radix 4 or 2 stage last. Each stage's butterflies
// run in registers; between two stages the group exchanges its line through
// its own shared-memory buffer, padded by one element in eight so that the
// exchanges are free of bank conflicts. There is no bit-reversal sweep.
// Other lengths (t the power of two at or above ceil(n/8)): a direct DFT of
// the line from the group's buffer, each thread summing its eight outputs.
// Twiddles come from a table exp(-2πi m/n) built in float64 on the host,
// conjugated for the inverse, which is left unscaled.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LINE = 4096;  // longest line a group transforms

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

// the exchange buffer's padded index: one pad element after every eight
__host__ __device__ __forceinline__ int line_pad(int i) { return i + (i >> 3); }

// complex elements of a group's exchange buffer for lines of length n
__host__ __device__ __forceinline__ int line_buf(int n) {
  return n + (n >> 3) + 1;
}

// A line length's transform: logn >= 3 for the register FFT of a power of
// two, else -1 (direct DFT); t threads per line, a power of two.
struct LineShape {
  int n, logn, t;
};

inline LineShape line_shape(int n) {
  LineShape s;
  s.n = n;
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  s.logn = (1 << lg) == n && lg >= 3 ? lg : -1;
  const int need = (n + 7) / 8;
  s.t = 1;
  while (s.t < need) s.t <<= 1;
  return s;
}

// The group of t threads that owns one line: thread j of group `index`
// among `count` in the block.
struct Group {
  int t, j, index, count;
  unsigned mask;

  __device__ __forceinline__ void sync() const {
    if (t > 32)
      asm volatile("bar.sync %0, %1;" ::"r"(index + 1), "r"(t) : "memory");
    else
      __syncwarp(mask);
  }
};

// blockDim.x is a multiple of t; with t > 32 at most 15 groups a block
// (named barriers 1-15)
__device__ __forceinline__ Group make_group(int t) {
  Group g;
  g.t = t;
  g.j = threadIdx.x & (t - 1);
  g.index = threadIdx.x / t;
  g.count = blockDim.x / t;
  const int lane = threadIdx.x & 31;
  g.mask = t >= 32 ? 0xffffffffu : ((1u << t) - 1u) << (lane & ~(t - 1));
  return g;
}

// -i·x for the forward transform, +i·x for the inverse
template <bool INV>
__device__ __forceinline__ float2 rot90(float2 x) {
  return INV ? make_float2(-x.y, x.x) : make_float2(x.y, -x.x);
}

template <bool INV>
__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = cadd(t, a1);
  a1 = csub(t, a1);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = rot90<INV>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

template <bool INV>
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6];
  float2 o0 = a[1], o1 = a[3], o2 = a[5], o3 = a[7];
  dft4<INV>(e0, e1, e2, e3);
  dft4<INV>(o0, o1, o2, o3);
  const float h = 0.70710678118654752f;
  // o_k times exp(∓iπk/4)
  o1 = INV ? make_float2(h * (o1.x - o1.y), h * (o1.x + o1.y))
           : make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));
  o2 = rot90<INV>(o2);
  o3 = INV ? make_float2(-h * (o3.x + o3.y), h * (o3.x - o3.y))
           : make_float2(h * (o3.y - o3.x), -h * (o3.x + o3.y));
  a[0] = cadd(e0, o0);
  a[4] = csub(e0, o0);
  a[1] = cadd(e1, o1);
  a[5] = csub(e1, o1);
  a[2] = cadd(e2, o2);
  a[6] = csub(e2, o2);
  a[3] = cadd(e3, o3);
  a[7] = csub(e3, o3);
}

// One Stockham stage of radix R after stages of total radix ns = 2^lns:
// the thread's 8/R butterflies jp = j + q·t take elements jp + r·n/R, held
// in v[q + r·(8/R)], twiddled by exp(∓2πi r·(jp mod ns)/(ns·R)), entry
// r·(jp mod ns)·n/(ns·R) of the table (n = 2^logn: shifts, no divisions).
template <int R, bool INV>
__device__ __forceinline__ void fft_stage(float2 (&v)[8], int j, int t,
                                          int logn, int lns,
                                          const float2* tw) {
  constexpr int Q = 8 / R;
  constexpr int LR = R == 8 ? 3 : (R == 4 ? 2 : 1);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (lns > 0) {
      const int step = ((j + q * t) & ((1 << lns) - 1)) << (logn - lns - LR);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = tw[r * step];
        v[q + r * Q] = INV ? cmul_conj(v[q + r * Q], w) : cmul(v[q + r * Q], w);
      }
    }
    if constexpr (R == 8) {
      dft8<INV>(v);
    } else if constexpr (R == 4) {
      dft4<INV>(v[q], v[q + 2], v[q + 4], v[q + 6]);
    } else {
      dft2<INV>(v[q], v[q + 4]);
    }
  }
}

// Direct DFT of a line of any length from the group's buffer.
template <bool INV>
__device__ void line_dft(float2 (&v)[8], float2* buf, const float2* tw, int n,
                         const Group& g) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int e = g.j + s * g.t;
    if (e < n) buf[line_pad(e)] = v[s];
  }
  g.sync();
  int m[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    v[s] = make_float2(0.0f, 0.0f);
    m[s] = 0;  // (i·e) mod n
  }
  for (int i = 0; i < n; ++i) {
    const float2 x = buf[line_pad(i)];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int e = g.j + s * g.t;  // an element past the line sums nothing
      const float2 w = tw[m[s]];
      v[s] = cadd(v[s], INV ? cmul_conj(x, w) : cmul(x, w));
      m[s] += e < n ? e : 0;
      if (m[s] >= n) m[s] -= n;
    }
  }
  g.sync();
}

// The DFT (INV: the unscaled inverse) of the group's line, in place in v;
// `buf` holds line_buf(n) elements of the group's own, `tw` the n-entry
// table. Every thread of the group calls it; it ends with the buffer free.
template <bool INV>
__device__ __forceinline__ void line_fft(float2 (&v)[8], float2* buf,
                                         const float2* tw,
                                         const LineShape& L, const Group& g) {
  if (L.logn < 0) {
    line_dft<INV>(v, buf, tw, L.n, g);
    return;
  }
  const int logn = L.logn, t = L.t, j = g.j;
  int rem = logn, lns = 0;
  while (rem >= 3) {
    fft_stage<8, INV>(v, j, t, logn, lns, tw);
    rem -= 3;
    if (rem == 0) return;
    // element (j / ns)·8·ns + j mod ns + r·ns of the stage's output is v[r]
    const int base = ((j >> lns) << (lns + 3)) + (j & ((1 << lns) - 1));
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[line_pad(base + (r << lns))] = v[r];
    g.sync();
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = buf[line_pad(j + s * t)];
    g.sync();
    lns += 3;
  }
  if (rem == 2)
    fft_stage<4, INV>(v, j, t, logn, lns, tw);
  else
    fft_stage<2, INV>(v, j, t, logn, lns, tw);
}

// ---------------------------------------------------------------------------
// The line kernels' blocks: a row kernel gives each row of a slice to one
// group; a column kernel loads a tile of columns into shared memory (each
// row of the tile one coalesced segment) and gives each column to a group.

constexpr int LINE_NT_MAX = 512;  // a line kernel's block: one 4096 line
constexpr int COL_TILE = 16;      // columns of a column block: 128-byte rows
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int ERR_SMEM = -2;      // the shape needs more shared memory
constexpr int ERR_SHAPE = -3;     // a side is longer than MAX_LINE

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The twiddle table of the block's lines into shared memory: its n entries
// at tw, then in the same sweep `steps` entries of `extra` (the DCT solve's
// tables of the steps around the FFT). Every thread of the block calls it.
__device__ __forceinline__ void load_twiddles(float2* tw, const float2* src,
                                              int n,
                                              const float2* extra = nullptr,
                                              int steps = 0) {
  for (int e = threadIdx.x; e < n + steps; e += blockDim.x)
    tw[e] = e < n ? src[e] : extra[e - n];
  __syncthreads();
}

// A column block's walk over its tile: thread c + cols·i (i < step) takes
// column c of rows i, i + step, ...; neighbouring threads read neighbouring
// columns of a row (one 128-byte segment for 16 complex columns). `in`: the
// column lies inside the slice (the last block may hold fewer than cols).
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

// Lets `kernel` use `bytes` of dynamic shared memory; ERR_SMEM when a
// block cannot have that much.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return ERR_SMEM;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The line blocks for an h × w slice: the lines along H and W, the threads
// of the column and row blocks, the columns of a column block, and the
// shared memory of the row and column kernels.
struct Lines {
  LineShape lh, lw;
  int nt_h, nt_w, cols;
  size_t smem_rows, smem_cols;
  int rows_per_block() const { return nt_w / lw.t; }
};

// 0, ERR_SHAPE for a side out of [1, MAX_LINE], or ERR_SMEM. A row block
// has `row_threads` threads (at least one group); a column block also
// holds a table of `col_ints` ints. A row and a column block hold
// `row_tables` and `col_tables` n-entry twiddle tables of their lines: the
// FFT's, and those of steps around it (the DCT solve's twiddles).
inline int lines_for(int h, int w, int row_threads, int col_ints, Lines* s,
                     int row_tables = 1, int col_tables = 1) {
  if (h < 1 || w < 1 || h > MAX_LINE || w > MAX_LINE) return ERR_SHAPE;
  s->lh = line_shape(h);
  s->lw = line_shape(w);
  s->nt_w = s->lw.t > row_threads ? s->lw.t : row_threads;
  const size_t c8 = sizeof(float2);
  s->smem_rows =
      c8 * ((size_t)row_tables * w + (size_t)s->rows_per_block() * line_buf(w));
  // a column block: one group per column of its tile, up to LINE_NT_MAX
  // threads (whole warps), its columns' tile and the groups' buffers
  const int t = s->lh.t;
  const size_t col = c8 * (h + 1);
  int cols = COL_TILE < w ? COL_TILE : w;
  for (;; --cols) {
    int nt = cols * t < LINE_NT_MAX ? cols * t : LINE_NT_MAX;
    nt = nt > t ? nt : t;
    s->nt_h = (nt + 31) / 32 * 32;
    s->smem_cols =
        c8 * ((size_t)col_tables * h + (size_t)(s->nt_h / t) * line_buf(h)) +
        cols * col + sizeof(int) * (size_t)col_ints;
    if (cols == 1 || s->smem_cols <= (size_t)MAX_SMEM) break;
  }
  s->cols = cols;
  return s->smem_cols > (size_t)MAX_SMEM ? ERR_SMEM : 0;
}

}  // namespace
