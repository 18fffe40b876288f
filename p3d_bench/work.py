"""The frozen work count of a configuration's solve stage, and the H100's
peaks.

The solve stage is the rfft of every trace over time, every frequency
slice's decay (one forward transform) and ``niter`` iterations of the
basis's forward transform, threshold, inverse and reinsertion, and the
irfft. Its work is counted from the configuration's shapes alone, so
that neither a kernel's name nor a design's passes change it:

- operations: 5 n log2 n a complex line FFT of length n (2.5 n log2 n a
  real one), over the lines the basis needs. A 2-D transform of a
  spectrum that is zero outside some rows and columns (or whose output is
  needed only there) takes the cheaper order: the support's rows along W
  and then every column along H, or the support's columns along H and
  then every row along W. Each basis's module in ``reference/bases/``
  counts one forward transform of one slice from these lines (the
  configuration's transform keys that shape the basis with it).
  Thresholds and reinsertion are not counted.
- bytes: each input read once and each output written once: the time
  cube in and out, the mask, and the basis's own tables. No scratch.

The least time is the larger of the operations over the fp32 peak and the
bytes over the memory rate.
"""

from __future__ import annotations

import math

from .reference import bases

# NVIDIA H100 SXM data sheet, 700 W: fp32 on the CUDA cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def line_flops(n: int) -> float:
    """One complex FFT of length n."""
    return 5.0 * n * math.log2(n)


def real_line_flops(n: int) -> float:
    """One real FFT of length n (half a complex one)."""
    return 2.5 * n * math.log2(n)


def fft2_flops(h: int, w: int) -> float:
    """A dense 2-D transform: h lines of w and w lines of h."""
    return h * line_flops(w) + w * line_flops(h)


def support_fft2_flops(h: int, w: int, rows: int, cols: int) -> float:
    """A 2-D transform whose spectrum lives on ``rows`` rows and ``cols``
    columns of an h x w grid: the cheaper of the two line orders."""
    return min(rows * line_flops(w) + w * line_flops(h),
               cols * line_flops(h) + h * line_flops(w))


def forward_flops(basis: str, h: int, w: int, **keys) -> float:
    """One forward (or inverse) transform of one slice."""
    return bases.module(basis).forward_flops(h, w, **keys)


def window_bytes(basis: str, h: int, w: int, **keys) -> int:
    """The basis's own tables, read once."""
    return bases.module(basis).window_bytes(h, w, **keys)


def solve_work(config: dict) -> dict:
    """The operations, bytes and least time of one cube's solve stage."""
    h, w, t = config["shape"]
    basis, keys = config["basis"], bases.shape_keys(config)
    slices = t // 2 + 1
    per_slice = (2 * config["niter"] + 1) * forward_flops(basis, h, w,
                                                          **keys)
    flops = 2 * h * w * real_line_flops(t) + slices * per_slice
    nbytes = 2 * h * w * t * 4 + h * w * 4 + window_bytes(basis, h, w,
                                                          **keys)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

