"""Step 15 — post-interpolation conditioning.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/postprocess.py``:
iline/xline upsampling to equal bin size (+ kx-ky spatial anti-aliasing),
acquisition-footprint removal (a directional kx-ky notch convolved with a
Gaussian), gaussian/median slice smoothing with an optional percentile
rescale, and AGC. The filters are built on the host exactly as the
reference builds them; they are applied on the device.

In memory, the cube goes to the device once. The slice operations act on
chunks of time slices and write one slice-major (T, iline, xline) buffer;
the AGC acts along time on chunks of ilines of that buffer, and each chunk
comes back to the host into the (iline, xline, T) result. The device holds
the input, the upsampled buffer and one chunk's work.

Out of core (``out_of_core=True``, or a path input whose upsampled cube
exceeds ``ooc_threshold_bytes``), the same operations stream through
slabs of time slices and then of ilines, with temporary files beside the
output (:func:`postprocess_slabs`); the smoothing's percentile rescale
takes its global percentiles from :func:`streamed_percentiles`, exact.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import scipy.signal
import torch

from ..io.cube import Cube
from ..ops import signal as sig
from ..utils.device import (CHUNK_BYTES, as_tensor, chunk_rows,
                            resolve_device)
from ..utils.rescale import nan_range, rescale
from .preprocess import cube_bytes

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# filter construction (host)
# ---------------------------------------------------------------------------
def gaussian_kernel_2d(sigma: int = 7, n=None, normalized: bool = True,
                       orientation: str = "equal") -> np.ndarray:
    """Separable Gaussian kernel (reference :127-176)."""
    factor = {"equal": (8, 8), "iline": (2, 8), "xline": (8, 2)}[orientation]
    if isinstance(n, tuple):
        ny, nx = n
    else:
        ny = nx = n
    ny = sigma * factor[0] + 1 if ny is None else ny + (ny % 2 == 0)
    nx = sigma * factor[1] + 1 if nx is None else nx + (nx % 2 == 0)
    k = np.outer(scipy.signal.windows.gaussian(ny, sigma),
                 scipy.signal.windows.gaussian(nx, sigma))
    if normalized:
        k = k / (2 * np.pi * sigma**2)
    return k


def _rescale_host(a: np.ndarray, vmin=0.0, vmax=1.0) -> np.ndarray:
    """:func:`rescale` of a host array in float32, as the JAX package
    rescales its float64 filter arrays (x64 off)."""
    return rescale(torch.from_numpy(np.asarray(a, np.float32)), vmin,
                   vmax).numpy()


def footprint_filter(ny: int, nx: int, sigma: int = 7,
                     direction: str = "both", buffer_center: float = 0.25,
                     buffer_filter: int = 3) -> np.ndarray:
    """Inverted, Gaussian-smoothed directional notch in the (shifted) kx-ky
    plane (reference remove_acquisition_footprint :179-260)."""
    npad = sigma * 5
    nyp, nxp = ny + npad, nx + npad
    shape = np.zeros((nyp, nxp), np.float64)
    # fwidth == 0 must notch nothing: shape[-0:] is the whole stripe
    if direction in ("both", "horizontal", "iline"):
        cidx = nxp // 2 + 1
        fwidth = round(nyp * (1 - buffer_center) + 0.5) // 2
        if fwidth > 0:
            shape[:fwidth, cidx - buffer_filter: cidx + buffer_filter + 1] = 1
            shape[-fwidth:, cidx - buffer_filter: cidx + buffer_filter + 1] = 1
    if direction in ("both", "vertical", "xline"):
        cidx = nyp // 2 + 1
        fwidth = round(nxp * (1 - buffer_center) + 0.5) // 2
        if fwidth > 0:
            shape[cidx - buffer_filter: cidx + buffer_filter + 1, :fwidth] = 1
            shape[cidx - buffer_filter: cidx + buffer_filter + 1, -fwidth:] = 1
    smoothed = scipy.signal.fftconvolve(shape, gaussian_kernel_2d(sigma),
                                        mode="same")
    cut = smoothed[npad // 2: -npad // 2, npad // 2: -npad // 2]
    return (1.0 - _rescale_host(cut)).astype(np.float32)


def antialias_filter(ny: int, nx: int, direction: str, factors: dict,
                     sigma: int = 7) -> np.ndarray:
    """Low-pass keep-band for the direction that was upsampled
    (reference spatial_antialiasing :263-347)."""
    npad = sigma * 5
    nyp, nxp = ny + npad, nx + npad
    p = 0.98
    shape = np.zeros((nyp, nxp), np.float64)
    # the keep band is centred in the padded array, whose pad adds npad//2
    # per side
    if direction == "iline":
        perc = 1 - factors.get("xline", 1) / factors.get("iline", 1)
        half = round(ny * perc * p) // 2 + npad // 2
        keep = nyp - 2 * half
        shape[half:-half, :] = 1
    elif direction == "xline":
        perc = 1 - factors.get("iline", 1) / factors.get("xline", 1)
        half = round(nx * perc * p) // 2 + npad // 2
        keep = nxp - 2 * half
        shape[:, half:-half] = 1
    else:
        raise ValueError("direction must be 'iline' or 'xline'")
    if keep < 1:
        raise ValueError(
            f"anti-alias keep band is empty for {direction} with factors "
            f"{factors} on a {ny}x{nx} grid — the upsample factor is too "
            "aggressive for this grid size")
    smoothed = scipy.signal.fftconvolve(shape, gaussian_kernel_2d(sigma),
                                        mode="same")
    cut = smoothed[npad // 2: -npad // 2, npad // 2: -npad // 2]
    return _rescale_host(cut, 1e-3, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# device application
# ---------------------------------------------------------------------------
def _half_filter(ffilter: np.ndarray, device) -> torch.Tensor:
    """The real part of ``ifft2(F·fft2(x))`` for real x and a real F is
    ``irfft2`` of the half spectrum times ``(F(k) + F(-k)) / 2``: the
    filter's even part on the rfft2 columns."""
    f = np.fft.ifftshift(np.asarray(ffilter, np.float32))
    f_neg = np.roll(f[::-1, ::-1], 1, axis=(0, 1))
    even = (0.5 * (f + f_neg)).astype(np.float32)
    return torch.from_numpy(
        np.ascontiguousarray(even[:, : f.shape[1] // 2 + 1])).to(device)


def _kxky_apply(x: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    ny, nx = x.shape[-2:]
    spec = torch.fft.rfft2(x.float()) * half
    return torch.fft.irfft2(spec, s=(ny, nx))


def apply_kxky_filter(slices, ffilter: np.ndarray, device=None):
    """Multiply each (..., ny, nx) slice by an fftshifted-domain filter:
    ``ifft2(ifftshift(filter) · fft2(x)).real``, in chunks of slices.
    Returns a tensor on the slices' device."""
    x = as_tensor(slices, device)
    half = _half_filter(ffilter, x.device)
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = torch.empty_like(flat)
    for a, b in chunk_rows(flat.shape[0], 16 * flat[0].numel()):
        out[a:b] = _kxky_apply(flat[a:b], half)
    return out.reshape(x.shape)


def _linspace_f32(stop: float, num: int) -> np.ndarray:
    """The float32 grid the JAX package interpolates onto,
    ``jnp.linspace(0.0, stop, num)`` as XLA computes it: the division by
    ``num - 1`` becomes one float32 reciprocal, folded with ``stop`` into
    one float32 step, so point ``i`` is ``i · step`` rounded once; the
    last point is ``stop``."""
    div = num - 1
    step = np.float32(np.float32(stop) * (np.float32(1) / np.float32(div)))
    out = np.arange(div, dtype=np.float32) * step
    return np.concatenate([out, np.float32([stop])]).astype(np.float32)


def _interp_last(x: torch.Tensor, f: int) -> torch.Tensor:
    """``jnp.interp`` of every row of ``x`` onto ``(n-1)·f + 1`` float32
    positions over ``[0, n-1]``: the neighbours at ``i - 1`` and ``i``,
    ``i = clip(searchsorted(arange(n), pos, 'right'), 1, n - 1)``, and
    ``fp[i-1] + (pos - (i-1)) · (fp[i] - fp[i-1])``."""
    n = x.shape[-1]
    pos = _linspace_f32(n - 1.0, (n - 1) * f + 1)
    i = np.clip(np.searchsorted(np.arange(n, dtype=np.float32), pos,
                                side="right"), 1, n - 1)
    delta = (pos - (i - 1).astype(np.float32)).astype(np.float32)
    hi = torch.from_numpy(i).to(x.device)
    lo = hi - 1
    d = torch.from_numpy(delta).to(x.device)
    left = x.index_select(-1, lo)
    return left + d * (x.index_select(-1, hi) - left)


def upsample_slices_linear(slices, factor_y: int, factor_x: int,
                           method: str = "linear", device=None):
    """Separable interpolation of (..., ny, nx) slices onto a grid
    ``factor`` times finer: ``(n-1)·f + 1`` points over the same extent,
    so every original sample stays on the grid and the spacing is exactly
    bin/f. ``method`` is the reference's ``--upsample`` choice: linear on
    the device, the scipy families (nearest/slinear/cubic/polynomial) on
    the host. Returns a tensor on the slices' device."""
    out = as_tensor(slices, device)
    if method == "linear":
        def interp_axis(a, f):
            return _interp_last(a, int(f))
    else:
        import scipy.interpolate

        kind = {"nearest": "nearest", "slinear": "slinear",
                "cubic": "cubic", "polynomial": 3}.get(method)
        if kind is None:
            raise ValueError(f"unknown upsample method {method!r}")

        def interp_axis(a, f):
            n = a.shape[-1]
            new = np.linspace(0.0, n - 1.0, (n - 1) * int(f) + 1)
            fn = scipy.interpolate.interp1d(np.arange(n), a.cpu().numpy(),
                                            kind=kind, axis=-1)
            return torch.from_numpy(fn(new).astype(np.float32)).to(a.device)

    if factor_x > 1:
        out = interp_axis(out, factor_x)
    if factor_y > 1:
        out = interp_axis(out.transpose(-1, -2), factor_y).transpose(-1, -2)
    return out.contiguous()


def _reflect_index(n: int, r: int) -> np.ndarray:
    """Indices of ``numpy.pad(mode='reflect')`` by ``r`` on both sides of a
    length-``n`` axis, for any ``r`` (torch's reflect pad needs r < n)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _gauss_smooth(x: torch.Tensor, g: np.ndarray, r: int) -> torch.Tensor:
    """Reflect-pad ``r`` on both slice axes, then two valid 1-D
    convolutions with ``g`` (last axis, then the one before)."""
    ny, nx = x.shape[-2:]
    iy = torch.from_numpy(_reflect_index(ny, r)).to(x.device)
    ix = torch.from_numpy(_reflect_index(nx, r)).to(x.device)
    ap = x.index_select(-2, iy).index_select(-1, ix)
    k = g[::-1]  # convolution: the kernel reversed over the window
    b = sum(float(k[j]) * ap[..., :, j: j + nx] for j in range(len(k)))
    return sum(float(k[j]) * b[..., j: j + ny, :] for j in range(len(k)))


def _median_smooth(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k median of every slice, edge-padded (one slice's k² window
    copies at a time per chunk)."""
    r = k // 2
    ny, nx = x.shape[-2:]
    iy = torch.from_numpy(np.clip(np.arange(-r, ny + r), 0, ny - 1)).to(
        x.device)
    ix = torch.from_numpy(np.clip(np.arange(-r, nx + r), 0, nx - 1)).to(
        x.device)
    ap = x.index_select(-2, iy).index_select(-1, ix)
    win = ap.unfold(-2, k, 1).unfold(-2, k, 1)  # (..., ny, nx, k, k)
    return sig.median(win.reshape(win.shape[:-2] + (k * k,)), dim=-1)


def _smooth_chunked(x: torch.Tensor, kind: str = "gaussian",
                    sigma: float = 1.0, size: int = 3) -> torch.Tensor:
    """Gaussian or median smoothing of every slice of ``x``, in chunks of
    slices."""
    if kind == "gaussian":
        r = max(int(3 * sigma + 0.5), 1)
        g = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
        g = (g / g.sum()).astype(np.float32)

        def fn(s):
            return _gauss_smooth(s, g, r)
        per_slice = 16
    elif kind == "median":
        k = size + (size % 2 == 0)

        def fn(s):
            return _median_smooth(s, k)
        per_slice = 12 * k * k
    else:
        raise ValueError("kind must be 'gaussian' or 'median'")
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = torch.empty_like(flat)
    for a, b in chunk_rows(flat.shape[0], per_slice * flat[0].numel()):
        out[a:b] = fn(flat[a:b])
    return out.reshape(x.shape)


def _linear_points(n: int, qs):
    """``numpy.percentile``'s method 'linear' for ``n`` values, with
    numpy's own arithmetic: per percentile, the ranks (0-based) of the two
    order statistics it interpolates (its virtual index (n - 1)·q/100 and
    the next, clipped to [0, n - 1]) and the weight of the second."""
    q = np.true_divide(np.asarray(qs, np.float64), 100)
    virtual = (n - 1) * q
    prev = np.floor(virtual)
    for v, p in zip(virtual.tolist(), prev.tolist()):
        if v >= n - 1:
            yield n - 1, n - 1, v - p
        elif v < 0:
            yield 0, 0, v - p
        else:
            yield int(p), int(p) + 1, v - p


def _linear_percentiles(order_stat, n: int, qs, dtype) -> list[float]:
    """``numpy.percentile(a, qs)`` (method 'linear') of ``n`` values of
    ``dtype`` from ``order_stat(k)``, the k-th smallest (0-based): the
    difference of the two order statistics in ``dtype`` and numpy's
    two-sided interpolation (``b - d·(1 - g)`` from g = 0.5)."""
    out = []
    for k0, k1, g in _linear_points(n, qs):
        a = np.asarray(order_stat(k0), dtype)
        b = np.asarray(order_stat(k1), dtype)
        g = np.asarray(g)
        diff = np.subtract(b, a)
        val = (np.subtract(b, diff * (1 - g)) if g >= 0.5
               else np.add(a, diff * g))
        out.append(float(val))
    return out


def _numpy_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def percentiles(x: torch.Tensor, qs) -> list[float]:
    """``numpy.percentile`` (linear) of all of ``x`` at each of ``qs``,
    exactly: :func:`streamed_percentiles` over chunks of ``x`` where it
    lies (a few histogram passes; a sort or ``kthvalue`` of a cube-sized
    tensor is far slower on the card)."""
    flat = x.reshape(-1)
    step = CHUNK_BYTES // 8  # a chunk's float64 copy

    def blocks():
        for i in range(0, flat.numel(), step):
            yield flat[i:i + step]
    return streamed_percentiles(blocks, qs)


# the streamed percentiles' histogram: bins a pass, and the most values a
# bin may hold to be gathered and sorted (more: refine that bin)
_N_BINS = 1 << 16
_GATHER_MAX = 4_000_000


def _as64(blk, device) -> torch.Tensor:
    """A block as a flat float64 tensor (on ``device`` when given), so
    every comparison with the float64 bin edges is exact."""
    t = blk if isinstance(blk, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(blk))
    if device is not None:
        t = t.to(device)
    return t.reshape(-1).to(torch.float64)


def _histogram(x: torch.Tensor, edges: np.ndarray) -> np.ndarray:
    """Counts of ``x`` in the bins ``[edges[b], edges[b + 1])``, the last
    closed on the right (``numpy.histogram``'s bins); values outside
    ``[edges[0], edges[-1]]`` are the caller's to drop."""
    e = torch.from_numpy(edges).to(x.device)
    idx = torch.searchsorted(e, x, right=True) - 1
    idx.clamp_(0, len(edges) - 2)
    return torch.bincount(idx, minlength=len(edges) - 1).cpu().numpy()


def _in_bin(x: torch.Tensor, edges: np.ndarray, b: int) -> torch.Tensor:
    """The values of ``x`` in bin ``b``: the same comparisons against the
    same float64 edges as :func:`_histogram` counts with."""
    lo, hi = float(edges[b]), float(edges[b + 1])
    last = b == len(edges) - 2
    return x[(x >= lo) & ((x <= hi) if last else (x < hi))]


def _order_stat(block_iter, k: int, lo: float, hi: float, device=None,
                n_below: int = 0, _depth: int = 0) -> float:
    """The exact k-th smallest (0-based) of the streamed values, with
    ``n_below`` of them below ``lo`` and the k-th in ``[lo, hi]``, by
    histogram refinement: a bin of more than ``_GATHER_MAX`` values is
    refined (at most four times), a smaller one gathered and sorted."""
    if lo == hi:
        return float(lo)
    edges = np.linspace(lo, hi, _N_BINS + 1)
    counts = np.zeros(_N_BINS, np.int64)
    for blk in block_iter():
        x = _as64(blk, device)
        x = x[(x >= lo) & (x <= hi)]
        if x.numel():
            counts += _histogram(x, edges)
    cum = n_below + np.cumsum(counts)
    b = int(np.searchsorted(cum, k + 1))
    below = int(cum[b - 1]) if b else n_below
    blo, bhi = float(edges[b]), float(edges[b + 1])
    if counts[b] > _GATHER_MAX and _depth < 4 and bhi > blo:
        return _order_stat(block_iter, k, blo, bhi, device, below,
                           _depth + 1)
    v = torch.sort(torch.cat([_in_bin(_as64(blk, device), edges, b)
                              for blk in block_iter()])).values
    return float(v[k - below])


def streamed_percentiles(block_iter, qs, device=None) -> list[float]:
    """``numpy.percentile(values, qs)`` (method 'linear'), exactly, over a
    stream too large to hold: ``block_iter()`` yields the blocks anew on
    every call (numpy arrays or tensors, any shape, one dtype).

    Three passes for any number of percentiles: the count, minimum and
    maximum; one 65536-bin histogram over [min, max]; one gather of every
    bin that holds a needed order statistic, sorted. A bin above
    ``_GATHER_MAX`` values is refined by more passes
    (:func:`_order_stat`). The histogram and the gathers compare each
    value, in float64, against the same float64 edges, so a value is
    gathered from the bin it was counted in. The blocks are compared on
    ``device`` when given (numpy blocks are uploaded), else where they
    lie. Memory: one block and the histogram."""
    n = 0
    lo, hi = np.inf, -np.inf
    dtype = None
    for blk in block_iter():
        if dtype is None:
            dtype = _numpy_dtype(blk)
        x = _as64(blk, device)
        n += x.numel()
        if x.numel():
            lo = min(lo, float(x.min()))
            hi = max(hi, float(x.max()))
    if n == 0:
        raise ValueError("empty stream")
    if lo == hi:
        return [float(np.asarray(lo, dtype))] * len(qs)

    edges = np.linspace(lo, hi, _N_BINS + 1)
    counts = np.zeros(_N_BINS, np.int64)
    for blk in block_iter():
        x = _as64(blk, device)
        if x.numel():
            counts += _histogram(x, edges)
    cum = np.cumsum(counts)

    def rank_bin(k):
        return int(np.searchsorted(cum, k + 1))

    # the bins of the order statistics the percentiles need
    needed = sorted({rank_bin(k) for k0, k1, _ in _linear_points(n, qs)
                     for k in (k0, k1)})
    small = [b for b in needed if counts[b] <= _GATHER_MAX]
    parts = {b: [] for b in small}
    if small:
        for blk in block_iter():
            x = _as64(blk, device)
            for b in small:
                parts[b].append(_in_bin(x, edges, b))
    sorted_bins = {b: torch.sort(torch.cat(p)).values
                   for b, p in parts.items()}

    stats = {}

    def order_stat(k):
        if k not in stats:
            b = rank_bin(k)
            below = int(cum[b - 1]) if b else 0
            stats[k] = (float(sorted_bins[b][k - below]) if b in sorted_bins
                        else _order_stat(block_iter, k, float(edges[b]),
                                         float(edges[b + 1]), device, below))
        return stats[k]
    return _linear_percentiles(order_stat, n, qs, dtype)


def smooth_slices(slices, kind: str = "gaussian", sigma: float = 1.0,
                  size: int = 3, rescale_percentiles=None, device=None):
    """Per-slice gaussian or median smoothing (+ optional rescale of the
    result onto the input's percentiles), on the device in chunks of
    slices (reference smoothing_filter :88-124). Returns a tensor."""
    x = as_tensor(slices, device)
    out = _smooth_chunked(x, kind, sigma, size)
    if rescale_percentiles is not None:
        lo, hi = percentiles(x, sorted(rescale_percentiles))
        out = rescale(out, lo, hi)
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def equal_bin_factors(cube: Cube) -> dict:
    """Upsample factors that refine the coarser line axis onto the finer
    one's bin size (the reference's bare ``--upsample``), from the
    bin_size attrs the binning step stamps."""
    return _equal_bin_factors_from_attrs(cube.attrs)


def _equal_bin_factors_from_attrs(a: dict) -> dict:
    bi, bx = a.get("bin_size_iline"), a.get("bin_size_xline")
    if bi is None or bx is None:
        if a.get("bin_size") is not None:
            bi = bx = float(a["bin_size"])
        else:
            raise ValueError(
                "upsample='auto' needs bin_size_iline/bin_size_xline (or "
                "bin_size) cube attrs — rebin with a cube CRS/geometry that "
                "stamps them, or pass explicit upsample_factors")
    bi, bx = float(bi), float(bx)
    if bi == bx:
        return {}
    ratio = max(bi, bx) / min(bi, bx)
    f = int(round(ratio))
    if abs(ratio - f) > 1e-6:
        raise ValueError(
            f"bin sizes {bi} x {bx} are not an integer ratio — pass "
            "explicit upsample_factors")
    # the axis with the larger spacing is the coarser one
    return {"iline": f} if bi > bx else {"xline": f}


def _upsampled_bytes(path, var, upsample_factors) -> int:
    from ..io.ncio import CubeFile

    factors = upsample_factors
    if factors == "auto":
        with CubeFile(path) as f:
            factors = _equal_bin_factors_from_attrs(f.attrs)
    mult = 1
    if factors:
        mult = int(factors.get("iline", 1)) * int(factors.get("xline", 1))
    return cube_bytes(path, var, mult)


class _SlicePlan:
    """What the postprocess does to a cube of (ny, nx) slices: the
    upsample factors, the kx-ky filters on the upsampled grid (built on
    the host, applied on ``device``), the smoothing and its percentile
    rescale, and the history entries, in chain order."""

    def __init__(self, attrs, ny, nx, upsample_factors, upsample_method,
                 antialias, footprint, smoothing, agc_win, agc_kind,
                 agc_sqrt, device):
        fy = fx = 1
        if upsample_factors == "auto":
            upsample_factors = _equal_bin_factors_from_attrs(attrs)
        if upsample_factors:
            fy = int(upsample_factors.get("iline", 1))
            fx = int(upsample_factors.get("xline", 1))
        self.fy, self.fx, self.method = fy, fx, upsample_method
        # all-ones factors are a no-op (and keep the fold)
        self.upsampled = fy > 1 or fx > 1
        self.ny = (ny - 1) * fy + 1 if fy > 1 else ny
        self.nx = (nx - 1) * fx + 1 if fx > 1 else nx
        self.filters, self.history = [], []
        if self.upsampled:
            if antialias and fy != fx:
                direction = "iline" if fy > fx else "xline"
                self.filters.append(_half_filter(antialias_filter(
                    self.ny, self.nx, direction, {"iline": fy, "xline": fx}),
                    device))
            self.history.append(f"UPSAMPLE(il x{fy}, xl x{fx})")
        if footprint is not None:
            self.filters.append(_half_filter(footprint_filter(
                self.ny, self.nx, **footprint), device))
            self.history.append("FOOTPRINT_REMOVAL")
        self.smooth = dict(smoothing or {})
        self.rescale_p = self.smooth.pop("rescale_percentiles", None)
        self.smoothing = smoothing is not None
        if self.smoothing:
            self.history.append(
                f"SMOOTH({smoothing.get('kind', 'gaussian')})")
        if agc_win is not None:
            self.history.append(
                f"AGC({agc_win}s,{agc_kind}{',sqrt' if agc_sqrt else ''})")

    def refine(self, coords: dict, attrs: dict, il_dim, xl_dim) -> None:
        """The upsampled grid's coordinates and bin sizes, in place:
        (n-1)·f + 1 points over each refined axis, spacing exactly bin/f;
        an equal-bin ``bin_size`` becomes per-axis keys, as the
        refinement makes bins anisotropic unless both factors match."""
        if not self.upsampled:
            return
        if "bin_size" in attrs:
            bs = float(attrs.pop("bin_size"))
            attrs["bin_size_iline"] = bs
            attrs["bin_size_xline"] = bs
        for dim, key, f in ((il_dim, "iline", self.fy),
                            (xl_dim, "xline", self.fx)):
            if f > 1:
                c = np.asarray(coords[dim], np.float64)
                coords[dim] = np.linspace(c[0], c[-1], (len(c) - 1) * f + 1)
                if f"bin_size_{key}" in attrs:
                    attrs[f"bin_size_{key}"] = (
                        float(attrs[f"bin_size_{key}"]) / f)

    def refined_dims(self, il_dim, xl_dim) -> set:
        return {d for d, f in ((il_dim, self.fy), (xl_dim, self.fx))
                if f > 1}

    def slice_ops(self, s: torch.Tensor, smooth: bool) -> torch.Tensor:
        """Upsampling, the kx-ky filters and, with ``smooth``, the
        smoothing of a (t, ny, nx) stack of slices."""
        if self.upsampled:
            s = upsample_slices_linear(s, self.fy, self.fx,
                                       method=self.method)
        for half in self.filters:
            s = _kxky_apply(s, half)
        if smooth:
            s = _smooth_chunked(s, **self.smooth)
        return s


def postprocess_slabs(src, store, var=None, upsample_factors=None,
                      upsample_method="linear", antialias=True,
                      footprint=None, smoothing=None, agc_win=None,
                      agc_kind="rms", agc_sqrt=False, block: int = 32,
                      verbose: int = 0, device=None):
    """The streamed postprocess's slab loops, the same operations as the
    in-memory chain with the cube never whole on the device or the host.

    Pass 1 streams slabs of ``block`` time slices through the slice
    operations (upsampling, anti-alias, footprint removal, and the
    smoothing unless it rescales). A smoothing with
    ``rescale_percentiles`` needs the percentiles of the whole
    pre-smoothing volume and the range of the whole smoothed one: they
    come from :func:`streamed_percentiles` over pass 1's output and from a
    smoothing sub-pass; the rescale, elementwise, is done by the AGC's
    pass, or by a last sub-pass without an AGC. The AGC acts along time,
    so it is a second pass over slabs of ilines. Each slab goes to
    ``device`` once and comes back once; the AGC keeps its float64 sums.

    ``src``: anything with :class:`~..io.ncio.CubeFile`'s slab methods;
    ``store``: ``writer(coords, attrs, coord_attrs, final)`` opens a sink
    (the last pass's with ``final``, intermediate ones without) and
    ``reader(writer)`` opens a closed sink as a source, as
    :class:`~..io.ncio.SlabFiles` does with files. Returns the final
    sink, closed."""
    device = resolve_device(device)
    if var is None:
        var = src.primary_var()
    dims = src.dims_of(var)
    il_dim, xl_dim, t_dim = dims
    sizes = src.sizes()
    ny, nx, nt = sizes[il_dim], sizes[xl_dim], sizes[t_dim]
    attrs = dict(src.attrs)
    coords = {d: np.asarray(src.coords[d]) for d in src.coords}
    plan = _SlicePlan(attrs, ny, nx, upsample_factors, upsample_method,
                      antialias, footprint, smoothing, agc_win, agc_kind,
                      agc_sqrt, device)
    plan.refine(coords, attrs, il_dim, xl_dim)
    refined = plan.refined_dims(il_dim, xl_dim)
    dropped = {k for k in src.data_vars
               if k != var and refined & set(src.dims_of(k))}

    # an iline slab of the AGC pass of about pass 1's slab volume; every
    # pass's output is chunked in tiles of one time slab by one iline
    # slab, so a time slab and an iline slab each read or write whole
    # chunks
    il_block = max(1, (block * plan.ny) // max(nt, 1))
    chunks = {il_dim: il_block, t_dim: block}

    def writer(final):
        w = store.writer(coords, attrs if final else None,
                         dict(src.coord_attrs) if final else None, final)
        w.create_var(var, dims, np.float32, chunks=chunks,
                     attrs=src.var_attrs.get(var, {}) if final else None)
        return w

    def time_slabs(source):
        for t0 in range(0, nt, block):
            t1 = min(t0 + block, nt)
            yield t0, np.asarray(source.read_slab(var, dim=t_dim, start=t0,
                                                  stop=t1), np.float32)

    def upload(slab):  # (il, xl, t) on the host -> (t, il, xl)
        return as_tensor(slab, device).permute(2, 0, 1)

    def download(s):  # (t, il, xl) -> (il, xl, t) on the host
        return s.permute(1, 2, 0).contiguous().cpu().numpy()

    # pass 1, [percentiles + smoothing], [AGC or rescale]: the last writes
    # the final sink
    rescaled = plan.smoothing and plan.rescale_p is not None
    w = writer(not rescaled and agc_win is None)
    for t0, slab in time_slabs(src):
        s = plan.slice_ops(upload(slab),
                           smooth=plan.smoothing and not rescaled)
        w.write_slab(var, download(s), dim=t_dim, start=t0)
        del s

    finish = None  # the rescale, elementwise: done by the pass after
    if rescaled:
        w.close()
        with store.reader(w) as cur:
            def blocks():
                for _, slab in time_slabs(cur):
                    yield slab
            lo, hi = streamed_percentiles(blocks, sorted(plan.rescale_p),
                                          device=device)
            log.debug("streamed percentiles %s -> [%.6g, %.6g]",
                      sorted(plan.rescale_p), lo, hi)
            w = writer(False)
            gmin, gmax = math.inf, -math.inf
            for t0, slab in time_slabs(cur):
                s = _smooth_chunked(upload(slab), **plan.smooth)
                s_lo, s_hi = nan_range(s)
                if not bool(torch.isnan(s_lo)):
                    gmin, gmax = min(gmin, float(s_lo)), max(gmax, float(s_hi))
                w.write_slab(var, download(s), dim=t_dim, start=t0)
                del s
        if gmin > gmax:  # every value NaN
            gmin = gmax = math.nan

        def finish(x):
            return rescale(x, lo, hi, amin=gmin, amax=gmax)
        if agc_win is None:
            w.close()
            w_r = writer(True)
            with store.reader(w) as cur:
                for t0, slab in time_slabs(cur):
                    w_r.write_slab(var, finish(as_tensor(slab, device)).cpu()
                                   .numpy(), dim=t_dim, start=t0)
            w = w_r

    if agc_win is not None:
        w.close()
        twt = np.asarray(coords[t_dim], np.float64)
        win = sig.agc_window_samples(agc_win, float(np.mean(np.diff(twt))))
        w_agc = writer(True)
        with store.reader(w) as cur:
            for i0 in range(0, plan.ny, il_block):
                i1 = min(i0 + il_block, plan.ny)
                x = as_tensor(np.asarray(cur.read_slab(
                    var, dim=il_dim, start=i0, stop=i1), np.float32), device)
                if finish is not None:
                    x = finish(x)
                out = sig.agc(x, win, kind=agc_kind, squared=agc_sqrt)
                del x
                w_agc.write_slab(var, out.cpu().numpy(), dim=il_dim,
                                 start=i0)
                del out
        w = w_agc

    # the untouched variables ride through slab by slab, but those whose
    # grid no longer matches the upsampled coordinates
    for k in src.data_vars:
        if k == var:
            continue
        if k in dropped:
            log.debug("dropped %s: its grid no longer matches the "
                      "upsampled coordinates", k)
            continue
        kd = src.dims_of(k)
        w.create_var(k, kd, src.dtype_of(k), attrs=src.var_attrs.get(k, {}))
        n_lead = sizes[kd[0]]
        for s0 in range(0, n_lead, max(1, block)):
            w.write_slab(k, src.read_slab(k, dim=kd[0], start=s0,
                                          stop=min(s0 + block, n_lead)),
                         dim=kd[0], start=s0)
    w.set_attrs(history=str(attrs.get("history", ""))
                + "".join(f"{h};" for h in plan.history))
    w.close()
    level = logging.INFO if verbose else logging.DEBUG
    for h in plan.history:
        log.log(level, "postprocess (streamed): %s", h)
    return w


def _postprocess_streamed(path, out_path: str, device, **kw) -> str:
    """Streamed postprocess of the cube file at ``path`` into ``out_path``
    (:func:`postprocess_slabs` over a ``CubeFile`` and ``SlabFiles``,
    whose temporary files sit beside ``out_path``); returns
    ``out_path``."""
    from ..io.ncio import CubeFile, SlabFiles

    with CubeFile(path) as src, SlabFiles(out_path) as store:
        postprocess_slabs(src, store, device=device, **kw)
    return out_path


def postprocess(
    cube: Cube | str,
    var: str | None = None,
    upsample_factors: dict | str | None = None,  # {'iline': f, ...} | 'auto'
    upsample_method: str = "linear",  # reference --upsample choices
    antialias: bool = True,
    footprint: dict | None = None,  # kwargs for footprint_filter
    smoothing: dict | None = None,  # kwargs for smooth_slices
    agc_win: float | None = None,  # seconds
    agc_kind: str = "rms",
    agc_sqrt: bool = False,  # reference --agc-sqrt
    out_path: str | None = None,
    out_of_core: bool | None = None,
    ooc_threshold_bytes: int = 2 << 30,
    block: int = 32,
    verbose: int = 0,
    device=None,
) -> Cube | str:
    """Apply the postprocessing chain; slice operations act on (iline,
    xline). The cube is changed in place and returned. ``device`` defaults
    to the first CUDA card and raises without one; ``device='cpu'`` runs
    on the host.

    ``out_of_core=True`` (a path input and ``out_path`` required) streams
    the cube through bounded passes (:func:`postprocess_slabs`, ``block``
    time slices a slab) and returns ``out_path``; ``None`` streams when
    the upsampled cube would exceed ``ooc_threshold_bytes``."""
    device = resolve_device(device)
    is_path = isinstance(cube, (str, os.PathLike))
    if out_of_core is None and is_path and out_path:
        est = _upsampled_bytes(cube, var, upsample_factors)
        out_of_core = est > ooc_threshold_bytes
        if out_of_core:
            log.log(logging.INFO if verbose else logging.DEBUG,
                    "postprocess: ~%.1f GiB upsampled cube — streaming out "
                    "of core", est / 2**30)
    if out_of_core:
        if not is_path or not out_path:
            raise ValueError("out_of_core=True requires a path input and "
                             "out_path")
        return _postprocess_streamed(
            cube, out_path, device, var=var,
            upsample_factors=upsample_factors,
            upsample_method=upsample_method, antialias=antialias,
            footprint=footprint, smoothing=smoothing, agc_win=agc_win,
            agc_kind=agc_kind, agc_sqrt=agc_sqrt, block=block,
            verbose=verbose)
    if is_path:
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    if var is None:
        var = cube.primary_var()
    dims, data = cube.data_vars[var]
    level = logging.INFO if verbose else logging.DEBUG
    x = as_tensor(np.asarray(data, np.float32), device)  # (il, xl, T)
    ny, nx, nt = x.shape
    plan = _SlicePlan(cube.attrs, ny, nx, upsample_factors, upsample_method,
                      antialias, footprint, smoothing, agc_win, agc_kind,
                      agc_sqrt, device)
    plan.refine(cube.coords, cube.attrs, "iline", "xline")
    ny_up, nx_up = plan.ny, plan.nx
    if plan.upsampled:
        log.log(level, "upsampled to %dx%d", ny_up, nx_up)
        # variables on the old grid no longer match the refined coords
        refined = plan.refined_dims("iline", "xline")
        for k in [k for k in cube.data_vars if k != var]:
            if refined & set(cube.data_vars[k][0]):
                cube.data_vars.pop(k)
                log.debug("dropped %s: its grid no longer matches the "
                          "upsampled coordinates", k)
    rescaled = plan.smoothing and plan.rescale_p is not None

    # slice operations, chunks of time slices -> slice-major buffer; the
    # widest per slice: the upsampled slice, its half spectrum and the
    # smoothing's padded copies, a few upsampled slices of float32
    buf = torch.empty((nt, ny_up, nx_up), dtype=torch.float32,
                      device=device)
    for t0, t1 in chunk_rows(nt, 4 * 8 * ny_up * nx_up):
        buf[t0:t1] = plan.slice_ops(x[:, :, t0:t1].permute(2, 0, 1),
                                    smooth=plan.smoothing and not rescaled)
    del x
    if rescaled:
        # the percentiles are of the whole pre-smoothing volume, the
        # rescale's range that of the whole smoothed volume
        lo, hi = percentiles(buf, sorted(plan.rescale_p))
        for t0, t1 in chunk_rows(nt, 4 * 8 * ny_up * nx_up):
            buf[t0:t1] = _smooth_chunked(buf[t0:t1], **plan.smooth)
        amin, amax = nan_range(buf)
        for t0, t1 in chunk_rows(nt, 4 * 4 * ny_up * nx_up):
            buf[t0:t1] = rescale(buf[t0:t1], lo, hi, amin=amin, amax=amax)

    win = None
    if agc_win is not None:
        twt = np.asarray(cube.coords[dims[-1]], np.float64)
        win = sig.agc_window_samples(agc_win, float(np.mean(np.diff(twt))))
    out = np.empty((ny_up, nx_up, nt), np.float32)
    # time-last chunks of ilines: the AGC's float64 sums are the widest
    for i0, i1 in chunk_rows(ny_up, 8 * 3 * nx_up * (nt + (win or 0))):
        blk = buf[:, i0:i1, :].permute(1, 2, 0)
        if win is not None:
            blk = sig.agc(blk, win, kind=agc_kind, squared=agc_sqrt)
        torch.from_numpy(out[i0:i1]).copy_(blk)  # straight into the host array
    del buf
    for h in plan.history:
        cube.append_history(h)

    cube.data_vars[var] = (dims, out)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, cube)
    return cube
