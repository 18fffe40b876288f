"""Step 15 — post-interpolation conditioning.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/postprocess.py``, in
memory: iline/xline upsampling to equal bin size (+ kx-ky spatial
anti-aliasing), acquisition-footprint removal (a directional kx-ky notch
convolved with a Gaussian), gaussian/median slice smoothing with an
optional percentile rescale, and AGC. The filters are built on the host
exactly as the reference builds them; they are applied on the device.

The cube goes to the device once. The slice operations act on chunks of
time slices and write one slice-major (T, iline, xline) buffer; the AGC
acts along time on chunks of ilines of that buffer, and each chunk comes
back to the host into the (iline, xline, T) result. The device holds the
input, the upsampled buffer and one chunk's work.

The streamed out-of-core passes of the JAX package are not ported yet
(ROADMAP queue 1 #15): ``out_of_core=True``, or a path input whose
upsampled cube exceeds ``ooc_threshold_bytes``, raises instead of loading
the cube.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import scipy.signal
import torch

from ..io.cube import Cube
from ..ops import signal as sig
from ..utils.device import as_tensor, chunk_rows, resolve_device
from ..utils.rescale import nan_range, rescale
from .preprocess import OOC_NOT_PORTED, cube_bytes

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


def percentiles(x: torch.Tensor, qs) -> list[float]:
    """``numpy.percentile`` (linear) of all of ``x`` at each of ``qs``,
    from ``kthvalue`` order statistics."""
    flat = x.reshape(-1)
    n = flat.numel()
    out = []
    for q in qs:
        pos = float(q) / 100.0 * (n - 1)
        k = int(np.floor(pos))
        lo = float(torch.kthvalue(flat, k + 1).values)
        frac = pos - k
        hi = (float(torch.kthvalue(flat, k + 2).values) if frac > 0
              else lo)
        out.append(lo + frac * (hi - lo))
    return out


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
    verbose: int = 0,
    device=None,
) -> Cube:
    """Apply the postprocessing chain; slice operations act on (iline,
    xline). The cube is changed in place and returned. ``device`` defaults
    to the first CUDA card and raises without one; ``device='cpu'`` runs
    on the host."""
    device = resolve_device(device)
    is_path = isinstance(cube, (str, os.PathLike))
    if out_of_core is None and is_path and out_path:
        est = _upsampled_bytes(cube, var, upsample_factors)
        if est > ooc_threshold_bytes:
            raise NotImplementedError(
                f"postprocess: ~{est / 2**30:.1f} GiB upsampled cube exceeds "
                "ooc_threshold_bytes; "
                + OOC_NOT_PORTED.format(step="postprocess"))
    if out_of_core:
        raise NotImplementedError(OOC_NOT_PORTED.format(step="postprocess"))
    if is_path:
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    if var is None:
        var = cube.primary_var()
    dims, data = cube.data_vars[var]
    level = logging.INFO if verbose else logging.DEBUG
    x = as_tensor(np.asarray(data, np.float32), device)  # (il, xl, T)
    ny, nx, nt = x.shape

    fy = fx = 1
    if upsample_factors == "auto":
        upsample_factors = equal_bin_factors(cube)
    if upsample_factors:
        fy = int(upsample_factors.get("iline", 1))
        fx = int(upsample_factors.get("xline", 1))
    upsampled = fy > 1 or fx > 1  # all-ones factors are a no-op (keep fold)
    ny_up = (ny - 1) * fy + 1 if fy > 1 else ny
    nx_up = (nx - 1) * fx + 1 if fx > 1 else nx

    filters = []
    if upsampled:
        if "bin_size" in cube.attrs:
            # the refinement makes bins anisotropic unless both factors
            # match: the equal-bin key becomes per-axis keys
            bs = float(cube.attrs.pop("bin_size"))
            cube.attrs["bin_size_iline"] = bs
            cube.attrs["bin_size_xline"] = bs
        for dim, f in (("iline", fy), ("xline", fx)):
            if f > 1:
                c = np.asarray(cube.coords[dim], np.float64)
                # (n-1)*f + 1 points: spacing exactly bin/f
                cube.coords[dim] = np.linspace(c[0], c[-1],
                                               (len(c) - 1) * f + 1)
                if f"bin_size_{dim}" in cube.attrs:
                    cube.attrs[f"bin_size_{dim}"] = (
                        float(cube.attrs[f"bin_size_{dim}"]) / f)
        if antialias and fy != fx:
            direction = "iline" if fy > fx else "xline"
            filters.append(_half_filter(antialias_filter(
                ny_up, nx_up, direction, {"iline": fy, "xline": fx}), device))
        cube.append_history(f"UPSAMPLE(il x{fy}, xl x{fx})")
        log.log(level, "upsampled to %dx%d", ny_up, nx_up)
        # variables on the old grid no longer match the refined coords
        refined = {d for d, f in (("iline", fy), ("xline", fx)) if f > 1}
        for k in [k for k in cube.data_vars if k != var]:
            if refined & set(cube.data_vars[k][0]):
                cube.data_vars.pop(k)
                log.debug("dropped %s: its grid no longer matches the "
                          "upsampled coordinates", k)
    if footprint is not None:
        filters.append(_half_filter(footprint_filter(ny_up, nx_up,
                                                     **footprint), device))
        cube.append_history("FOOTPRINT_REMOVAL")
    smooth = dict(smoothing or {})
    rescale_p = smooth.pop("rescale_percentiles", None)

    # slice operations, chunks of time slices -> slice-major buffer; the
    # widest per slice: the upsampled slice, its half spectrum and the
    # smoothing's padded copies, a few upsampled slices of float32
    buf = torch.empty((nt, ny_up, nx_up), dtype=torch.float32,
                      device=device)
    for t0, t1 in chunk_rows(nt, 4 * 8 * ny_up * nx_up):
        s = x[:, :, t0:t1].permute(2, 0, 1)
        if upsampled:
            s = upsample_slices_linear(s, fy, fx, method=upsample_method)
        for half in filters:
            s = _kxky_apply(s, half)
        if smoothing is not None and rescale_p is None:
            s = _smooth_chunked(s, **smooth)
        buf[t0:t1] = s
    del x
    if smoothing is not None and rescale_p is not None:
        # the percentiles are of the whole pre-smoothing volume, the
        # rescale's range that of the whole smoothed volume
        lo, hi = percentiles(buf, sorted(rescale_p))
        for t0, t1 in chunk_rows(nt, 4 * 8 * ny_up * nx_up):
            buf[t0:t1] = _smooth_chunked(buf[t0:t1], **smooth)
        amin, amax = nan_range(buf)
        for t0, t1 in chunk_rows(nt, 4 * 4 * ny_up * nx_up):
            buf[t0:t1] = rescale(buf[t0:t1], lo, hi, amin=amin, amax=amax)
    if smoothing is not None:
        cube.append_history(f"SMOOTH({smoothing.get('kind', 'gaussian')})")

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
    if agc_win is not None:
        cube.append_history(
            f"AGC({agc_win}s,{agc_kind}{',sqrt' if agc_sqrt else ''})")

    cube.data_vars[var] = (dims, out)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, cube)
    return cube
