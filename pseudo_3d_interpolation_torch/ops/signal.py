"""Trace conditioning: gain (Seismic-Unix ``sugain`` semantics), AGC,
balancing, RMS utilities, Hilbert envelope, frequency spectra, resampling.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/signal.py``. Time is the
**last** axis throughout, with batched leading axes. Every function takes
numpy or tensors: numpy goes to ``device`` (default the first CUDA card,
an error without one), a tensor stays on its device. Results are tensors.

Differences from the JAX functions that the results do not show:

- medians are the mean of the two middle values for an even count, as
  ``jnp.median`` (``torch.median`` returns the lower one);
- quantiles take two ``kthvalue`` order statistics with linear
  interpolation (``torch.quantile`` refuses inputs above about 16M
  values);
- the AGC's moving sums are cumulative sums in float64, the float32
  rounding of the exact window mean whatever the card's TF32 settings;
- sliding windows (median AGC) and the per-trace FFTs (envelope,
  resampling) run in chunks of traces, so a cube-sized input does not
  hold every window or spectrum at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_tensor, map_rows
from . import dft
from .cplx import Cplx


def median(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """``jnp.median`` over ``dim`` (an int or a tuple of dims): the middle
    value, or the mean of the two middle values for an even count."""
    if isinstance(dim, tuple):
        dims = sorted(d % x.ndim for d in dim)
        keep = [d for d in range(x.ndim) if d not in dims]
        x = x.permute(keep + dims).reshape(
            [x.shape[d] for d in keep] + [-1])
        dim = -1
    n = x.shape[dim]
    lo = torch.kthvalue(x, (n + 1) // 2, dim=dim).values
    if n % 2:
        return lo
    hi = torch.kthvalue(x, n // 2 + 1, dim=dim).values
    return 0.5 * (lo + hi)


def quantile(x: torch.Tensor, q: float, dim: int = -1,
             keepdim: bool = False) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim)`` with its default linear method:
    the order statistics at ``floor`` and ``ceil`` of ``q·(n-1)``, weighted
    by the position's fraction (in float32, as JAX computes it)."""
    n = x.shape[dim]
    pos = np.float32(q) * np.float32(n - 1)
    low = int(np.clip(np.floor(pos), 0, n - 1))
    high = int(np.clip(np.ceil(pos), 0, n - 1))
    w_high = float(pos - np.floor(pos))
    lo = torch.kthvalue(x, low + 1, dim=dim, keepdim=keepdim).values
    hi = torch.kthvalue(x, high + 1, dim=dim, keepdim=keepdim).values
    return lo * (1.0 - w_high) + hi * w_high


# ---------------------------------------------------------------------------
# RMS helpers
# ---------------------------------------------------------------------------
def rms(x, axis=None, device=None):
    """Root-mean-square amplitude over ``axis`` (None = whole array)."""
    x = as_tensor(x, device)
    return torch.sqrt((x * x).mean() if axis is None
                      else (x * x).mean(dim=axis))


def rms_normalization(x, axis=None, device=None):
    """Divide by RMS amplitude (zero RMS left unscaled)."""
    x = as_tensor(x, device)
    r = rms(x, axis=axis)
    r = torch.where(r == 0.0, 1.0, r)
    if axis is not None and x.ndim > 0:
        axes = axis if isinstance(axis, tuple) else (axis,)
        for a in sorted(d % x.ndim for d in axes):
            r = r.unsqueeze(a)
    return x / r


def calc_reference_amplitude(x, axis=None, scale: str = "rms", device=None):
    """Per-trace reference amplitude, ``rms`` or ``peak``/``max``; zero
    becomes one."""
    x = as_tensor(x, device)
    if scale == "rms":
        ref = rms(x, axis=axis)
    elif scale in ("peak", "max"):
        ref = x.abs().amax() if axis is None else x.abs().amax(dim=axis)
    else:
        raise ValueError(f"unknown scale {scale!r}")
    return torch.where(ref == 0.0, 1.0, ref)


# ---------------------------------------------------------------------------
# AGC
# ---------------------------------------------------------------------------
def agc_window_samples(win_sec: float, dt: float) -> int:
    """Window length seconds -> odd sample count."""
    n = int(win_sec / dt)
    return n + 1 if n % 2 == 0 else n


def _conv_same(x: torch.Tensor, win: int) -> torch.Tensor:
    """'same' convolution along the last axis with the uniform kernel
    ``1/win`` (the JAX ``_conv_same`` with ``full((win,), 1/win)``): ``win
    // 2`` zeros on the left, ``win - 1 - win // 2`` on the right. The
    window sums are differences of a float64 cumulative sum."""
    pad = torch.nn.functional.pad(x.double(), (win // 2, win - 1 - win // 2))
    c = torch.nn.functional.pad(torch.cumsum(pad, dim=-1), (1, 0))
    return ((c[..., win:] - c[..., :-win]) / win).to(x.dtype)


def _agc_gain(x: torch.Tensor, win: int, kind: str) -> torch.Tensor:
    if kind == "rms":
        return torch.sqrt(_conv_same(x * x, win))
    if kind == "mean":
        return _conv_same(x, win)
    npad = win // 2
    xp = torch.nn.functional.pad(x, (npad, npad))
    return median(xp.unfold(-1, win, 1), dim=-1)


def agc(x, win: int, kind: str = "rms", squared: bool = False,
        return_gain: bool = False, device=None):
    """Automatic gain control along the last axis.

    ``win`` is in samples (odd; even is bumped +1 like the reference). The
    gain is the centred moving rms/mean/median; zero gain cells pass
    through unscaled. The median gathers each trace's (T, win) windows in
    chunks of traces.
    """
    x = as_tensor(x, device)
    win = int(win) + 1 if int(win) % 2 == 0 else int(win)
    if kind not in ("rms", "mean", "median"):
        raise ValueError(f"Unknown AGC kind {kind!r}")
    t = x.shape[-1]
    # a row's widest intermediate: the float64 padded sums, or the median's
    # windows with kthvalue's copy of them
    row_bytes = (8 * (t + win) * 3 if kind != "median"
                 else 4 * t * win * 3)
    g = map_rows(lambda r: _agc_gain(r, win, kind), x, row_bytes)
    g = torch.where(g == 0.0, 1.0, g)
    out = x / g
    if squared:
        out = torch.sign(out) * out * out
    if return_gain:
        return out, g
    return out


# ---------------------------------------------------------------------------
# Programmed gain control
# ---------------------------------------------------------------------------
def programmed_gain_control(twt, twt_gain: dict) -> torch.Tensor:
    """Linear-interpolated gain curve through {TWT: gain} control points.

    Control points snap to the nearest TWT sample; the ends extend the
    first/last gain value. Host-side (small 1D): a float32 CPU tensor.
    """
    twt = np.asarray(twt)
    keys = np.asarray(list(twt_gain.keys()), float)
    order = np.argsort(keys)
    keys = keys[order]
    gains = np.asarray(list(twt_gain.values()), float)[order]
    idx = np.abs(twt[:, None] - keys[None, :]).argmin(0)
    g = np.full(twt.shape, np.nan, np.float32)
    g[idx] = gains
    if np.isnan(g[0]):
        g[0] = gains[0]
    if np.isnan(g[-1]):
        g[-1] = gains[-1]
    nan = np.isnan(g)
    g[nan] = np.interp(np.nonzero(nan)[0], np.nonzero(~nan)[0], g[~nan])
    return torch.from_numpy(g)


# ---------------------------------------------------------------------------
# gain() — sugain
# ---------------------------------------------------------------------------
def gain(
    data,
    twt,
    tpow: float = 0.0,
    epow: float = 0.0,
    etpow: float = 1.0,
    ebase: float | None = None,
    gpow: float = 0.0,
    agc_: bool = False,
    agc_win: float = 0.05,
    agc_kind: str = "rms",
    agc_sqrt: bool = False,
    clip=None,
    pclip=None,
    nclip=None,
    qclip=None,
    linear=None,
    pgc: dict | None = None,
    bias=None,
    scale: float = 1.0,
    norm: bool = False,
    norm_rms: bool = False,
    device=None,
):
    """Seismic-Unix style composite gain along the **last** (time) axis.

    Application order matches the reference: bias -> tpow -> epow (with
    etpow/ebase) -> gpow -> AGC -> clip -> pclip -> nclip -> qclip ->
    linear -> PGC -> norm_rms -> scale (or 1/scale when ``norm``).
    ``twt`` is a host array.
    """
    data = as_tensor(data, device)
    twt_host = np.asarray(twt)
    t = torch.from_numpy(np.asarray(twt_host, np.float32)).to(
        data.device).reshape((1,) * (data.ndim - 1) + (-1,))

    if bias is not None and bias != 0.0:
        data = data + bias

    if tpow:
        tf = torch.pow(t, tpow)
        # t = 0 gets zero gain (the reference zeroes the first sample)
        data = data * torch.where(t == 0.0, 0.0, tf)

    if epow:
        etf = torch.pow(t, etpow)
        ef = (torch.pow(float(ebase), epow * etf) if ebase is not None
              else torch.exp(epow * etf))
        data = data * ef

    if gpow:
        data = torch.sign(data) * data.abs() ** gpow

    if agc_:
        dt = float(np.round(float(np.mean(np.diff(twt_host))) * 1e9) / 1e9)
        data = agc(data, agc_window_samples(agc_win, dt), kind=agc_kind,
                   squared=agc_sqrt)

    if clip is not None:
        data = torch.where(data.abs() > clip, clip * torch.sign(data), data)
    if pclip is not None:
        data = torch.clamp(data, max=pclip)
    if nclip is not None:
        data = torch.clamp(data, min=nclip)
    if qclip is not None:
        mag = data.abs()
        q = quantile(mag, qclip, dim=-1, keepdim=True)
        data = torch.where(mag > q, q * torch.sign(data), data)

    if linear is not None:
        g = torch.linspace(min(linear), max(linear), twt_host.size,
                           dtype=torch.float32, device=data.device)
        data = data * g.reshape(t.shape)

    if isinstance(pgc, dict):
        g = programmed_gain_control(twt_host, pgc).to(data.device)
        data = data * g.reshape(t.shape)

    if norm_rms:
        data = rms_normalization(data, axis=-1)

    if scale is not None and scale != 1.0:
        data = data * (1.0 / scale) if norm else data * scale

    return data


# ---------------------------------------------------------------------------
# trace balancing
# ---------------------------------------------------------------------------
def balance_traces(traces, scale: str = "rms", n_traces: int | None = None,
                   device=None):
    """Balance traces by a per-trace (or trace-windowed) reference amplitude.

    Layout: (..., ntraces, nsamples): the reference amplitude reduces the
    sample axis; ``n_traces`` > 1 additionally pools a centred window of
    neighbouring traces, zero-padded at the ends as the reference does.
    """
    traces = as_tensor(traces, device)
    scale = scale.lower()
    if scale not in ("rms", "max", "peak", "mean", "median"):
        raise ValueError("scale must be rms/peak/max/mean/median")

    def _stat(x, axis):
        if scale == "rms":
            return rms(x, axis=axis)
        if scale in ("peak", "max"):
            return x.abs().amax(dim=axis)
        if scale == "mean":
            return x.abs().mean(dim=axis)
        return median(x.abs(), dim=axis)

    if n_traces is None or n_traces == 1:
        ref = _stat(traces, -1)[..., None]
    else:
        w = int(n_traces) + 1 if int(n_traces) % 2 == 0 else int(n_traces)
        # (..., ntr, nsamp) -> (..., ntr, w, nsamp): windows over the traces
        xp = torch.nn.functional.pad(traces.movedim(-2, -1),
                                     (w // 2, w // 2))
        win = xp.unfold(-1, w, 1).movedim(-3, -1)
        ref = _stat(win, (-2, -1))[..., None]
    ref = torch.where(ref == 0.0, 1.0, ref)
    return traces / ref


# ---------------------------------------------------------------------------
# Hilbert envelope
# ---------------------------------------------------------------------------
def _envelope_rows(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    h = np.zeros((n,), np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[1: (n + 1) // 2] = 2.0
    hw = torch.from_numpy(h).to(x.device)
    zf = dft.fft1(Cplx(x, torch.zeros_like(x)), axis=-1)
    za = dft.ifft1(Cplx(zf.re * hw, zf.im * hw), axis=-1)
    return za.abs().to(x.dtype)


def envelope(x, device=None):
    """Amplitude envelope |analytic signal| along the last axis:
    IFFT(FFT(x)·h) with the one-sided doubling window h, as
    ``scipy.signal.hilbert``; in chunks of traces."""
    x = as_tensor(x, device)
    return map_rows(_envelope_rows, x, 4 * x.shape[-1] * 12)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------
def _resample_rows(x: torch.Tensor, n_out: int) -> torch.Tensor:
    n_in = x.shape[-1]
    spec = dft.rfft1(x, axis=-1)
    nb_in = n_in // 2 + 1
    nb_out = n_out // 2 + 1
    # branch on the sample counts, not the bin counts: 11 -> 10 ties the
    # bin counts yet needs scipy's Nyquist-bin handling
    if n_out < n_in:
        re = spec.re[..., :nb_out].clone()
        im = spec.im[..., :nb_out].clone()
        if n_out % 2 == 0:
            # scipy: the new even-length Nyquist bin folds its mirror in
            re[..., -1] *= 2.0
            im[..., -1] = 0.0
    elif n_out > n_in:
        re = torch.nn.functional.pad(spec.re, (0, nb_out - nb_in))
        im = torch.nn.functional.pad(spec.im, (0, nb_out - nb_in))
        if n_in % 2 == 0:
            # scipy: the original Nyquist bin splits when upsampling
            re[..., nb_in - 1] *= 0.5
            im[..., nb_in - 1] *= 0.5
    else:
        re, im = spec.re, spec.im
    out = dft.irfft1(Cplx(re, im), n=n_out, axis=-1)
    return out * (n_out / n_in)


def resample_fft(x, n_out: int, device=None):
    """Fourier resampling of the last axis to ``n_out`` samples (as
    ``scipy.signal.resample``): rfft -> truncate/zero-pad the spectrum ->
    irfft, scaled by ``n_out/n_in``; in chunks of traces."""
    x = as_tensor(x, device)
    n_out = int(n_out)
    return map_rows(lambda r: _resample_rows(r, n_out), x,
                    4 * (x.shape[-1] + n_out) * 6)


def resampled_twt(twt, n_resamples: int, n_samples: int):
    """New TWT coordinate after resampling (host)."""
    twt = np.asarray(twt)
    return (np.arange(n_resamples) * (twt[1] - twt[0]) * n_samples
            / float(n_resamples) + twt[0])


# ---------------------------------------------------------------------------
# frequency spectrum
# ---------------------------------------------------------------------------
def freq_spectrum(signal, fs: float, n: int | None = None, taper: bool = True,
                  return_minmax: bool = False, device=None):
    """Single-sided magnitude spectrum with optional Blackman taper.

    Returns (frequencies, normalized magnitudes) as tensors; magnitudes
    scaled by ``2 / sum(window)`` like the reference. ``return_minmax``
    also estimates the signal band from a slope-derived amplitude
    threshold (host) -> (f, a, f_min, f_max).
    """
    signal = as_tensor(signal, device)
    n_sig = signal.shape[-1]
    win = torch.from_numpy(np.blackman(n_sig).astype(np.float32) if taper
                           else np.ones((n_sig,), np.float32)).to(
        signal.device)
    n = n_sig if n is None else int(n)
    a = dft.rfft1(signal * win, axis=-1, n=n).abs()
    f = np.fft.rfftfreq(n, 1.0 / fs)
    a_norm = a * 2.0 / win.sum()
    f_t = torch.from_numpy(f.astype(np.float32))
    if not return_minmax:
        return f_t, a_norm
    a_np = a_norm.cpu().numpy()
    if a_np.ndim > 1:
        a_np = a_np.mean(axis=tuple(range(a_np.ndim - 1)))
    slope = np.abs(np.diff(a_np) / np.diff(f))
    threshold = (slope.max() - slope.min()) * 0.001
    limits = np.nonzero(a_np > threshold)[0]
    f_min = float(f[limits[0]]) if limits.size else 0.0
    f_max = float(f[limits[-1]]) if limits.size else float(f[-1])
    return f_t, a_norm, f_min, f_max

