"""Time <-> frequency transforms with physical (xrft-style) scaling.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/spectral.py``:

    X(f) = dt · exp(-2πi f t0) · Σ_t x[t] e^{-2πi f t Δ}      (forward)

so spectra are in units · s and phased relative to the first TWT value;
the inverse undoes the scaling exactly. Also the Hanning-edged frequency
window filter and the dropping of filtered bins (the original ``nfft``
stays recorded for the inverse).

Layout: time or frequency on the **last** axis, batched leading axes. The
transforms are ``torch.fft`` calls on the tensors' device; the rotations
are built in float64 on the host and rounded once to float32, as the JAX
package builds them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import as_tensor
from . import dft
from .cplx import Cplx


class Spectrum(NamedTuple):
    """Frequency-domain data + the metadata needed to invert it."""

    data: Cplx  # (..., nbins)
    freqs: np.ndarray  # (nbins,) Hz
    nfft: int  # transform length (after upsampling)
    n_time: int  # original number of time samples
    t0: float  # first TWT value (s)
    dt: float  # sample interval (s)
    real: bool  # rfft (True) or full fft (False)


def _rotation(freqs, t0: float, scale: float, sign: float, like) -> Cplx:
    """``scale · exp(sign·2πi f t0)`` per bin, in float64 on the host and
    rounded once to float32, on ``like``'s device."""
    ang = sign * 2.0 * np.pi * np.asarray(freqs, np.float64) * t0
    return Cplx(torch.from_numpy((np.cos(ang) * scale).astype(np.float32))
                .to(like.device),
                torch.from_numpy((np.sin(ang) * scale).astype(np.float32))
                .to(like.device))


def _cmul(a: Cplx, b: Cplx) -> Cplx:
    return Cplx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, n)) if n > 0 else t


def forward_fft(x, twt, real: bool = True, upsample: int = 1,
                device=None) -> Spectrum:
    """Forward FFT along the last (time) axis with true amplitude+phase.

    ``upsample`` zero-pads the time axis by an integer factor for a finer
    frequency sampling. An odd-length time axis loses its last sample
    first. ``x`` is real (numpy or tensor) or, with ``real=False``, may
    be a ``Cplx`` pair; numpy goes to ``device`` (default the first CUDA
    card), a tensor stays where it is.
    """
    is_pair = isinstance(x, Cplx)
    if is_pair:
        x = Cplx(as_tensor(x.re, device), as_tensor(x.im, device))
    else:
        x = as_tensor(x, device)
    twt = np.asarray(twt, np.float64)
    n = x.shape[-1]
    if n % 2 != 0:
        x = (Cplx(x.re[..., : n - 1], x.im[..., : n - 1]) if is_pair
             else x[..., : n - 1])
        twt = twt[: n - 1]
        n -= 1
    dt = float(np.mean(np.diff(twt)))
    t0 = float(twt[0])
    if int(upsample) != upsample or int(upsample) < 1:
        raise ValueError(
            f"upsample must be a positive integer factor, got {upsample!r} "
            "(the spectrum length is an integer multiple of the input)")
    nfft = int(upsample) * n

    if real:
        if is_pair:
            raise ValueError("real=True expects a real array, not a Cplx pair")
        spec = dft.rfft1(x, axis=-1, n=nfft)
        freqs = np.fft.rfftfreq(nfft, dt)
    else:
        z = x if is_pair else Cplx(x, torch.zeros_like(x))
        z = Cplx(_pad_last(z.re, nfft - n), _pad_last(z.im, nfft - n))
        spec = dft.fft1(z, axis=-1)
        freqs = np.fft.fftfreq(nfft, dt)

    # true amplitude (× dt) and true phase (× e^{-2πi f t0}) in one rotation
    spec = _cmul(spec, _rotation(freqs, t0, dt, -1.0, spec.re))
    return Spectrum(spec, freqs, nfft, n, t0, dt, real)


def inverse_fft(spec: Spectrum, full_complex: bool = False):
    """Invert :func:`forward_fft`; returns (twt, x) for the upsampled grid.

    Bins dropped by :func:`apply_freq_filter` are zero-padded back to
    ``nfft`` first. ``x`` is the real part by default (every reference
    cube variable is a real signal); ``full_complex=True`` returns the
    ``Cplx`` pair of a full-fft spectrum instead. ``x`` lies on the
    spectrum's device.
    """
    z = _cmul(spec.data, _rotation(spec.freqs, spec.t0, 1.0 / spec.dt, 1.0,
                                   spec.data.re))
    nfft = spec.nfft
    if spec.real:
        missing = nfft // 2 + 1 - z.shape[-1]
        z = Cplx(_pad_last(z.re, missing), _pad_last(z.im, missing))
        x = dft.irfft1(z, n=nfft, axis=-1)
    else:
        xc = dft.ifft1(z, axis=-1)
        x = xc if full_complex else xc.re

    # zero-padding in time (spectrum upsampling) leaves dt unchanged: the
    # inverse returns nfft samples on the original grid, of which the first
    # n_time are the signal
    twt = spec.t0 + np.arange(nfft) * spec.dt
    return twt, x


def inverse_fft_original(spec: Spectrum):
    """Like :func:`inverse_fft` but truncated to the original time axis."""
    twt, x = inverse_fft(spec)
    return twt[: spec.n_time], x[..., : spec.n_time]


def _ramp_down(f, fmin, fmax):
    """Hanning-shaped 1->0 taper over [fmin, fmax] as a function of f."""
    t = np.clip((f - fmin) / max(fmax - fmin, 1e-30), 0.0, 1.0)
    w = np.cos(0.5 * np.pi * t) ** 2
    return np.where(f <= fmin, 1.0, np.where(f >= fmax, 0.0, w))


def freq_filter_window(freqs, filter_freqs,
                       filter_type: str = "lowpass") -> np.ndarray:
    """Hanning-edged low/high/bandpass window over the frequency coordinate.

    ``filter_freqs`` = [fmin, fmax] (taper band) for low/highpass, or
    [f1, f2, f3, f4] for bandpass. The weight is a function of
    |frequency|, so it suits any bin order (full-fft layouts with negative
    bins too) and keeps Hermitian symmetry. Host numpy, float32.
    """
    af = np.abs(np.asarray(freqs, np.float64))
    if filter_type == "lowpass":
        fmin, fmax = min(filter_freqs), max(filter_freqs)
        win = _ramp_down(af, fmin, fmax)
    elif filter_type == "highpass":
        fmin, fmax = min(filter_freqs), max(filter_freqs)
        win = 1.0 - _ramp_down(af, fmin, fmax)
    elif filter_type == "bandpass":
        f1, f2, f3, f4 = sorted(filter_freqs)
        win = (1.0 - _ramp_down(af, f1, f2)) * _ramp_down(af, f3, f4)
    else:
        raise ValueError(f"unknown filter_type {filter_type!r}")
    return win.astype(np.float32)


def apply_freq_filter(spec: Spectrum, filter_freqs,
                      filter_type: str = "lowpass",
                      drop_filtered: bool = False) -> Spectrum:
    """Multiply the spectrum by the window; optionally drop stop-band bins.

    Dropping is only meaningful for a lowpass on the rfft layout (a
    contiguous passband from DC); the original ``nfft`` stays recorded in
    the Spectrum so :func:`inverse_fft` can reconstruct.
    """
    win = freq_filter_window(spec.freqs, filter_freqs, filter_type)
    w = torch.from_numpy(win).to(spec.data.re.device)
    data = Cplx(spec.data.re * w, spec.data.im * w)
    freqs = spec.freqs
    if drop_filtered:
        if filter_type != "lowpass":
            raise ValueError("drop_filtered only supported for lowpass filters")
        if not spec.real:
            raise ValueError(
                "drop_filtered requires the rfft layout (real=True); "
                "full-fft bins are not contiguous in |frequency|")
        keep = int(np.count_nonzero(spec.freqs <= max(filter_freqs)))
        data = Cplx(data.re[..., :keep], data.im[..., :keep])
        freqs = spec.freqs[:keep]
    return Spectrum(data, freqs, spec.nfft, spec.n_time, spec.t0, spec.dt,
                    spec.real)
