"""Zero-phase Butterworth filters: host design, host ``sosfiltfilt``, and
the spectral application on the device.

Counterpart of the part of ``pseudo_3d_interpolation_tpu/ops/filters.py``
that ``pipeline/preprocess.py`` uses (JAX :99-178). The STA/LTA, moving
statistics, MAD and seafloor-picking functions belong to stage 1 and are
not ported yet (ROADMAP queue 1 #17).
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from ..utils.device import as_tensor, map_rows
from . import dft
from .cplx import Cplx


def _spectral_rows(x: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    n = x.shape[-1]
    pad = min(n - 1, 3 * (2 * sos.shape[0] * 2 + 1))
    # odd-extension edge padding (like filtfilt), so the circular
    # application does not ring at the trace ends
    left = 2.0 * x[..., :1] - torch.flip(x[..., 1:pad + 1], (-1,))
    right = 2.0 * x[..., -1:] - torch.flip(x[..., -pad - 1:-1], (-1,))
    xp = torch.cat([left, x, right], dim=-1)
    np_ = xp.shape[-1]
    # |H|² at the rfft bin frequencies, on the host
    w_bins = 2.0 * np.pi * np.arange(np_ // 2 + 1) / np_
    _, h = scipy.signal.sosfreqz(sos, worN=w_bins)
    h2 = torch.from_numpy((np.abs(h) ** 2).astype(np.float32)).to(x.device)
    spec = dft.rfft1(xp, axis=-1)
    out = dft.irfft1(Cplx(spec.re * h2, spec.im * h2), n=np_, axis=-1)
    return out[..., pad: pad + n]


def butterworth_apply_spectral(x, sos, device=None):
    """Zero-phase Butterworth along the last axis, on the device.

    Multiplies by ``|H(f)|²`` (the magnitude response of one forward and
    one backward SOS pass, what ``sosfiltfilt`` realizes, without its
    edge transients) in the rfft domain of the odd-extended trace; in
    chunks of traces. ``sos`` comes from :func:`butterworth_design`.
    """
    x = as_tensor(x, device)
    sos = np.asarray(sos)
    n = x.shape[-1]
    np_ = n + 2 * min(n - 1, 3 * (2 * sos.shape[0] * 2 + 1))
    return map_rows(lambda r: _spectral_rows(r, sos), x, 4 * np_ * 8)


def butterworth_design(btype: str, cutoff, fs: float, order: int = 9):
    """Butterworth SOS coefficients (host-side scipy design)."""
    if btype not in ("lowpass", "highpass", "bandpass"):
        raise ValueError("btype must be lowpass, highpass, or bandpass")
    nyq = fs / 2.0
    return scipy.signal.butter(order, np.asarray(cutoff) / nyq, btype=btype,
                               output="sos")


def butterworth_filter(data, btype: str, cutoff, fs: float, order: int = 9,
                       axis: int = -1):
    """Exact zero-phase Butterworth via ``sosfiltfilt`` (host numpy, parity
    with the reference)."""
    sos = butterworth_design(btype, cutoff, fs, order)
    return scipy.signal.sosfiltfilt(sos, np.asarray(data), axis=axis)


def filter_design(freqs, fs: float, filter_type: str, gpass: float = 1.0,
                  gstop: float = 10.0) -> np.ndarray:
    """SOS of the pass/stop-band specified Butterworth that
    :func:`filter_frequency` applies (order from ``buttord``)."""
    if filter_type == "bandpass":
        if list(freqs) != sorted(freqs):
            raise ValueError("Invalid filter frequencies!")
        wp = [freqs[1], freqs[2]]
        ws = [freqs[0], freqs[3]]
    elif filter_type == "lowpass":
        wp, ws = freqs
        if wp > ws:
            raise ValueError("Invalid filter frequencies!")
    elif filter_type == "highpass":
        wp, ws = freqs
        if wp < ws:
            raise ValueError("Invalid filter frequencies!")
    else:
        raise ValueError(f"unknown filter_type {filter_type!r}")
    n, wn = scipy.signal.buttord(wp, ws, gpass, gstop, fs=fs)
    return scipy.signal.butter(n, wn, btype=filter_type, output="sos", fs=fs)


def filter_frequency(data, freqs, fs: float, filter_type: str,
                     gpass: float = 1.0, gstop: float = 10.0, axis: int = -1,
                     spectral: bool = False, device=None):
    """Pass/stop-band specified Butterworth with automatic order.

    ``freqs``: [f_pass, f_stop] for lowpass, [f_cut, f_stop] highpass,
    [f1, f2, f3, f4] bandpass with passband [f2, f3] and stopband beyond
    [f1, f4]. ``spectral=True`` (the JAX package's ``device=True``) applies
    the zero-phase response on ``device`` through
    :func:`butterworth_apply_spectral` (time on the last axis) and returns
    a tensor; otherwise the host ``sosfiltfilt`` runs along ``axis`` and
    returns numpy.
    """
    sos = filter_design(freqs, fs, filter_type, gpass, gstop)
    if spectral:
        return butterworth_apply_spectral(data, sos, device=device)
    return scipy.signal.sosfiltfilt(sos, np.asarray(data), axis=axis)
