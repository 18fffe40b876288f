"""Windowed statistics, outlier filters, seafloor picking and zero-phase
Butterworth filters.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/filters.py``. Split by
where the work belongs:

- **Device (tensors, time on the last axis, batched):** the STA/LTA
  ratio, the moving mean and median, the polynomial de/trend and the
  spectral Butterworth application. numpy goes to ``device`` (the first
  CUDA card by default, an error without one); a tensor stays where it
  is.
- **Host (numpy and scipy):** the per-profile 1-D chains on (ntraces,)
  metadata (MAD variants, smoothing with extrapolated edges, outlier
  filters and re-interpolation, the seafloor pick's post-processing) and
  the Butterworth design and ``sosfiltfilt``. Inside
  :func:`detect_seafloor_reflection` the STA/LTA and the moving median
  run on ``device``.

Where the JAX package rounds, this module rounds the same way, so the
integer decisions built on these values (seafloor picks, outlier flags)
come out equal:

- the cumulative sums of the STA/LTA and the moving average add in the
  order XLA's CPU backend adds a ``jnp.cumsum``: sequentially inside
  blocks of 16, then the block totals by the same rule, recursively. Each
  add is one float32 add, so the sums are bit-equal to JAX's on the host
  and on the card (``torch.cumsum`` adds in another order, and in float64
  on the host);
- the polynomial fit solves its least squares as ``jnp.linalg.lstsq``
  does: an SVD that drops the singular values below ``eps·max(M, N)``
  times the largest (``torch.linalg.lstsq`` on the card is a QR that
  drops none, and fits this badly conditioned system differently);
- the JAX package computes without 64-bit types, so the mirror padding
  of the moving MAD filter runs in float32 (int32) for float64 (int64)
  input, as it does there.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.signal
import torch

from ..utils.device import as_tensor, map_rows, resolve_device
from . import dft
from .cplx import Cplx
from .signal import median as _median

# XLA's CPU backend rewrites a cumulative sum into blocks of this length
_SCAN_BLOCK = 16


# ===========================================================================
# Device ops (tensors, time on the last axis)
# ===========================================================================
def _block_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, added in XLA's CPU
    order: sequentially inside blocks of 16, each block then offset by
    the (recursively summed) totals of the blocks before it."""
    n = x.shape[-1]
    b = _SCAN_BLOCK
    if n == 0:
        return x.clone()
    if n <= b:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, dim=-1)
    nb = -(-n // b)
    xp = torch.nn.functional.pad(x, (0, nb * b - n))
    inner = _block_cumsum(xp.reshape(x.shape[:-1] + (nb, b)))
    totals = _block_cumsum(inner[..., -1])
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(x.shape[:-1] + (nb * b,))
    return out[..., :n]


def sta_lta(a, nsta: int, nlta: int, device=None):
    """STA/LTA energy ratio along the last axis (batched).

    Classic trigger of Withers et al. (1998) as in the reference
    (functions/filter.py:511-570): running mean of a² over short and long
    trailing windows via cumulative sums; the first ``nlta-1`` samples of
    the STA are zeroed; zero LTA yields zero ratio.
    """
    a = as_tensor(a, device)
    cs = _block_cumsum(a * a)
    sta = cs.clone()
    sta[..., nsta:] += -cs[..., :-nsta]
    sta = sta / nsta
    lta = cs.clone()
    lta[..., nlta:] += -cs[..., :-nlta]
    lta = lta / nlta
    sta[..., : nlta - 1] = 0.0
    return torch.where(lta != 0, sta / torch.where(lta == 0, 1.0, lta), 0.0)


def moving_average(a, win: int = 3, device=None):
    """Trailing moving average, 'valid' length (reference
    filter.py:42-66)."""
    a = as_tensor(a, device)
    cs = _block_cumsum(a)
    out = cs.clone()
    out[..., win:] += -cs[..., :-win]
    return out[..., win - 1:] / win


def moving_median(a, win: int = 3, padded: bool = False, device=None):
    """Centered moving median (the mean of the two middle values for an
    even window, as ``jnp.median``); optional odd-symmetric edge padding
    (reference filter.py:89-113 + pad_array). ``win`` should be odd when
    ``padded`` so the output keeps the input length."""
    from ..utils.pad import pad_mirror_flip

    a = as_tensor(a, device)
    if padded:
        if a.ndim != 1:
            raise ValueError("padded moving_median expects a 1D array")
        a = pad_mirror_flip(a, (win - 1) // 2)
    return _median(a.unfold(-1, win, 1), dim=-1)


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x ** k`` by the square-and-multiply steps of ``lax.integer_pow``
    (``torch.pow`` rounds differently)."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _lstsq_svd(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(v, b)`` with its default ``rcond``: the SVD
    solve that drops singular values below ``eps·max(M, N)·s[0]``."""
    m, n = v.shape
    u, s, vt = torch.linalg.svd(v, full_matrices=False)
    rcond = float(torch.finfo(v.dtype).eps) * max(m, n)
    mask = s >= torch.tensor(rcond, dtype=s.dtype, device=s.device) * s[0]
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    return vt.T @ (s_inv * (u.T @ b))


def polynomial_filter(data, order: int = 3, kind: str = "high", device=None):
    """Remove (``high``) or keep (``low``) a polynomial trend along the
    last axis (reference filter.py:370-400): one least-squares fit on the
    Vandermonde matrix of ``x/n`` for all rows, solved as JAX solves it
    (:func:`_lstsq_svd`), in float32."""
    data = as_tensor(data, device)
    n = data.shape[-1]
    x = torch.arange(n, dtype=torch.float32, device=data.device)
    v = torch.stack([_integer_pow(x / n, k) for k in range(order + 1)],
                    dim=-1)
    coef = _lstsq_svd(v, torch.movedim(data, -1, 0).reshape(n, -1))
    fit = (v @ coef).reshape((n,) + tuple(data.shape[:-1]))
    fit = torch.movedim(fit, 0, -1)
    if kind == "high":
        return data - fit
    if kind == "low":
        return fit
    raise ValueError(f"filter kind {kind!r} is not available")


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


# ===========================================================================
# Host-side 1D statistics / outlier chains (numpy)
# ===========================================================================
def median_abs_deviation(x, axis=-1):
    """MAD: median(|x - median(x)|) (reference filter.py:155-175)."""
    x = np.asarray(x)
    med = np.median(x, axis=axis, keepdims=True)
    return np.median(np.abs(x - med), axis=axis)


def median_abs_deviation_double(x, axis=-1):
    """Two-sided MAD for asymmetric distributions (eurekastatistics method;
    reference filter.py:177-232). 1D: per-element left/right MAD. 2D (rows =
    windows): MAD side chosen by the window's center element."""
    x = np.asarray(x)
    if x.ndim == 1:
        med = np.median(x)
        diff = np.abs(x - med)
        left = np.median(diff[x <= med])
        right = np.median(diff[x >= med])
        if left == 0 or right == 0:
            raise ValueError("one side of median absolute deviation is zero")
        mad = np.where(x > med, right, left)
        return mad.astype(x.dtype)
    if x.ndim == 2:
        med = np.median(x, axis=axis)
        diff = np.abs(x - med[:, None])
        center_le = (x <= med[:, None])[:, x.shape[-1] // 2]
        center_ge = (x >= med[:, None])[:, x.shape[-1] // 2]
        left = np.median(diff[center_le], axis=axis)
        right = np.median(diff[center_ge], axis=axis)
        left = np.where(left == 0, 1, left)
        right = np.where(right == 0, 1, right)
        mad = np.ones((x.shape[0],), x.dtype)
        mad[center_le] = left
        mad[center_ge] = right
        return mad.astype(x.dtype)
    raise ValueError("only 1D/2D supported")


def _pad_mirror_flip_np(a, n: int) -> np.ndarray:
    """``utils.pad.pad_mirror_flip`` of host values, in the 32-bit type the
    JAX package pads in."""
    from ..utils.pad import pad_mirror_flip

    a = np.asarray(a)
    a = a.astype({np.dtype(np.float64): np.float32,
                  np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype))
    return pad_mirror_flip(torch.from_numpy(a), n).numpy()


def smooth(data, window_len: int = 11, window: str = "hanning"):
    """Window-convolution smoothing with least-squares-extrapolated edges
    (reference filter.py:238-301)."""
    data = np.asarray(data, float)
    if data.ndim != 1:
        raise ValueError("smooth only accepts 1D arrays")
    if data.size < window_len:
        raise ValueError("input shorter than window length")
    if window_len < 3:
        return data
    window_len += 1 if window_len % 2 == 0 else 0
    wins = {"flat": np.ones, "hanning": np.hanning, "hamming": np.hamming,
            "bartlett": np.bartlett, "blackman": np.blackman}
    if window not in wins:
        raise ValueError(f"window must be one of {list(wins)}")
    half = window_len // 2
    # linear extrapolation by least squares over the edge windows
    xs = np.vstack([np.arange(half), np.ones(half)]).T
    m0, c0 = np.linalg.lstsq(xs, data[:half], rcond=None)[0]
    m1, c1 = np.linalg.lstsq(xs, data[-half:], rcond=None)[0]
    s = np.r_[np.arange(-half, 0) * m0 + c0, data,
              np.arange(half, half * 2) * m1 + c1]
    w = wins[window](window_len)
    return np.convolve(s, w / w.sum(), mode="valid")


def zscore_filter(data, axis=-1):
    """Indices where |z-score| > 1 (reference filter.py:304-309)."""
    data = np.asarray(data)
    z = (data - np.mean(data, axis=axis)) / np.std(data, axis=axis)
    return np.nonzero(np.abs(z) > 1)[0]


def moving_zscore_filter(data, win, axis=-1):
    """Z-score against a smoothed running mean (reference
    filter.py:310-317)."""
    data = np.asarray(data)
    mean = smooth(data, window_len=win, window="hanning")
    z = (data - mean) / np.std(data, axis=axis)
    return np.nonzero(np.abs(z) > 1)[0]


def iqr_filter(a, axis=-1):
    """Tukey-fence outlier indices (reference filter.py:320-329)."""
    a = np.asarray(a)
    q1, q3 = np.quantile(a, [0.25, 0.75], axis=axis)
    iqr = q3 - q1
    return np.nonzero((a < q1 - 1.5 * iqr) | (a > q3 + 1.5 * iqr))[0]


def mad_filter(a, threshold: float = 3, mad_mode: str = "single"):
    """Global MAD outlier indices (reference filter.py:332-339)."""
    a = np.asarray(a)
    med = np.median(a)
    mad = (median_abs_deviation(a) if mad_mode == "single"
           else median_abs_deviation_double(a))
    mad = np.where(mad == 0, 1, mad)
    return np.nonzero(np.abs(a - med) / mad > threshold)[0]


def moving_mad_filter(a, win: int, threshold: float = 3,
                      mad_mode: str = "single"):
    """Moving-window MAD outlier indices (reference filter.py:342-367)."""
    a = np.asarray(a)
    if not isinstance(win, (int, np.integer)) or win % 2 != 1:
        raise ValueError("window length must be odd integer")
    half = (win - 1) // 2
    ap = _pad_mirror_flip_np(a, half)
    windows = np.lib.stride_tricks.sliding_window_view(ap, win)
    mov_med = np.median(windows, axis=-1)
    if mad_mode == "single":
        mov_mad = median_abs_deviation(windows)
    else:
        mov_mad = median_abs_deviation_double(windows)
    mov_mad = np.where(mov_mad == 0, 1, mov_mad)
    return np.nonzero(np.abs(a - mov_med) / mov_mad > threshold)[0]


def filter_interp_1d(data, method: str = "IQR", kind: str = "cubic",
                     win: int = 11, threshold: float = 3.0,
                     filter_boundaries: bool = True):
    """Detect outliers by ``method``, then re-interpolate across them
    (reference filter.py:403-505). Boundary runs of flagged indices are
    un-flagged to avoid extrapolation edge effects."""
    data = np.asarray(data)
    if data.ndim != 1:
        raise ValueError("data must be 1D")
    dispatch = {
        "IQR": lambda: iqr_filter(data),
        "z-score": lambda: zscore_filter(data),
        "r_z-score": lambda: moving_zscore_filter(data, win=win),
        "MAD": lambda: mad_filter(data, threshold=threshold,
                                  mad_mode="single"),
        "doubleMAD": lambda: mad_filter(data, threshold=threshold,
                                        mad_mode="double"),
        "r_doubleMAD": lambda: moving_mad_filter(
            data, win=win, threshold=threshold, mad_mode="double"),
        "r_singleMAD": lambda: moving_mad_filter(
            data, win=win, threshold=threshold, mad_mode="single"),
    }
    if method not in dispatch:
        raise ValueError(f"method must be one of {list(dispatch)}")
    idx = dispatch[method]()

    if filter_boundaries and idx.size:
        # drop runs of consecutive flags touching either end
        if idx[0] == 0:
            run = 1
            while run < idx.size and idx[run] == idx[run - 1] + 1:
                run += 1
            idx = idx[run:]
        if idx.size and idx[-1] == data.size - 1:
            run = 1
            while run < idx.size and idx[-run - 1] == idx[-run] - 1:
                run += 1
            idx = idx[:-run]

    mask = np.ones(data.size, bool)
    mask[idx] = False
    x = np.arange(data.size)
    f = scipy.interpolate.interp1d(x[mask], data[mask], kind=kind)
    return f(x)


# ===========================================================================
# Seafloor reflection detection (reference filter.py:574-751)
# ===========================================================================
def detect_seafloor_reflection(
    data,
    idx_slice_start=None,
    nsta: int | None = None,
    nlta: int | None = None,
    win: int = 30,
    threshold: float | None = None,
    win_mad: int | None = None,
    win_mad_post: int | None = None,
    win_median: int = 11,
    n: int = 5,
    post_detection_filter: bool = True,
    device=None,
):
    """Pick the seafloor reflection sample index per trace.

    Multi-stage chain (matching the reference): STA/LTA first-break
    detection (on ``device``) -> moving double-MAD outlier
    re-interpolation -> moving median (on ``device``) -> per-trace peak
    search window picking the first significant positive amplitude group
    among the n largest -> zero-trace interpolation -> optional post MAD
    filter.

    ``data`` is (nsamples, ntraces) numpy, reference layout.
    Returns int sample indices, shape (ntraces,).
    """
    device = resolve_device(device)
    data = np.asarray(data)
    nsamples, ntraces = data.shape

    nonzero_per_trace = np.count_nonzero(data, axis=0)
    mask_nonzero = nonzero_per_trace.astype(bool)
    n_zero = ntraces - int(np.count_nonzero(mask_nonzero))
    work = data[:, mask_nonzero] if n_zero else data

    if nsta is None:
        nsta = int(np.around(nsamples * 0.001))
    if nlta is None:
        nlta = int(np.around(nsamples * 0.05))
    if nsta < 3:
        nsta, nlta = 3, 50

    # (1) STA/LTA on the device, time last there
    ratio = sta_lta(np.ascontiguousarray(work.T, np.float32), nsta, nlta,
                    device=device).cpu().numpy().T

    # (2) first sample exceeding the threshold (default: water-column noise)
    thr = ratio[nlta: nlta * 2, :].max() if threshold is None else threshold
    idx = np.argmax(ratio > thr, axis=0)

    if idx_slice_start is not None:
        idx = idx + idx_slice_start
        idx = np.where(
            (idx > nsamples - idx_slice_start) | (idx < idx_slice_start),
            np.median(idx), idx,
        )

    # (3) outlier removal on the picked horizon
    if win_mad is None:
        win_mad = int(idx.size * 0.02)
        win_mad += 1 if win_mad % 2 == 0 else 0
        win_mad = max(win_mad, 7)
    idx = filter_interp_1d(idx, method="r_doubleMAD", kind="cubic",
                           threshold=3, win=win_mad).astype(int)

    # (4) moving median to kill remaining spikes (window forced odd — an
    # even window makes the centered median one element short)
    win_median = (int(0.3 * work.shape[1]) if win_median > work.shape[1]
                  else win_median)
    win_median = max(win_median, 3) | 1
    idx = moving_median(idx.astype(np.float32), win_median, padded=True,
                        device=device).cpu().numpy().astype(int)

    # (5) refine to the actual peak within ±win samples
    if win > 0:
        # fixed-width search window per trace, clamped inside the section
        # (the reference's boolean-mask construction assumes all windows fit)
        width = 2 * win + 1
        upper = np.clip(idx - win, 0, max(nsamples - width, 0))
        indices = upper[None, :] + np.arange(width)[:, None]
        seg = np.take_along_axis(work, indices, axis=0)

        k = min(n, seg.shape[0] - 1)
        nl = np.argpartition(-seg, k, axis=0)[:n]
        nl = np.take_along_axis(nl, np.argsort(nl, axis=0), axis=0)
        picks = np.empty(work.shape[1], int)
        for j in range(work.shape[1]):
            tr_idx = nl[:, j]
            gaps = np.diff(tr_idx)
            brk = np.nonzero(gaps > 1)[0]
            group = tr_idx[: brk[0] + 1] if brk.size else tr_idx
            picks[j] = group[np.argmax(seg[group, j])]
        idx = picks + upper
    # (6) interpolate across zero traces
    if n_zero:
        x = np.arange(ntraces)
        f = scipy.interpolate.interp1d(x[mask_nonzero], idx, kind="linear",
                                       fill_value="extrapolate")
        idx = f(x).astype(int)

    if post_detection_filter:
        if win_mad_post is None:
            win_mad_post = int(idx.size * 0.01)
            win_mad_post += 1 if win_mad_post % 2 == 0 else 0
            win_mad_post = max(win_mad_post, 7)
        idx = filter_interp_1d(idx, method="r_doubleMAD", kind="cubic",
                               threshold=3, win=win_mad_post).astype(int)
    return idx.astype(int)
