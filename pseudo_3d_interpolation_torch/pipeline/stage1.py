"""Stage-1 workflow steps 01-08: per-profile SEG-Y conditioning.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/stage1.py``.
replaces: the reference scripts merge_segys.py, reproject_segy.py,
delrt_correction_segy.py, delrt_padding_segy.py, static_correction_segy.py,
tide_compensation_segy.py, mistie_correction_segy.py, despiking_2D_segy.py.

Shared skeleton (reference pattern, e.g. static_correction_segy.py:324-545):
resolve input (file/dir/datalist) -> copy or in-place -> eager read ->
transform -> write back -> textual-header provenance -> sidecar aux file.

The array work runs on ``device`` (the first CUDA card by default, an
error without one; ``device='cpu'`` runs the same PyTorch ops on the host):
the trace shifts of steps 05-07, the despike windows (08), the moving
medians of the delrt correction (03), the STA/LTA, moving median and
polynomial fit of the seafloor statics (05) and the envelopes of the
mistie correlation (07). Steps 01, 02 and 04 are host numpy, as in the
JAX package, and take no ``device``. A step resolves its device before
its first file, so a missing card raises at once instead of failing
every file of the batch.

Differences from the JAX package that the results do not show:

- no shape buckets: the JAX package pads sections to multiples of
  (64, 128) so that ``jax.jit`` compiles once per bucket; eager PyTorch
  compiles nothing, and the buckets were exact, so the outputs are the
  same without them;
- no pandas on the steps' path: per-trace times are ``datetime64[ns]``
  built with numpy, the tide CSV is read with ``csv``, the sidecars and
  ``misties.csv`` are written with ``csv`` (same columns, same order),
  and the mistie table is a mapping of columns (:func:`compute_misties`
  still returns a DataFrame, and imports pandas to build it).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..io import textual
from ..io.auxiliary import (aux_path, resolve_input_files, table_columns,
                            table_rows, write_aux, write_csv)
from ..io.headers import scale_coordinates, unscale_coordinates
from ..io.segy import TRACE_HEADER_FIELDS, SegyFile, write_segy
from ..ops import filters as flt
from ..ops import signal as sig
from ..utils.crs import transform as crs_transform
from ..utils.device import as_tensor, resolve_device
from ..utils.logging import xprint
from .postprocess import _reflect_index

TODAY = datetime.date.today().strftime("%Y-%m-%d")

_NS_PER_S = 1_000_000_000
_NS_PER_DAY = 86_400 * _NS_PER_S


# ===========================================================================
# shared plumbing
# ===========================================================================
def _output_path(path: str, inplace: bool, suffix: str, output_dir=None) -> str:
    if inplace:
        return path
    base, ext = os.path.splitext(path)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        base = os.path.join(output_dir, os.path.basename(base))
    return f"{base}_{suffix}{ext}"


def _rewrite(src: SegyFile, out_path: str, data: np.ndarray, note: str,
             header_updates: dict | None = None, bin_updates: dict | None = None):
    """Write a processed copy preserving all trace headers, the source
    binary header (unmanaged fields like MeasurementSystem/job/line
    numbers survive — the reference's segyio copy mode preserved them),
    and provenance."""
    text = textual.add_processing_entry(src.text, note, prefix=TODAY)
    write_segy(
        out_path,
        data,
        headers=header_updates or {},
        raw_trace_headers=src.trace_headers_raw(),
        raw_binary_header=src.binary_header_raw(),
        bin_updates={"Interval": src.dt_us, **(bin_updates or {})},
        text=text,
        fmt=5,
        dt_us=src.dt_us,
    )


def _shift_traces(data, shifts, device) -> np.ndarray:
    """Integer-sample trace shift with zero fill of a host (ntraces, ns)
    block on ``device``, numpy back; a positive shift moves samples
    deeper (down).
    reference: static_correction_segy.py:259-321 (compensate_static).
    """
    x = as_tensor(np.asarray(data, np.float32), device)
    ns = x.shape[-1]
    idx = (torch.arange(ns, device=x.device)[None, :]
           - as_tensor(np.asarray(shifts), device, torch.int64)[:, None])
    inside = (idx >= 0) & (idx < ns)
    moved = torch.take_along_dim(x, idx.clamp(0, ns - 1), dim=-1)
    return torch.where(inside, moved, 0.0).cpu().numpy()


def _per_file(files, fn, verbose: int = 0) -> list[str]:
    """Run ``fn(path) -> out_path`` per file; failures are counted and
    skipped so one bad profile doesn't kill the batch (reference pattern:
    static_correction_segy.py:617-623). The steps resolve their device
    before this loop, so a missing card is no per-file failure."""
    outs, failed = [], 0
    for p in files:
        try:
            outs.append(fn(p))
        except Exception as e:  # noqa: BLE001 — batch robustness by design
            failed += 1
            xprint(f"{p}: FAILED ({type(e).__name__}: {e})", kind="error",
                   verbosity=verbose)
    if failed:
        xprint(f"{failed}/{len(files)} files failed", kind="warning",
               verbosity=verbose)
    return outs


def _delay_field(byte_delay: int = 109):
    """Trace-header spec for the recording delay (reference --byte_delay,
    delrt_correction_segy.py:45-46 / delrt_padding_segy.py:39-40): the
    standard DelayRecordingTime at byte 109, or an (offset, 'i2') spec for
    acquisition systems that store it at a non-standard byte."""
    b = int(byte_delay)
    return "DelayRecordingTime" if b == 109 else (b, "i2")


# ===========================================================================
# 08 — despike (reference despiking_2D_segy.py:75-387)
# ===========================================================================
def _despike_block(x: torch.Tensor, threshold: torch.Tensor,
                   gfloor: torch.Tensor, wy: int, wx: int, mode: str,
                   replace: str):
    """The window statistics of one (ns, ntr) block, its edges reflected:
    the (ns, ntr, wy·wx) window tensor, medians by ``kthvalue`` (the
    windows are odd, so the median is one order statistic, as
    ``jnp.median`` takes it)."""
    ns, ntr = x.shape
    ry, rx = wy // 2, wx // 2
    # numpy's reflect pad for any r, as jnp.pad reflects
    iy = torch.from_numpy(_reflect_index(ns, ry)).to(x.device)
    ix = torch.from_numpy(_reflect_index(ntr, rx)).to(x.device)
    xp = x.index_select(0, iy).index_select(1, ix)
    win = xp.unfold(0, wy, 1).unfold(1, wx, 1).reshape(ns, ntr, wy * wx)
    if mode == "median":
        stat = sig.median(win.abs(), dim=-1)
    elif mode == "mean":
        stat = win.abs().mean(dim=-1)
    else:
        stat = torch.sqrt((win * win).mean(dim=-1))
    floor = torch.maximum(stat, gfloor)
    spikes = x.abs() > threshold * floor
    if replace == "median":
        repl = sig.median(win, dim=-1)
    elif replace == "zeros":
        repl = torch.zeros_like(x)
    elif replace == "mode":
        # signed window statistic (reference out='mode': func over the
        # signed neighborhood, despiking_2D_segy.py:369-371)
        if mode == "median":
            repl = sig.median(win, dim=-1)
        elif mode == "mean":
            repl = win.mean(dim=-1)
        else:
            repl = torch.sqrt((win * win).mean(dim=-1))
    elif replace == "scaled":
        # scale the spike down to the background amplitude (the per-sample
        # form of the reference's out='scaled' window rescale, :358-366)
        repl = torch.sign(x) * floor
    else:  # 'threshold': clip to the local threshold amplitude
        repl = torch.sign(x) * threshold * floor
    return torch.where(spikes, repl, x), spikes


def despike_section(data: np.ndarray, window=(9, 5), threshold: float = 4.0,
                    mode: str = "median", replace: str = "median",
                    max_bytes: float = 256e6, device=None):
    """Remove single-trace noise bursts from a (nsamples, ntraces) section.

    A sample is a spike when its magnitude exceeds ``threshold`` x the local
    window statistic (``median``/``mean``/``rms`` of |amplitude| over a
    (nsamples x ntraces) neighborhood). Spikes are replaced by the window
    median (``replace='median'``), zero, or a threshold-clipped value.
    The section goes to ``device`` once; blocks of traces, each with a
    halo of ``window[1] // 2`` traces, keep the window tensor under about
    ``max_bytes``, and the result does not depend on the blocks.
    Returns numpy (cleaned, spike_mask).
    """
    device = resolve_device(device)
    wy, wx = int(window[0]) | 1, int(window[1]) | 1  # force odd
    data = np.asarray(data, np.float32)
    ns, ntr = data.shape
    rx = wx // 2
    # amplitude floor from the WHOLE section, so the result does not
    # depend on the blocks
    gfloor = np.float32(1e-8 + np.abs(data).mean() * 1e-3)
    x = as_tensor(data, device)
    thr = torch.tensor(np.float32(threshold), device=x.device)
    gf = torch.tensor(gfloor, device=x.device)
    # bound the (ns, block, wy·wx) window tensor to ~max_bytes
    block = max(int(max_bytes / max(ns * wy * wx * 4, 1)), wx * 4)
    if ntr <= block:
        c, s = _despike_block(x, thr, gf, wy, wx, mode, replace)
        return c.cpu().numpy(), s.cpu().numpy()
    halo = rx
    cleaned = torch.empty_like(x)
    spikes = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    width = min(block + 2 * halo, ntr)
    for s0 in range(0, ntr, block):
        s1 = min(s0 + block, ntr)
        lo = min(max(s0 - halo, 0), ntr - width)
        c, sp = _despike_block(x[:, lo: lo + width], thr, gf, wy, wx, mode,
                               replace)
        cleaned[:, s0:s1] = c[:, s0 - lo: s1 - lo]
        spikes[:, s0:s1] = sp[:, s0 - lo: s1 - lo]
    return cleaned.cpu().numpy(), spikes.cpu().numpy()


def despike(path, window=(9, 5), threshold: float = 4.0, mode: str = "median",
            replace: str = "median", split_at_delrt: bool = False,
            window_time_ms: float | None = None,
            inplace: bool = False, output_dir=None, txt_suffix: str | None = None,
            byte_delay: int = 109, verbose: int = 0, device=None) -> list[str]:
    """``window_time_ms`` sets the sample-axis window in TWT milliseconds
    per file (reference --window_time), overriding ``window[0]``. The
    windows run on ``device``."""
    device = resolve_device(device)

    def _one(p):
        with SegyFile(p) as f:
            data = f.trace_data()
            win = window
            if window_time_ms is not None:
                dt_ms = f.dt_us / 1000.0
                win = (max(int(round(window_time_ms / dt_ms)) | 1, 3),
                       window[1])
            if split_at_delrt:
                # process segments of constant DelayRecordingTime separately
                # so window statistics never mix differently-delayed traces
                # (reference despiking_2D_segy.py:451-473)
                delrt = f.header(_delay_field(byte_delay))
                cleaned = np.empty_like(data)
                n_spikes = 0
                edges = np.r_[0, np.nonzero(np.diff(delrt))[0] + 1, len(delrt)]
                for a, b in zip(edges[:-1], edges[1:]):
                    c, s = despike_section(data[a:b].T, win, threshold, mode,
                                           replace, device=device)
                    cleaned[a:b] = c.T
                    n_spikes += int(s.sum())
                cleaned = cleaned.T
            else:
                cleaned, spikes = despike_section(data.T, win, threshold, mode,
                                                  replace, device=device)
                n_spikes = int(spikes.sum())
            out = _output_path(p, inplace, txt_suffix or "despk", output_dir)
            _rewrite(f, out, cleaned.T, f"DESPIKE ({n_spikes} samples)")
        xprint(f"{p}: removed {n_spikes} spike samples -> {out}",
               kind="info", verbosity=verbose)
        return out

    return _per_file(resolve_input_files(path), _one, verbose)


# ===========================================================================
# 04 — delrt padding (reference delrt_padding_segy.py:47-251)
# ===========================================================================
def delrt_pad(path, inplace: bool = False, output_dir=None, txt_suffix: str | None = None,
              byte_delay: int = 109, verbose: int = 0) -> list[str]:
    """Zero-pad all traces of all files onto one global TWT axis spanning
    the min..max recorded window; updates Samples + per-trace delrt."""
    files = resolve_input_files(path)
    infos = []
    for p in files:
        with SegyFile(p) as f:
            delrt = f.header(_delay_field(byte_delay))
            if delrt.size == 0:
                xprint(f"{p}: zero traces — skipped", kind="warning",
                       verbosity=verbose)
                continue
            infos.append((p, delrt, f.n_samples, f.dt_us))
    if not infos:
        raise ValueError(f"delrt_pad: no non-empty SEG-Y files under {path!r}")
    dts = {dt_us for _, _, _, dt_us in infos}
    if len(dts) > 1:
        raise ValueError(
            f"delrt_pad requires one sample interval across files, got {sorted(dts)} µs"
        )
    dt_ms = infos[0][3] / 1000.0
    delrt_min = min(int(d.min()) for _, d, _, _ in infos)
    end_max = max(int(d.max()) + int(round(ns * dt_ms)) for _, d, ns, _ in infos)
    ns_out = int(round((end_max - delrt_min) / dt_ms))
    xprint(f"global TWT axis: {delrt_min}-{end_max} ms ({ns_out} samples)",
           kind="info", verbosity=verbose)

    outs = []
    for p, delrt, ns, dt_us in infos:
        with SegyFile(p) as f:
            data = f.trace_data()
            off = np.rint((delrt - delrt_min) / dt_ms).astype(int)
            padded = np.zeros((f.n_traces, ns_out), np.float32)
            for o in np.unique(off):
                sel = off == o
                end = min(o + ns, ns_out)
                padded[sel, o:end] = data[sel, : end - o]
            out = _output_path(p, inplace, txt_suffix or "pad", output_dir)
            _rewrite(
                f, out, padded,
                f"DELRT PAD ({delrt_min} ms, {ns_out} samples)",
                header_updates={
                    _delay_field(byte_delay): delrt_min,
                    "TRACE_SAMPLE_COUNT": ns_out,
                },
                bin_updates={"Samples": ns_out, "SamplesOriginal": ns},
            )
        outs.append(out)
        xprint(f"padded {p} -> {out}", kind="debug", verbosity=verbose)
    return outs


# ===========================================================================
# 03 — delrt correction (reference delrt_correction_segy.py:82-430)
# ===========================================================================
def _moving_median_f32(values: np.ndarray, win: int, device) -> np.ndarray:
    """The padded moving median of float64 host values in float32 on
    ``device``, numpy float32 back (the JAX step's ``moving_median`` of
    ``jnp.asarray(values, jnp.float32)``)."""
    return flt.moving_median(values.astype(np.float32), win, padded=True,
                             device=device).cpu().numpy()


def delrt_correct(path, n_neighbors: int = 3, win_samples: int = 100,
                  inplace: bool = False, output_dir=None, txt_suffix: str | None = None,
                  byte_delay: int = 109, verbose: int = 0,
                  device=None) -> list[str]:
    """Fix wrong DelayRecordingTime values.

    Detection: the first-break TWT (peak |amplitude| within a window) should
    vary smoothly along the profile; traces whose absolute first-break TWT
    (delrt + peak-sample·dt) jumps while their neighbors' agree get their
    delrt re-based so the first break lines up with the local median. The
    two moving medians of each pass run on ``device``.
    """
    device = resolve_device(device)

    def _one(p):
        with SegyFile(p) as f:
            data = f.trace_data()
            delrt = f.header(_delay_field(byte_delay)).astype(np.float64)
            dt_ms = f.dt_us / 1000.0
            peak = np.argmax(np.abs(data[:, :win_samples]), axis=1)
            fb_twt = delrt + peak * dt_ms
            # Only traces whose HEADER disagrees with the neighborhood are
            # candidates (the reference inspects delrt-change points,
            # :82-255) — first-break deviation alone must never rewrite a
            # correct header on rough seafloor. Corrections snap to the
            # neighborhood's recorded delrt when the first breaks then
            # line up. Wrong values come in runs, so widen the window and
            # iterate until stable.
            win = max(2 * n_neighbors + 1, min(21, len(fb_twt) | 1)) | 1
            new_delrt = delrt.copy()
            n_fix = 0
            fb = fb_twt.copy()
            # corrections cascade inward ~win/2 traces per pass, so a long
            # wrong-delrt run needs ~run/(win/2) passes; the loop still
            # breaks as soon as a pass changes nothing
            tol_fix = max(2 * dt_ms, 1.0)
            w = win
            while True:
                for _ in range(max(3, 2 + len(fb) // max(1, w // 2))):
                    med = _moving_median_f32(fb, min(w, len(fb) | 1), device)
                    delrt_med = _moving_median_f32(
                        new_delrt, min(w, len(fb) | 1), device)
                    dev = fb - med
                    header_odd = np.abs(new_delrt - delrt_med) > max(dt_ms, 0.5)
                    step = header_odd & (np.abs(dev) > tol_fix)
                    if not step.any():
                        break
                    corrected = new_delrt[step] - dev[step]
                    # snap to the neighborhood's actual recorded delrt value
                    snap = np.abs(corrected - delrt_med[step]) <= tol_fix
                    corrected[snap] = delrt_med[step][snap]
                    fb[step] += corrected - new_delrt[step]
                    new_delrt[step] = corrected
                    n_fix = int((new_delrt != delrt).sum())
                # a wrong-delrt RUN longer than w/2 defeats the windowed
                # detector outright; at its boundaries the first breaks
                # JUMP together WITH the header step, while a genuine delrt
                # change keeps the first breaks continuous. Widen only on
                # that evidence.
                d_h = np.diff(new_delrt)
                d_f = np.diff(fb)
                spurious = (np.abs(d_h) > tol_fix) & (np.abs(d_f - d_h) <= tol_fix)
                if not spurious.any() or w >= (len(fb) | 1):
                    break
                w = min(2 * w + 1, len(fb) | 1) | 1
            # Offset-trace special case (reference delrt_correction_segy.py:
            # 195-242): a GENUINE delrt change whose header flip is
            # misaligned by one trace leaves exactly one trace adjacent to
            # the boundary recorded with the OTHER delay; snap it to the
            # other delrt value present at the boundary when that lines the
            # first break up.
            tol = max(2 * dt_ms, 1.0)
            for c in np.where(np.diff(new_delrt) != 0)[0] + 1:
                lo = max(c - n_neighbors - 1, 0)
                hi = min(c + n_neighbors + 1, len(new_delrt))
                vals = np.unique(new_delrt[lo:hi])
                if len(vals) != 2:
                    continue
                fb2 = new_delrt[lo:hi] + peak[lo:hi] * dt_ms
                med = np.median(fb2)
                for j in (c - 1, c):
                    if not (lo <= j < hi):
                        continue
                    other = vals[vals != new_delrt[j]][0]
                    if (abs(new_delrt[j] + peak[j] * dt_ms - med) > tol
                            and abs(other + peak[j] * dt_ms - med) <= tol):
                        new_delrt[j] = other
            n_fix = int((new_delrt != delrt).sum())
            out = _output_path(p, inplace, txt_suffix or "delrt", output_dir)
            _rewrite(
                f, out, data, f"DELRT CORRECTION ({n_fix} traces)",
                header_updates={_delay_field(byte_delay):
                                np.rint(new_delrt).astype(np.int64)},
            )
        xprint(f"{p}: corrected {n_fix} DelayRecordingTime values -> {out}",
               kind="info", verbosity=verbose)
        return out

    return _per_file(resolve_input_files(path), _one, verbose)


# ===========================================================================
# 05 — static correction (reference static_correction_segy.py:93-545)
# ===========================================================================
def _limit_depression_shifts(static: np.ndarray, horizon_smooth: np.ndarray,
                             limits, device=None):
    """Relax the static clamp over seafloor depressions (pockmarks).

    reference static_correction_segy.py:182-238: depressions are detected
    as negative double-MAD outliers of the polynomial-detrended lowpassed
    horizon (the fit on ``device``); across each depression (runs >= 3
    traces) the shift is clipped to a trapezoid limit profile — ``limits
    = (npad, max_edges, max_center)`` ramps from ``max_edges`` at the
    transition-zone boundary down to ``max_center`` over the depression
    itself.

    Returns ``(static, applied)``: when no depression is detected the
    reference RETURNS EARLY from ``get_static`` (:188-201), skipping every
    subsequent clip — ``applied=False`` lets the caller mirror that.
    """
    npad, limit_outer, limit_center = (int(v) for v in limits)
    detrend = -flt.polynomial_filter(horizon_smooth, order=11,
                                     device=device).cpu().numpy()
    try:
        idx = flt.mad_filter(detrend, threshold=3, mad_mode="double")
    except ValueError:  # a zero one-sided MAD (flat detrend): no depressions
        return static, False
    idx = idx[detrend[idx] < 0]
    if idx.size == 0:
        return static, False
    runs = [r for r in np.split(idx, np.nonzero(np.diff(idx) > 1)[0] + 1)
            if r.size >= 3]
    if not runs:
        return static, False
    pos = np.concatenate(
        [np.arange(r[0] - npad, r[-1] + npad + 1) for r in runs])
    lim = np.concatenate(
        [np.concatenate((np.linspace(limit_outer, limit_center + 1, npad),
                         np.full(r.size, limit_center, float),
                         np.linspace(limit_center + 1, limit_outer, npad)))
         for r in runs]).astype(int)
    ok = (pos >= 0) & (pos < static.size)
    pos, lim = pos[ok], lim[ok]
    static[pos] = np.where(np.abs(static[pos]) > lim,
                           lim * np.sign(static[pos]), static[pos])
    return static, True


def compute_static(horizon_samples: np.ndarray, dt_ms: float,
                   savgol_window: int = 7, savgol_order: int = 1,
                   clip_samples: int | None = 10,
                   clip_percentile: float | None = 99.0,
                   clip_mad: float | None = None,
                   limit_depressions=None,
                   win_mad: int | None = None,
                   integer: bool = True, device=None) -> np.ndarray:
    """static = lowpassed(horizon) − filtered horizon (the reference's
    ``get_static``, static_correction_segy.py:93-256, mirrored exactly).

    The static is measured against the MAD-repaired horizon. Defaults and
    semantics match the reference: ``savgol_window``/``savgol_order`` are
    its ``win_sg=7``/polyorder 1; the robust pre-filter window ``win_mad``
    defaults to 5% of the series (odd, ≥7 traces, :164-167); limits apply
    in the reference's order — depressions clamp (``(npad, max_edges,
    max_center)`` trapezoid, :182-238, its polynomial fit on ``device``),
    percentile (:242-244), hard ``clip_samples`` bound (:247-248), then
    ``|static| ≤ ceil(median(|static|)·clip_mad)`` (:251-254).
    ``integer=False`` returns the unrounded float statics. Host numpy
    otherwise: ``device`` is resolved only with ``limit_depressions``.
    """
    import scipy.signal as ss

    h = horizon_samples.astype(np.float64)
    if win_mad is None:
        win_mad = int(len(h) * 0.05)  # reference :164-167
    win_mad = max(win_mad | 1, 7)
    # outlier-robust pre-filter, as the reference chains r_doubleMAD+interp
    h_f = flt.filter_interp_1d(h, method="r_doubleMAD", kind="cubic",
                               win=win_mad)
    win = min(savgol_window | 1, len(h) - (1 - len(h) % 2))
    if win <= savgol_order:
        smooth = h_f
    else:
        smooth = ss.savgol_filter(h_f, win, savgol_order)
    static = smooth - h_f
    if limit_depressions is not None:
        static, applied = _limit_depression_shifts(
            static, smooth, limit_depressions, device=resolve_device(device))
        if not applied:
            # reference quirk mirrored exactly: with limit_depressions
            # enabled but NO depression detected, get_static returns
            # before every subsequent clip (static_correction_segy.py:
            # 188-201) — percentile/samples/MAD limits never run
            return static if not integer else np.rint(static).astype(np.int32)
    if clip_percentile is not None:
        bound = np.percentile(np.abs(static), clip_percentile)
        static = np.clip(static, -bound, bound)
    if clip_samples is not None:
        static = np.clip(static, -clip_samples, clip_samples)
    if clip_mad is not None:
        bound = np.ceil(np.median(np.abs(static)) * clip_mad)
        static = np.clip(static, -bound, bound)
    if not integer:
        return static
    return np.rint(static).astype(np.int32)


def static_correct(path, mode: str = "amp", win_samples: int = 30,
                   savgol_window: int = 7, inplace: bool = False,
                   output_dir=None, txt_suffix: str | None = None, verbose: int = 0,
                   nsta: int | None = None, nlta: int | None = None,
                   win_mad: int | None = None, win_median: int = 11,
                   limit_shift: int = 12,
                   n_amp_samples: int = 5,
                   limit_depressions=(10, 10, 5),
                   velocity: float = 1500.0,
                   write_aux_file: bool = True,
                   write_seafloor2trace: bool = False,
                   device=None) -> list[str]:
    """Seafloor-static correction; knobs map to the reference's
    ``--nsta/--nlta/--win_mad/--win_median/--limit_shift/--n_amp_samples/
    --limit_depressions/--write_aux/--write_seafloor2trace`` flags with the
    reference wrapper's defaults and clip chain (no percentile, hard
    ``limit_shift`` bound, median-of-abs×3 clamp, depressions trapezoid
    (10, 10, 5) — static_correction_segy.py:390-400,473-481).

    ``mode='swdep'`` computes the static on the ElevationScalar-scaled
    SourceWaterDepth VALUES (meters), then converts depth→samples with
    ``velocity`` and rounds (:390-408). Headers follow the reference
    convention (:504-536): TotalStaticApplied (byte 103) holds the applied
    static in ms×1000 with the -1000 scalar in UnassignedInt1 (byte 233);
    ``write_seafloor2trace`` additionally stores the picked seafloor TWT
    (ms×1000) in UnassignedInt2 (byte 237). The seafloor pick, the
    depression fit and the shift run on ``device``."""
    device = resolve_device(device)

    def _one(p):
        with SegyFile(p) as f:
            data = f.trace_data()
            dt_ms = f.dt_us / 1000.0
            delrt = f.header("DelayRecordingTime").astype(np.float64)
            clip_kw = dict(savgol_window=savgol_window,
                           win_mad=win_mad,
                           clip_percentile=None,
                           clip_samples=limit_shift,
                           clip_mad=3,
                           limit_depressions=limit_depressions,
                           device=device)
            if mode == "swdep":
                swdep = f.header("SourceWaterDepth").astype(np.float64)
                scalel = f.header("ElevationScalar").astype(np.int64)
                if np.all(scalel > 0):
                    swdep = swdep * np.abs(scalel)
                elif np.all(scalel < 0):
                    swdep = swdep / np.abs(scalel)
                # static in DEPTH units; depth -> samples BEFORE rounding
                static_depth = compute_static(swdep, dt_ms, integer=False,
                                              **clip_kw)
                static = np.rint(
                    static_depth * 2.0 / (velocity * dt_ms * 1e-3)
                ).astype(np.int32)
                # sidecar 'horizon_sample' column stays a SAMPLE index in
                # both modes
                horizon = (2.0 * swdep / velocity * 1e3 - delrt) / dt_ms
            else:
                horizon = flt.detect_seafloor_reflection(
                    data.T, win=win_samples, nsta=nsta, nlta=nlta,
                    win_mad=win_mad, win_median=win_median, n=n_amp_samples,
                    device=device)
                static = compute_static(horizon, dt_ms, **clip_kw)
            shifted = _shift_traces(data, static, device)
            out = _output_path(p, inplace, txt_suffix or "sta", output_dir)
            # reference convention: ms x 1000 with a -1000 scalar in byte
            # 233 (static_correction_segy.py:520-530); truncation toward
            # zero mirrors the reference's astype('int32')
            tsa = (static.astype(np.float64) * dt_ms * 1000.0).astype(np.int64)
            # byte 103 is i2: saturate beyond +-32.767 ms
            tsa = np.clip(tsa, -32767, 32767)
            header_updates = {
                "TotalStaticApplied": tsa,
                "UnassignedInt1": np.full(len(static), -1000, np.int64)}
            note = f"STATIC CORRECTION ({mode}, sg{savgol_window})"
            if write_seafloor2trace and mode == "amp":
                twt_seafloor_ms = delrt + horizon.astype(np.float64) * dt_ms
                header_updates["UnassignedInt2"] = np.rint(
                    twt_seafloor_ms * 1000.0).astype(np.int64)
                header_updates["UnassignedInt1"] = np.full(
                    len(static), -1000, np.int64)
                note += " -> SEAFLOOR (byte:237, scalar byte:233)"
            _rewrite(f, out, shifted, note, header_updates=header_updates)
            if write_aux_file:
                write_aux(out, ".sta", {
                    "tracl": np.arange(1, len(static) + 1),
                    "horizon_sample": horizon.astype(int),
                    "static_samples": static,
                    "static_ms": static * dt_ms,
                })
        xprint(f"{p}: static range [{static.min()}, {static.max()}] samples -> {out}",
               kind="info", verbosity=verbose)
        return out

    return _per_file(resolve_input_files(path), _one, verbose)


# ===========================================================================
# 06 — tide compensation (reference tide_compensation_segy.py:77-289)
# ===========================================================================
def header_datetimes(year, doy, hh, mm, ss) -> np.ndarray:
    """``datetime64[ns]`` of (year, day of year, hour, minute, second)
    header columns, as pandas assembles them: January 1st of the year,
    plus the days, hours, minutes and seconds, each of which may overflow
    its unit. Years outside the nanosecond range (1678-2261) raise
    ``ValueError``, as pandas refuses them."""
    year = np.asarray(year, np.int64)
    if year.size and ((year < 1678) | (year > 2261)).any():
        bad = year[(year < 1678) | (year > 2261)][0]
        raise ValueError(f"recording year {bad} is outside the datetime64[ns] "
                         "range (1678-2261)")
    jan1 = (year - 1970).astype("datetime64[Y]").astype("datetime64[ns]")
    offset = ((np.asarray(doy, np.int64) - 1) * _NS_PER_DAY
              + np.asarray(hh, np.int64) * 3600 * _NS_PER_S
              + np.asarray(mm, np.int64) * 60 * _NS_PER_S
              + np.asarray(ss, np.int64) * _NS_PER_S)
    return jan1 + offset.astype("timedelta64[ns]")


def trace_datetimes(f: SegyFile) -> np.ndarray:
    """Per-trace ``datetime64[ns]`` from the standard header fields
    (reference :224-236)."""
    return header_datetimes(f.header("YearDataRecorded"), f.header("DayOfYear"),
                            f.header("HourOfDay"), f.header("MinuteOfHour"),
                            f.header("SecondOfMinute"))


def tide_compensate(path, tide_file: str, velocity: float = 1500.0,
                    src_epsg: int | None = None,
                    constituents: list[str] | None = None,
                    correct_minor: bool = False,
                    coords_bytes=(73, 77),
                    inplace: bool = False, output_dir=None, txt_suffix: str | None = None,
                    verbose: int = 0, device=None) -> list[str]:
    """Shift traces by the predicted tide at their recording time/position.

    ``tide_file`` is either

    - a CSV with columns ``datetime`` (UTC, ISO 8601) and ``height`` (m,
      positive up) — a positionally constant tide series
      (``utils.tide.read_tide_csv``), or
    - a harmonic-constant **atlas** (``.nc``/``.h5`` with ``<NAME>_amp`` /
      ``<NAME>_phase`` grids over lat/lon, see ``utils.tide.TideAtlas``;
      read with h5py, so only where h5py is installed) — tide is then
      predicted at every trace's lat/lon and recording time, matching the
      reference's TPXO9 spatial prediction
      (tide_compensation_segy.py:77-143, 242-252).

    ``src_epsg``: EPSG of projected trace coordinates, for conversion to
    lat/lon when using an atlas. ``constituents`` restricts the atlas
    synthesis to the named subset and ``correct_minor`` adds the sixteen
    admittance-inferred minors (reference ``--constituents`` /
    ``--correct_minor``). ``coords_bytes`` selects the header coordinate
    pair (reference ``--src_coords``). The shift runs on ``device``.
    """
    from ..utils.tide import TideAtlas, read_tide_csv

    device = resolve_device(device)
    atlas = None
    if tide_file.lower().endswith((".nc", ".h5", ".hdf5", ".atlas")):
        atlas = TideAtlas.from_file(tide_file)
        xprint(f"tide atlas: {sorted(atlas.constituents)} over "
               f"lat [{atlas.lat[0]:.2f}, {atlas.lat[-1]:.2f}], "
               f"lon [{atlas.lon[0]:.2f}, {atlas.lon[-1]:.2f}]",
               kind="info", verbosity=verbose)
    else:
        t_ref, h_ref = read_tide_csv(tide_file)
        t_ref = t_ref.astype("int64")

    def _trace_latlon(f):
        from ..utils import crs as crs_lib

        x, y, units = scale_coordinates(f, coords_bytes)
        if units == 2:  # already geographic (converted to decimal degrees)
            return y, x
        if src_epsg in (None, 4326):
            # src_epsg=4326 says the header lengths ARE decimal degrees;
            # with src_epsg omitted degrees and a small local grid look
            # alike, so the caller must say
            if src_epsg == 4326:
                if (np.abs(x) <= 360).all() and (np.abs(y) <= 90).all():
                    return y, x
                raise ValueError(
                    "src_epsg=4326 but header coordinates exceed degree "
                    "bounds — they look projected; pass the projected CRS")
            raise ValueError(
                "atlas tide compensation on projected coordinates requires "
                "src_epsg (e.g. the UTM zone EPSG) to convert to lat/lon")
        lon, lat = crs_lib.transform(x, y, src_epsg, 4326)
        return lat, lon

    def _one(p):
        with SegyFile(p) as f:
            data = f.trace_data()
            dt_s = f.dt_us * 1e-6
            times64 = trace_datetimes(f)
            times = times64.astype("int64")
            if atlas is not None:
                lat, lon = _trace_latlon(f)
                height = atlas.predict(times64, lat, lon,
                                       constituents=constituents,
                                       correct_minor=correct_minor)
            else:
                if times.min() < t_ref[0] or times.max() > t_ref[-1]:
                    xprint(f"{p}: trace times extend beyond the tide table — "
                           "endpoint heights will be clamped", kind="warning",
                           verbosity=verbose)
                height = np.interp(times, t_ref, h_ref)
            # high tide raises the vessel, so the seafloor records DEEPER;
            # compensation shifts traces up (negative = shallower), matching
            # the reference's compensate_tide sign
            shift = -np.rint(2.0 * height / velocity / dt_s).astype(np.int32)
            shifted = _shift_traces(data, shift, device)
            out = _output_path(p, inplace, txt_suffix or "tide", output_dir)
            _rewrite(f, out, shifted, "TIDE COMPENSATION")
            write_aux(out, ".tid", {
                "tracl": np.arange(1, len(shift) + 1),
                "tide_m": height,
                "shift_samples": shift,
            })
        xprint(f"{p}: tide range [{height.min():.2f}, {height.max():.2f}] m -> {out}",
               kind="info", verbosity=verbose)
        return out

    return _per_file(resolve_input_files(path), _one, verbose)


# ===========================================================================
# 07 — mistie correction (reference mistie_correction_segy.py)
# ===========================================================================
def _segment_intersections(nav_a: np.ndarray, nav_b: np.ndarray,
                           chunk: int = 2048):
    """All intersection points between two polylines (vectorized cross
    products on the host; replaces shapely/GEOS STRtree, reference
    :85-212).

    Returns list of (point, idx_a, idx_b) with segment indices.
    """
    out = []
    # `chunk` bounds broadcast memory at ~chunk² · 8 floats
    for sa in range(0, len(nav_a) - 1, chunk):
        ea = min(sa + chunk, len(nav_a) - 1)
        a_lo = np.minimum(nav_a[sa:ea], nav_a[sa + 1 : ea + 1])
        a_hi = np.maximum(nav_a[sa:ea], nav_a[sa + 1 : ea + 1])
        for sb in range(0, len(nav_b) - 1, chunk):
            eb = min(sb + chunk, len(nav_b) - 1)
            b_lo = np.minimum(nav_b[sb:eb], nav_b[sb + 1 : eb + 1])
            b_hi = np.maximum(nav_b[sb:eb], nav_b[sb + 1 : eb + 1])
            # bbox rejection of whole chunk pairs
            if (a_lo.min(0) > b_hi.max(0)).any() or (b_lo.min(0) > a_hi.max(0)).any():
                continue
            a0 = nav_a[sa:ea][:, None, :]
            a1 = nav_a[sa + 1 : ea + 1][:, None, :]
            b0 = nav_b[sb:eb][None, :, :]
            b1 = nav_b[sb + 1 : eb + 1][None, :, :]
            d1 = a1 - a0
            d2 = b1 - b0
            denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
            diff = b0 - a0
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]) / denom
                u = (diff[..., 0] * d1[..., 1] - diff[..., 1] * d1[..., 0]) / denom
            # half-open [0, 1) on the segment parameters except each
            # polyline's FINAL segment: a crossing exactly on a shared
            # interior vertex must count once
            t_ok = np.where(
                (np.arange(sa, ea) == len(nav_a) - 2)[:, None], t <= 1, t < 1)
            u_ok = np.where(
                (np.arange(sb, eb) == len(nav_b) - 2)[None, :], u <= 1, u < 1)
            hit = (np.abs(denom) > 1e-12) & (t >= 0) & t_ok & (u >= 0) & u_ok
            for ia, ib in zip(*np.nonzero(hit)):
                pt = nav_a[sa + ia] + t[ia, ib] * (nav_a[sa + ia + 1] - nav_a[sa + ia])
                out.append((pt, sa + ia, sb + ib))
    return out


MISTIE_COLUMNS = ("line_a", "line_b", "trace_a", "trace_b", "x", "y",
                  "x_a", "y_a", "dist_a", "x_b", "y_b", "dist_b",
                  "lag_samples", "mistie_ms", "correlation")


def mistie_table(profiles: dict, twt_window_ms: float = 50.0,
                 min_correlation: float = 0.8, win_cc_ms=None,
                 verbose: int = 0, device=None, timings: dict | None = None):
    """The mistie table of :func:`compute_misties` without pandas: an
    ordered dict of the columns ``MISTIE_COLUMNS`` (numpy arrays, the
    rows whose correlation reaches ``min_correlation``) and the lines.

    The envelopes run on ``device``; the intersection search and the
    correlations are host numpy. ``timings``, when given, collects the
    seconds of the intersection search under ``'intersections'``.
    """
    import time

    device = resolve_device(device)
    names = list(profiles)
    rows = []
    # clustered crossings snap to the same nearest trace; memoize envelopes
    # per (line, trace) so N intersections cost O(unique traces) FFTs
    _env_cache: dict = {}

    def _envelope(line, tr, trace_data):
        key = (line, tr)
        if key not in _env_cache:
            _env_cache[key] = sig.envelope(
                np.asarray(trace_data, np.float32), device=device).cpu().numpy()
        return _env_cache[key]

    t_search = 0.0
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = profiles[names[i]], profiles[names[j]]
            t0_search = time.perf_counter()
            hits = _segment_intersections(a["nav"], b["nav"])
            t_search += time.perf_counter() - t0_search
            for pt, ia, ib in hits:
                tr_a = int(np.argmin(np.hypot(*(a["nav"] - pt).T)))
                tr_b = int(np.argmin(np.hypot(*(b["nav"] - pt).T)))
                dt = a["dt_ms"]
                if b["dt_ms"] != dt:
                    raise ValueError("profiles must share one sample interval")
                ea = _envelope(names[i], tr_a, a["data"][tr_a])
                eb = _envelope(names[j], tr_b, b["data"][tr_b])
                # overlapping absolute-TWT window
                t0 = max(a["delrt"][tr_a], b["delrt"][tr_b])
                t1 = min(a["delrt"][tr_a] + len(ea) * dt, b["delrt"][tr_b] + len(eb) * dt)
                if win_cc_ms is not None:
                    t0 = max(t0, float(min(win_cc_ms)))
                    t1 = min(t1, float(max(win_cc_ms)))
                if t1 - t0 < twt_window_ms:
                    continue
                sa = int(round((t0 - a["delrt"][tr_a]) / dt))
                sb = int(round((t0 - b["delrt"][tr_b]) / dt))
                n = int((t1 - t0) / dt)
                wa = ea[sa : sa + n] - ea[sa : sa + n].mean()
                wb = eb[sb : sb + n] - eb[sb : sb + n].mean()
                if len(wa) != len(wb) or len(wa) < 8:
                    continue
                xc = np.correlate(wa, wb, mode="full")
                lag = int(np.argmax(xc)) - (len(wa) - 1)
                denom = np.sqrt((wa**2).sum() * (wb**2).sum())
                corr = float(xc.max() / denom) if denom > 0 else 0.0
                xa, ya = a["nav"][tr_a]
                xb, yb = b["nav"][tr_b]
                rows.append((
                    names[i], names[j], tr_a, tr_b, pt[0], pt[1],
                    # nearest-trace positions + distances to the geometric
                    # intersection (reference nearest-vertices QC layers)
                    xa, ya, float(np.hypot(xa - pt[0], ya - pt[1])),
                    xb, yb, float(np.hypot(xb - pt[0], yb - pt[1])),
                    lag, lag * dt, corr))
    if timings is not None:
        timings["intersections"] = timings.get("intersections", 0.0) + t_search
    if not rows:
        return {}, names
    cols = {k: np.asarray(v) for k, v in zip(MISTIE_COLUMNS, zip(*rows))}
    kept = cols["correlation"] >= min_correlation
    xprint(f"{len(kept)} intersections, {int(kept.sum())} pass correlation "
           f">= {min_correlation}", kind="info", verbosity=verbose)
    return {k: v[kept] for k, v in cols.items()}, names


def compute_misties(profiles: dict, twt_window_ms: float = 50.0,
                    min_correlation: float = 0.8,
                    win_cc_ms=None, verbose: int = 0, device=None):
    """Cross-correlate envelope traces at every line intersection.

    ``profiles``: {line_name: dict(nav=(n,2), data=(ntr,ns), delrt=(ntr,),
    dt_ms=float)}. ``win_cc_ms=(upper, lower)`` restricts the correlation
    window to an absolute-TWT range (reference ``--win_cc``). Returns
    (pairs DataFrame, lines list); pandas is imported here, and
    :func:`mistie_table` gives the same table as columns.
    reference: mistie_correction_segy.py:325-543.
    """
    import pandas as pd

    cols, names = mistie_table(profiles, twt_window_ms, min_correlation,
                               win_cc_ms, verbose, device)
    return pd.DataFrame(cols), names


def solve_mistie_network(df, lines: list[str]) -> dict[str, float]:
    """Least-squares network adjustment (Bishop & Nunns 1994): find one
    vertical shift per line minimizing all pairwise misties
    (reference :514-524). Gauge fixed by zero-mean constraint. ``df`` is
    the table of :func:`compute_misties` or of :func:`mistie_table`."""
    cols = table_columns(df)
    n = table_rows(cols)
    if not n:
        return {ln: 0.0 for ln in lines}
    idx = {ln: k for k, ln in enumerate(lines)}
    a = np.zeros((n + 1, len(lines)))
    m = np.zeros(n + 1)
    for r, (la, lb, mistie) in enumerate(zip(cols["line_a"], cols["line_b"],
                                             cols["mistie_ms"])):
        # mistie = event TWT on A − event TWT on B  => shift_a − shift_b ≈ −mistie
        a[r, idx[la]] = 1.0
        a[r, idx[lb]] = -1.0
        m[r] = -mistie
    a[-1, :] = 1.0  # gauge: shifts sum to zero
    sol, *_ = np.linalg.lstsq(a, m, rcond=None)
    return {ln: float(sol[idx[ln]]) for ln in lines}


def _aux_navigation(coords_path, coords_fsuffix, coords_fnsuffix) -> dict:
    """The ``.nav``-style sidecars under ``coords_path`` as ``{line: (x,
    y) sorted by tracl}``, read without pandas."""
    from ..io.auxiliary import read_auxiliary_columns

    by_line = read_auxiliary_columns(coords_path, coords_fsuffix or "nav",
                                     suffix=coords_fnsuffix)
    if by_line is None:
        raise FileNotFoundError(
            f"no {coords_fsuffix or 'nav'} sidecars under {coords_path!r}")
    nav = {}
    for ln, cols in by_line.items():
        order = np.argsort(cols["tracl"], kind="stable")
        nav[ln] = np.column_stack([np.asarray(cols["x"], float)[order],
                                   np.asarray(cols["y"], float)[order]])
    return nav


def mistie_correct(path, min_correlation: float = 0.8, inplace: bool = False,
                   win_cc_ms=None, write_aux_file: bool = True,
                   write_qc: bool = True,
                   coords_origin: str = "header", coords_path=None,
                   coords_fsuffix: str | None = None,
                   coords_fnsuffix: str | None = None,
                   output_dir=None, txt_suffix: str | None = None, verbose: int = 0,
                   device=None, timings: dict | None = None) -> list[str]:
    """``min_correlation`` is the reference's ``--quality_threshold``;
    ``win_cc_ms`` its ``--win_cc`` correlation-window TWT limits;
    ``write_aux_file``/``write_qc`` gate the .mst sidecars and the
    intersection QC layer (reference --write_aux/--write_QC).

    ``coords_origin='aux'`` reads navigation from sidecar CSVs (x/y per
    tracl, e.g. ``.nav`` from ``p3d nav``) under ``coords_path`` instead of
    the trace headers, matched by line name — the reference's
    ``--coords_origin/--coords_path/--coords_fsuffix``; ``coords_fnsuffix``
    is its ``--coords_text_suffix`` basename-suffix filter for those
    sidecars (mistie_correction_segy.py:329-390, :67-69). The envelopes
    and the shifts run on ``device``; ``timings`` is passed to
    :func:`mistie_table`."""
    from ..io.auxiliary import export_coords, line_name
    from ..io.gpkg import write_gpkg_points

    device = resolve_device(device)
    files = resolve_input_files(path)
    nav_aux = None
    if coords_origin == "aux":
        if coords_path is None:
            raise ValueError("coords_origin='aux' requires coords_path")
        nav_aux = _aux_navigation(coords_path, coords_fsuffix, coords_fnsuffix)
    elif coords_origin != "header":
        raise ValueError("coords_origin must be 'header' or 'aux'")

    def _nav_for(p, f):
        if nav_aux is None:
            x, y, _ = scale_coordinates(f)
            return np.column_stack([x, y])
        ln = line_name(p)
        if ln not in nav_aux:
            raise KeyError(f"{p}: no navigation for line {ln!r} in "
                           f"{coords_path!r}")
        nav = nav_aux[ln]
        if len(nav) != f.n_traces:
            raise ValueError(f"{p}: nav rows ({len(nav)}) != traces "
                             f"({f.n_traces})")
        return nav

    profiles = {}
    for p in files:
        try:
            # read everything needed up front; no handle kept open across
            # the global solve
            with SegyFile(p) as f:
                profiles[p] = dict(
                    nav=_nav_for(p, f),
                    data=f.trace_data(),
                    delrt=f.header("DelayRecordingTime").astype(np.float64),
                    dt_ms=f.dt_us / 1000.0,
                    raw_headers=f.trace_headers_raw().copy(),
                    text=f.text,
                    dt_us=f.dt_us,
                )
        except Exception as e:  # noqa: BLE001 — skip unreadable profiles
            xprint(f"{p}: FAILED to read ({type(e).__name__}: {e})",
                   kind="error", verbosity=verbose)
    if not profiles:
        raise FileNotFoundError(f"no readable SEG-Y profiles under {path!r}")
    dts = {prof["dt_us"] for prof in profiles.values()}
    if len(dts) > 1:
        raise ValueError(
            f"mistie correction requires one sample interval across "
            f"profiles, got {sorted(dts)} µs")
    table, lines = mistie_table(profiles, min_correlation=min_correlation,
                                win_cc_ms=win_cc_ms, verbose=verbose,
                                device=device, timings=timings)
    shifts = solve_mistie_network(table, lines)
    outs = []
    for p, prof in profiles.items():
        dt_ms = prof["dt_ms"]
        shift_samples = int(round(shifts[p] / dt_ms))
        shifted = _shift_traces(
            prof["data"], np.full(len(prof["data"]), shift_samples, np.int32),
            device)
        out = _output_path(p, inplace, txt_suffix or "mst", output_dir)
        text = textual.add_processing_entry(
            prof["text"], f"MISTIE CORRECTION ({shifts[p]:+.2f} ms)", prefix=TODAY)
        write_segy(out, shifted, raw_trace_headers=prof["raw_headers"],
                   bin_updates={"Interval": prof["dt_us"]}, text=text, fmt=5,
                   dt_us=prof["dt_us"])
        if write_aux_file:
            write_aux(out, ".mst", {"line": np.asarray([p]),
                                    "shift_ms": np.asarray([shifts[p]])})
        outs.append(out)
        xprint(f"{p}: mistie shift {shifts[p]:+.2f} ms -> {out}",
               kind="info", verbosity=verbose)
    n_rows = table_rows(table)
    base = os.path.dirname(files[0])
    if n_rows:
        # the tabular per-intersection record (lags/correlations) is the
        # primary mistie artifact — written regardless of write_qc
        write_csv(os.path.join(base, "misties.csv"), table)
    if n_rows and write_qc:
        # intersection QC layers: GeoJSON and a GeoPackage with the
        # reference's 'intersections' layer name
        # (mistie_correction_segy.py:629-703)
        points = {k: v for k, v in table.items()
                  if k not in ("line_a", "line_b")}
        points["pair"] = np.asarray([f"{a} x {b}" for a, b in
                                     zip(table["line_a"], table["line_b"])])
        export_coords(points, os.path.join(base, "misties.geojson"))
        write_gpkg_points(
            os.path.join(base,
                         f"{TODAY}_QC_{os.path.basename(base)}_intersections"
                         ".gpkg"),
            {"intersections": (table, "x", "y"),
             # the reference's nearest-trace layers (one per line side)
             "nearest_vertices_line_0": (
                 {"x_a": table["x_a"], "y_a": table["y_a"],
                  "dist": table["dist_a"]}, "x_a", "y_a"),
             "nearest_vertices_line_1": (
                 {"x_b": table["x_b"], "y_b": table["y_b"],
                  "dist": table["dist_b"]}, "x_b", "y_b")},
            # header coordinates are in the survey's (usually projected)
            # CRS, unknown here: the spec's undefined-cartesian SRS
            srs_id=-1)
    return outs


# ===========================================================================
# 02 — reproject (reference reproject_segy.py:73-169)
# ===========================================================================
def reproject(path, src_epsg, dst_epsg, smooth_window: int | None = None,
              coords_bytes=(73, 77), scalar: int = -100,
              dst_coords: str | None = None, inplace: bool = False,
              output_dir=None, txt_suffix: str | None = None, verbose: int = 0) -> list[str]:
    """Reproject trace-header coordinates between CRSs (reference
    reproject_segy.py:73-169), on the host. Either side takes any CRS spec
    the reference hands to pyproj: an EPSG code, a WKT1/WKT2 string, a
    proj string, or a projection instance (``utils.crs.parse_crs``);
    further codes can be added via ``utils.crs.register_crs``.
    """
    from ..io.headers import check_coordinate_scalar
    from ..utils.crs import GEOGRAPHIC, crs_label, parse_crs

    scalar = check_coordinate_scalar(scalar)  # 'auto' -> -100; rejects ±3 etc.
    dst_geographic = parse_crs(dst_epsg) is GEOGRAPHIC

    def _encode(xt, yt):
        """Header ints + (scalar, units) for transformed coordinates."""
        if dst_geographic:
            # geographic output: CoordinateUnits=2 milli-arc-seconds
            # (scalar -1000); scale_coordinates reads this back via /3.6e6
            xi = np.rint(np.asarray(xt, np.float64) * 3.6e6).astype(np.int64)
            yi = np.rint(np.asarray(yt, np.float64) * 3.6e6).astype(np.int64)
            return xi.astype(np.int32), yi.astype(np.int32), -1000, 2
        xi, yi = unscale_coordinates(xt, yt, scale_factor=scalar)
        return xi, yi, scalar, 1

    def _one(p):
        with SegyFile(p) as f:
            x, y, units = scale_coordinates(f, coords_bytes)
            xt, yt = crs_transform(x, y, src_epsg, dst_epsg)
            if smooth_window and smooth_window > 2:
                xt = flt.smooth(xt, smooth_window)
                yt = flt.smooth(yt, smooth_window)
            xi, yi, out_scalar, out_units = _encode(xt, yt)
            out = _output_path(p, inplace, txt_suffix or "reproj", output_dir)
            # destination field pair (reference --dst_coords). Default
            # (None): write back to the SAME fields the coordinates were
            # read from; the source+CDP double write is kept only for the
            # default source bytes (73, 77)
            pairs = {"source": [("SourceX", "SourceY")],
                     "CDP": [("CDP_X", "CDP_Y")],
                     "group": [("GroupX", "GroupY")]}
            if dst_coords is None:
                by_bytes = {(73, 77): "source", (181, 185): "CDP",
                            (81, 85): "group"}
                src_name = by_bytes.get(tuple(coords_bytes))
                if src_name == "source":
                    targets = [("SourceX", "SourceY"), ("CDP_X", "CDP_Y")]
                elif src_name is not None:
                    targets = pairs[src_name]
                else:
                    # arbitrary byte pair: write back to exactly the bytes
                    # read (numeric header keys are 4-byte fields)
                    targets = [(int(coords_bytes[0]), int(coords_bytes[1]))]
            else:
                targets = pairs[dst_coords]
            updates = {"SourceGroupScalar": out_scalar,
                       "CoordinateUnits": out_units}
            for xf, yf in targets:
                updates[xf] = xi
                updates[yf] = yi
            # the scalar/units fields are GLOBAL per trace: any OTHER
            # populated standard coordinate pair would decode wrong under
            # the new scalar, so transform and re-encode them too
            named_bytes = {"source": (73, 77), "CDP": (181, 185),
                           "group": (81, 85)}
            written = {fld for pair in targets for fld in pair}
            for nm, nb in named_bytes.items():
                fx, fy = pairs[nm][0]
                if fx in written or fy in written:
                    continue
                if not (np.any(f.header(nb[0])) or np.any(f.header(nb[1]))):
                    continue  # unpopulated pair: leave zeros
                if nb == tuple(coords_bytes):
                    # the READ pair, routed elsewhere by dst_coords:
                    # re-encode it with the ints already transformed
                    updates[fx] = xi
                    updates[fy] = yi
                    continue
                ox, oy, _ = scale_coordinates(f, nb)
                oxt, oyt = crs_transform(ox, oy, src_epsg, dst_epsg)
                oxi, oyi, _, _ = _encode(oxt, oyt)
                updates[fx] = oxi
                updates[fy] = oyi
            _rewrite(
                f, out, f.trace_data(),
                f"REPROJECT {crs_label(src_epsg)}->{crs_label(dst_epsg)}",
                header_updates=updates,
            )
        xprint(f"reprojected {p} -> {out}", kind="info", verbosity=verbose)
        return out

    return _per_file(resolve_input_files(path), _one, verbose)


# ===========================================================================
# 01 — merge (reference merge_segys.py:73-382)
# ===========================================================================
def merge_small_files(path, min_kb: float = 100.0, max_gap_s: float = 60.0,
                      output_dir=None, txt_suffix: str | None = None,
                      verbose: int = 0) -> list[str]:
    """Merge small SEG-Y files into temporally adjacent neighbors (host
    numpy).

    Files smaller than ``min_kb`` join the previous file when their first
    trace is recorded within ``max_gap_s`` of the neighbor's last trace;
    duplicate consecutive traces (same time + position) are dropped. A
    ``.parts`` sidecar records the source files per merged output.
    """
    files = resolve_input_files(path)
    infos = []
    for p in files:
        with SegyFile(p) as f:
            times = trace_datetimes(f)
            if times.size == 0:
                xprint(f"{p}: zero traces — skipped from merge",
                       kind="warning", verbosity=verbose)
                continue
            infos.append(dict(path=p, size_kb=os.path.getsize(p) / 1024.0,
                              t0=times[0], t1=times[-1],
                              n_samples=f.n_samples, dt_us=f.dt_us))
    infos.sort(key=lambda r: r["t0"])

    groups: list[list[dict]] = []
    for info in infos:
        if (groups and info["size_kb"] < min_kb
                and (info["t0"] - groups[-1][-1]["t1"]) / np.timedelta64(1, "s") <= max_gap_s):
            groups[-1].append(info)
        elif (groups and groups[-1][-1]["size_kb"] < min_kb and len(groups[-1]) == 1
                and (info["t0"] - groups[-1][-1]["t1"]) / np.timedelta64(1, "s") <= max_gap_s):
            groups[-1].append(info)  # small leading file merges forward
        else:
            groups.append([info])

    # split groups at n_samples/dt mismatches: traces of different length or
    # rate cannot be concatenated (delrt-pad is the step that harmonizes
    # them)
    conforming: list[list[dict]] = []
    for grp in groups:
        split = [[grp[0]]]
        for g in grp[1:]:
            prev = split[-1][-1]
            if (g["n_samples"], g["dt_us"]) == (prev["n_samples"], prev["dt_us"]):
                split[-1].append(g)
            else:
                split.append([g])
        if len(split) > 1:
            xprint(f"group starting at {grp[0]['path']} mixes n_samples/dt; "
                   f"split into {len(split)} conforming runs",
                   kind="warning", verbosity=verbose)
        conforming.extend(split)
    groups = conforming

    outs = []
    for grp in groups:
        first = grp[0]["path"]
        if len(grp) == 1:
            outs.append(first)
            continue
        datas, headers_raw, texts = [], [], None
        prev_header_set: set[bytes] = set()
        dt_us = None
        for g in grp:
            with SegyFile(g["path"]) as f:
                data = f.trace_data()
                raw = f.trace_headers_raw()
                # drop only TRUE duplicates: traces whose full 240-byte
                # header already appeared in the previous file (overlap at
                # the file seam)
                keep = [k for k in range(f.n_traces)
                        if raw[k].tobytes() not in prev_header_set]
                prev_header_set = {raw[k].tobytes() for k in range(f.n_traces)}
                datas.append(data[keep])
                headers_raw.append(raw[keep])
                texts = texts or f.text
                dt_us = f.dt_us
        merged = np.concatenate(datas)
        raws = np.concatenate(headers_raw)
        merged, raws, n_inserted = _fill_time_gaps(merged, raws)
        if n_inserted:
            xprint(f"inserted {n_inserted} zero traces for data gaps",
                   kind="info", verbosity=verbose)
        base, ext = os.path.splitext(first)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            base = os.path.join(output_dir, os.path.basename(base))
        out = f"{base}_{txt_suffix or 'merged'}{ext}"
        text = textual.add_processing_entry(texts, f"MERGE ({len(grp)} files)",
                                            prefix=TODAY)
        write_segy(out, merged, raw_trace_headers=raws, text=text, fmt=5, dt_us=dt_us,
                   headers={"TRACE_SEQUENCE_FILE": np.arange(1, len(merged) + 1)})
        with open(aux_path(out, ".parts"), "w") as fh:
            fh.write("\n".join(g["path"] for g in grp))
        outs.append(out)
        xprint(f"merged {len(grp)} files -> {out} ({len(merged)} traces)",
               kind="info", verbosity=verbose)
    return outs


def _calendar_fields(t_s: int) -> tuple[int, int, int, int, int]:
    """(year, day of year, hour, minute, second) of a second count since
    1970-01-01 UTC."""
    s = np.datetime64(int(t_s), "s")
    year = s.astype("datetime64[Y]")
    day = s.astype("datetime64[D]")
    doy = int((day - year.astype("datetime64[D]")).astype(np.int64)) + 1
    sod = int((s - day.astype("datetime64[s]")).astype(np.int64))
    return (int(year.astype(np.int64)) + 1970, doy, sod // 3600,
            (sod % 3600) // 60, sod % 60)


def _fill_time_gaps(data: np.ndarray, raws: np.ndarray, factor: float = 1.5):
    """Insert zero traces (with linearly interpolated headers) into recording
    gaps longer than ``factor`` x the median shot interval
    (reference merge_segys.py gap handling)."""
    def col(name):
        off, dt = TRACE_HEADER_FIELDS[name]
        size = int(dt[-1])
        return np.ascontiguousarray(raws[:, off - 1 : off - 1 + size]).view(">" + dt)[:, 0]

    # real calendar epochs (a day-count formula fabricates ~1-day gaps at
    # year boundaries)
    stamps = header_datetimes(
        col("YearDataRecorded").astype(int), col("DayOfYear").astype(int),
        col("HourOfDay").astype(int), col("MinuteOfHour").astype(int),
        col("SecondOfMinute").astype(int))
    t = stamps.astype("datetime64[s]").astype("int64")
    dts = np.diff(t)
    if len(dts) == 0:
        return data, raws, 0
    med = np.median(dts[dts > 0]) if (dts > 0).any() else 1.0
    # interpolate coordinates AND sequence counters for gap fillers — the
    # reference linearly interpolates every header column of a gap record
    # (merge_segys.py:325-331)
    coord_cols = {name: col(name).astype(np.float64)
                  for name in ("SourceX", "SourceY", "GroupX", "GroupY",
                               "TRACE_SEQUENCE_LINE", "FieldRecord",
                               "ShotPoint")}
    out_data = [data[:1]]
    out_raws = [raws[:1]]
    n_ins = 0
    for i in range(1, len(data)):
        gap = t[i] - t[i - 1]
        if med > 0 and gap > factor * med:
            n_fill = min(int(round(gap / med)) - 1, 10000)
            for k in range(1, n_fill + 1):
                frac = k / (n_fill + 1)
                z = np.zeros((1, data.shape[1]), data.dtype)
                hdr = raws[i - 1 : i].copy()
                # interpolate coordinates of inserted traces
                for name, cvals in coord_cols.items():
                    off, dtc = TRACE_HEADER_FIELDS[name]
                    size = int(dtc[-1])
                    vi = np.array([round(cvals[i - 1] + frac * (cvals[i] - cvals[i - 1]))
                                   ]).astype(">" + dtc)
                    hdr[0, off - 1 : off - 1 + size] = vi.view(np.uint8)
                # interpolate the recording time too — copied timestamps
                # would give gap fillers duplicate times
                fields = _calendar_fields(int(round(t[i - 1] + frac * gap)))
                for name, val in zip(("YearDataRecorded", "DayOfYear",
                                      "HourOfDay", "MinuteOfHour",
                                      "SecondOfMinute"), fields):
                    off, dtc = TRACE_HEADER_FIELDS[name]
                    size = int(dtc[-1])
                    hdr[0, off - 1 : off - 1 + size] = (
                        np.array([val]).astype(">" + dtc).view(np.uint8))
                # mark as dead trace (TraceIdentificationCode = 2)
                off, dtc = TRACE_HEADER_FIELDS["TraceIdentificationCode"]
                hdr[0, off - 1 : off + 1] = np.array([2]).astype(">" + dtc).view(np.uint8)
                out_data.append(z)
                out_raws.append(hdr)
                n_ins += 1
        out_data.append(data[i : i + 1])
        out_raws.append(raws[i : i + 1])
    return np.concatenate(out_data), np.concatenate(out_raws), n_ins


# ===========================================================================
# CLI dispatch
# ===========================================================================
def run_cli(cmd: str, args, verbose: int = 0) -> int:
    """Run stage-1 step ``cmd`` on the parsed arguments of its ``p3d-torch``
    subcommand. The five steps that compute on a device get
    ``args.device`` (None: the first CUDA card); merge, reproject and
    delrt-pad are host numpy and take none."""
    # shared batch-selection conventions: resolve directory inputs through
    # the --suffix / --filename-suffix filters up front (the step functions
    # accept pre-resolved lists), and thread --txt-suffix / --output-dir
    inp = args.input
    fsuffix = getattr(args, "suffix", None) or "sgy"
    fnsuffix = getattr(args, "filename_suffix", None)
    if os.path.isdir(str(inp)) and (fsuffix != "sgy" or fnsuffix):
        inp = resolve_input_files(inp, fsuffix=fsuffix, fnsuffix=fnsuffix)
    io_kw = dict(txt_suffix=getattr(args, "txt_suffix", None),
                 output_dir=getattr(args, "output_dir", None))
    device = getattr(args, "device", None)
    if cmd == "merge":
        merge_small_files(inp, min_kb=args.min_kb, max_gap_s=args.max_gap_s,
                          output_dir=args.output_dir,
                          txt_suffix=getattr(args, "txt_suffix", None),
                          verbose=verbose)
    elif cmd == "reproject":
        from ..utils.crs import resolve_crs_spec as _crs_arg

        reproject(inp, _crs_arg(args.src_epsg), _crs_arg(args.dst_epsg),
                  smooth_window=args.smooth_window,
                  coords_bytes=tuple(args.coords_bytes),
                  scalar=args.scalar, dst_coords=args.dst_coords,
                  inplace=args.inplace, verbose=verbose, **io_kw)
    elif cmd == "delrt-correct":
        delrt_correct(inp, n_neighbors=args.n_neighbors,
                      win_samples=args.win_samples, inplace=args.inplace,
                      byte_delay=getattr(args, "byte_delay", 109),
                      verbose=verbose, device=device, **io_kw)
    elif cmd == "delrt-pad":
        delrt_pad(inp, inplace=args.inplace,
                  byte_delay=getattr(args, "byte_delay", 109),
                  verbose=verbose, **io_kw)
    elif cmd == "static":
        static_correct(inp, mode=args.mode, win_samples=args.win_samples,
                       savgol_window=args.savgol_window, nsta=args.nsta,
                       nlta=args.nlta, win_mad=args.win_mad,
                       win_median=args.win_median,
                       limit_shift=args.limit_shift,
                       n_amp_samples=getattr(args, "n_amp_samples", 5),
                       limit_depressions=getattr(args, "limit_depressions",
                                                 (10, 10, 5)),
                       write_aux_file=not getattr(args, "no_aux", False),
                       write_seafloor2trace=getattr(args, "write_seafloor2trace", False),
                       inplace=args.inplace, verbose=verbose, device=device,
                       **io_kw)
    elif cmd == "tide":
        tide_compensate(inp, args.tide_file,
                        velocity=args.velocity,
                        src_epsg=getattr(args, "src_epsg", None),
                        constituents=getattr(args, "constituents", None),
                        correct_minor=getattr(args, "correct_minor", False),
                        coords_bytes=tuple(getattr(args, "coords_bytes", (73, 77))),
                        inplace=args.inplace, verbose=verbose, device=device,
                        **io_kw)
    elif cmd == "mistie":
        mistie_correct(inp, min_correlation=args.min_correlation,
                       win_cc_ms=getattr(args, "win_cc", None),
                       write_aux_file=not getattr(args, "no_aux", False),
                       write_qc=not getattr(args, "no_qc", False),
                       coords_origin=getattr(args, "coords_origin", "header"),
                       coords_path=getattr(args, "coords_path", None),
                       coords_fsuffix=getattr(args, "coords_fsuffix", None),
                       coords_fnsuffix=getattr(args, "coords_text_suffix", None),
                       inplace=args.inplace, verbose=verbose, device=device,
                       **io_kw)
    elif cmd == "despike":
        despike(inp, window=tuple(args.window), threshold=args.threshold,
                mode=args.mode, replace=args.replace,
                split_at_delrt=args.split_at_delrt,
                window_time_ms=getattr(args, "window_time", None),
                byte_delay=getattr(args, "byte_delay", 109),
                inplace=args.inplace, verbose=verbose, device=device,
                **io_kw)
    else:
        raise SystemExit(f"unknown stage-1 command {cmd!r}")
    return 0
