"""QC plotting library (matplotlib, Agg-safe).

Counterpart of ``pseudo_3d_interpolation_tpu/qc/plot.py``: the same 13
plotting functions, options and figure files.
reference: pseudo_3D_interpolation/functions/plot.py (1184 LoC: seismic
image/diff, wiggle/diff, statics overlay, trace & average frequency
spectra) and the POCS inversion panels (functions/POCS.py:666-764).
All functions return the Figure and accept an optional ``path`` to save
(``path=None`` leaves the figure open for interactive display).

matplotlib is imported inside the functions, so that this module imports
where matplotlib is absent (the card's machine). The functions that
normalize by RMS or take spectra run those through ``ops.signal`` on
``device`` (the first CUDA card by default, an error without one;
``device='cpu'`` on the host) and plot the result from the host.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..ops import signal as sig


def _plt():
    """``matplotlib.pyplot``, imported on first use.

    Headless default WITHOUT hijacking an interactive session:
    matplotlib.use(..., force=False) still SWITCHES an already-selected
    backend (force=False only suppresses the ImportError) — so only pick
    Agg when nothing has chosen a backend yet and no display is available.
    "no display": X11 (DISPLAY) and Wayland (WAYLAND_DISPLAY) both absent
    on a non-macOS platform — macOS GUI sessions never set DISPLAY, and
    forcing Agg there would silently break the documented path=None
    interactive use."""
    import matplotlib

    if ("matplotlib.pyplot" not in sys.modules
            and not os.environ.get("MPLBACKEND")
            and not os.environ.get("DISPLAY")
            and not os.environ.get("WAYLAND_DISPLAY")
            and sys.platform != "darwin"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _finish(fig, path, tight=True):
    if tight:
        fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150)
        _plt().close(fig)
    return fig


def _clip(data, perc=99.0):
    # NaN-aware: upsampled/postprocessed cubes can carry NaN edge cells, and
    # a NaN vmin/vmax blanks the whole QC figure
    v = np.nanpercentile(np.abs(data), perc)
    return -v, v


def _time_axis(data, dt, twt):
    """(t, ylabel) from dt or twt — reference accepts either
    (plot.py:83-89); falls back to sample index when neither is given."""
    ns = data.shape[0]
    if twt is not None:
        return np.asarray(twt, float), None
    if dt is not None:
        return np.arange(ns, dtype=float) * dt, None
    return np.arange(ns, dtype=float), "sample"


def _safe_scale(value):
    """A finite positive normalization scale: NaN (all-NaN input — `x or 1`
    keeps NaN because NaN is truthy), inf, and 0 all fall back to 1.0."""
    v = float(value)
    return v if np.isfinite(v) and v != 0.0 else 1.0


def _apply_norm(data, norm, device=None):
    """Reference norm semantics (plot.py:92-96): True/'rms' -> per-trace
    RMS normalization (on ``device``), 'max'/'peak' -> global peak
    normalization."""
    if norm is True or (isinstance(norm, str) and norm.lower() == "rms"):
        return _host(sig.rms_normalization(np.asarray(data, np.float32),
                                           axis=0, device=device))
    if isinstance(norm, str) and norm.lower() in ("max", "peak"):
        peak = _safe_scale(np.nanmax(np.abs(data)))
        return data / peak
    return data


def plot_seismic_image(data, dt=None, twt=None, traces=None, title=None,
                       perc=99.0, cmap="gray_r", gain=1.0, norm=False,
                       env=False, reverse=False, units="s",
                       show_colorbar=True, path=None, ax=None, device=None):
    """Variable-density section; ``data`` is (nsamples, ntraces).

    Option parity with the reference (plot.py:23-196): ``dt`` or ``twt``
    time axis, ``traces`` x-coordinates, display ``gain``, ``norm``
    (True/'rms'/'max'), ``env`` (sequential colormap from 0 for envelope
    data), ``reverse`` profile orientation, time ``units`` label, and
    colorbar toggle. ``perc`` percentile clipping is this library's
    addition. ``device``: where the RMS normalization runs.
    """
    data = _apply_norm(np.asarray(data), norm, device)
    if reverse:
        data = data[:, ::-1]
    if ax is None:
        fig, ax = _plt().subplots(figsize=(10, 6))
    else:
        fig = ax.figure
    t, fallback = _time_axis(data, dt, twt)
    vmin, vmax = _clip(data, perc)
    vmin, vmax = vmin / gain, vmax / gain
    if env:
        cmap = "magma" if cmap == "gray_r" else cmap
        vmin = 0.0
    x0, x1 = ((traces[0], traces[-1]) if traces is not None
              else (0, data.shape[1]))
    if reverse and traces is not None:
        x0, x1 = x1, x0
    im = ax.imshow(data, aspect="auto", cmap=cmap, vmin=vmin, vmax=vmax,
                   extent=[x0, x1, t[-1], t[0]])
    ax.set_xlabel("trace")
    ax.set_ylabel(fallback or f"TWT ({units})")
    if title:
        ax.set_title(title)
    if show_colorbar:
        fig.colorbar(im, ax=ax, fraction=0.05, pad=0.02)
    return _finish(fig, path)


def plot_seismic_difference(before, after, dt=None, twt=None, traces=None,
                            titles=("before", "after"), perc=99.0,
                            cmap="gray_r", gain=1.0, norm=False, env=False,
                            reverse=False, units="s", show_colorbar=True,
                            path=None, device=None):
    """Three panels: before / after / difference, shared color scale
    (reference plot_seismic_image_diff, plot.py:199-388, incl. its gain/
    norm/env/reverse/units options and mismatched-shape zero difference)."""
    before = _apply_norm(np.asarray(before), norm, device)
    after = _apply_norm(np.asarray(after), norm, device)
    diff = (before - after if before.shape == after.shape
            else np.zeros_like(before))  # reference plot.py:277-280
    fig, axes = _plt().subplots(1, 3, figsize=(16, 6), sharey=True)
    t, fallback = _time_axis(before, dt, twt)
    vmin, vmax = _clip(before, perc)
    vmin, vmax = vmin / gain, vmax / gain
    if env:
        cmap = "magma" if cmap == "gray_r" else cmap
        vmin = 0.0
    im = None
    for ax, d, ttl in zip(axes, [before, after, diff],
                          [titles[0], titles[1], "difference"]):
        if reverse:
            d = d[:, ::-1]
        x0, x1 = ((traces[0], traces[-1]) if traces is not None
                  else (0, d.shape[1]))
        if reverse and traces is not None:
            x0, x1 = x1, x0
        im = ax.imshow(d, aspect="auto", cmap=cmap, vmin=vmin, vmax=vmax,
                       extent=[x0, x1, t[-1], t[0]])
        ax.set_title(ttl)
        ax.set_xlabel("trace")
    axes[0].set_ylabel(fallback or f"TWT ({units})")
    if show_colorbar:
        fig.colorbar(im, ax=list(axes), fraction=0.03, pad=0.02)
        return _finish(fig, path, tight=False)  # colorbar owns the layout
    return _finish(fig, path)


def plot_seismic_wiggle(data, dt=None, twt=None, traces=None, add_info=None,
                        scale=1.0, gain=None, norm=False, max_traces=60,
                        tr_step=None, fill=True, color="k", units="s",
                        title=None, path=None, ax=None, device=None):
    """Wiggle traces with positive-lobe fill; ``data`` (nsamples, ntraces).

    Option parity with the reference (plot.py:391-533): ``dt``/``twt``,
    ``traces`` labels with optional ``add_info`` annotations appended,
    ``gain``, ``norm`` (True/'rms'/'max'), ``tr_step`` decimation, fill
    ``color`` and time ``units``. ``max_traces`` auto-picks tr_step when
    it is not given. ``device``: where the RMS normalization runs.
    """
    data = _apply_norm(np.asarray(data), norm, device)
    ns, ntr = data.shape
    if add_info is not None and traces is not None:
        assert len(add_info) == len(traces), \
            f"add_info must match traces length ({len(traces)})"
    step = tr_step or max(1, -(-ntr // max_traces))
    t, fallback = _time_axis(data, dt, twt)
    if ax is None:
        fig, ax = _plt().subplots(figsize=(10, 6))
    else:
        fig = ax.figure
    amp = _safe_scale(np.nanmax(np.abs(data)))
    sc = scale if gain is None else gain
    _wiggle_on_ax(ax, data, t, scale=sc, tr_step=step, color=color,
                  norm=amp, fill=fill)
    if traces is not None:
        ticks = list(range(0, ntr, step))
        labels = [str(traces[k]) for k in ticks]
        if add_info is not None:
            labels = [f"{lab}\n{add_info[k]}" for lab, k in zip(labels, ticks)]
        ax.set_xticks(ticks)
        ax.set_xticklabels(labels, fontsize=7)
    ax.set_ylim(t[-1], t[0])
    ax.set_xlabel("trace")
    ax.set_ylabel(fallback or f"TWT ({units})")
    if title:
        ax.set_title(title)
    return _finish(fig, path)


def plot_statics_overlay(data, horizon, static=None, twt=None, title=None,
                         path=None):
    """Section with picked horizon (and optional applied static) overlays
    (reference plot.py:391ff)."""
    data = np.asarray(data)
    fig, ax = _plt().subplots(figsize=(10, 6))
    plot_seismic_image(data, twt=twt, ax=ax)
    x = np.arange(data.shape[1])
    y = np.asarray(horizon, float)
    if twt is not None:
        y = np.interp(y, np.arange(len(twt)), np.asarray(twt))
    ax.plot(x, y, "r-", lw=1.2, label="horizon")
    if static is not None:
        ys = y + (np.asarray(static, float) * (twt[1] - twt[0] if twt is not None else 1))
        ax.plot(x, ys, "c--", lw=1.0, label="after static")
    ax.legend(loc="upper right")
    if title:
        ax.set_title(title)
    return _finish(fig, path)


def plot_trace_spectrum(trace, fs, title=None, path=None, device=None):
    """Single-trace amplitude spectrum (reference plot.py:704ff), taken
    on ``device``."""
    f, a = sig.freq_spectrum(np.asarray(trace, np.float32), fs,
                             device=device)
    fig, ax = _plt().subplots(figsize=(8, 4))
    ax.plot(_host(f), _host(a), "k-", lw=0.8)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("amplitude")
    ax.set_title(title or "amplitude spectrum")
    return _finish(fig, path)


def plot_average_spectrum(data, fs, n_traces=None, title=None, path=None,
                          device=None):
    """Mean spectrum over traces ± 1 std band (reference plot.py:863ff),
    the spectra taken on ``device``."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    if n_traces and data.shape[0] > n_traces:
        idx = np.linspace(0, data.shape[0] - 1, n_traces).astype(int)
        data = data[idx]
    f, a = sig.freq_spectrum(data, fs, device=device)
    f = _host(f)
    a = _host(a)
    mean, std = a.mean(axis=0), a.std(axis=0)
    fig, ax = _plt().subplots(figsize=(8, 4))
    ax.plot(f, mean, "k-", lw=1.0, label="mean")
    ax.fill_between(f, mean - std, mean + std, color="0.7", label="±1σ")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("amplitude")
    ax.legend()
    ax.set_title(title or "average spectrum")
    return _finish(fig, path)


def plot_inversion_result(x_sparse, x_rec, metadata: dict | None = None,
                          title=None, path=None):
    """Sparse input vs POCS reconstruction panels; complex input gets
    real/imag rows (reference POCS.py:666-764)."""
    x_sparse = np.asarray(x_sparse)
    x_rec = np.asarray(x_rec)
    is_complex = np.iscomplexobj(x_sparse) or np.iscomplexobj(x_rec)
    nrows = 2 if is_complex else 1
    fig, axes = _plt().subplots(nrows, 2, figsize=(12, 5 * nrows), squeeze=False)
    vmax = _safe_scale(np.percentile(np.abs(x_sparse), 99))
    kw = dict(cmap="RdBu", vmin=-vmax, vmax=vmax, aspect="auto")
    parts = [("real", np.real)] + ([("imag", np.imag)] if is_complex else [])
    for r, (name, fn) in enumerate(parts):
        for c, (d, lab) in enumerate([(x_sparse, "sparse input"), (x_rec, "reconstructed")]):
            im = axes[r][c].imshow(fn(d).T, **kw)
            axes[r][c].set_title(f"{lab} ({name})" if is_complex else lab)
            fig.colorbar(im, ax=axes[r][c], fraction=0.05, pad=0.02)
    if title is None and metadata:
        title = (f"{metadata.get('transform_kind', '?')} | {metadata.get('version', '?')}"
                 f" (iterations: {metadata.get('niterations', '?')})")
    if title:
        fig.suptitle(title)
    return _finish(fig, path)


def plot_iline_grid(data, ilines=None, twt=None, perc=99.0, cmap="gray_r",
                    gain=1.0, units="s", title=None, path=None):
    """Multi-iline subplot grid of a cube: N sections in a ceil(sqrt(N))
    grid with one SHARED color scale and colorbar (the reference's grid-QC
    pattern — trim_axes + subplot grids, plot.py:12-20, POCS.py:666-764).

    ``data`` is (iline, xline, twt); ``ilines`` defaults to 6 sections
    evenly spread over the cube.
    """
    data = np.asarray(data)
    if ilines is None:
        ilines = np.linspace(0, data.shape[0] - 1, min(6, data.shape[0]))
        ilines = np.unique(ilines.astype(int))
    n = len(ilines)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    fig, axes = _plt().subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows),
                             sharex=True, sharey=True, squeeze=False)
    sections = [data[int(i)].T for i in ilines]
    vmin, vmax = _clip(np.stack(sections), perc)
    vmin, vmax = vmin / gain, vmax / gain
    t = np.asarray(twt) if twt is not None else np.arange(data.shape[-1])
    flat = axes.ravel()
    im = None
    for k, (i, sec) in enumerate(zip(ilines, sections)):
        im = flat[k].imshow(sec, aspect="auto", cmap=cmap, vmin=vmin,
                            vmax=vmax, extent=[0, sec.shape[1], t[-1], t[0]])
        flat[k].set_title(f"iline {int(i)}", fontsize=9)
    for j in range(n, len(flat)):
        flat[j].axis("off")
    for ax in axes[:, 0]:
        ax.set_ylabel(f"TWT ({units})" if twt is not None else "sample")
    _label_grid_x(axes, "xline")
    fig.colorbar(im, ax=axes.ravel().tolist(), fraction=0.03, pad=0.02)
    if title:
        fig.suptitle(title)
    return _finish(fig, path, tight=False)


def _label_grid_x(axes, xlabel):
    """xlabel + visible tick labels on the bottommost VISIBLE axis of each
    column: with sharex the last row owns the tick labels, so a column
    whose last-row panel is axis('off') would render with no x axis at
    all."""
    nrows, ncols = axes.shape
    for c in range(ncols):
        for r in range(nrows - 1, -1, -1):
            ax = axes[r, c]
            if ax.axison:
                ax.set_xlabel(xlabel)
                ax.xaxis.set_tick_params(labelbottom=True)
                break


def plot_fold_map(fold, title=None, path=None):
    """Bin fold / coverage map of the cube grid."""
    fold = np.asarray(fold)
    fig, ax = _plt().subplots(figsize=(8, 6))
    im = ax.imshow(fold.T, origin="lower", aspect="auto", cmap="viridis")
    ax.set_xlabel("iline")
    ax.set_ylabel("xline")
    coverage = (fold > 0).mean()
    ax.set_title(title or f"fold (coverage {coverage:.1%})")
    fig.colorbar(im, ax=ax, fraction=0.05, pad=0.02)
    return _finish(fig, path)


# ---------------------------------------------------------------------------
# round-2 parity panels (reference plot.py:536, 704, 863, 1067)
# ---------------------------------------------------------------------------

def _wiggle_on_ax(ax, data, t, scale=1.0, tr_step=1, color="k", norm=None,
                  fill=True):
    data = np.asarray(data)
    norm = norm or _safe_scale(np.nanmax(np.abs(data)))
    for k in range(0, data.shape[1], tr_step):
        x = k + scale * tr_step * data[:, k] / norm
        ax.plot(x, t, color=color, lw=0.5)
        if fill:
            ax.fill_betweenx(t, k, x, where=x > k, color=color, lw=0)
    ax.set_ylim(t[-1], t[0])
    ax.set_xlabel("trace")


def plot_seismic_wiggle_diff(before, after, twt=None, gain=1.0, tr_step=None,
                             titles=("original", "edited"), path=None):
    """Three wiggle panels: before / after / difference, on a SHARED
    amplitude normalization so the difference panel is honestly scaled
    (reference plot.py:536-701)."""
    before = np.asarray(before)
    after = np.asarray(after)
    assert before.shape == after.shape, "sections must share a shape"
    ns, ntr = before.shape
    tr_step = tr_step or max(1, -(-ntr // 60))
    t = np.asarray(twt) if twt is not None else np.arange(ns)
    fig, axes = _plt().subplots(1, 3, figsize=(16, 6), sharey=True)
    norm = _safe_scale(max(np.nanmax(np.abs(before)),
                       np.nanmax(np.abs(after))) / gain)
    # difference = original - edited, like the reference (plot.py:634)
    for ax, d, title in zip(axes, (before, after, before - after),
                            (titles[0], titles[1], "difference")):
        _wiggle_on_ax(ax, d, t, tr_step=tr_step, norm=norm)
        ax.set_title(title)
    axes[0].set_ylabel("TWT (s)" if twt is not None else "sample")
    return _finish(fig, path)


def plot_statics_panels(sections, titles=None, twt=None, gain=1.0,
                        tr_step=None, path=None):
    """Auto-gridded wiggle panels of N processing states of one section
    (e.g. raw / detected horizon applied / smoothed static applied) —
    reference _plot_seismic_wiggle_statics (plot.py:704-860) incl. its
    ceil(sqrt(N)) grid layout and shared normalization."""
    sections = [np.asarray(s) for s in sections]
    assert all(s.shape == sections[0].shape for s in sections)
    n = len(sections)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))  # same layout the other grids use
    ns, ntr = sections[0].shape
    tr_step = tr_step or max(1, ntr // 40)
    t = np.asarray(twt) if twt is not None else np.arange(ns)
    fig, axes = _plt().subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows),
                             sharey=True, squeeze=False)
    norm = _safe_scale(max(np.nanmax(np.abs(s)) for s in sections) / gain)
    flat = axes.ravel()
    for i, s in enumerate(sections):
        _wiggle_on_ax(flat[i], s, t, tr_step=tr_step, norm=norm)
        flat[i].set_title((titles or [f"state {i}"] * n)[i])
    for j in range(n, len(flat)):
        flat[j].axis("off")
    flat[0].set_ylabel("TWT (s)" if twt is not None else "sample")
    return _finish(fig, path)


def plot_trace_freq_spectrum(data, fs, trace_labels=None, plot_mvg_avg=True,
                             plot_combined=True, mvg_win=7, path=None,
                             device=None):
    """Per-trace amplitude spectra grid with optional moving-average
    overlays and a combined-average panel (reference plot.py:863-1064),
    the spectra taken on ``device``."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    n = data.shape[0]
    f, a = sig.freq_spectrum(data, fs, device=device)
    f, a = _host(f), np.atleast_2d(_host(a))
    total = n + (1 if (plot_combined and n > 1) else 0)
    ncols = int(np.ceil(np.sqrt(total)))
    nrows = int(np.ceil(total / ncols))
    fig, axes = _plt().subplots(nrows, ncols, figsize=(5 * ncols, 3.2 * nrows),
                             sharex=True, squeeze=False)
    flat = axes.ravel()
    kern = np.ones(mvg_win) / mvg_win
    for i in range(n):
        ax = flat[i]
        ax.plot(f, a[i], "k-", lw=0.6, label="spectrum")
        if plot_mvg_avg and len(f) > mvg_win:
            ax.plot(f, np.convolve(a[i], kern, mode="same"), "r-", lw=1.0,
                    label=f"moving avg ({mvg_win})")
        label = trace_labels[i] if trace_labels is not None else f"trace {i}"
        ax.set_title(str(label))
        ax.set_ylabel("amplitude")
        if i == 0:
            ax.legend(fontsize=8)
    if plot_combined and n > 1:
        ax = flat[n]
        ax.plot(f, a.mean(axis=0), "b-", lw=1.2)
        ax.set_title("combined average")
    for j in range(total, len(flat)):
        flat[j].axis("off")
    _label_grid_x(axes, "frequency (Hz)")
    return _finish(fig, path)


def plot_average_freq_spectrum(data, fs, n_traces=None, norm=False,
                               mvg_win=7, path=None, title=None,
                               device=None):
    """Survey-average spectrum: mean over traces with a percentile band and
    a moving-average overlay (reference plot.py:1067-1184), the spectra
    taken on ``device``."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    if n_traces and data.shape[0] > n_traces:
        idx = np.linspace(0, data.shape[0] - 1, n_traces).astype(int)
        data = data[idx]
    f, a = sig.freq_spectrum(data, fs, device=device)
    f, a = _host(f), np.atleast_2d(_host(a))
    mean = a.mean(axis=0)
    if norm and mean.max() > 0:
        a = a / mean.max()
        mean = mean / mean.max()
    p10, p90 = np.percentile(a, [10, 90], axis=0)
    fig, ax = _plt().subplots(figsize=(9, 4.5))
    ax.fill_between(f, p10, p90, color="0.8", label="P10–P90")
    ax.plot(f, mean, "k-", lw=1.0, label="mean")
    if len(f) > mvg_win:
        kern = np.ones(mvg_win) / mvg_win
        ax.plot(f, np.convolve(mean, kern, mode="same"), "r-", lw=1.2,
                label=f"moving avg ({mvg_win})")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("amplitude" + (" (normalized)" if norm else ""))
    ax.legend()
    ax.set_title(title or "average frequency spectrum")
    return _finish(fig, path)
