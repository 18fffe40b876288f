"""Step 11 — cube preprocessing: balance / gain / filter / resample / envelope.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/preprocess.py``, in
memory. The operations run in the reference's order: trace balancing ->
time-variant gain -> Butterworth frequency filter -> resampling ->
envelope. Each acts on every trace alone, along time, so the cube goes to
the device once and the whole chain runs there on chunks of traces, each
chunk through every operation before the next; the results come back
once. Each applied operation appends to the history attrs.

The streamed out-of-core pass of the JAX package is not ported yet
(ROADMAP queue 1 #15): ``out_of_core=True``, or a path input whose cube
exceeds ``ooc_threshold_bytes``, raises instead of loading the cube.
"""

from __future__ import annotations

import logging
import os
from math import gcd

import numpy as np
import torch

from ..io.cube import Cube
from ..ops import filters as flt
from ..ops import signal as sig
from ..utils.device import as_tensor, chunk_rows, resolve_device

log = logging.getLogger(__name__)

OOC_NOT_PORTED = ("the streamed out-of-core {step} is not ported yet "
                  "(ROADMAP queue 1 #15)")


def _resolve_resample_to(twt, resample_to, resample_interval_ms,
                         resample_frequency_hz, resample_factor):
    """Resolve the mutually exclusive resample target specs against the twt
    axis (reference cube_preprocessing_3D.py:86-91)."""
    if resample_to is not None or not (resample_interval_ms
                                       or resample_frequency_hz
                                       or resample_factor):
        return resample_to
    if len(twt) < 2:
        raise ValueError("cannot derive a resample target from a "
                         "single-sample twt axis; pass resample_to")
    n_in, dt_in = len(twt), float(twt[1] - twt[0])  # twt in seconds
    if resample_interval_ms:
        return int(round(n_in * dt_in / (resample_interval_ms / 1e3)))
    if resample_frequency_hz:
        return int(round(n_in * dt_in * resample_frequency_hz))
    return int(round(n_in / resample_factor))


def _resample_block(data: torch.Tensor, resample_to, resample_method,
                    resample_window) -> torch.Tensor:
    """Traces (rows, T) resampled to ``resample_to`` samples: Fourier
    resampling on the device, or scipy's polyphase filter on the host
    ('poly', as in the JAX package)."""
    if resample_method == "poly":
        import scipy.signal as ss

        n_old = data.shape[-1]
        g = gcd(int(resample_to), n_old)
        out = ss.resample_poly(
            data.cpu().numpy(), int(resample_to) // g, n_old // g, axis=-1,
            # a bare 'kaiser' needs a beta: scipy's default ('kaiser', 5.0)
            window=(resample_window, 5.0) if resample_window == "kaiser"
            else resample_window).astype(np.float32)
        return torch.from_numpy(out).to(data.device)
    return sig.resample_fft(data, int(resample_to))


def cube_bytes(path, var, factor: int = 1) -> int:
    """float32 bytes of ``var`` in the cube file at ``path``, times
    ``factor`` (host, h5py)."""
    from ..io.ncio import CubeFile

    with CubeFile(path) as f:
        v = var or f.primary_var()
        sizes = f.sizes()
        return 4 * int(np.prod([sizes[k] for k in f.dims_of(v)])) * factor


def preprocess(
    cube: Cube | str,
    var: str = "amp",
    balance: str | None = None,  # 'rms' | 'max'
    balance_store_ref: bool = True,
    gain_args: dict | None = None,  # sugain kwargs
    gain_use_samples: bool = False,  # gain over the sample index
    filter_type: str | None = None,  # lowpass/highpass/bandpass
    filter_freqs=None,
    resample_to: int | None = None,  # new sample count
    # alternative target specs, the reference's mutually exclusive
    # --resampling_interval (ms) / --resampling_frequency (Hz) /
    # --resampling_factor flags, resolved against the twt axis when
    # resample_to is not given
    resample_interval_ms: float | None = None,
    resample_frequency_hz: float | None = None,
    resample_factor: float | None = None,
    resample_method: str = "fft",  # 'fft' (device) | 'poly' (host)
    resample_window: str = "hann",  # polyphase FIR window
    envelope: bool = False,  # Hilbert envelope -> 'env'
    attrs_config=None,  # attrs_time family (reference --params_netcdf)
    out_path: str | None = None,
    out_of_core: bool | None = None,
    ooc_threshold_bytes: int = 2 << 30,
    verbose: int = 0,
    device=None,
) -> Cube:
    """Apply the preprocessing chain to ``var`` (time last); the cube is
    changed in place and returned. ``device`` defaults to the first CUDA
    card and raises without one; ``device='cpu'`` runs on the host."""
    device = resolve_device(device)
    is_path = isinstance(cube, (str, os.PathLike))
    if out_of_core is None and is_path and out_path:
        est = cube_bytes(cube, var)
        if est > ooc_threshold_bytes:
            raise NotImplementedError(
                f"preprocess: ~{est / 2**30:.1f} GiB cube exceeds "
                f"ooc_threshold_bytes; "
                + OOC_NOT_PORTED.format(step="preprocess"))
    if out_of_core:
        raise NotImplementedError(OOC_NOT_PORTED.format(step="preprocess"))
    if is_path:
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    dims, data = cube.data_vars[var]
    if dims[-1] != "twt":
        raise ValueError(f"{var} must be time-last, has dims {dims}")
    twt = np.asarray(cube.coords["twt"], np.float64)
    dt = float(np.mean(np.diff(twt)))
    history = []

    resample_to = _resolve_resample_to(twt, resample_to, resample_interval_ms,
                                       resample_frequency_hz, resample_factor)
    if filter_type and filter_freqs is None:
        raise ValueError("filter_freqs required with filter_type")
    sos = (flt.filter_design(list(filter_freqs), 1.0 / dt, filter_type)
           if filter_type else None)
    gain_axis = (np.arange(len(twt), dtype=np.float64) if gain_use_samples
                 else twt)

    x = as_tensor(np.asarray(data, np.float32), device)
    lead, n_old = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n_old)
    n_new = int(resample_to) if resample_to else n_old
    out = torch.empty((rows.shape[0], n_new), dtype=torch.float32,
                      device=device)
    env = torch.empty_like(out) if envelope else None
    ref = (torch.empty(rows.shape[0], dtype=torch.float32, device=device)
           if balance else None)
    # a chunk's rows pass through every operation before the next chunk;
    # the widest intermediate per row is the filter's padded spectrum
    for a, b in chunk_rows(rows.shape[0], 4 * max(n_old, n_new) * 8):
        y = rows[a:b]
        if balance:
            ref[a:b] = sig.calc_reference_amplitude(y, axis=-1, scale=balance)
            y = y / ref[a:b, None]
        if gain_args:
            y = sig.gain(y, gain_axis, **gain_args)
        if sos is not None:
            y = flt.butterworth_apply_spectral(y, sos)
        if resample_to:
            y = _resample_block(y, resample_to, resample_method,
                                resample_window)
        out[a:b] = y
        if envelope:
            env[a:b] = sig.envelope(y)
    del x, rows

    level = logging.INFO if verbose else logging.DEBUG
    if balance:
        if balance_store_ref:
            cube.data_vars["amp_ref"] = (dims[:-1],
                                         ref.cpu().numpy().reshape(lead))
        history.append(f"BALANCE({balance})")
    if gain_args:
        history.append("GAIN(" + ",".join(f"{k}={v}"
                                          for k, v in gain_args.items()) + ")")
    if filter_type:
        history.append(f"FILTER({filter_type},"
                       f"{'/'.join(str(f) for f in filter_freqs)}Hz)")
    if resample_to:
        cube.coords["twt"] = sig.resampled_twt(twt, n_new, n_old)
        history.append(f"RESAMPLE({n_old}->{resample_to})")
    cube.data_vars[var] = (dims, out.cpu().numpy().reshape(
        tuple(lead) + (n_new,)))
    if envelope:
        cube.data_vars["env"] = (dims, env.cpu().numpy().reshape(
            tuple(lead) + (n_new,)))
        history.append("ENVELOPE")

    for h in history:
        log.log(level, "preprocess: %s", h)
        cube.append_history(h)
    if attrs_config is not None:
        from ..io.ncio import apply_time_attrs

        apply_time_attrs(cube, attrs_config)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, cube)
    return cube
