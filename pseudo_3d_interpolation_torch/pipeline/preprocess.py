"""Step 11 — cube preprocessing: balance / gain / filter / resample / envelope.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/preprocess.py``. The
operations run in the reference's order: trace balancing -> time-variant
gain -> Butterworth frequency filter -> resampling -> envelope. Each acts
on every trace alone, along time, so the cube goes to the device once and
the whole chain runs there on chunks of traces, each chunk through every
operation before the next; the results come back once. Each applied
operation appends to the history attrs.

Out of core (``out_of_core=True``, or a path input whose cube exceeds
``ooc_threshold_bytes``), the same chain streams iline slabs from the
input file to ``out_path``, one upload and one download a slab
(:func:`_preprocess_streamed`).
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


def _chain_plan(twt, gain_use_samples, filter_type, filter_freqs):
    """The filter's second-order sections (None without a filter) and the
    gain's time axis, from the twt axis."""
    if filter_type and filter_freqs is None:
        raise ValueError("filter_freqs required with filter_type")
    dt = float(np.mean(np.diff(twt)))
    sos = (flt.filter_design(list(filter_freqs), 1.0 / dt, filter_type)
           if filter_type else None)
    gain_axis = (np.arange(len(twt), dtype=np.float64) if gain_use_samples
                 else twt)
    return sos, gain_axis


class _TraceChain:
    """The preprocessing chain on a tensor of traces (..., T), in chunks
    of traces: each chunk passes through every operation before the next.
    Returns ``(out, env, ref)`` on the traces' device: the processed
    traces, their envelope (None without ``envelope``) and the balance's
    reference amplitude per trace (None without ``balance``)."""

    def __init__(self, balance, gain_args, gain_axis, sos, resample_to,
                 resample_method, resample_window, envelope):
        self.balance, self.gain_args = balance, gain_args
        self.gain_axis, self.sos = gain_axis, sos
        self.resample_to = resample_to
        self.resample_method = resample_method
        self.resample_window = resample_window
        self.envelope = envelope

    def __call__(self, x: torch.Tensor):
        lead, n_old = x.shape[:-1], x.shape[-1]
        rows = x.reshape(-1, n_old)
        n_new = int(self.resample_to) if self.resample_to else n_old
        out = torch.empty((rows.shape[0], n_new), dtype=torch.float32,
                          device=x.device)
        env = torch.empty_like(out) if self.envelope else None
        ref = (torch.empty(rows.shape[0], dtype=torch.float32,
                           device=x.device) if self.balance else None)
        # the widest intermediate per row is the filter's padded spectrum
        for a, b in chunk_rows(rows.shape[0], 4 * max(n_old, n_new) * 8):
            y = rows[a:b]
            if self.balance:
                ref[a:b] = sig.calc_reference_amplitude(y, axis=-1,
                                                        scale=self.balance)
                y = y / ref[a:b, None]
            if self.gain_args:
                y = sig.gain(y, self.gain_axis, **self.gain_args)
            if self.sos is not None:
                y = flt.butterworth_apply_spectral(y, self.sos)
            if self.resample_to:
                y = _resample_block(y, self.resample_to,
                                    self.resample_method,
                                    self.resample_window)
            out[a:b] = y
            if self.envelope:
                env[a:b] = sig.envelope(y)
        shape = tuple(lead) + (n_new,)
        return (out.reshape(shape),
                env.reshape(shape) if env is not None else None,
                ref.reshape(lead) if ref is not None else None)


def _history(balance, gain_args, filter_type, filter_freqs, resample_to,
             n_old, envelope) -> list[str]:
    """The history entries of the applied operations, in chain order."""
    history = []
    if balance:
        history.append(f"BALANCE({balance})")
    if gain_args:
        history.append("GAIN(" + ",".join(f"{k}={v}"
                                          for k, v in gain_args.items()) + ")")
    if filter_type:
        history.append(f"FILTER({filter_type},"
                       f"{'/'.join(str(f) for f in filter_freqs)}Hz)")
    if resample_to:
        history.append(f"RESAMPLE({n_old}->{resample_to})")
    if envelope:
        history.append("ENVELOPE")
    return history


def preprocess_slabs(src, store, var, balance=None,
                     balance_store_ref=True, gain_args=None,
                     gain_use_samples=False, filter_type=None,
                     filter_freqs=None, resample_to=None,
                     resample_interval_ms=None, resample_frequency_hz=None,
                     resample_factor=None, resample_method="fft",
                     resample_window="hann", envelope=False,
                     attrs_config=None, block: int = 16, verbose: int = 0,
                     device=None):
    """The streamed preprocess's slab loop: ``var`` of ``src`` through the
    chain in slabs of ``block`` ilines, each uploaded to ``device`` once,
    processed and downloaded once into the sink.

    ``src`` is anything with :class:`~..io.ncio.CubeFile`'s slab methods
    (``data_vars``, ``dims_of``, ``sizes``, ``coords``, ``attrs``,
    ``var_attrs``, ``coord_attrs``, ``dtype_of``, ``read_slab``,
    ``read``); ``store.writer(coords, attrs, coord_attrs)`` returns the
    sink, anything with :class:`~..io.ncio.CubeWriter`'s methods
    (``create_var``, ``write_slab``, ``set_attrs``, ``close``), as
    :class:`~..io.ncio.SlabFiles` does for a file. The untouched variables
    ride through in the same slabs when they carry the iline dim, whole
    otherwise; one that carries the resampled twt dim is dropped. Every
    operation acts on each trace alone, so the output equals the
    in-memory chain's. Returns the closed sink."""
    device = resolve_device(device)
    dims = src.dims_of(var)
    if dims[-1] != "twt":
        raise ValueError(f"{var} must be time-last, has dims {dims}")
    il_dim = dims[0]
    n_il = src.sizes()[il_dim]
    twt = np.asarray(src.coords["twt"], np.float64)
    resample_to = _resolve_resample_to(twt, resample_to, resample_interval_ms,
                                       resample_frequency_hz, resample_factor)
    sos, gain_axis = _chain_plan(twt, gain_use_samples, filter_type,
                                 filter_freqs)
    chain = _TraceChain(balance, gain_args, gain_axis, sos, resample_to,
                        resample_method, resample_window, envelope)
    n_old = len(twt)
    out_coords = {d: np.asarray(src.coords[d]) for d in src.coords}
    if resample_to:
        out_coords["twt"] = sig.resampled_twt(twt, int(resample_to), n_old)
    history = _history(balance, gain_args, filter_type, filter_freqs,
                       resample_to, n_old, envelope)

    attrs = dict(src.attrs)
    # the attrs_time family: global attrs merge into the file's attrs,
    # per-variable and per-coordinate ones into theirs, as the in-memory
    # path's apply_time_attrs does
    attrs_time = {}
    if attrs_config is not None:
        from ..io.ncio import load_attrs_config

        attrs_time = load_attrs_config(attrs_config)[0]
        for k, v in attrs_time.get("cube", {}).items():
            if k != "history":
                attrs[k] = v

    def var_attrs(name):
        a = dict(src.var_attrs.get(name, {}))
        a.update(attrs_time.get(name, {}))
        return a

    coord_attrs = {d: dict(src.coord_attrs.get(d, {})) for d in out_coords}
    for d in coord_attrs:
        coord_attrs[d].update(attrs_time.get(d, {}))
    level = logging.INFO if verbose else logging.DEBUG
    riders = []
    for k in src.data_vars:
        if k in (var, "amp_ref", "env"):
            continue
        if "twt" in src.dims_of(k) and resample_to:
            log.debug("dropped %s: carries the twt dim being resampled", k)
            continue
        riders.append(k)

    w = store.writer(out_coords, attrs, coord_attrs)
    w.create_var(var, dims, np.float32, chunks={il_dim: min(block, n_il)},
                 attrs=var_attrs(var))
    if balance and balance_store_ref:
        w.create_var("amp_ref", dims[:-1], np.float32,
                     attrs=var_attrs("amp_ref"))
    if envelope:
        w.create_var("env", dims, np.float32, attrs=var_attrs("env"))
    for k in riders:
        w.create_var(k, src.dims_of(k), src.dtype_of(k), attrs=var_attrs(k))

    for i0 in range(0, n_il, block):
        i1 = min(i0 + block, n_il)
        x = as_tensor(np.asarray(src.read_slab(var, dim=il_dim, start=i0,
                                               stop=i1), np.float32), device)
        out, env, ref = chain(x)
        del x
        w.write_slab(var, out.cpu().numpy(), dim=il_dim, start=i0)
        if balance and balance_store_ref:
            w.write_slab("amp_ref", ref.cpu().numpy(), dim=il_dim, start=i0)
        if envelope:
            w.write_slab("env", env.cpu().numpy(), dim=il_dim, start=i0)
        del out, env, ref
        for k in riders:
            kd = src.dims_of(k)
            if kd and kd[0] == il_dim:
                w.write_slab(k, src.read_slab(k, dim=il_dim, start=i0,
                                              stop=i1), dim=il_dim, start=i0)
            elif i0 == 0:
                w.write_slab(k, src.read(k))

    w.set_attrs(history=str(attrs.get("history", ""))
                + "".join(f"{h};" for h in history))
    w.close()
    for h in history:
        log.log(level, "preprocess (streamed): %s", h)
    return w


def _preprocess_streamed(path, out_path: str, device, **kw) -> str:
    """Streamed preprocess of the cube file at ``path`` into ``out_path``
    (:func:`preprocess_slabs` over a ``CubeFile`` and ``SlabFiles``);
    returns ``out_path``."""
    from ..io.ncio import CubeFile, SlabFiles

    with CubeFile(path) as src, SlabFiles(out_path) as store:
        preprocess_slabs(src, store, device=device, **kw)
    return out_path


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
    block: int = 16,
    verbose: int = 0,
    device=None,
) -> Cube | str:
    """Apply the preprocessing chain to ``var`` (time last); the cube is
    changed in place and returned. ``device`` defaults to the first CUDA
    card and raises without one; ``device='cpu'`` runs on the host.

    ``out_of_core=True`` (a path input and ``out_path`` required) streams
    slabs of ``block`` ilines through the same chain and returns
    ``out_path`` (:func:`preprocess_slabs`); ``None`` streams when the
    cube exceeds ``ooc_threshold_bytes``."""
    device = resolve_device(device)
    is_path = isinstance(cube, (str, os.PathLike))
    if out_of_core is None and is_path and out_path:
        est = cube_bytes(cube, var)
        out_of_core = est > ooc_threshold_bytes
        if out_of_core:
            log.log(logging.INFO if verbose else logging.DEBUG,
                    "preprocess: ~%.1f GiB cube — streaming out of core",
                    est / 2**30)
    if out_of_core:
        if not is_path or not out_path:
            raise ValueError("out_of_core=True requires a path input and "
                             "out_path")
        return _preprocess_streamed(
            cube, out_path, device, var=var, balance=balance,
            balance_store_ref=balance_store_ref, gain_args=gain_args,
            gain_use_samples=gain_use_samples, filter_type=filter_type,
            filter_freqs=filter_freqs, resample_to=resample_to,
            resample_interval_ms=resample_interval_ms,
            resample_frequency_hz=resample_frequency_hz,
            resample_factor=resample_factor, resample_method=resample_method,
            resample_window=resample_window, envelope=envelope,
            attrs_config=attrs_config, block=block, verbose=verbose)
    if is_path:
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    dims, data = cube.data_vars[var]
    if dims[-1] != "twt":
        raise ValueError(f"{var} must be time-last, has dims {dims}")
    twt = np.asarray(cube.coords["twt"], np.float64)
    resample_to = _resolve_resample_to(twt, resample_to, resample_interval_ms,
                                       resample_frequency_hz, resample_factor)
    sos, gain_axis = _chain_plan(twt, gain_use_samples, filter_type,
                                 filter_freqs)

    chain = _TraceChain(balance, gain_args, gain_axis, sos, resample_to,
                        resample_method, resample_window, envelope)
    x = as_tensor(np.asarray(data, np.float32), device)
    n_old = x.shape[-1]
    n_new = int(resample_to) if resample_to else n_old
    out, env, ref = chain(x)
    del x

    level = logging.INFO if verbose else logging.DEBUG
    if balance and balance_store_ref:
        cube.data_vars["amp_ref"] = (dims[:-1], ref.cpu().numpy())
    if resample_to:
        cube.coords["twt"] = sig.resampled_twt(twt, n_new, n_old)
    cube.data_vars[var] = (dims, out.cpu().numpy())
    if envelope:
        cube.data_vars["env"] = (dims, env.cpu().numpy())

    for h in _history(balance, gain_args, filter_type, filter_freqs,
                      resample_to, n_old, envelope):
        log.log(level, "preprocess: %s", h)
        cube.append_history(h)
    if attrs_config is not None:
        from ..io.ncio import apply_time_attrs

        apply_time_attrs(cube, attrs_config)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, cube)
    return cube
