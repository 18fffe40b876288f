"""Step 12 — forward FFT along the time axis of the cube.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/fft.py``. The cube's
(iline, xline, twt) amp/env variable becomes complex
``freq_<var>(iline, xline, freq_twt)`` with true-amplitude/true-phase
scaling, optional integer spectrum upsampling, optional Hanning-edged
frequency filtering, and optional dropping of filtered bins (the original
nfft is recorded for the inverse). The cube goes to the device once, is
transformed there and comes back as complex64 numpy.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..io.cube import Cube
from ..ops import spectral
from ..ops.cplx import from_complex, to_complex
from ..utils.device import as_tensor, resolve_device

log = logging.getLogger(__name__)


def apply_fft(
    cube: Cube | str,
    var: str | None = None,
    real: bool = True,
    upsample: int = 1,
    filter_type: str | None = None,
    filter_freqs=None,
    drop_filtered: bool = False,
    out_path: str | None = None,
    attrs_config=None,
    verbose: int = 0,
    device=None,
) -> Cube:
    """``device`` defaults to the first CUDA card and raises without one;
    ``device='cpu'`` runs on the host. A path input and ``out_path`` are
    cube files (host, h5py)."""
    if isinstance(cube, (str, os.PathLike)):
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    if var is None:
        var = cube.primary_var()
    dims, data = cube.data_vars[var]
    if dims[-1] != "twt":
        raise ValueError(f"{var} must have twt as its last axis, has {dims}")
    twt = np.asarray(cube.coords["twt"], np.float64)
    x = as_tensor(np.asarray(data, np.float32), resolve_device(device))

    spec = spectral.forward_fft(x, twt, real=real, upsample=upsample)
    del x
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "FFT: %s -> %s bins", data.shape, tuple(spec.data.shape))

    if filter_type is not None:
        if filter_freqs is None:
            raise ValueError("filter frequencies must be specified")
        spec = spectral.apply_freq_filter(spec, list(filter_freqs),
                                          filter_type,
                                          drop_filtered=drop_filtered)
        log.log(level, "freq filter %s %s Hz%s", filter_type, filter_freqs,
                " (+drop)" if drop_filtered else "")

    var_new = f"freq_{var}"
    # every non-time coordinate rides along (cubes and 2D profiles alike)
    coords = {k: v for k, v in cube.coords.items() if k != "twt"}
    coords["freq_twt"] = spec.freqs
    out = Cube(
        coords=coords,
        data_vars={var_new: (dims[:-1] + ("freq_twt",),
                             to_complex(spec.data))},
        attrs=dict(cube.attrs),
        coord_attrs={"freq_twt": {"units": "Hz", "long_name": "frequency"}},
        var_attrs={var_new: {
            "original_var": var,
            "nfft": spec.nfft,
            "n_time": spec.n_time,
            "twt0": spec.t0,
            "dt": spec.dt,
            "real_fft": int(spec.real),
        }},
    )
    if "fold" in cube.data_vars:
        out.data_vars["fold"] = cube.data_vars["fold"]
    out.append_history(
        f"FFT({var})" + (f" x{upsample}" if upsample > 1 else "")
        + (f" {filter_type.upper()} {filter_freqs}" if filter_type else ""))
    # the attrs config applies to the returned cube too, or in-memory
    # chains would lose the configured frequency metadata
    encodings = None
    if attrs_config is not None:
        from ..io.ncio import apply_attrs, load_attrs_config

        _, attrs_freq, encodings, _ = load_attrs_config(attrs_config)
        named = {{"data": var_new, "new_dim": "freq_twt"}.get(k, k): a
                 for k, a in attrs_freq.items()}
        apply_attrs(out, named)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, out, chunks={"freq_twt": 1},
                   encodings=encodings)
    return out


def spectrum_from_cube(cube: Cube, var: str,
                       device=None) -> spectral.Spectrum:
    """Rebuild a :class:`Spectrum` from a stored frequency cube, its data
    on ``device`` (default the first CUDA card)."""
    dims, data = cube.data_vars[var]
    a = cube.var_attrs.get(var, {})
    return spectral.Spectrum(
        data=from_complex(np.asarray(data), resolve_device(device)),
        freqs=np.asarray(cube.coords["freq_twt"], np.float64),
        nfft=int(a["nfft"]),
        n_time=int(a["n_time"]),
        t0=float(a["twt0"]),
        dt=float(a["dt"]),
        real=bool(a.get("real_fft", 1)),
    )
