"""Step 09 — convert 2D SEG-Y profiles to per-profile netCDF files.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/segy2cube.py``, on
the host: :func:`profile_to_cube` reads a profile into an in-memory
:class:`Cube`; :func:`convert` writes the files (h5py).

replaces: pseudo_3D_interpolation/cnv_segy2netcdf.py (segysak converter +
multiprocessing.Pool). Each profile becomes an HDF5/netCDF file with
``amp(tracl, twt)``, navigation coordinates, and acquisition metadata. A
thread pool covers the reference's process-pool parallelism (the work is
I/O-bound memcpy + decode).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from ..io.auxiliary import resolve_input_files
from ..io.cube import Cube
from ..io.headers import scale_coordinates
from ..io.segy import SegyFile
from ..utils.logging import xprint


def profile_to_cube(segy_path: str, src_coords_bytes=(73, 77)) -> Cube:
    with SegyFile(segy_path) as f:
        data = f.trace_data()
        x, y, units = scale_coordinates(f, src_coords_bytes)
        delrt = f.header("DelayRecordingTime").astype(np.float64) * 1e-3
        tracl = f.header("TRACE_SEQUENCE_FILE")
        if not tracl.any():
            tracl = np.arange(1, f.n_traces + 1)
        dt = f.dt_us * 1e-6
        text = f.text
    # valid-but-empty file (aborted line): an empty cube, not a
    # zero-size-reduction ValueError that kills the whole convert() batch
    twt = ((delrt.min() if delrt.size else 0.0)
           + np.arange(data.shape[1]) * dt)
    return Cube(
        coords={"tracl": tracl.astype(np.int64), "twt": twt},
        data_vars={
            "amp": (("tracl", "twt"), data),
            "x": (("tracl",), x),
            "y": (("tracl",), y),
            "delrt": (("tracl",), delrt),
        },
        attrs={
            "source_file": os.path.basename(segy_path),
            "dt": dt,
            "text": text,
        },
        coord_attrs={"twt": {"units": "s"}},
    )


def convert(path, out_dir: str | None = None, fsuffix: str = "sgy",
            fnsuffix: str | None = None,
            workers: int = 4, verbose: int = 0) -> list[str]:
    """Convert all profiles under ``path``; returns written file paths.
    ``fsuffix``/``fnsuffix`` are the reference's ``--suffix`` /
    ``--filename_suffix`` directory filters (cnv_segy2netcdf.py:22-25)."""
    from ..io.ncio import write_cube

    files = resolve_input_files(path, fsuffix, fnsuffix=fnsuffix)
    if out_dir is None:
        out_dir = os.path.dirname(files[0]) if files else "."
    os.makedirs(out_dir, exist_ok=True)

    def _one(p):
        out = os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".nc")
        write_cube(out, profile_to_cube(p))
        xprint(f"converted {p} -> {out}", kind="debug", verbosity=verbose)
        return out

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_one, files))
