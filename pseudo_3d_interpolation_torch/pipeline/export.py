"""Step 16 — export the interpolated cube to SEG-Y.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/export.py``, on the
host (numpy): the files the two packages write are byte-identical.

replaces: pseudo_3D_interpolation/cube_cnv_netcdf2segy_3D.py (customized
segysak writer). Traces are written iline-major with CDP / iline / xline /
CDP_X / CDP_Y / fold headers (reference byte map :226-233), a regenerated
40-line textual header carrying the provenance ``text`` attribute
(:237-261), and binary-header interval/sorting updates (:277-282).
"""

from __future__ import annotations

import os

import numpy as np

from ..io import textual as txt
from ..io.cube import Cube
from ..io.headers import check_coordinate_scalar, unscale_coordinates
from ..io.segy import write_segy
from ..ops.affine import Affine
from ..utils.logging import xprint


def cube_to_segy(
    cube: Cube | str,
    out_path: str,
    var: str | None = None,
    ilxl_to_coords: Affine | None = None,
    coordinate_scalar: int | str = -100,
    fmt: int = 5,
    verbose: int = 0,
) -> str:
    """Write the cube's ``var`` (default: its primary variable), a
    (iline, xline, twt) array, as an iline-major SEG-Y at ``out_path``. A
    path input is a cube file (host, h5py)."""
    # 'auto' and the ±10^k ladder validated like the reference
    # (--scalar_coords, cube_cnv_netcdf2segy_3D.py:41-45)
    coordinate_scalar = check_coordinate_scalar(coordinate_scalar)
    if isinstance(cube, (str, os.PathLike)):
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    if var is None:
        var = cube.primary_var()
    dims, data = cube.data_vars[var]
    if dims[-1] != "twt":
        raise ValueError(f"{var} must be (iline, xline, twt); has {dims}")
    data = np.asarray(data, np.float32)
    n_il, n_xl, ns = data.shape
    twt = np.asarray(cube.coords["twt"], np.float64)
    dt_us = int(round(float(np.mean(np.diff(twt))) * 1e6))
    delrt_ms = int(round(float(twt[0]) * 1e3))

    def _index_coord(c):
        """Integer bin indices for the trace headers. Post-upsampling
        coords are fractional (postprocess interpolates new ilines between
        the originals) — truncating those would emit DUPLICATE
        INLINE_3D/CROSSLINE_3D pairs, so renumber consecutively instead."""
        c = np.asarray(c, float)
        ri = np.rint(c)
        if np.allclose(c, ri) and len(np.unique(ri)) == len(ri):
            return ri.astype(np.int64)
        return np.arange(1, len(c) + 1, dtype=np.int64)

    il_idx = _index_coord(cube.coords["iline"])
    xl_idx = _index_coord(cube.coords["xline"])
    il = np.repeat(il_idx, n_xl)
    xl = np.tile(xl_idx, n_il)
    headers = {
        "INLINE_3D": il,
        "CROSSLINE_3D": xl,
        "CDP": np.arange(1, n_il * n_xl + 1),
        "TraceIdentificationCode": 1,
        "DelayRecordingTime": delrt_ms,
        "CoordinateUnits": 1,
        "SourceGroupScalar": coordinate_scalar,
    }
    if "fold" in cube.data_vars:
        headers["NStackedTraces"] = np.asarray(cube.data_vars["fold"][1]).reshape(-1)
    if ilxl_to_coords is not None:
        # navigation comes from the ACTUAL iline/xline coordinate values —
        # the affine is fit in original bin units (ops/binning.py), so
        # feeding it the renumbered 1..N header indices of an upsampled
        # cube would stretch/shift the written grid by the upsample factor
        il_vals = np.repeat(np.asarray(cube.coords["iline"], float), n_xl)
        xl_vals = np.tile(np.asarray(cube.coords["xline"], float), n_il)
        pts = ilxl_to_coords.transform(np.column_stack([il_vals, xl_vals]))
        cx, cy = unscale_coordinates(pts[:, 0], pts[:, 1], scale_factor=coordinate_scalar)
        headers["CDP_X"] = cx
        headers["CDP_Y"] = cy
        headers["SourceX"] = cx
        headers["SourceY"] = cy

    text_attr = cube.attrs.get("text", "")
    if isinstance(text_attr, bytes):
        text_attr = text_attr.decode()
    # regenerate a 40-line header: title + provenance entries under the
    # PROCESSING WORKFLOW banner (reference :237-261)
    text = txt.decode_textual_header(txt.encode_textual_header(
        f"pseudo-3D cube: {var} ({n_il} il x {n_xl} xl x {ns} samples)"))
    text, _ = txt.ensure_workflow_header(text, line=5)
    for ln in str(text_attr).split("\n"):
        ln = ln.strip()
        if not ln:
            continue
        try:
            text = txt.add_processing_entry(text, ln, prefix=None)
        except IndexError:
            break  # header full; keep the earliest entries

    write_segy(
        out_path,
        data.reshape(n_il * n_xl, ns),
        headers=headers,
        bin_updates={"SortingCode": 4, "EnsembleFold": 1},
        text=text,
        fmt=fmt,
        dt_us=dt_us,
    )
    xprint(f"wrote {n_il * n_xl} traces -> {out_path}", kind="info", verbosity=verbose)
    return out_path
