"""netCDF4-compatible cube files over h5py, on the host.

Counterpart of ``pseudo_3d_interpolation_tpu/io/ncio.py``; the files the
two packages write are interchangeable. They are HDF5 with dimension
scales and attributes, so they open in xarray/netCDF4 elsewhere. Complex
variables are stored split as ``<var>.real`` / ``<var>.imag`` float32
halves, as the reference does, and recombined on read; CF packing
(``scale_factor``, ``add_offset``, ``_FillValue``) is applied on write
through ``encodings`` and undone on read.

h5py and yaml are imported inside the functions that use them: the
machine with the card has neither, and runs the pipeline on in-memory
cubes.
"""

from __future__ import annotations

import os

import numpy as np

from .cube import AUX_VARS, Cube, primary_var_name

__all__ = ["AUX_VARS", "Cube", "CubeFile", "CubeWriter", "SlabFiles",
           "apply_attrs", "apply_time_attrs", "load_attrs_config",
           "primary_var_name", "read_cube", "write_cube"]

# attributes h5py's dimension scales own, never copied into a cube
_SCALE_ATTRS = ("CLASS", "NAME", "REFERENCE_LIST")
_VAR_ATTRS = ("DIMENSION_LIST", "_dims")


def _s(v):
    return v.decode() if isinstance(v, bytes) else v


def _sanitize_attr(v):
    if isinstance(v, (np.ndarray, list, tuple, str, bytes, int, float,
                      np.integer, np.floating)):
        return v
    return str(v)


def _pack(data: np.ndarray, enc: dict):
    """CF-convention packing: stored = rint((x - add_offset)/scale_factor)
    as the encoding dtype; NaN -> _FillValue. Returns (stored, cf_attrs)."""
    dtype = np.dtype(enc.get("dtype", data.dtype))
    scale = float(enc.get("scale_factor", 1.0))
    offset = float(enc.get("add_offset", 0.0))
    fill = enc.get("_FillValue")
    if dtype.kind in "iu":
        stored = np.rint((np.asarray(data, np.float64) - offset) / scale)
        info = np.iinfo(dtype)
        stored = np.clip(stored, info.min, info.max)
        if fill is not None:
            stored = np.where(np.isnan(data), float(fill), stored)
        stored = stored.astype(dtype)
    else:
        stored = np.asarray(data, dtype)
    cf = {}
    if scale != 1.0:
        cf["scale_factor"] = scale
    if offset != 0.0:
        cf["add_offset"] = offset
    if fill is not None:
        cf["_FillValue"] = np.asarray(fill, dtype)
    return stored, cf


def _is_packed(attrs, dtype) -> bool:
    """Whether a stored variable carries CF packing. A fill-only encoding
    (integer dtype, default scale and offset) counts too, or NaN cells
    would come back as literal fill values."""
    return ("scale_factor" in attrs or "add_offset" in attrs
            or ("_FillValue" in attrs and np.dtype(dtype).kind in "iu"))


def _unpack(raw: np.ndarray, attrs) -> np.ndarray:
    """Undo CF packing in float64, like xarray/netCDF4, and cast down only
    at the end: float64 for int32-packed data (float32 cannot hold 2^31
    levels), float32 otherwise."""
    scale = float(attrs.get("scale_factor", 1.0))
    offset = float(attrs.get("add_offset", 0.0))
    fill = attrs.get("_FillValue")
    unpacked = raw.astype(np.float64) * scale + offset
    if fill is not None:
        unpacked = np.where(raw == fill, np.nan, unpacked)
    out_dt = (np.float64 if raw.dtype.itemsize >= 4
              and raw.dtype.kind in "iu" else np.float32)
    return unpacked.astype(out_dt)


def _read_header(f):
    """(dimension names, coords, coord attrs) of an open h5py file."""
    dims = [k for k in f.keys()
            if _s(f[k].attrs.get("CLASS", "")) == "DIMENSION_SCALE"]
    coords = {k: f[k][()] for k in dims}
    coord_attrs = {k: {a: v for a, v in f[k].attrs.items()
                       if not a.startswith(_SCALE_ATTRS)} for k in dims}
    return dims, coords, coord_attrs


def _chunk_shape(chunks, dims, shape):
    if not chunks:
        return None
    return tuple(min(chunks.get(d, s), s) for d, s in zip(dims, shape))


def write_cube(path, cube: Cube, compress: bool | str = False,
               chunks: dict | None = None, encodings: dict | None = None):
    """Write a :class:`Cube` as a netCDF4-flavored HDF5 file.

    ``chunks`` maps dim name -> chunk length (``{"freq_twt": 1}`` for the
    slice-major layout). ``encodings`` maps var name -> {dtype,
    scale_factor, add_offset, _FillValue} for CF-convention packed
    storage; :func:`read_cube` unpacks it.
    """
    import h5py

    kw = {}
    if compress:
        kw["compression"] = "gzip" if compress is True else compress
        kw["compression_opts"] = 1 if kw["compression"] == "gzip" else None
    encodings = encodings or {}

    with h5py.File(path, "w") as f:
        for dim, coord in cube.coords.items():
            dset = f.create_dataset(dim, data=np.asarray(coord))
            dset.make_scale(dim)
            for k, v in cube.coord_attrs.get(dim, {}).items():
                dset.attrs[k] = _sanitize_attr(v)

        def _write_var(name, dims, data, attrs_name=None, cf_attrs=None):
            d = f.create_dataset(name, data=data,
                                 chunks=_chunk_shape(chunks, dims,
                                                     data.shape), **kw)
            for i, dim in enumerate(dims):
                d.dims[i].attach_scale(f[dim])
            d.attrs["_dims"] = [s.encode() for s in dims]
            for k, v in cube.var_attrs.get(attrs_name or name, {}).items():
                d.attrs[k] = _sanitize_attr(v)
            for k, v in (cf_attrs or {}).items():
                d.attrs[k] = v

        for name, (dims, data) in cube.data_vars.items():
            data = np.asarray(data)
            if np.iscomplexobj(data):
                # the complex variable's attrs ride on both halves
                _write_var(f"{name}.real", dims,
                           data.real.astype(np.float32), attrs_name=name)
                _write_var(f"{name}.imag", dims,
                           data.imag.astype(np.float32), attrs_name=name)
            elif name in encodings:
                stored, cf = _pack(data, encodings[name])
                _write_var(name, dims, stored, cf_attrs=cf)
            else:
                _write_var(name, dims, data)

        for k, v in cube.attrs.items():
            f.attrs[k] = _sanitize_attr(v)


def read_cube(path, combine_complex: bool = True, variables=None) -> Cube:
    """Read a cube file written by :func:`write_cube` (or compatible
    netCDF4/h5netcdf output). Split complex pairs recombine by default."""
    import h5py

    with h5py.File(path, "r") as f:
        dim_names, coords, coord_attrs = _read_header(f)
        data_vars = {}
        var_attrs = {}
        for k in f.keys():
            if k in dim_names:
                continue
            if (variables is not None and k.split(".")[0] not in variables
                    and k not in variables):
                continue
            dims = tuple(_s(s) for s in f[k].attrs.get("_dims", []))
            if not dims:
                dims = tuple((d.keys()[0] if len(d.keys()) else f"dim_{i}")
                             for i, d in enumerate(f[k].dims))
            raw = f[k][()]
            attrs_k = {a: v for a, v in f[k].attrs.items()
                       if not a.startswith(_VAR_ATTRS)}
            if _is_packed(attrs_k, raw.dtype):
                raw = _unpack(raw, attrs_k)
                for key in ("scale_factor", "add_offset", "_FillValue"):
                    attrs_k.pop(key, None)
            data_vars[k] = (dims, raw)
            var_attrs[k] = attrs_k
        attrs = dict(f.attrs)

    if combine_complex:
        for k in list(data_vars):
            if k.endswith(".real") and k[:-5] + ".imag" in data_vars:
                base = k[:-5]
                dims, re = data_vars.pop(k)
                _, im = data_vars.pop(base + ".imag")
                data_vars[base] = (dims, re.astype(np.complex64)
                                   + 1j * im.astype(np.complex64))
                var_attrs[base] = var_attrs.pop(k, {})
                var_attrs.pop(base + ".imag", None)

    return Cube(coords=coords, data_vars=data_vars, attrs=attrs,
                var_attrs=var_attrs, coord_attrs=coord_attrs)


class CubeFile:
    """Lazy cube reader: metadata up front, data slabs on demand.

    The out-of-core counterpart of :func:`read_cube`: ``read_slab``
    reads ``[start:stop]`` along one dim. Split complex pairs recombine
    per slab, and CF-packed variables come back unpacked, so the public
    ``var_attrs`` carry no packing keys. Use as a context manager.
    """

    def __init__(self, path):
        import h5py

        self._f = h5py.File(path, "r")
        f = self._f
        self.dim_names, self.coords, self.coord_attrs = _read_header(f)
        self.attrs = dict(f.attrs)
        self._dims = {}
        self.var_attrs = {}
        complex_halves = set()
        for k in f.keys():
            if k in self.dim_names:
                continue
            self._dims[k] = tuple(_s(s) for s in f[k].attrs.get("_dims", []))
            attrs_k = {a: v for a, v in f[k].attrs.items()
                       if not a.startswith(_VAR_ATTRS)}
            if _is_packed(attrs_k, f[k].dtype):
                for key in ("scale_factor", "add_offset", "_FillValue"):
                    attrs_k.pop(key, None)
            self.var_attrs[k] = attrs_k
            if k.endswith(".real") and k[:-5] + ".imag" in f.keys():
                complex_halves.add(k[:-5])
        # logical variable table: complex pairs under their base name
        self.data_vars = {}
        for k, dims in self._dims.items():
            base = k[:-5] if k.endswith((".real", ".imag")) else k
            if base in complex_halves:
                self.data_vars[base] = dims
                self.var_attrs.setdefault(
                    base, self.var_attrs.get(base + ".real", {}))
            else:
                self.data_vars[k] = dims
        self._complex = complex_halves

    def dims_of(self, var: str) -> tuple[str, ...]:
        return self.data_vars[var]

    def primary_var(self) -> str:
        """First non-auxiliary variable (same contract as Cube's)."""
        return primary_var_name(self.data_vars)

    def sizes(self) -> dict[str, int]:
        return {d: len(c) for d, c in self.coords.items()}

    def is_complex(self, var: str) -> bool:
        return var in self._complex

    def dtype_of(self, var: str) -> np.dtype:
        """The dtype :meth:`read_slab` returns for ``var``: complex64 for a
        split pair, the unpacked float for a CF-packed variable, else the
        stored dtype."""
        if var in self._complex:
            return np.dtype(np.complex64)
        d = self._f[var]
        if _is_packed(d.attrs, d.dtype):
            return np.dtype(np.float64 if d.dtype.itemsize >= 4
                            and d.dtype.kind in "iu" else np.float32)
        return d.dtype

    def read_slab(self, var: str, dim: str | None = None, start: int = 0,
                  stop: int | None = None) -> np.ndarray:
        """Read ``var`` restricted to ``[start:stop]`` along ``dim``."""
        sel = tuple(slice(start, stop) if (dim is not None and d == dim)
                    else slice(None) for d in self.data_vars[var])
        if var in self._complex:
            re = self._f[var + ".real"][sel]
            im = self._f[var + ".imag"][sel]
            return re.astype(np.complex64) + 1j * im.astype(np.complex64)
        raw = self._f[var][sel]
        attrs = self._f[var].attrs
        return _unpack(raw, attrs) if _is_packed(attrs, raw.dtype) else raw

    def read(self, var: str) -> np.ndarray:
        return self.read_slab(var)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CubeWriter:
    """Incremental cube writer: dims and datasets created up front, data
    filled slab by slab, attributes written on close.

    The out-of-core counterpart of :func:`write_cube`, with the same file
    layout; complex dtypes store as ``.real``/``.imag`` float32 halves.
    """

    def __init__(self, path, coords: dict, attrs: dict | None = None,
                 coord_attrs: dict | None = None):
        import h5py

        self.path = path
        self._f = h5py.File(path, "w")
        self.coords = {k: np.asarray(v) for k, v in coords.items()}
        for dim, coord in self.coords.items():
            d = self._f.create_dataset(dim, data=coord)
            d.make_scale(dim)
            for k, v in (coord_attrs or {}).get(dim, {}).items():
                d.attrs[k] = _sanitize_attr(v)
        self._attrs = dict(attrs or {})
        self._complex = set()

    def create_var(self, name: str, dims: tuple[str, ...], dtype,
                   chunks: dict | None = None, attrs: dict | None = None):
        shape = tuple(len(self.coords[d]) for d in dims)
        dtype = np.dtype(dtype)
        names = [name]
        if dtype.kind == "c":
            names = [name + ".real", name + ".imag"]
            dtype = np.float32
            self._complex.add(name)
        for n in names:
            d = self._f.create_dataset(n, shape=shape, dtype=dtype,
                                       chunks=_chunk_shape(chunks, dims,
                                                           shape))
            for i, dim in enumerate(dims):
                d.dims[i].attach_scale(self._f[dim])
            d.attrs["_dims"] = [s.encode() for s in dims]
            for k, v in (attrs or {}).items():
                d.attrs[k] = _sanitize_attr(v)

    def write_slab(self, name: str, data: np.ndarray, dim: str | None = None,
                   start: int = 0):
        """Write ``data`` at offset ``start`` along ``dim`` (full extent on
        the other axes)."""
        target = (self._f[name + ".real"] if name in self._complex
                  else self._f[name])
        dims = tuple(_s(s) for s in target.attrs["_dims"])
        sel = tuple(slice(start, start + n) if (dim is not None and d == dim)
                    else slice(None) for d, n in zip(dims, data.shape))
        if name in self._complex:
            data = np.asarray(data)
            self._f[name + ".real"][sel] = data.real.astype(np.float32)
            self._f[name + ".imag"][sel] = data.imag.astype(np.float32)
        else:
            self._f[name][sel] = data

    def set_attrs(self, **kw):
        self._attrs.update(kw)

    def close(self):
        for k, v in self._attrs.items():
            self._f.attrs[k] = _sanitize_attr(v)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SlabFiles:
    """Where a streamed pass writes: its output file, and temporary files
    beside it for the passes before the last.

    ``writer(coords, attrs, coord_attrs, final)`` opens a
    :class:`CubeWriter` on ``out_path`` (``final``) or on a new temporary
    file; ``reader(writer)`` opens what a closed writer wrote as a
    :class:`CubeFile`; ``close()`` removes the temporary files. The
    streamed passes take any object with these two methods, so an
    in-memory store can stand in for the files."""

    def __init__(self, out_path):
        self.out_path = out_path
        self._tmps = []

    def writer(self, coords, attrs=None, coord_attrs=None,
               final: bool = True) -> CubeWriter:
        if final:
            path = self.out_path
        else:
            import tempfile

            fd, path = tempfile.mkstemp(
                suffix=".nc", dir=os.path.dirname(os.path.abspath(
                    self.out_path)))
            os.close(fd)
            self._tmps.append(path)
        return CubeWriter(path, coords, attrs=attrs, coord_attrs=coord_attrs)

    def reader(self, writer: CubeWriter) -> CubeFile:
        return CubeFile(writer.path)

    def close(self):
        for p in self._tmps:
            try:
                os.remove(p)
            except OSError:
                pass
        self._tmps = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_attrs_config(path_or_dict):
    """Load the reference-format netCDF attrs/encodings YAML.

    Returns (attrs_time, attrs_freq, encodings, var_aux) dicts; any family
    may be absent. ``attrs_time`` keys are variable/coordinate names;
    ``attrs_freq`` uses the reference's ``data``/``new_dim`` placeholders
    for the spectral variable and frequency coordinate.
    """
    if isinstance(path_or_dict, dict):
        cfg = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f) or {}
    return (cfg.get("attrs_time", {}) or {}, cfg.get("attrs_freq", {}) or {},
            cfg.get("encodings", {}) or {}, cfg.get("var_aux", []) or [])


def apply_attrs(cube: Cube, attrs: dict) -> None:
    """Merge a per-variable/coordinate attrs mapping into a cube in place;
    the special key ``cube`` carries global attributes."""
    for name, a in attrs.items():
        if name == "cube":
            for k, v in a.items():
                if k == "history":
                    continue  # history accumulates through append_history
                cube.attrs[k] = v
        elif name in cube.data_vars:
            cube.var_attrs.setdefault(name, {}).update(a)
        elif name in cube.coords:
            cube.coord_attrs.setdefault(name, {}).update(a)


def apply_time_attrs(cube: Cube, attrs_config) -> None:
    """Apply the ``attrs_time`` family of a reference-format attrs YAML
    (path or dict) to a time-domain cube."""
    attrs_time, _, _, _ = load_attrs_config(attrs_config)
    apply_attrs(cube, attrs_time)
