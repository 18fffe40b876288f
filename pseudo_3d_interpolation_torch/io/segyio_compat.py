"""Drop-in segyio-compatible API over the port's SEG-Y codec.

Counterpart of ``pseudo_3d_interpolation_tpu/io/segyio_compat.py``, a host
copy over :mod:`pseudo_3d_interpolation_torch.io.segy` (numpy only; no
torch). The reference's stage-1 workflow scripts (and most users' own QC
tooling) are written against segyio (merge_segys.py:12,
delrt_padding_segy.py:186-249, static_correction_segy.py:366-538, ...).
This module reproduces the slice of segyio's surface those scripts use —
``open``/``create``/``tools.dt``/``tools.metadata``, the
``TraceField``/``BinField`` constants, ``tracefield.keys``, and the
file object's ``trace``/``header``/``bin``/``text``/``attributes``
accessors — so segyio-based code runs unchanged without the C
dependency:

    from pseudo_3d_interpolation_torch.io import segyio_compat
    segyio_compat.install()          # registers sys.modules['segyio']
    import segyio                    # -> this module
    ...
    segyio_compat.uninstall()        # removes the alias again

Semantics intentionally mirrored from segyio:
  - ``f.samples`` is ``t0 + arange(ns) * dt_us / 1000.0`` (ms) with
    ``t0`` the FIRST trace's DelayRecordingTime and ``dt_us`` from
    ``tools.dt`` (binary Interval, else first-trace interval, else the
    4000 µs fallback);
  - ``attributes(field)[:]`` returns int32;
  - header/bin/trace assignment accepts both this module's objects and
    plain arrays/dicts;
  - mode ``'r'`` never writes; ``'r+'`` and ``create`` rewrite the file
    on close (the codec is whole-file, not byte-patching — equivalent
    result, simpler invariants).

Constants carry the real segyio values (1-based start bytes), so code
mixing enum members with raw byte offsets (e.g. ``--byte_delay 109``,
delrt_correction_segy.py:45) behaves identically.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from . import segy as _segy

# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


class _FieldConsts:
    """Namespace of field -> start-byte constants (segyio enum values)."""

    def __init__(self, mapping):
        for name, (off, _dt) in mapping.items():
            setattr(self, name, off)


TraceField = _FieldConsts(_segy.TRACE_HEADER_FIELDS)
BinField = _FieldConsts({k: (v[0], v[1])
                         for k, v in _segy.BINARY_HEADER_FIELDS.items()})

# byte offset -> struct dtype maps
_TR_OFF2DT = {off: dt for off, dt in _segy.TRACE_HEADER_FIELDS.values()}
_BIN_OFF2DT = {off: dt for off, dt in _segy.BINARY_HEADER_FIELDS.values()}

tracefield = types.SimpleNamespace(
    keys={name: off for name, (off, _dt) in _segy.TRACE_HEADER_FIELDS.items()}
)
binfield = types.SimpleNamespace(
    keys={name: off for name, (off, _dt) in _segy.BINARY_HEADER_FIELDS.items()}
)


def _tr_dtype(off: int) -> str:
    try:
        return _TR_OFF2DT[int(off)]
    except KeyError:
        raise KeyError(f"unknown trace-header byte offset {off}") from None


# ---------------------------------------------------------------------------
# raw-buffer get/set helpers (big-endian scalars inside uint8 rows)
# ---------------------------------------------------------------------------


def _get(buf: np.ndarray, off: int, dt: str) -> int:
    size = int(dt[-1])
    return int(np.ascontiguousarray(
        buf[off - 1:off - 1 + size]).view(">" + dt)[0])


def _set(buf: np.ndarray, off: int, dt: str, value) -> None:
    size = int(dt[-1])
    v = int(value)
    # loud range check, matching io/segy.write_segy's semantics — a bare
    # astype would wrap two's-complement and silently flip signs
    info = np.iinfo(np.dtype(dt))
    if not (info.min <= v <= info.max):
        raise ValueError(
            f"value {v} exceeds the {8 * size}-bit SEG-Y field at byte {off}")
    enc = np.asarray(v).astype(">" + dt)
    buf[off - 1:off - 1 + size] = np.frombuffer(enc.tobytes(), np.uint8)


# ---------------------------------------------------------------------------
# accessor objects
# ---------------------------------------------------------------------------


class _HeaderField:
    """Mutable mapping view of one trace's 240-byte header."""

    def __init__(self, row: np.ndarray, file: "SegyFile | None" = None):
        self._row = row  # uint8 view into the file's header block
        self._file = file

    def __getitem__(self, field) -> int:
        off = int(field)
        return _get(self._row, off, _tr_dtype(off))

    def __setitem__(self, field, value) -> None:
        off = int(field)
        _set(self._row, off, _tr_dtype(off), value)
        if self._file is not None:
            self._file._headers_dirty = True

    def update(self, mapping) -> None:
        for k, v in dict(mapping).items():
            self[k] = v

    def get(self, field, default=None):
        try:
            return self[field]
        except KeyError:
            return default

    def keys(self):
        return tracefield.keys.values()

    def items(self):
        return [(off, self[off]) for off in tracefield.keys.values()]

    def __repr__(self):
        vals = {name: self[off] for name, off in tracefield.keys.items()}
        return repr(vals)


class _HeaderAccessor:
    """``f.header``: sequence of per-trace :class:`_HeaderField` views."""

    def __init__(self, file: "SegyFile"):
        self._file = file

    def __len__(self):
        return self._file.tracecount

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return _HeaderField(self._file._headers[i], self._file)

    def __setitem__(self, i, mapping):
        self[i].update(mapping)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class _RawAccessor:
    def __init__(self, file: "SegyFile"):
        self._file = file

    def __getitem__(self, i):
        return np.array(self._file._data[i], np.float32)


class _TraceAccessor:
    """``f.trace``: per-trace float32 sample access (+ ``.raw``)."""

    def __init__(self, file: "SegyFile"):
        self._file = file
        self.raw = _RawAccessor(file)

    def __len__(self):
        return self._file.tracecount

    def __getitem__(self, i):
        return np.array(self._file._data[i], np.float32)

    def __setitem__(self, i, values):
        self._file._data[i] = np.asarray(values, np.float32)
        self._file._data_dirty = True

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class _BinAccessor:
    """``f.bin``: mutable mapping over the 400-byte binary header."""

    def __init__(self, file: "SegyFile"):
        self._file = file

    def __getitem__(self, field) -> int:
        off = int(field)
        return _get(self._file._bin, off - 3200, _BIN_OFF2DT[off])

    def __setitem__(self, field, value) -> None:
        off = int(field)
        _set(self._file._bin, off - 3200, _BIN_OFF2DT[off], value)
        self._file._bin_dirty = True

    def update(self, mapping) -> None:
        for k, v in dict(mapping).items():
            self[k] = v

    def items(self):
        return [(off, self[off]) for off in binfield.keys.values()]

    def __eq__(self, other):  # value equality, like segyio's Field
        if isinstance(other, _BinAccessor):
            return bool(np.array_equal(self._file._bin, other._file._bin))
        if isinstance(other, dict):
            return all(self[k] == v for k, v in other.items())
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return id(self._file)

    def __repr__(self):
        return repr({name: self[off] for name, off in binfield.keys.items()})


class _TextAccessor:
    """``f.text[0]``: the 3200-byte textual header (bytes in/out)."""

    def __init__(self, file: "SegyFile"):
        self._file = file

    def __getitem__(self, i) -> bytes:
        if i != 0:
            raise IndexError("extended textual headers not supported")
        return bytes(self._file._text)

    def __setitem__(self, i, value) -> None:
        if i != 0:
            raise IndexError("extended textual headers not supported")
        raw = value.encode("ascii") if isinstance(value, str) else bytes(value)
        if len(raw) != _segy.TEXT_SIZE:
            raise ValueError(f"textual header must be {_segy.TEXT_SIZE} bytes")
        self._file._text = np.frombuffer(raw, np.uint8).copy()
        self._file._text_dirty = True


class _Attributes:
    """``f.attributes(field)``: lazy whole-file header column."""

    def __init__(self, file: "SegyFile", field):
        self._file = file
        self._off = int(field)

    def __getitem__(self, i):
        off = self._off
        dt = _tr_dtype(off)
        size = int(dt[-1])
        sub = self._file._headers[:, off - 1:off - 1 + size]
        vals = np.ascontiguousarray(sub).view(">" + dt)[:, 0].astype(np.int32)
        return vals[i]

    def __len__(self):
        return self._file.tracecount


# ---------------------------------------------------------------------------
# the file object
# ---------------------------------------------------------------------------


class Spec:
    """segyio.spec equivalent (tools.metadata return type)."""

    def __init__(self):
        self.iline = 189
        self.xline = 193
        self.samples = None
        self.tracecount = 0
        self.format = 5
        self.sorting = None
        self.ext_headers = 0
        self.endian = "big"


class SegyFile:
    """In-memory segyio-compatible file (see module docstring)."""

    def __init__(self, path: str, mode: str = "r", *, _new_spec=None,
                 **_kwargs):
        self._path = path
        self._mode = mode
        self._closed = False
        self._text_dirty = self._bin_dirty = False
        self._headers_dirty = self._data_dirty = False
        if _new_spec is not None:
            ns = len(_new_spec.samples)
            ntr = int(_new_spec.tracecount)
            self._text = np.full(_segy.TEXT_SIZE, 0x20, np.uint8)
            self._ext = np.zeros(0, np.uint8)
            self._bin = np.zeros(_segy.BIN_SIZE, np.uint8)
            self._headers = np.zeros((ntr, _segy.TRACE_HEADER_SIZE), np.uint8)
            self._data = np.zeros((ntr, ns), np.float32)
            self._format = int(getattr(_new_spec, "format", 5) or 5)
            self.bin[BinField.Samples] = ns
            self.bin[BinField.Format] = self._format
            if ns > 1:
                dt_us = round((_new_spec.samples[1]
                               - _new_spec.samples[0]) * 1000.0)
                self.bin[BinField.Interval] = int(dt_us)
            # a brand-new file must always be written, whatever the flags
            self._text_dirty = self._bin_dirty = True
            self._headers_dirty = self._data_dirty = True
            self._fresh = True
            return
        self._fresh = False
        (self._text, self._ext, self._bin, self._headers, self._data,
         self._format) = self._read_sections(path)

    @staticmethod
    def _read_sections(path: str):
        """Read every file section through the repo codec (extended
        textual stanzas preserved verbatim — dropping them while keeping
        the binary ExtendedHeaders count would shift the trace block)."""
        with _segy.SegyFile(path) as f:
            text = np.frombuffer(f.text_raw, np.uint8).copy() \
                if isinstance(f.text_raw, (bytes, bytearray)) \
                else np.asarray(f.text_raw, np.uint8).copy()
            ext = np.asarray(f._mm[_segy.TEXT_SIZE + _segy.BIN_SIZE:
                                   f._data_start], np.uint8).copy()
            return (text, ext, f.binary_header_raw().astype(np.uint8),
                    f.trace_headers_raw().copy(),
                    f.trace_data().astype(np.float32), f.format)

    # -- segyio surface --
    @property
    def tracecount(self) -> int:
        return self._headers.shape[0]

    @property
    def samples(self) -> np.ndarray:
        ns = self._data.shape[1]
        t0 = (_HeaderField(self._headers[0])[TraceField.DelayRecordingTime]
              if self.tracecount else 0)
        return np.arange(ns, dtype=np.float64) * (dt(self) / 1000.0) + t0

    @property
    def format(self) -> int:
        return self._format

    @property
    def sorting(self):
        return None

    @property
    def ext_headers(self) -> int:
        return int(self._ext.size) // _segy.TEXT_SIZE

    @property
    def header(self) -> _HeaderAccessor:
        return _HeaderAccessor(self)

    @header.setter
    def header(self, value) -> None:
        self._headers_dirty = True
        if isinstance(value, _HeaderAccessor):
            src = value._file._headers
            n = min(len(src), len(self._headers))
            self._headers[:n] = src[:n]
            return
        for i, mapping in enumerate(value):
            if isinstance(mapping, _HeaderField):
                self._headers[i] = mapping._row
            else:
                self.header[i].update(mapping)

    @property
    def trace(self) -> _TraceAccessor:
        return _TraceAccessor(self)

    @trace.setter
    def trace(self, values) -> None:
        arr = np.asarray(values, np.float32)
        if arr.shape != self._data.shape:
            raise ValueError(
                f"trace block shape {arr.shape} != file {self._data.shape}")
        self._data = arr.copy()
        self._data_dirty = True

    @property
    def bin(self) -> _BinAccessor:
        return _BinAccessor(self)

    @bin.setter
    def bin(self, value) -> None:
        self._bin_dirty = True
        if isinstance(value, _BinAccessor):
            self._bin = value._file._bin.copy()
        else:
            self.bin.update(value)

    @property
    def text(self) -> _TextAccessor:
        return _TextAccessor(self)

    def attributes(self, field) -> _Attributes:
        return _Attributes(self, field)

    def mmap(self) -> bool:  # segyio API compat; everything is in memory
        return False

    def flush(self) -> None:
        if self._mode != "r":
            self._write()

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._closed = True

    def __enter__(self) -> "SegyFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- write-back --
    def _write(self) -> None:
        import os

        # The codec is whole-file, not byte-patching, so a close() from a
        # stale in-memory snapshot would clobber writes other handles made
        # while this one was open (the reference's static wrapper updates
        # the textual header through a SECOND handle inside its own 'r+'
        # block, static_correction_segy.py:473-481). Merge: re-read the
        # file and keep every section this handle did NOT modify.
        text, ext, binh, headers, data = (self._text, self._ext, self._bin,
                                          self._headers, self._data)
        if not self._fresh and os.path.isfile(self._path):
            try:
                f_text, f_ext, f_bin, f_headers, f_data, _fmt = \
                    self._read_sections(self._path)
            except Exception:
                f_headers = f_data = None  # unreadable: write our snapshot
            else:
                if not self._text_dirty:
                    text = f_text
                ext = f_ext  # never modified through this API
                if not self._bin_dirty:
                    binh = f_bin
                if (not self._headers_dirty
                        and f_headers.shape == headers.shape):
                    headers = f_headers
                if not self._data_dirty and f_data.shape == data.shape:
                    data = f_data
        ntr, ns = data.shape
        enc = _segy._encode_samples(data, self._format)
        sample_bytes = enc.reshape(ntr, -1)
        head = _segy.TEXT_SIZE + _segy.BIN_SIZE + ext.size
        out = np.empty(head + ntr * (_segy.TRACE_HEADER_SIZE
                                     + sample_bytes.shape[1]), np.uint8)
        out[:_segy.TEXT_SIZE] = text
        out[_segy.TEXT_SIZE:_segy.TEXT_SIZE + _segy.BIN_SIZE] = binh
        out[_segy.TEXT_SIZE + _segy.BIN_SIZE:head] = ext
        body = out[head:].reshape(ntr, -1)
        body[:, :_segy.TRACE_HEADER_SIZE] = headers
        body[:, _segy.TRACE_HEADER_SIZE:] = sample_bytes
        out.tofile(self._path)


# ---------------------------------------------------------------------------
# module-level segyio API
# ---------------------------------------------------------------------------


def open(path, mode: str = "r", **kwargs) -> SegyFile:  # noqa: A001
    """segyio.open equivalent (``strict``/``ignore_geometry`` accepted and
    ignored — geometry inference never fails here)."""
    return SegyFile(str(path), mode, **kwargs)


def create(path, spec: Spec) -> SegyFile:
    """segyio.create equivalent: zero-initialized file sized by ``spec``,
    written on close."""
    return SegyFile(str(path), "w", _new_spec=spec)


def dt(f: SegyFile, fallback_dt: float = 4000.0) -> float:
    """Sample interval in MICROseconds (binary Interval, else the first
    trace's interval, else ``fallback_dt``) — segyio.tools.dt."""
    v = f.bin[BinField.Interval]
    if v > 0:
        return float(v)
    if f.tracecount:
        v = f.header[0][TraceField.TRACE_SAMPLE_INTERVAL]
        if v > 0:
            return float(v)
    return float(fallback_dt)


def metadata(f: SegyFile) -> Spec:
    """segyio.tools.metadata equivalent."""
    spec = Spec()
    spec.samples = f.samples
    spec.tracecount = f.tracecount
    spec.format = f.format
    spec.sorting = f.sorting
    spec.ext_headers = f.ext_headers
    return spec


tools = types.SimpleNamespace(dt=dt, metadata=metadata)


def install(force: bool = False) -> types.ModuleType:
    """Register this module as ``sys.modules['segyio']`` so segyio-based
    code (e.g. the reference workflow scripts) imports it transparently.
    Refuses to shadow a real segyio installation unless ``force``."""
    existing = sys.modules.get("segyio")
    if existing is not None and not force:
        if getattr(existing, "__p3d_shim__", False):
            return existing
        raise RuntimeError("a real segyio module is already imported; "
                           "pass force=True to shadow it")
    mod = sys.modules[__name__]
    mod.__p3d_shim__ = True
    sys.modules["segyio"] = mod
    return mod


def uninstall() -> None:
    """Remove the ``segyio`` alias if it points at this module."""
    if getattr(sys.modules.get("segyio"), "__p3d_shim__", False):
        del sys.modules["segyio"]
