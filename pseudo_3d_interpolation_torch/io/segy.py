"""SEG-Y rev0/rev1 codec: memory-mapped, fully vectorized numpy.

Counterpart of ``pseudo_3d_interpolation_tpu/io/segy.py``, on the host:
the files the two packages write are byte-identical, and each reads the
other's. It replaces the segyio (C) dependency used throughout the
reference's stage-1 scripts. Reads are vectorized over all traces (one
strided view per header field instead of per-trace Python loops), the file
is memory-mapped so header scrapes touch only the bytes they need, and
trace data lands directly in float32 blocks ready for device upload.
Full-file sample reads use the native C++/OpenMP decoder (``io/native``:
the package's copy of ``native/segy_core.cpp``, built with g++ at first
use) as the JAX package does; partial reads, and a machine without a C++
compiler, decode with numpy, bit for bit the same.
pandas is imported only by :meth:`SegyFile.headers_dataframe`.

Supported sample formats: 1 (IBM float), 2 (int32), 3 (int16), 5 (IEEE
float32), 8 (int8). Byte order: big-endian (the SEG-Y standard).
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

# ---------------------------------------------------------------------------
# standard header field maps (byte positions are 1-based per the SEG-Y spec)
# ---------------------------------------------------------------------------
TEXT_SIZE = 3200
BIN_SIZE = 400
TRACE_HEADER_SIZE = 240

BINARY_HEADER_FIELDS = {
    "JobID": (3201, "i4"),
    "LineNumber": (3205, "i4"),
    "ReelNumber": (3209, "i4"),
    "Traces": (3213, "i2"),
    "AuxTraces": (3215, "i2"),
    "Interval": (3217, "i2"),  # sample interval, µs
    "IntervalOriginal": (3219, "i2"),
    "Samples": (3221, "i2"),
    "SamplesOriginal": (3223, "i2"),
    "Format": (3225, "i2"),
    "EnsembleFold": (3227, "i2"),
    "SortingCode": (3229, "i2"),
    "VerticalSum": (3231, "i2"),
    "MeasurementSystem": (3255, "i2"),
    "ImpulseSignalPolarity": (3257, "i2"),
    "SEGYRevision": (3501, "i2"),
    "TraceFlag": (3503, "i2"),
    "ExtendedHeaders": (3505, "i2"),
}

TRACE_HEADER_FIELDS = {
    "TRACE_SEQUENCE_LINE": (1, "i4"),
    "TRACE_SEQUENCE_FILE": (5, "i4"),
    "FieldRecord": (9, "i4"),
    "TraceNumber": (13, "i4"),
    "EnergySourcePoint": (17, "i4"),
    "CDP": (21, "i4"),
    "CDP_TRACE": (25, "i4"),
    "TraceIdentificationCode": (29, "i2"),
    "NSummedTraces": (31, "i2"),
    "NStackedTraces": (33, "i2"),
    "DataUse": (35, "i2"),
    "offset": (37, "i4"),
    "ReceiverGroupElevation": (41, "i4"),
    "SourceSurfaceElevation": (45, "i4"),
    "SourceDepth": (49, "i4"),
    "ReceiverDatumElevation": (53, "i4"),
    "SourceDatumElevation": (57, "i4"),
    "SourceWaterDepth": (61, "i4"),
    "GroupWaterDepth": (65, "i4"),
    "ElevationScalar": (69, "i2"),
    "SourceGroupScalar": (71, "i2"),
    "SourceX": (73, "i4"),
    "SourceY": (77, "i4"),
    "GroupX": (81, "i4"),
    "GroupY": (85, "i4"),
    "CoordinateUnits": (89, "i2"),
    "WeatheringVelocity": (91, "i2"),
    "SubWeatheringVelocity": (93, "i2"),
    "SourceUpholeTime": (95, "i2"),
    "GroupUpholeTime": (97, "i2"),
    "SourceStaticCorrection": (99, "i2"),
    "GroupStaticCorrection": (101, "i2"),
    "TotalStaticApplied": (103, "i2"),
    "LagTimeA": (105, "i2"),
    "LagTimeB": (107, "i2"),
    "DelayRecordingTime": (109, "i2"),
    "MuteTimeStart": (111, "i2"),
    "MuteTimeEND": (113, "i2"),
    "TRACE_SAMPLE_COUNT": (115, "i2"),
    "TRACE_SAMPLE_INTERVAL": (117, "i2"),
    "GainType": (119, "i2"),
    "InstrumentGainConstant": (121, "i2"),
    "InstrumentInitialGain": (123, "i2"),
    "Correlated": (125, "i2"),
    "SweepFrequencyStart": (127, "i2"),
    "SweepFrequencyEnd": (129, "i2"),
    "YearDataRecorded": (157, "i2"),
    "DayOfYear": (159, "i2"),
    "HourOfDay": (161, "i2"),
    "MinuteOfHour": (163, "i2"),
    "SecondOfMinute": (165, "i2"),
    "TimeBaseCode": (167, "i2"),
    "TraceWeightingFactor": (169, "i2"),
    "GeophoneGroupNumberRoll1": (171, "i2"),
    "CDP_X": (181, "i4"),
    "CDP_Y": (185, "i4"),
    "INLINE_3D": (189, "i4"),
    "CROSSLINE_3D": (193, "i4"),
    "ShotPoint": (197, "i4"),
    "ShotPointScalar": (201, "i2"),
    "TraceValueMeasurementUnit": (203, "i2"),
    # rev-1 unassigned area; the reference parks a custom static scalar and
    # the picked seafloor TWT here (static_correction_segy.py:505-536)
    "UnassignedInt1": (233, "i4"),
    "UnassignedInt2": (237, "i4"),
}

_FORMAT_INFO = {1: 4, 2: 4, 3: 2, 5: 4, 8: 1}


# ---------------------------------------------------------------------------
# IBM 360 float <-> IEEE 754, vectorized
# ---------------------------------------------------------------------------
def ibm2ieee(u: np.ndarray) -> np.ndarray:
    """uint32 big-endian-decoded IBM floats -> float32 (vectorized)."""
    u = np.asarray(u, np.uint32)
    sign = np.where(u >> 31, -1.0, 1.0).astype(np.float64)
    exponent = ((u >> 24) & 0x7F).astype(np.int64) - 64
    mantissa = (u & 0x00FFFFFF).astype(np.float64) / float(1 << 24)
    out = sign * mantissa * np.power(16.0, exponent)
    return out.astype(np.float32)


def ieee2ibm(x: np.ndarray) -> np.ndarray:
    """float32 -> uint32 IBM float bit patterns (vectorized)."""
    x = np.asarray(x, np.float64)
    sign = (x < 0).astype(np.uint32) << 31
    ax = np.abs(x)
    isinf = np.isinf(ax)
    nonzero = (ax > 0) & np.isfinite(ax)  # NaN encodes to zero
    exp16 = np.zeros(x.shape, np.int64)
    # exponent: smallest e with ax <= 16^e, mantissa in [1/16, 1)
    with np.errstate(divide="ignore"):
        exp16[nonzero] = np.floor(np.log2(ax[nonzero]) / 4.0).astype(np.int64) + 1
    mant = np.zeros(x.shape, np.float64)
    mant[nonzero] = ax[nonzero] / np.power(16.0, exp16[nonzero])
    # fix boundary cases from log rounding
    hi = mant >= 1.0
    mant[hi] /= 16.0
    exp16[hi] += 1
    lo = nonzero & (mant < 1.0 / 16.0)
    mant[lo] *= 16.0
    exp16[lo] -= 1
    m24 = np.rint(mant * (1 << 24)).astype(np.uint64)
    carry = m24 >= (1 << 24)
    m24[carry] >>= 4
    exp16[carry] += 1
    biased = exp16 + 64
    # saturate out-of-range magnitudes: overflow -> IBM max (exp=127,
    # mantissa all ones), underflow -> flush to zero
    over = (nonzero & (biased > 127)) | isinf
    under = nonzero & (biased < 0)
    exp = np.clip(biased, 0, 127).astype(np.uint32)
    exp[over] = 127
    m24u = m24.astype(np.uint32) & 0x00FFFFFF
    m24u[over] = 0x00FFFFFF
    out = sign | (np.where(nonzero | over, exp, 0).astype(np.uint32) << 24) | m24u
    out[under] = 0
    return out


def _decode_samples(raw: np.ndarray, fmt: int) -> np.ndarray:
    """(ntraces, ns*bytes) uint8 -> float32 samples."""
    if fmt == 1:
        u = raw.reshape(raw.shape[0], -1, 4)
        u32 = (
            (u[..., 0].astype(np.uint32) << 24)
            | (u[..., 1].astype(np.uint32) << 16)
            | (u[..., 2].astype(np.uint32) << 8)
            | u[..., 3].astype(np.uint32)
        )
        return ibm2ieee(u32)
    dtype = {2: ">i4", 3: ">i2", 5: ">f4", 8: "i1"}[fmt]
    return np.ascontiguousarray(raw).view(dtype).astype(np.float32)


# 16-bit trace-header fields with rev2 UNSIGNED semantics (counts and
# intervals can exceed 32767 on long sub-bottom records); every other i2
# field is signed two's complement
_UNSIGNED16_TRACE_FIELDS = frozenset(
    {"TRACE_SAMPLE_COUNT", "TRACE_SAMPLE_INTERVAL"})
# binary-header fields with the same rev2 unsigned semantics (the reader
# normalizes these back with & 0xFFFF on open)
_UNSIGNED16_BIN_FIELDS = frozenset(
    {"Samples", "SamplesOriginal", "Interval", "IntervalOriginal"})


def _encode_samples(data: np.ndarray, fmt: int) -> np.ndarray:
    if fmt == 1:
        u32 = ieee2ibm(data)
        return u32.astype(">u4").view(np.uint8).reshape(data.shape[0], -1)
    dtype = {2: ">i4", 3: ">i2", 5: ">f4", 8: "i1"}[fmt]
    if fmt == 5:
        enc = data.astype(dtype)
    else:
        # saturate out-of-range samples at the integer format's limits —
        # the same semantics as the IBM encoder's overflow clamp; a silent
        # two's-complement wrap would flip amplitude signs. NaN encodes to
        # zero like the IBM path (np.clip passes NaN through and the
        # float->int cast of NaN is undefined — a full-scale spike)
        info = np.iinfo(np.dtype(dtype))
        # clip in float64: float32 cannot represent 2^31-1 exactly (it
        # rounds UP to 2^31), so an f32 clip of a large value would
        # overflow the int32 cast into an INT_MIN wrap — the exact failure
        # the clamp exists to prevent
        clean = np.where(np.isnan(data), 0.0, np.asarray(data, np.float64))
        enc = np.clip(np.rint(clean), info.min, info.max).astype(dtype)
    return enc.view(np.uint8).reshape(data.shape[0], -1)


class SegyFile:
    """Memory-mapped SEG-Y reader with vectorized header/data access.

    Usage::

        with SegyFile(path) as f:
            delrt = f.header("DelayRecordingTime")     # (ntraces,) int
            df    = f.headers_dataframe(["SourceX", "SourceY"])
            data  = f.trace_data()                     # (ntraces, ns) f32
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        if self._mm.size < TEXT_SIZE + BIN_SIZE:
            raise ValueError(f"{path}: too small to be a SEG-Y file")
        self.text_raw = bytes(self._mm[:TEXT_SIZE])
        self.bin = {
            name: int(self._read_scalar(off - 1, dt))
            for name, (off, dt) in BINARY_HEADER_FIELDS.items()
        }
        self.format = self.bin["Format"] or 5
        if self.format not in _FORMAT_INFO:
            raise ValueError(f"{path}: unsupported sample format {self.format}")
        # i2 fields storing 32768..65535 read back negative; normalize
        # (rev2 unsigned semantics, e.g. long sub-bottom records)
        for f16 in ("Samples", "SamplesOriginal", "Interval",
                    "IntervalOriginal"):
            if self.bin.get(f16, 0) < 0:
                self.bin[f16] &= 0xFFFF
        self.n_samples = self.bin["Samples"]
        self.dt_us = self.bin["Interval"]
        n_ext = self.bin.get("ExtendedHeaders", 0)
        if n_ext == -1:
            # rev1 'variable count': 3200-byte stanzas terminated by an
            # EndText stanza — scan instead of clamping (a clamp would
            # misplace data_start and decode garbage traces)
            n_ext = 0
            pos = TEXT_SIZE + BIN_SIZE
            # stanzas may be ASCII or EBCDIC (decode_textual_header
            # auto-detects both) — match the terminator in either encoding
            terminators = (b"SEG: EndText",
                           "SEG: EndText".encode("cp037"))
            while pos + TEXT_SIZE <= self._mm.size:
                stanza = bytes(self._mm[pos : pos + TEXT_SIZE])
                n_ext += 1
                pos += TEXT_SIZE
                if any(t in stanza for t in terminators):
                    break
            else:
                raise ValueError(
                    f"{path}: ExtendedHeaders=-1 but no 'SEG: EndText' "
                    "stanza found")
        n_ext = max(n_ext, 0)
        self._data_start = TEXT_SIZE + BIN_SIZE + n_ext * TEXT_SIZE
        self._sample_bytes = _FORMAT_INFO[self.format]
        self.trace_size = TRACE_HEADER_SIZE + self.n_samples * self._sample_bytes
        body = self._mm.size - self._data_start
        if self.n_samples <= 0 or self.trace_size <= TRACE_HEADER_SIZE:
            raise ValueError(f"{path}: invalid Samples={self.n_samples}")
        self.n_traces = body // self.trace_size
        self._traces_u8 = self._mm[
            self._data_start : self._data_start + self.n_traces * self.trace_size
        ].reshape(self.n_traces, self.trace_size)

    # -- context manager --
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        self._mm = None
        self._traces_u8 = None

    def _read_scalar(self, off: int, dtype: str) -> int:
        size = int(dtype[-1])
        return int(np.frombuffer(bytes(self._mm[off : off + size]), dtype=">" + dtype)[0])

    # -- textual header --
    @property
    def text(self) -> str:
        from .textual import decode_textual_header

        return decode_textual_header(self.text_raw)

    # -- trace headers --
    def header(self, field, traces: Iterable[int] | None = None) -> np.ndarray:
        """Vectorized trace-header column. ``field`` is a name from
        TRACE_HEADER_FIELDS, a 1-based byte offset (4-byte width assumed),
        or an ``(offset, dtype)`` pair like ``(109, 'i2')`` for fields at
        non-standard bytes (reference --byte_delay,
        delrt_correction_segy.py:45-46)."""
        if isinstance(field, str):
            off, dt = TRACE_HEADER_FIELDS[field]
        elif isinstance(field, tuple):
            off, dt = int(field[0]), str(field[1])
        else:
            off, dt = int(field), "i4"
        size = int(dt[-1])
        sub = self._traces_u8[:, off - 1 : off - 1 + size]
        vals = np.ascontiguousarray(sub).view(">" + dt)[:, 0].astype(np.int64)
        if size == 2 and field in _UNSIGNED16_TRACE_FIELDS:
            # rev2 unsigned semantics for counts/intervals (long sub-bottom
            # records) — mirrors the binary-header normalization above
            vals = vals & 0xFFFF
        if traces is not None:
            vals = vals[np.asarray(list(traces))]
        return vals

    def headers_dataframe(self, fields: Iterable[str] | None = None):
        """Header scrape -> pandas DataFrame (the segysak
        ``segy_header_scrape`` equivalent used by
        cube_binning_3D.py:561-711)."""
        import pandas as pd

        fields = list(fields) if fields is not None else list(TRACE_HEADER_FIELDS)
        return pd.DataFrame({f: self.header(f) for f in fields})

    # -- trace data --
    def trace_data(self, traces=None) -> np.ndarray:
        """Decoded samples as float32 (ntraces, ns), of every trace or of
        the ``traces`` given.

        Full-file reads use the native C++/OpenMP decoder when it builds
        (``io/native``); otherwise, and for partial reads, the vectorized
        numpy path."""
        if traces is None:
            from . import native

            cdll = native.lib()
            if cdll is not None:
                out = np.empty((self.n_traces, self.n_samples), np.float32)
                rc = cdll.decode_traces(
                    self._traces_u8.ctypes.data + TRACE_HEADER_SIZE,
                    self.trace_size,
                    self.n_traces,
                    self.n_samples,
                    self.format,
                    out.ctypes.data,
                )
                if rc == 0:
                    return out
        raw = self._traces_u8[:, TRACE_HEADER_SIZE:]
        if traces is not None:
            raw = raw[np.asarray(traces)]
        return _decode_samples(np.asarray(raw), self.format)

    def trace_headers_raw(self, traces=None) -> np.ndarray:
        raw = self._traces_u8[:, :TRACE_HEADER_SIZE]
        if traces is not None:
            raw = raw[np.asarray(traces)]
        return np.asarray(raw)

    def binary_header_raw(self) -> np.ndarray:
        """The 400 raw binary-header bytes — pass to ``write_segy``'s
        ``raw_binary_header`` so unmanaged fields survive a rewrite."""
        return np.asarray(self._mm[TEXT_SIZE : TEXT_SIZE + BIN_SIZE]).copy()


def write_segy(
    path: str,
    data: np.ndarray,
    headers: dict | None = None,
    bin_updates: dict | None = None,
    text: str | bytes | None = None,
    fmt: int = 5,
    dt_us: int | None = None,
    raw_trace_headers: np.ndarray | None = None,
    raw_binary_header: np.ndarray | bytes | None = None,
):
    """Write a SEG-Y file.

    Parameters
    ----------
    data : (ntraces, nsamples) float32
    headers : {field_name: scalar or (ntraces,) array} trace-header values
        (applied on top of ``raw_trace_headers`` if given, else zeros)
    bin_updates : binary-header overrides by field name
    text : 3200-char textual header (str padded / bytes verbatim)
    fmt : sample format (5 = IEEE float default, 1 = IBM float)
    dt_us : sample interval in µs (required unless in bin_updates)
    """
    from .textual import encode_textual_header

    data = np.ascontiguousarray(np.asarray(data, np.float32))
    ntr, ns = data.shape

    if text is None:
        text_raw = encode_textual_header("")
    elif isinstance(text, bytes):
        text_raw = text.ljust(TEXT_SIZE)[:TEXT_SIZE]
    else:
        text_raw = encode_textual_header(text)

    if raw_binary_header is not None:
        # start from the source's binary header (400 bytes) so fields this
        # writer does not manage (MeasurementSystem, job/line numbers,
        # EnsembleFold, ...) survive a processing rewrite; the _set_bin
        # calls below still overwrite everything that must reflect the
        # data actually written
        bin_raw = np.frombuffer(bytes(raw_binary_header), np.uint8).copy()
        if bin_raw.size != BIN_SIZE:
            raise ValueError(
                f"raw_binary_header must be {BIN_SIZE} bytes, got {bin_raw.size}")
    else:
        bin_raw = np.zeros(BIN_SIZE, np.uint8)

    def _set_bin(name, value):
        off, dt = BINARY_HEADER_FIELDS[name]
        size = int(dt[-1])
        v = int(value)
        if size == 2:
            # mirror the reader's semantics field by field: the count/
            # interval fields carry rev2 UNSIGNED values (reader
            # normalizes them back via & 0xFFFF), every other i2 field is
            # signed two's complement — e.g. ExtendedHeaders=-1 is the
            # legal rev1 'variable count' the reader itself supports,
            # while EnsembleFold=40000 would read back as -25536
            if name in _UNSIGNED16_BIN_FIELDS:
                lo, hi = 0, 65535
            else:
                lo, hi = -32768, 32767
            if not lo <= v <= hi:
                raise ValueError(f"binary header {name}={value} exceeds the "
                                 f"16-bit SEG-Y field range ([{lo}, {hi}])")
            enc = np.array([v & 0xFFFF], ">u2")
        else:
            info = np.iinfo(np.int32)
            if not info.min <= v <= info.max:
                raise ValueError(f"binary header {name}={value} exceeds the "
                                 "32-bit SEG-Y field range")
            enc = np.array([v]).astype(">" + dt)
        bin_raw[off - 3201 : off - 3201 + size] = np.frombuffer(enc.tobytes(), np.uint8)

    _set_bin("Samples", ns)
    _set_bin("SamplesOriginal", ns)
    _set_bin("Format", fmt)
    if dt_us is not None:
        _set_bin("Interval", dt_us)
        _set_bin("IntervalOriginal", dt_us)
    _set_bin("SEGYRevision", 256)  # rev 1.0
    _set_bin("TraceFlag", 1)
    # this writer emits no extended textual stanzas: a preserved source
    # count would make readers skip into the trace data
    _set_bin("ExtendedHeaders", 0)
    for name, value in (bin_updates or {}).items():
        _set_bin(name, value)
    # a preserved raw_binary_header keeps the source's Interval field (only
    # Samples/Format/Revision/TraceFlag/ExtendedHeaders are overwritten
    # above), so read the field actually being written rather than warning
    # on the argument list alone
    off, _ = BINARY_HEADER_FIELDS["Interval"]
    preserved_dt = int(np.frombuffer(
        bin_raw[off - 3201 : off - 3199].tobytes(), ">u2")[0])
    if (dt_us is None and "Interval" not in (bin_updates or {})
            and preserved_dt == 0
            and raw_trace_headers is None
            and "TRACE_SAMPLE_INTERVAL" not in (headers or {})):
        import warnings

        warnings.warn(
            f"write_segy({os.path.basename(path)}): no sample interval "
            "given (dt_us / bin_updates['Interval'] / "
            "TRACE_SAMPLE_INTERVAL) — readers will see dt_us == 0",
            stacklevel=2)

    if raw_trace_headers is not None:
        th = np.ascontiguousarray(raw_trace_headers, np.uint8).copy()
        if th.shape != (ntr, TRACE_HEADER_SIZE):
            raise ValueError("raw_trace_headers must be (ntraces, 240) uint8")
    else:
        th = np.zeros((ntr, TRACE_HEADER_SIZE), np.uint8)

    hdrs = dict(headers or {})
    if raw_trace_headers is None:
        # fresh headers get sensible defaults; preserved headers are kept
        # verbatim (no silent trace renumbering on rewrites)
        hdrs.setdefault("TRACE_SAMPLE_COUNT", ns)
        if dt_us is not None:
            hdrs.setdefault("TRACE_SAMPLE_INTERVAL", dt_us)
        hdrs.setdefault("TRACE_SEQUENCE_FILE", np.arange(1, ntr + 1))
    for name, value in hdrs.items():
        if isinstance(name, str):
            off, dt = TRACE_HEADER_FIELDS[name]
        elif isinstance(name, tuple):
            # (offset, dtype) spec, mirroring SegyFile.header — used by the
            # --byte-delay steps to write a delay field at a custom byte
            off, dt = int(name[0]), str(name[1])
        else:
            off, dt = int(name), "i4"
        size = int(dt[-1])
        vals = np.broadcast_to(np.asarray(value), (ntr,))
        if size == 2:
            # i2 fields: signed range natively; the unsigned bit pattern
            # 32768..65535 is permitted ONLY for the rev2 unsigned-semantics
            # count/interval fields the reader normalizes back — a signed
            # field (e.g. DelayRecordingTime) written as 40000 would read
            # back -25536, so fail loudly instead
            vmin, vmax = int(np.min(vals)), int(np.max(vals))
            if name in _UNSIGNED16_TRACE_FIELDS:
                # unsigned semantics: a negative value would silently
                # round-trip to a huge positive count/interval through the
                # reader's & 0xFFFF normalization
                lo, hi = 0, 65535
            else:
                lo, hi = -32768, 32767
            if vmin < lo or vmax > hi:
                raise ValueError(
                    f"trace header {name}: value range [{vmin}, {vmax}] "
                    f"exceeds the 16-bit SEG-Y field ([{lo}, {hi}])"
                )
            col = (vals.astype(np.int64) & 0xFFFF).astype(">u2")
        else:
            # 32-bit fields get the same loud range check the 16-bit ones
            # do — a silent modulo-2^32 wrap corrupts navigation
            vmin, vmax = int(np.min(vals)), int(np.max(vals))
            info32 = np.iinfo(np.int32)
            if vmin < info32.min or vmax > info32.max:
                raise ValueError(
                    f"trace header {name}: value range [{vmin}, {vmax}] "
                    "exceeds the 32-bit SEG-Y field")
            col = vals.astype(">" + dt)
        th[:, off - 1 : off - 1 + size] = col.view(np.uint8).reshape(ntr, size)

    samples = _encode_samples(data, fmt)
    body = np.concatenate([th, samples], axis=1)

    with open(path, "wb") as f:
        f.write(text_raw)
        f.write(bin_raw.tobytes())
        f.write(body.tobytes())


