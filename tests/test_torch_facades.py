"""The port's reference-parity facades against the JAX package's:
``io/segyio_compat.py`` (segyio's surface over the SEG-Y codec) and
``utils/pyproj_compat.py`` (pyproj's over the CRS engine).

The same calls run through both packages' facades on the same files and
CRS strings: values read back, files written (byte for byte), and the
coordinates transformed (bit for bit). ``install()`` registers
``sys.modules['segyio']`` / ``['pyproj']``; every test that installs runs
under a fixture that puts ``sys.modules`` back as it found it, so nothing
leaks into the worker's later tests."""

import sys

import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.io import segyio_compat as jsio
from pseudo_3d_interpolation_tpu.utils import pyproj_compat as jpp
from pseudo_3d_interpolation_torch.io import segy
from pseudo_3d_interpolation_torch.io import segyio_compat as sio
from pseudo_3d_interpolation_torch.utils import pyproj_compat as pp

from test_tide_crs import WKT1_UTM33N, WKT2_LAEA_EUROPE

NTR, NS, DT_US = 23, 57, 125
CRS_SPECS = [4326, "EPSG:4326", "32631", "EPSG:32633", WKT1_UTM33N,
             WKT2_LAEA_EUROPE,
             "+proj=utm +zone=33 +datum=WGS84 +units=m +no_defs",
             "+proj=laea +lat_0=52 +lon_0=10 +x_0=4321000 +y_0=3210000 "
             "+ellps=GRS80 +units=m +no_defs"]
PAIRS = [("EPSG:4326", "EPSG:32631"), ("EPSG:32631", "EPSG:4326"),
         (WKT1_UTM33N, WKT2_LAEA_EUROPE), ("EPSG:4326", WKT2_LAEA_EUROPE)]


@pytest.fixture
def clean_modules():
    """Put ``sys.modules['segyio']`` and ``['pyproj']`` back as they
    were."""
    saved = {k: sys.modules.get(k) for k in ("segyio", "pyproj")}
    yield
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


def _survey_file(path, fmt=5, seed=0):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(NTR, NS)) * 100).astype(np.float32)
    segy.write_segy(str(path), data, headers={
        "TRACE_SEQUENCE_LINE": np.arange(1, NTR + 1),
        "SourceX": rng.integers(-10**6, 10**6, NTR),
        "SourceY": rng.integers(-10**6, 10**6, NTR),
        "DelayRecordingTime": 15,
        "SourceGroupScalar": -100,
    }, text="C01 facade test", fmt=fmt, dt_us=DT_US)
    return str(path)


def _read_all(mod, path):
    """Everything a reader reaches through the facade's surface."""
    with mod.open(path, ignore_geometry=True) as f:
        out = {
            "tracecount": f.tracecount, "samples": f.samples.copy(),
            "format": f.format, "ext_headers": f.ext_headers,
            "sorting": f.sorting, "mmap": f.mmap(),
            "bin": dict(f.bin.items()), "text": f.text[0],
            "dt": mod.tools.dt(f), "traces": np.stack(list(f.trace)),
            "raw3": f.trace.raw[3],
            "headers": [dict(h.items()) for h in f.header],
            "slice": [dict(h.items()) for h in f.header[2:6]],
        }
        for name in ("SourceX", "SourceY", "DelayRecordingTime",
                     "TRACE_SEQUENCE_LINE"):
            field = getattr(mod.TraceField, name)
            col = f.attributes(field)[:]
            out[name] = (col, col.dtype, f.header[4][field])
        meta = mod.tools.metadata(f)
        out["metadata"] = (meta.iline, meta.xline, meta.samples.copy(),
                           meta.tracecount, meta.format, meta.sorting,
                           meta.ext_headers, meta.endian)
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
            assert va.dtype == vb.dtype, k
        elif isinstance(va, tuple):
            for x, y in zip(va, vb):
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=k)
                else:
                    assert x == y, k
        else:
            assert va == vb, k


def test_constants_and_field_maps_match():
    assert vars(sio.TraceField) == vars(jsio.TraceField)
    assert vars(sio.BinField) == vars(jsio.BinField)
    assert sio.tracefield.keys == jsio.tracefield.keys
    assert sio.binfield.keys == jsio.binfield.keys
    assert sio.TraceField.DelayRecordingTime == 109  # segyio's start byte
    spec, jspec = sio.Spec(), jsio.Spec()
    assert vars(spec) == vars(jspec)


@pytest.mark.parametrize("fmt", [1, 5])
def test_reading_a_file_matches(tmp_path, fmt):
    path = _survey_file(tmp_path / "a.sgy", fmt)
    _equal(_read_all(sio, path), _read_all(jsio, path))


def _edit(mod, path):
    """The edits of the reference's stage-1 scripts: header fields, a
    trace, the whole trace block, the binary header, the text."""
    with mod.open(path, "r+") as f:
        f.header[0][mod.TraceField.DelayRecordingTime] = 30
        f.header[5] = {mod.TraceField.SourceX: 123456,
                       mod.TraceField.SourceY: -654321}
        f.trace[2] = np.linspace(-1, 1, NS, dtype=np.float32)
        f.bin[mod.BinField.JobID] = 77
        f.bin.update({mod.BinField.LineNumber: 9})
        f.text[0] = ("C01 edited by the facade".ljust(3200)).encode("ascii")
        with pytest.raises(ValueError, match="exceeds"):
            f.header[1][mod.TraceField.DelayRecordingTime] = 1 << 20


@pytest.mark.parametrize("fmt", [1, 5])
def test_editing_a_file_writes_the_same_bytes(tmp_path, fmt):
    ours = _survey_file(tmp_path / "ours.sgy", fmt)
    theirs = _survey_file(tmp_path / "theirs.sgy", fmt)
    _edit(sio, ours)
    _edit(jsio, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    _equal(_read_all(sio, ours), _read_all(jsio, theirs))
    # mode 'r' never writes, whatever is assigned
    before = open(ours, "rb").read()
    with sio.open(ours) as f:
        f.trace[0] = np.zeros(NS, np.float32)
    assert open(ours, "rb").read() == before


def test_whole_block_assignment_and_header_copy(tmp_path):
    src = _survey_file(tmp_path / "src.sgy", 5, seed=3)
    outs = []
    for mod, name in ((sio, "ours"), (jsio, "theirs")):
        dst = _survey_file(tmp_path / f"{name}.sgy", 5, seed=4)
        with mod.open(src) as s, mod.open(dst, "r+") as d:
            d.header = s.header
            d.bin = s.bin
            d.trace = np.asarray([t * 2 for t in s.trace])
            with pytest.raises(ValueError, match="trace block shape"):
                d.trace = np.zeros((NTR + 1, NS), np.float32)
        outs.append(open(dst, "rb").read())
    assert outs[0] == outs[1]


def test_create_writes_the_same_file(tmp_path):
    outs = []
    for mod, name in ((sio, "ours"), (jsio, "theirs")):
        spec = mod.Spec()
        spec.samples = np.arange(NS) * (DT_US / 1000.0)
        spec.tracecount = 4
        spec.format = 1
        path = str(tmp_path / f"{name}.sgy")
        with mod.create(path, spec) as f:
            for i in range(4):
                f.header[i] = {mod.TraceField.TRACE_SEQUENCE_LINE: i + 1}
                f.trace[i] = np.full(NS, i - 1.5, np.float32)
        outs.append(open(path, "rb").read())
        assert mod.tools.dt(mod.open(path)) == DT_US
    assert outs[0] == outs[1]


def test_segyio_install_registers_and_uninstalls(clean_modules, tmp_path):
    sys.modules.pop("segyio", None)
    mod = sio.install()
    import segyio

    assert segyio is mod is sio and segyio.__p3d_shim__
    assert sio.install() is sio  # idempotent
    path = _survey_file(tmp_path / "i.sgy")
    with segyio.open(path) as f:
        assert f.tracecount == NTR
    sio.uninstall()
    assert "segyio" not in sys.modules
    sys.modules["segyio"] = object()  # a real segyio is never shadowed
    with pytest.raises(RuntimeError, match="already imported"):
        sio.install()
    assert sio.install(force=True) is sio
    sio.uninstall()


@pytest.mark.parametrize("spec", CRS_SPECS, ids=range(len(CRS_SPECS)))
def test_crs_matches(spec):
    a, b = pp.CRS(spec), jpp.CRS(spec)
    assert (a.is_geographic, a.is_projected, a.to_epsg()) == (
        b.is_geographic, b.is_projected, b.to_epsg())
    assert repr(a) == repr(b) and hash(a) == hash(b)
    assert a == pp.CRS(a) and pp.CRS(a).spec == spec


@pytest.mark.parametrize("src,dst", PAIRS, ids=range(len(PAIRS)))
def test_transformer_matches_bit_for_bit(src, dst):
    rng = np.random.default_rng(5)
    geographic = pp.CRS(src).is_geographic
    if geographic:
        x, y = rng.uniform(0, 6, 50), rng.uniform(45, 60, 50)
    else:
        x, y = rng.uniform(3e5, 7e5, 50), rng.uniform(5.0e6, 6.5e6, 50)
    got = pp.Transformer.from_crs(src, dst, always_xy=True).transform(
        x, y, errcheck=True)
    want = jpp.Transformer.from_crs(src, dst, always_xy=True).transform(
        x, y, errcheck=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the submodule spellings of the reference
    t = pp.transformer.Transformer.from_crs(pp.crs.CRS(src), dst,
                                            always_xy=True)
    np.testing.assert_array_equal(t.transform(x, y)[0], got[0])


def test_transformer_refuses_what_pyproj_would_transpose():
    with pytest.raises(NotImplementedError, match="always_xy"):
        pp.Transformer.from_crs("EPSG:4326", "EPSG:32631")
    t = pp.Transformer.from_crs("EPSG:32631", "EPSG:4326", always_xy=True)
    with pytest.raises(RuntimeError, match="non-finite"):
        t.transform([np.nan], [0.0], errcheck=True)
    x, _ = t.transform([np.nan], [0.0])
    assert not np.isfinite(x).all()


def test_pyproj_install_registers_and_uninstalls(clean_modules):
    sys.modules.pop("pyproj", None)
    pp.install()
    import pyproj

    assert pyproj is pp
    x, y = pyproj.Transformer.from_crs(
        pyproj.CRS("EPSG:4326"), pyproj.crs.CRS(32631),
        always_xy=True).transform(3.0, 52.0)
    want = jpp.Transformer.from_crs("EPSG:4326", 32631,
                                    always_xy=True).transform(3.0, 52.0)
    assert (float(x), float(y)) == (float(want[0]), float(want[1]))
    pp.uninstall()
    assert "pyproj" not in sys.modules
    sys.modules["pyproj"] = object()
    with pytest.raises(RuntimeError, match="already imported"):
        pp.install()
