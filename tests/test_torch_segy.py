"""The port's SEG-Y codec and its host helpers against the JAX package:
``ibm2ieee``/``ieee2ibm`` bit for bit on random bit patterns and on the
edges, ``write_segy`` byte for byte in every sample format (the i2 fields'
unsigned bit patterns, raw header passthrough, binary-header updates),
``SegyFile`` reading equal headers, text, dt, ns and samples from files
written by either package, the textual header and its provenance, the
coordinate scaling, the input-file plumbing, the affine geometry, the CRS
copy and the logger. Everything here is host numpy and held exact."""

import os

import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.io import auxiliary as jaux
from pseudo_3d_interpolation_tpu.io import headers as jhd
from pseudo_3d_interpolation_tpu.io import segy as jsegy
from pseudo_3d_interpolation_tpu.io import textual as jtxt
from pseudo_3d_interpolation_tpu.ops import affine as jaffine
from pseudo_3d_interpolation_tpu.utils import crs as jcrs
from pseudo_3d_interpolation_tpu.utils import logging as jlog
from pseudo_3d_interpolation_torch.io import auxiliary as aux
from pseudo_3d_interpolation_torch.io import headers as hd
from pseudo_3d_interpolation_torch.io import segy
from pseudo_3d_interpolation_torch.io import textual as txt
from pseudo_3d_interpolation_torch.ops import affine
from pseudo_3d_interpolation_torch.utils import crs
from pseudo_3d_interpolation_torch.utils import logging as plog

FORMATS = (1, 2, 3, 5, 8)


def _edges_u32():
    """IBM bit patterns at the edges: zeros of both signs, the smallest
    and largest exponents with the smallest and largest mantissas,
    unnormalized mantissas, and 1.0."""
    pats = []
    for sign in (0, 1):
        for exp in (0, 1, 63, 64, 65, 126, 127):
            for mant in (0, 1, 0x0FFFFF, 0x100000, 0x800000, 0xFFFFFF):
                pats.append((sign << 31) | (exp << 24) | mant)
    return np.array(pats + [0x41100000], np.uint32)


def _edges_f32():
    info = np.finfo(np.float32)
    vals = [0.0, -0.0, 1.0, -1.0, 16.0, 1 / 16.0, info.tiny, -info.tiny,
            info.tiny * 16, info.smallest_subnormal, info.max, -info.max,
            np.inf, -np.inf, np.nan]
    return np.array(vals, np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ibm2ieee_bit_exact_on_random_patterns_and_edges(seed):
    rng = np.random.default_rng(seed)
    u = np.concatenate([rng.integers(0, 2**32, 20000, dtype=np.uint64)
                        .astype(np.uint32), _edges_u32()])
    with np.errstate(over="ignore"):  # IBM's range passes float32's
        got, want = segy.ibm2ieee(u), jsegy.ibm2ieee(u)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_ieee2ibm_bit_exact_on_random_floats_and_edges(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        rng.normal(0, 1e3, 2000).astype(np.float32),
                        _edges_f32()])
    with np.errstate(invalid="ignore", over="ignore"):
        got, want = segy.ieee2ibm(x), jsegy.ieee2ibm(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    finite = np.isfinite(x) & (np.abs(x) > 1e-30)
    with np.errstate(over="ignore"):  # saturated IBM max is past float32's
        back = segy.ibm2ieee(got)
    np.testing.assert_allclose(back[finite], x[finite], rtol=1e-6)


def _payload(fmt, ntr=9, ns=40, seed=3):
    rng = np.random.default_rng(seed)
    scale = {2: 1e5, 3: 1e3, 8: 50.0}.get(fmt, 1.0)
    data = (rng.normal(size=(ntr, ns)) * scale).astype(np.float32)
    data[0, :3] = [np.nan, 1e12, -1e12]  # NaN and saturation
    headers = {
        "FieldRecord": np.arange(1, ntr + 1),
        "SourceX": np.rint(rng.uniform(5e7, 5.1e7, ntr)).astype(np.int64),
        "SourceY": np.rint(rng.uniform(6e8, 6.1e8, ntr)).astype(np.int64),
        "SourceGroupScalar": -100,
        "CoordinateUnits": 1,
        "DelayRecordingTime": rng.integers(-300, 300, ntr),
        "TRACE_SAMPLE_INTERVAL": 40000,  # an i2 field's unsigned pattern
        "NStackedTraces": rng.integers(0, 9, ntr),
        (233, "i4"): np.arange(ntr) * 7,
    }
    return data, headers


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_segy_byte_identical(fmt, tmp_path):
    data, headers = _payload(fmt)
    kw = dict(headers=headers, fmt=fmt, dt_us=40000, text="Survey\nLine 7",
              bin_updates={"SortingCode": 4, "EnsembleFold": 1,
                           "MeasurementSystem": 1})
    with np.errstate(invalid="ignore", over="ignore"):
        jsegy.write_segy(str(tmp_path / "j.sgy"), data, **kw)
        segy.write_segy(str(tmp_path / "p.sgy"), data, **kw)
    assert (tmp_path / "p.sgy").read_bytes() == (tmp_path / "j.sgy").read_bytes()


def test_write_segy_raw_headers_and_bytes_text_byte_identical(tmp_path):
    data, headers = _payload(5)
    jsegy.write_segy(str(tmp_path / "src.sgy"), data, headers=headers,
                     dt_us=250)
    with segy.SegyFile(str(tmp_path / "src.sgy")) as f:
        raw_th, raw_bin = f.trace_headers_raw(), f.binary_header_raw()
    kw = dict(raw_trace_headers=raw_th, raw_binary_header=raw_bin,
              headers={"DelayRecordingTime": 12}, text=b"C01 raw" + b" " * 10,
              fmt=1)
    jsegy.write_segy(str(tmp_path / "j.sgy"), data * 2, **kw)
    segy.write_segy(str(tmp_path / "p.sgy"), data * 2, **kw)
    assert (tmp_path / "p.sgy").read_bytes() == (tmp_path / "j.sgy").read_bytes()


def test_write_segy_refuses_what_the_jax_writer_refuses(tmp_path):
    data = np.zeros((2, 4), np.float32)
    for bad in ({"TRACE_SAMPLE_COUNT": -1}, {"DelayRecordingTime": 40000},
                {"SourceX": 2**31}):
        for mod in (jsegy, segy):
            with pytest.raises(ValueError, match="exceeds"):
                mod.write_segy(str(tmp_path / "x.sgy"), data, headers=bad,
                               dt_us=100)
    with pytest.warns(UserWarning, match="no sample interval"):
        segy.write_segy(str(tmp_path / "x.sgy"), data)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_segyfile_reads_either_package_equal(writer, fmt, tmp_path):
    data, headers = _payload(fmt, seed=4)
    path = str(tmp_path / "f.sgy")
    with np.errstate(invalid="ignore", over="ignore"):
        (jsegy if writer == "jax" else segy).write_segy(
            path, data, headers=headers, fmt=fmt, dt_us=40000,
            text="Survey XYZ")
    with segy.SegyFile(path) as f, jsegy.SegyFile(path) as g:
        assert (f.n_traces, f.n_samples, f.dt_us, f.format) == \
            (g.n_traces, g.n_samples, g.dt_us, g.format)
        assert f.dt_us == 40000 and f.n_samples == 40
        assert f.bin == g.bin and f.text == g.text and f.text_raw == g.text_raw
        for name in segy.TRACE_HEADER_FIELDS:
            np.testing.assert_array_equal(f.header(name), g.header(name))
        np.testing.assert_array_equal(f.header((233, "i4")),
                                      g.header((233, "i4")))
        np.testing.assert_array_equal(f.header(73, traces=[2, 0]),
                                      g.header(73, traces=[2, 0]))
        np.testing.assert_array_equal(f.trace_data(), g.trace_data())
        np.testing.assert_array_equal(f.trace_data([5, 1]),
                                      g.trace_data([5, 1]))
        np.testing.assert_array_equal(f.trace_headers_raw([3]),
                                      g.trace_headers_raw([3]))
        np.testing.assert_array_equal(f.binary_header_raw(),
                                      g.binary_header_raw())
        assert f.headers_dataframe(["SourceX", "CDP"]).equals(
            g.headers_dataframe(["SourceX", "CDP"]))
        assert (f.header("TRACE_SAMPLE_INTERVAL") == 40000).all()


def test_segyfile_extended_stanzas_and_errors(tmp_path):
    path = str(tmp_path / "ext.sgy")
    segy.write_segy(path, np.ones((3, 8), np.float32), dt_us=100)
    raw = bytearray(open(path, "rb").read())
    stanza = txt.encode_textual_header("SEG: EndText")
    raw[3200 + 304:3200 + 306] = (-1).to_bytes(2, "big", signed=True)
    raw[3600:3600] = stanza
    open(path, "wb").write(bytes(raw))
    with segy.SegyFile(path) as f, jsegy.SegyFile(path) as g:
        assert f.n_traces == g.n_traces == 3
        np.testing.assert_array_equal(f.trace_data(), g.trace_data())
    open(path, "wb").write(b"\0" * 100)
    with pytest.raises(ValueError, match="too small"):
        segy.SegyFile(path)


def test_segy_imports_pandas_only_for_the_dataframe():
    import subprocess
    import sys

    code = ("import sys\nsys.modules['pandas'] = None\n"
            "from pseudo_3d_interpolation_torch.io import segy\n"
            "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_textual_header_and_provenance_match_jax():
    for ebcdic in (False, True):
        raw = txt.encode_textual_header("Survey\nLine 1", ebcdic=ebcdic)
        assert raw == jtxt.encode_textual_header("Survey\nLine 1",
                                                 ebcdic=ebcdic)
        assert txt.decode_textual_header(raw) == \
            jtxt.decode_textual_header(raw)
    text = txt.decode_textual_header(txt.encode_textual_header("Survey"))
    got, want = text, text
    for entry, prefix in (("STATIC", "2024-01-15"), ("TIDE", "2024-01-15"),
                          ("DESPIKE", "2024-02-01"), ("MERGE", None)):
        got = txt.add_processing_entry(got, entry, prefix=prefix)
        want = jtxt.add_processing_entry(want, entry, prefix=prefix)
    assert got == want
    assert txt.get_processing_entries(got) == jtxt.get_processing_entries(want)
    assert txt.ensure_workflow_header(text, line=5) == \
        jtxt.ensure_workflow_header(text, line=5)


def test_coordinate_scaling_matches_jax(tmp_path):
    data, headers = _payload(5)
    path = str(tmp_path / "c.sgy")
    segy.write_segy(path, data, headers=headers, dt_us=250)
    with segy.SegyFile(path) as f, jsegy.SegyFile(path) as g:
        for got, want in zip(hd.scale_coordinates(f),
                             jhd.scale_coordinates(g)):
            np.testing.assert_array_equal(got, want)
    x, y = np.array([500000.123, -1.5]), np.array([6e6, 2.25])
    for units, scalar in ((1, -100), (1, 10), (2, -100), (0, 1)):
        if units == 2:  # arc seconds of degrees
            x, y = np.array([9.5, -0.25]), np.array([54.1, 2.25])
        for got, want in zip(hd.unscale_coordinates(x, y, units, scalar),
                             jhd.unscale_coordinates(x, y, units, scalar)):
            np.testing.assert_array_equal(got, want)
    for s in ("auto", -1000, 0, 10):
        assert hd.check_coordinate_scalar(s) == jhd.check_coordinate_scalar(s)
    with pytest.raises(ValueError):
        hd.check_coordinate_scalar(-37)


def test_input_files_match_jax(tmp_path):
    for name in ("b_UTM32_x.sgy", "a_UTM32.segy", "c.txt", "skip.nc"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "list.txt").write_text("a_UTM32.segy\n# note\n\n/abs/x.sgy\n")
    for args in ((str(tmp_path),), (str(tmp_path), "sgy", "a"),
                 (str(tmp_path), "sgy", None, "x"),
                 (str(tmp_path / "list.txt"),),
                 (str(tmp_path / "a_UTM32.segy"),), (["p", "q"],)):
        assert aux.resolve_input_files(*args) == jaux.resolve_input_files(*args)
    with pytest.raises(IOError):
        aux.resolve_input_files(str(tmp_path / "missing"))
    for p in ("/d/L1_UTM32N_x.sgy", "UTM33_line.sgy", "plain.sgy"):
        assert aux.line_name(p) == jaux.line_name(p)
        assert aux.aux_path(p, "nav") == jaux.aux_path(p, ".nav")


def test_affine_and_grid_match_jax():
    a = affine.Affine().rotation(33.0).scaling((2.0, 0.5)).translation(
        (10.0, -5.0))
    ja = jaffine.Affine().rotation(33.0).scaling((2.0, 0.5)).translation(
        (10.0, -5.0))
    np.testing.assert_array_equal(a.matrix, ja.matrix)
    np.testing.assert_array_equal(a.inverse().matrix, ja.inverse().matrix)
    pts = np.random.default_rng(0).normal(size=(20, 2))
    np.testing.assert_array_equal(a.transform(pts), ja.transform(pts))
    for kw in (dict(extent=(0, 100, 0, 50), spacing=10.0),
               dict(extent=(0, 100, 0, 50), spacing=(5.0, 10.0),
                    base_transform=affine.Affine().rotate_around(
                        -30.0, (50.0, 25.0)))):
        jkw = dict(kw)
        if "base_transform" in jkw:
            jkw["base_transform"] = jaffine.Affine().rotate_around(
                -30.0, (50.0, 25.0))
        t, n_il, n_xl = affine.coords_to_ilxl_transform(**kw)
        jt, jn_il, jn_xl = jaffine.coords_to_ilxl_transform(**jkw)
        assert (n_il, n_xl) == (jn_il, jn_xl)
        np.testing.assert_array_equal(t.matrix, jt.matrix)
    np.testing.assert_array_equal(affine.points_from_extent((0, 1, 2, 3)),
                                  jaffine.points_from_extent((0, 1, 2, 3)))


def test_crs_copy_matches_jax():
    lat = np.array([54.1, 54.3, -33.9])
    lon = np.array([9.5, 10.2, 18.4])
    for src, dst in (("EPSG:4326", "EPSG:32632"), ("EPSG:4326", 3857),
                     (4326, "EPSG:32734")):
        got = crs.transform_any(lon, lat, src, dst)
        want = jcrs.transform_any(lon, lat, src, dst)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for spec in ("EPSG:32632", 4326, "+proj=utm +zone=32 +datum=WGS84"):
        assert crs.crs_label(spec) == jcrs.crs_label(spec)
    assert crs.parse_crs(4326) is crs.GEOGRAPHIC
    assert crs.dms_to_dd(54, 30, 36) == jcrs.dms_to_dd(54, 30, 36)


def test_xprint_matches_jax(capsys):
    for mod in (jlog, plog):
        mod.xprint("binned", 3, kind="info", verbosity=1)
        mod.xprint("hidden", kind="debug", verbosity=1)
        mod.xprint("warned", kind="warning", verbosity=0)
    out = capsys.readouterr()
    half = len(out.out) // 2
    assert out.out[:half] == out.out[half:] and "binned 3" in out.out
    assert "hidden" not in out.out + out.err
