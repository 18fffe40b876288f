"""The port's native SEG-Y decoder (``io/native.py`` over its own copy of
``native/segy_core.cpp``) against the numpy path and the JAX package.

Files in formats 1 (IBM float), 2, 3, 5 and 8 hold random bit patterns
and codec-written data; ``SegyFile.trace_data()`` (the full-file read,
which takes the native decoder) must equal the numpy decode of the same
bytes and the JAX package's ``SegyFile.trace_data()`` bit for bit. One
bit pattern decodes differently by design in both packages: an IBM zero
with the sign bit set (0x80000000) is +0.0 natively and −0.0 in numpy;
it is compared by value. Also: ``backends.native_segy_enabled()``, a
build into a temporary build directory keyed by the source, a failed
build keeping the compiler's error, and partial reads on the numpy
path."""

import ctypes
import os
import shutil

import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.io import segy as jsegy
from pseudo_3d_interpolation_torch import backends
from pseudo_3d_interpolation_torch.io import native, segy

FORMATS = (1, 2, 3, 5, 8)
WIDTH = {1: 4, 2: 4, 3: 2, 5: 4, 8: 1}
NTR, NS = 97, 131
IBM_NEG_ZERO = 0x80000000

needs_cxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler to build the decoder")


def _write(path, fmt: int, random_bits: bool, seed: int = 0) -> np.ndarray:
    """A format-``fmt`` file of NTR x NS samples: codec-written values,
    or random bit patterns poked into the sample bytes. Returns the raw
    sample bytes (NTR, NS·width)."""
    rng = np.random.default_rng(seed + fmt)
    scale = {1: 1e3, 2: 1e6, 3: 1e3, 5: 1e3, 8: 30}[fmt]
    data = np.clip(rng.normal(size=(NTR, NS)) * scale, -2e9, 2e9)
    if fmt in (2, 3, 8):
        data = np.clip(np.round(data), *{2: (-2**31, 2**31 - 1),
                                         3: (-2**15, 2**15 - 1),
                                         8: (-128, 127)}[fmt])
    segy.write_segy(str(path), data.astype(np.float32), fmt=fmt, dt_us=250)
    width = WIDTH[fmt]
    if random_bits:
        raw = rng.integers(0, 256, size=(NTR, NS * width), dtype=np.uint8)
        if fmt == 1:  # the edge patterns, IBM's signed zero among them
            edges = np.array([0, IBM_NEG_ZERO, 0x00FFFFFF, 0x7FFFFFFF,
                              0xFFFFFFFF, 0x41100000, 0x00000001],
                             ">u4").view(np.uint8)
            raw[0, :edges.size] = edges
        with open(path, "r+b") as fh:
            for t in range(NTR):
                fh.seek(3600 + t * (240 + NS * width) + 240)
                fh.write(raw[t].tobytes())
    with segy.SegyFile(str(path)) as f:
        return np.asarray(f._traces_u8[:, 240:]).copy()


def _same_bits(got: np.ndarray, want: np.ndarray, raw: np.ndarray,
               fmt: int) -> None:
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (NTR, NS)
    same = got.view(np.uint32) == want.view(np.uint32)
    if fmt == 1:
        u = raw.reshape(NTR, NS, 4).view(">u4")[..., 0]
        signed_zero = u == IBM_NEG_ZERO
        assert np.all(got[signed_zero] == 0) and np.all(want[signed_zero] == 0)
        same |= signed_zero
    assert same.all(), np.argwhere(~same)[:5]


@needs_cxx
def test_native_decoder_is_enabled_and_built_from_the_port_copy():
    assert backends.native_segy_enabled()
    assert backends.native_segy_error() is None
    assert native.openmp() in (True, False)
    summary = backends.summary()
    assert summary["native_segy"] is True
    assert summary["native_segy_error"] is None
    path = native.library_path(flags=native.CXX_FLAGS if native.openmp()
                               else native.SERIAL_FLAGS)
    assert path.parent == native.BUILD_DIR
    assert path.exists()
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "pseudo_3d_interpolation_torch"
    # the port's copy is the JAX package's source below its own header
    repo = native.PACKAGE_DIR.parent
    theirs = (repo / "native" / "segy_core.cpp").read_text()
    ours = native.SOURCE.read_text()
    assert ours[ours.index("#include <cstdint>"):] == \
        theirs[theirs.index("#include <cstdint>"):]


@needs_cxx
@pytest.mark.parametrize("random_bits", [False, True],
                         ids=["codec data", "random bits"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_native_decode_matches_numpy_and_jax(tmp_path, fmt, random_bits):
    path = tmp_path / f"f{fmt}.sgy"
    raw = _write(path, fmt, random_bits)
    assert native.lib() is not None
    with np.errstate(over="ignore", invalid="ignore"):
        with segy.SegyFile(str(path)) as f:
            got = f.trace_data()  # full file: the native decoder
            numpy_path = segy._decode_samples(raw, fmt)
        with jsegy.SegyFile(str(path)) as f:
            jax_got = f.trace_data()
    _same_bits(got, numpy_path, raw, fmt)
    # the JAX package decodes full files natively too
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jax_got.view(np.uint32))


@needs_cxx
@pytest.mark.parametrize("fmt", FORMATS)
def test_partial_reads_take_the_numpy_path(tmp_path, fmt):
    path = tmp_path / f"p{fmt}.sgy"
    raw = _write(path, fmt, False, seed=7)
    with segy.SegyFile(str(path)) as f:
        whole = f.trace_data()
        part = f.trace_data([3, 0, 50])
    want = segy._decode_samples(raw[[3, 0, 50]], fmt)
    np.testing.assert_array_equal(part.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(part, whole[[3, 0, 50]])


@needs_cxx
def test_build_into_a_temporary_build_directory(tmp_path):
    """A build lands in the directory given, named by the source and the
    flags; a second call reuses it; a changed source builds anew; the
    four entry points bind and decode."""
    out = native.build(build_dir=tmp_path)
    assert out.parent == tmp_path and out.name.startswith("libp3dsegy_")
    mtime = out.stat().st_mtime_ns
    assert native.build(build_dir=tmp_path) == out
    assert out.stat().st_mtime_ns == mtime
    src = tmp_path / "segy_core.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// changed\n")
    other = native.build(src, tmp_path)
    assert other != out and other.exists()
    cdll = native.bind(ctypes.CDLL(str(out)))
    ibm = np.array([0x41100000, 0xC2640000], ">u4").view(np.uint8)
    res = np.empty(2, np.float32)
    cdll.ibm2ieee_buffer(ibm.ctypes.data, res.ctypes.data, 2)
    np.testing.assert_array_equal(res, [1.0, -100.0])
    back = np.empty(8, np.uint8)
    cdll.ieee2ibm_buffer(res.ctypes.data, back.ctypes.data, 2)
    np.testing.assert_array_equal(back, ibm)
    rows = np.zeros((3, 240), np.uint8)
    rows[:, 8:12] = np.array([5, -6, 7], ">i4").view(np.uint8).reshape(3, 4)
    col = np.empty(3, np.int64)
    assert cdll.header_column(rows.ctypes.data, 240, 3, 8, 4,
                              col.ctypes.data) == 0
    np.testing.assert_array_equal(col, [5, -6, 7])
    assert cdll.decode_traces(rows.ctypes.data, 240, 3, 1, 9,
                              col.ctypes.data) == -1  # unknown format


def test_a_failed_build_keeps_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "segy_core.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="exited"):
        native.build(bad, tmp_path)
    assert not list(tmp_path.glob("*.so"))
    # lib() keeps the reason and the codec falls back to numpy
    real_build = native.build
    monkeypatch.setattr(native, "build",
                        lambda flags: real_build(bad, tmp_path, flags))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_flags", None)
    assert native.lib() is None
    # both builds were tried, each one's error kept
    assert native.build_error().count("exited") == 2
    assert native.openmp() is None
    path = tmp_path / "f1.sgy"
    raw = _write(path, 1, False)
    with segy.SegyFile(str(path)) as f:
        got = f.trace_data()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  segy._decode_samples(raw, 1).view(np.uint32))


def test_no_compiler_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-p3d")
    src = tmp_path / "segy_core.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// not built yet\n")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build(src, tmp_path)
    assert os.listdir(tmp_path) == ["segy_core.cpp"]


@needs_cxx
def test_without_openmp_the_serial_build_loads(tmp_path, monkeypatch):
    """A compiler without OpenMP's runtime fails the ``-fopenmp`` build;
    ``lib()`` then builds and loads the serial one, which decodes the same
    bits."""
    real_build = native.build

    def no_libgomp(flags):
        if "-fopenmp" in flags:
            raise RuntimeError("g++ exited 1 on segy_core.cpp: cannot read "
                               "spec file 'libgomp.spec'")
        return real_build(native.SOURCE, tmp_path, flags)
    monkeypatch.setattr(native, "build", no_libgomp)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_flags", None)
    assert native.lib() is not None
    assert native.openmp() is False and native.build_error() is None
    assert "-fopenmp" not in native.SERIAL_FLAGS
    path = tmp_path / "f1.sgy"
    raw = _write(path, 1, True, seed=3)
    with segy.SegyFile(str(path)) as f, np.errstate(over="ignore"):
        got = f.trace_data()
        want = segy._decode_samples(raw, 1)
    _same_bits(got, want, raw, 1)
