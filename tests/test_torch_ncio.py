"""Cube files: a file the JAX package writes reads back equal in the port,
and the other way round (data, dims, coords, attrs, complex halves, CF
packing, chunking), through ``read_cube``/``write_cube`` and the lazy
``CubeFile``/``CubeWriter``; the attrs-config helpers; the port's
``Cube``; and the import rule: no module of the port needs jax, h5py or
yaml to import."""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.io import ncio as jnc
from pseudo_3d_interpolation_torch.io import ncio as nc
from pseudo_3d_interpolation_torch.io.cube import Cube

REPO = Path(__file__).resolve().parents[1]


def _fields(n_il=4, n_xl=5, n_f=6, seed=0):
    rng = np.random.default_rng(seed)
    coords = {"iline": np.arange(n_il, dtype=np.int64) + 10,
              "xline": np.arange(n_xl, dtype=np.float64) * 2.5,
              "freq_twt": np.linspace(0.0, 500.0, n_f)}
    spec = (rng.standard_normal((n_il, n_xl, n_f))
            + 1j * rng.standard_normal((n_il, n_xl, n_f))).astype(
        np.complex64)
    amp = rng.standard_normal((n_il, n_xl, n_f)).astype(np.float32) * 3.0
    amp[0, 1, 2] = np.nan
    fold = rng.integers(0, 4, (n_il, n_xl)).astype(np.int32)
    data_vars = {"freq_amp": (("iline", "xline", "freq_twt"), spec),
                 "amp": (("iline", "xline", "freq_twt"), amp),
                 "fold": (("iline", "xline"), fold)}
    attrs = {"history": "BIN;FFT(amp);", "bin_size": 2.5, "crs": "EPSG:32632",
             "count": 7}
    var_attrs = {"freq_amp": {"nfft": 10, "dt": 0.001, "original_var": "amp",
                              "real_fft": 1},
                 "amp": {"units": "m"}}
    coord_attrs = {"freq_twt": {"units": "Hz", "long_name": "frequency"}}
    return dict(coords=coords, data_vars=data_vars, attrs=attrs,
                var_attrs=var_attrs, coord_attrs=coord_attrs)


ENCODINGS = {"amp": {"dtype": "int16", "scale_factor": 0.001,
                     "add_offset": 0.5, "_FillValue": -32768},
             "fold": {"dtype": "int8", "_FillValue": -1}}


def _as_text(v):
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype.kind in "SO":
        return [x.decode() if isinstance(x, bytes) else x for x in v]
    return v


def _same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        va, vb = _as_text(a[k]), _as_text(b[k])
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, k


def _same_cube(a, b):
    assert list(a.coords) == list(b.coords)
    for d in a.coords:
        np.testing.assert_array_equal(a.coords[d], b.coords[d])
        assert a.coords[d].dtype == b.coords[d].dtype
    assert sorted(a.data_vars) == sorted(b.data_vars)
    for k, (dims, data) in a.data_vars.items():
        bdims, bdata = b.data_vars[k]
        assert tuple(dims) == tuple(bdims)
        assert data.dtype == bdata.dtype, k
        np.testing.assert_array_equal(data, bdata)
    _same_attrs(a.attrs, b.attrs)
    assert sorted(a.var_attrs) == sorted(b.var_attrs)
    for k in a.var_attrs:
        _same_attrs(a.var_attrs[k], b.var_attrs[k])
    for k in a.coord_attrs:
        _same_attrs(a.coord_attrs[k], b.coord_attrs.get(k, {}))


WRITERS = [pytest.param({}, id="plain"),
           pytest.param({"chunks": {"freq_twt": 1}}, id="slice-chunks"),
           pytest.param({"encodings": ENCODINGS}, id="cf-packed"),
           pytest.param({"compress": True}, id="gzip")]


@pytest.mark.parametrize("kw", WRITERS)
def test_jax_file_reads_back_equal_in_the_port(tmp_path, kw):
    path = tmp_path / "jax.nc"
    jnc.write_cube(str(path), jnc.Cube(**_fields()), **kw)
    _same_cube(nc.read_cube(path), jnc.read_cube(str(path)))
    halves = nc.read_cube(path, combine_complex=False)
    assert {"freq_amp.real", "freq_amp.imag"} <= set(halves.data_vars)
    assert halves["freq_amp.real"].dtype == np.float32
    only = nc.read_cube(path, variables=["fold"])
    assert list(only.data_vars) == ["fold"]


@pytest.mark.parametrize("kw", WRITERS)
def test_port_file_reads_back_equal_in_jax(tmp_path, kw):
    path = tmp_path / "port.nc"
    fields = _fields(seed=1)
    nc.write_cube(path, Cube(**fields), **kw)
    _same_cube(jnc.read_cube(str(path)), nc.read_cube(path))
    back = nc.read_cube(path)
    np.testing.assert_array_equal(back["freq_amp"],
                                  fields["data_vars"]["freq_amp"][1])
    if "encodings" in kw:
        amp = fields["data_vars"]["amp"][1]
        assert np.isnan(back["amp"][0, 1, 2])
        ok = ~np.isnan(amp)
        assert np.abs(back["amp"][ok] - amp[ok]).max() <= 0.0005 + 1e-7
        with h5py.File(path) as f:
            assert f["amp"].dtype == np.int16 and f["fold"].dtype == np.int8
            assert f["amp"].attrs["scale_factor"] == 0.001
    if "chunks" in kw:
        with h5py.File(path) as f:
            assert f["freq_amp.real"].chunks == (4, 5, 1)
    # the same bytes where the packages agree byte for byte in meaning
    jpath = tmp_path / "jax.nc"
    jnc.write_cube(str(jpath), jnc.Cube(**_fields(seed=1)), **kw)
    with h5py.File(path) as f, h5py.File(jpath) as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for k in f.keys():
            np.testing.assert_array_equal(f[k][()], g[k][()])
            assert f[k].dtype == g[k].dtype and f[k].chunks == g[k].chunks
            _same_attrs({a: v for a, v in f[k].attrs.items()
                         if a not in ("DIMENSION_LIST", "REFERENCE_LIST")},
                        {a: v for a, v in g[k].attrs.items()
                         if a not in ("DIMENSION_LIST", "REFERENCE_LIST")})


def test_lazy_reader_and_writer_interchange(tmp_path):
    fields = _fields(seed=2)
    jpath, path = tmp_path / "jax.nc", tmp_path / "port.nc"
    jnc.write_cube(str(jpath), jnc.Cube(**fields), encodings=ENCODINGS)
    with nc.CubeFile(jpath) as f, jnc.CubeFile(str(jpath)) as g:
        assert f.data_vars == g.data_vars and f.sizes() == g.sizes()
        # HDF5 lists variables by name: amp before freq_amp
        assert f.primary_var() == g.primary_var() == "amp"
        assert f.is_complex("freq_amp") and not f.is_complex("amp")
        for k in f.var_attrs:
            _same_attrs(f.var_attrs[k], g.var_attrs[k])
        assert "scale_factor" not in f.var_attrs["amp"]
        for var in ("freq_amp", "amp", "fold"):
            np.testing.assert_array_equal(
                f.read_slab(var, dim="xline", start=1, stop=4),
                g.read_slab(var, dim="xline", start=1, stop=4))
            np.testing.assert_array_equal(f.read(var), g.read(var))

    with nc.CubeWriter(path, fields["coords"], attrs={"history": "A;"},
                       coord_attrs=fields["coord_attrs"]) as w:
        w.create_var("freq_amp", ("iline", "xline", "freq_twt"),
                     np.complex64, chunks={"freq_twt": 1},
                     attrs={"nfft": 10})
        w.create_var("fold", ("iline", "xline"), np.int32)
        spec = fields["data_vars"]["freq_amp"][1]
        for s in range(0, 6, 4):
            w.write_slab("freq_amp", spec[..., s:s + 4], dim="freq_twt",
                         start=s)
        w.write_slab("fold", fields["data_vars"]["fold"][1])
        w.set_attrs(pocs_mean_iterations=50.0)
    back = jnc.read_cube(str(path))
    np.testing.assert_array_equal(back.data_vars["freq_amp"][1], spec)
    assert back.attrs["pocs_mean_iterations"] == 50.0
    assert back.var_attrs["freq_amp"]["nfft"] == 10


def test_attrs_config_helpers_match_jax(tmp_path):
    cfg = {"attrs_time": {"cube": {"title": "survey", "history": "x"},
                          "amp": {"units": "counts"},
                          "twt": {"units": "s"}},
           "attrs_freq": {"data": {"units": "counts s"}},
           "encodings": {"amp": {"dtype": "int16"}},
           "var_aux": ["fold"]}
    path = tmp_path / "attrs.yml"
    path.write_text(
        "attrs_time:\n  cube:\n    title: survey\n    history: x\n"
        "  amp:\n    units: counts\n  twt:\n    units: s\n"
        "attrs_freq:\n  data:\n    units: counts s\n"
        "encodings:\n  amp:\n    dtype: int16\nvar_aux: [fold]\n")
    assert nc.load_attrs_config(str(path)) == jnc.load_attrs_config(
        str(path)) == nc.load_attrs_config(cfg)
    assert nc.load_attrs_config({}) == ({}, {}, {}, [])
    fields = _fields()
    fields["coords"]["twt"] = fields["coords"].pop("freq_twt")
    cube, jcube = Cube(**fields), jnc.Cube(**_fields())
    jcube.coords["twt"] = jcube.coords.pop("freq_twt")
    nc.apply_time_attrs(cube, cfg)
    jnc.apply_time_attrs(jcube, cfg)
    assert cube.attrs == jcube.attrs and cube.attrs["title"] == "survey"
    assert cube.attrs["history"] == "BIN;FFT(amp);"
    assert cube.var_attrs == jcube.var_attrs
    assert cube.coord_attrs == jcube.coord_attrs


def test_cube_accessors_match_jax():
    cube, jcube = Cube(**_fields()), jnc.Cube(**_fields())
    assert cube.sizes() == jcube.sizes() == {"iline": 4, "xline": 5,
                                             "freq_twt": 6}
    assert cube["fold"] is cube.data_vars["fold"][1]
    assert cube.primary_var() == jcube.primary_var() == "freq_amp"
    env = np.zeros((4, 5, 6), np.float32)
    cube.set_var("env", ("iline", "xline", "freq_twt"), env, {"units": "m"})
    jcube.set_var("env", ("iline", "xline", "freq_twt"), env, {"units": "m"})
    assert cube.data_vars["env"][0] == jcube.data_vars["env"][0]
    assert cube.var_attrs["env"] == {"units": "m"}
    with pytest.raises(ValueError, match="coord length"):
        cube.set_var("bad", ("iline",), np.zeros(3))
    aux = Cube(coords={}, data_vars={"fold": ((), np.zeros(()))})
    with pytest.raises(ValueError, match="besides fold"):
        aux.primary_var()
    assert nc.Cube is Cube


def test_port_imports_without_jax_h5py_or_yaml():
    """The card's machine has neither jax, h5py, yaml nor pandas: every
    module of the port (the native decoder's loader, the segyio and pyproj
    facades and the roofline among them) imports with all four blocked,
    and reaching a file raises only when a file is asked for."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'h5py', 'yaml', 'pandas'): sys.modules[m] = None\n"
        "import pseudo_3d_interpolation_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "new = {'io.ncio', 'ops.spectral', 'ops.signal', 'ops.filters',\n"
        "       'ops.metrics', 'utils.rescale', 'utils.device',\n"
        "       'pipeline.fft', 'pipeline.ifft', 'pipeline.preprocess',\n"
        "       'pipeline.postprocess', 'io.segy', 'io.headers',\n"
        "       'io.textual', 'io.auxiliary', 'ops.affine', 'ops.binning',\n"
        "       'utils.crs', 'utils.logging', 'pipeline.binning',\n"
        "       'pipeline.segy2cube', 'pipeline.export', 'io.native',\n"
        "       'io.segyio_compat', 'utils.pyproj_compat',\n"
        "       'utils.roofline'}\n"
        "missing = {p.__name__ + '.' + m for m in new} - set(mods)\n"
        "assert not missing, missing\n"
        "assert not any(k.startswith('pseudo_3d_interpolation_tpu') "
        "for k in sys.modules)\n"
        "from pseudo_3d_interpolation_torch.io import ncio\n"
        "try:\n"
        "    ncio.read_cube('cube.nc')\n"
        "except ImportError:\n"
        "    print('h5py needed')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "h5py needed"
