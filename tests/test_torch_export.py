"""SEG-Y in and out of the port against the JAX package: a profile read
into a cube (``profile_to_cube``, workflow step 09), the per-profile
files ``convert`` writes (read back through ``read_cube``), and a binned
cube exported to SEG-Y (``cube_to_segy``, step 16), byte for byte, in IBM
and IEEE formats, with fold, navigation and fractional line coordinates,
from memory and from a file. Everything here is host numpy and held
exact; files are compared written on the same day (the textual header
stamps the date)."""

import os

import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.io import ncio as jnc
from pseudo_3d_interpolation_tpu.io.segy import write_segy as jwrite_segy
from pseudo_3d_interpolation_tpu.ops.affine import Affine as JAffine
from pseudo_3d_interpolation_tpu.pipeline import export as jexport
from pseudo_3d_interpolation_tpu.pipeline import segy2cube as js2c
from pseudo_3d_interpolation_torch.io import ncio as nc
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.io.segy import SegyFile
from pseudo_3d_interpolation_torch.ops.affine import Affine
from pseudo_3d_interpolation_torch.pipeline import binning as pbin
from pseudo_3d_interpolation_torch.pipeline import export
from pseudo_3d_interpolation_torch.pipeline import segy2cube as s2c
from test_torch_binning import write_survey


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return write_survey(tmp_path_factory.mktemp("survey"), seed=11)


def _same(got, want):
    assert got.coords.keys() == want.coords.keys()
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    assert got.data_vars.keys() == want.data_vars.keys()
    for k, (dims, arr) in want.data_vars.items():
        assert got.data_vars[k][0] == tuple(dims)
        np.testing.assert_array_equal(got.data_vars[k][1], np.asarray(arr))
        assert got.data_vars[k][1].dtype == np.asarray(arr).dtype
    assert got.attrs == want.attrs
    assert got.coord_attrs == want.coord_attrs


def test_profile_to_cube_matches_jax(survey):
    for name in sorted(os.listdir(survey))[:3]:
        path = os.path.join(survey, name)
        _same(s2c.profile_to_cube(path), js2c.profile_to_cube(path))


def test_profile_to_cube_of_an_empty_profile_matches_jax(tmp_path):
    path = str(tmp_path / "empty.sgy")
    jwrite_segy(path, np.zeros((1, 16), np.float32), dt_us=250)
    with open(path, "r+b") as f:
        f.truncate(3600)  # the headers of an aborted line, no trace
    got, want = s2c.profile_to_cube(path), js2c.profile_to_cube(path)
    _same(got, want)
    assert got["amp"].shape == (0, 16)


def test_convert_files_match_jax(survey, tmp_path):
    got = s2c.convert(survey, out_dir=str(tmp_path / "p"), fnsuffix="UTM",
                      workers=2)
    want = js2c.convert(survey, out_dir=str(tmp_path / "j"), fnsuffix="UTM",
                        workers=2)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and len(got) == 8
    for g, w in zip(got, want):
        _same(nc.read_cube(g), jnc.read_cube(w))
        _same(nc.read_cube(w), jnc.read_cube(g))


def _binned(survey, method="average"):
    return pbin.bin_cube(survey, pbin.BinningGeometry(
        spacing=10.0, extent=(0.0, 80.0, 0.0, 80.0), stacking_method=method),
        device="cpu")


def _jcube(cube):
    return jnc.Cube(coords=dict(cube.coords),
                    data_vars=dict(cube.data_vars), attrs=dict(cube.attrs),
                    var_attrs=dict(cube.var_attrs),
                    coord_attrs=dict(cube.coord_attrs))


@pytest.mark.parametrize("fmt", [1, 5])
@pytest.mark.parametrize("nav", [False, True])
def test_cube_to_segy_byte_identical(survey, tmp_path, fmt, nav):
    cube = _binned(survey, "nearest")
    kw = dict(fmt=fmt, coordinate_scalar="auto" if nav else -10)
    if nav:
        ilxl = Affine().scaling(10.0).translation((-5.0, -5.0))
        kw_p = dict(kw, ilxl_to_coords=ilxl)
        kw_j = dict(kw, ilxl_to_coords=JAffine(matrix=ilxl.matrix))
    else:
        kw_p = kw_j = kw
    p = export.cube_to_segy(cube, str(tmp_path / "p.sgy"), **kw_p)
    j = jexport.cube_to_segy(_jcube(cube), str(tmp_path / "j.sgy"), **kw_j)
    assert open(p, "rb").read() == open(j, "rb").read()
    with SegyFile(p) as f:
        n_il, n_xl, ns = cube["amp"].shape
        assert f.n_traces == n_il * n_xl and f.n_samples == ns
        assert f.dt_us == 500 and f.format == fmt
        np.testing.assert_array_equal(f.header("NStackedTraces"),
                                      cube["fold"].reshape(-1))
        np.testing.assert_array_equal(f.header("INLINE_3D"),
                                      np.repeat(cube.coords["iline"], n_xl))
        if fmt == 5:
            np.testing.assert_array_equal(
                f.trace_data(), cube["amp"].reshape(-1, ns))


def test_cube_to_segy_from_a_file_and_of_fractional_lines(survey, tmp_path):
    cube = _binned(survey)
    cube.coords["iline"] = cube.coords["iline"] * 0.5 + 0.25
    cube.attrs["text"] = "\n".join(f"step {i}" for i in range(60))
    nc.write_cube(str(tmp_path / "c.nc"), cube)
    p = export.cube_to_segy(str(tmp_path / "c.nc"), str(tmp_path / "p.sgy"),
                            var="amp")
    j = jexport.cube_to_segy(str(tmp_path / "c.nc"), str(tmp_path / "j.sgy"),
                             var="amp")
    assert open(p, "rb").read() == open(j, "rb").read()
    with SegyFile(p) as f:
        np.testing.assert_array_equal(np.unique(f.header("INLINE_3D")),
                                      np.arange(1, 9))


def test_cube_to_segy_errors(tmp_path):
    cube = Cube(coords={"iline": np.arange(2), "twt": np.arange(3) * 1e-3,
                        "xline": np.arange(2)},
                data_vars={"amp": (("iline", "twt", "xline"),
                                   np.zeros((2, 3, 2), np.float32))})
    with pytest.raises(ValueError, match="must be"):
        export.cube_to_segy(cube, str(tmp_path / "x.sgy"))
    with pytest.raises(ValueError, match="coordinate scalar"):
        export.cube_to_segy(cube, str(tmp_path / "x.sgy"),
                            coordinate_scalar=-37)
