"""Trace binning (workflow step 10) of the port against the JAX package:
the stack functions of ``ops/binning.py`` on folds 0-7 with even folds
and tied distances, the host helpers (bin assignment on a plain and on a
stepped region grid, the global-TWT padding, the bin-center distances),
and ``pipeline/binning.bin_cube`` on a small survey written by the JAX
``write_segy`` with every stacking method, in memory and out of core,
the streaming nearest over small trace blocks, a nested region grid and
the CRS attributes. The port runs with ``device="cpu"``.

Tolerances: nearest and median select or average the same float32 values
and are held exact. average and IDW sum in another order (the port's
``index_add_`` against JAX's segment sum, or the JAX streaming path's
sorted ``reduceat``): max|Δ| ≤ 1e-6·max|JAX|. Fold, coordinates and the
host helpers are exact."""

import os

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io import ncio as jnc
from pseudo_3d_interpolation_tpu.io.segy import write_segy as jwrite_segy
from pseudo_3d_interpolation_tpu.ops import binning as jbn
from pseudo_3d_interpolation_tpu.ops.affine import \
    coords_to_ilxl_transform as jcoords_to_ilxl
from pseudo_3d_interpolation_tpu.pipeline import binning as jpipe
from pseudo_3d_interpolation_torch.io import ncio as nc
from pseudo_3d_interpolation_torch.ops import binning as bn
from pseudo_3d_interpolation_torch.ops.affine import coords_to_ilxl_transform
from pseudo_3d_interpolation_torch.pipeline import binning as pipe

torch.set_num_threads(2)

SUM_TOL = 1e-6
EXACT = ("nearest", "median")
METHODS = ("average", "idw", "nearest", "median")


def _close(got, want, method):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if method in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= SUM_TOL * scale


def _stack_inputs(seed, ns=16, nan=False):
    """Bins with folds 0..7 (bin b holds b traces) plus two empty bins,
    traces in shuffled order, distances on a coarse lattice so bins hold
    tied nearest candidates."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(8), np.arange(8))
    ids = np.where(ids == 5, 9, ids)  # the fold-5 bin moves past an empty one
    ids = ids[rng.permutation(len(ids))]
    traces = rng.standard_normal((len(ids), ns)).astype(np.float32)
    if nan:
        traces[rng.integers(0, len(ids), 6), rng.integers(0, ns, 6)] = np.nan
    dist = rng.integers(0, 3, len(ids)) * 2.5
    return traces, ids.astype(np.int64), dist, 11


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_stack_traces_match_jax(method, seed):
    traces, ids, dist, n_bins = _stack_inputs(seed)
    want = np.asarray(jbn.stack_traces(traces, ids, n_bins, method=method,
                                       dist=dist, idw_power=1.5))
    got = bn.stack_traces(traces, ids, n_bins, method=method, dist=dist,
                          idw_power=1.5, device="cpu")
    assert got.device.type == "cpu"
    _close(got.numpy(), want, method)
    assert not got[[5, 10]].any()  # empty bins stack to zero traces


def test_stack_functions_match_jax_one_by_one():
    traces, ids, dist, n_bins = _stack_inputs(3)
    np.testing.assert_array_equal(
        bn.fold_map(ids, n_bins, device="cpu").numpy(),
        np.asarray(jbn.fold_map(ids, n_bins)))
    assert bn.fold_map(ids, n_bins, device="cpu").dtype == torch.int32
    tr = torch.from_numpy(traces)
    _close(bn.stack_average(tr, ids, n_bins).numpy(),
           np.asarray(jbn.stack_average(traces, ids, n_bins)), "average")
    _close(bn.stack_idw(tr, ids, dist, n_bins, power=2.0).numpy(),
           np.asarray(jbn.stack_idw(traces, ids, dist, n_bins, power=2.0)),
           "idw")
    _close(bn.stack_nearest(tr, torch.from_numpy(ids), dist, n_bins).numpy(),
           np.asarray(jbn.stack_nearest(traces, ids, dist, n_bins)),
           "nearest")
    _close(bn.stack_median(tr, ids, n_bins, max_fold=9).numpy(),
           np.asarray(jbn.stack_median(traces, ids, n_bins, max_fold=9)),
           "median")


def test_nearest_keeps_the_first_of_tied_traces():
    traces = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([1, 1, 0, 1])
    dist = np.array([2.0, 1.0, 3.0, 1.0])
    got = bn.stack_nearest(traces, ids, dist, 3, device="cpu").numpy()
    np.testing.assert_array_equal(got, [traces[2], traces[1], np.zeros(3)])
    np.testing.assert_array_equal(
        got, np.asarray(jbn.stack_nearest(traces, ids, dist, 3)))


@pytest.mark.parametrize("budget", [None, 1, 3000])
@pytest.mark.parametrize("nan", [False, True])
def test_median_even_folds_nan_samples_and_chunks_match_jax(nan, budget):
    """Even folds take the mean of the two middle values (torch.median
    would take the lower); NaN samples are left out as jnp.nanmedian
    does; chunks of a few bins (budget 1: one bin a chunk) change
    nothing."""
    traces, ids, _, n_bins = _stack_inputs(4, nan=nan)
    want = np.asarray(jbn.stack_median(traces, ids, n_bins, max_fold=7))
    got = bn.stack_median(traces, ids, n_bins, 7, device="cpu",
                          budget=budget)
    np.testing.assert_array_equal(got.numpy(), want)
    two = bn.stack_median(np.array([[1.0], [4.0]], np.float32), [0, 0], 1, 2,
                          device="cpu")
    assert float(two[0, 0]) == 2.5


def test_median_refuses_a_short_max_fold_and_stacks_nothing_to_zero():
    traces, ids, _, n_bins = _stack_inputs(5)
    with pytest.raises(ValueError, match="max_fold"):
        bn.stack_median(traces, ids, n_bins, 6, device="cpu")
    empty = bn.stack_median(np.zeros((0, 4), np.float32), np.zeros(0, int),
                            3, 1, device="cpu")
    assert empty.shape == (3, 4) and not empty.any()
    with pytest.raises(ValueError, match="unknown stacking method"):
        bn.stack_traces(traces, ids, n_bins, method="mode", device="cpu")
    with pytest.raises(ValueError, match="distances"):
        bn.stack_traces(traces, ids, n_bins, method="idw", device="cpu")


def test_stack_functions_raise_without_a_card_unless_given_cpu():
    traces, ids, dist, n_bins = _stack_inputs(6)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bn.stack_average(traces, ids, n_bins)
    # a CPU tensor stays where it is
    assert bn.stack_average(torch.from_numpy(traces), ids,
                            n_bins).device.type == "cpu"


def test_host_helpers_match_jax():
    rng = np.random.default_rng(7)
    t, n_il, n_xl = coords_to_ilxl_transform(extent=(0, 40, 0, 20),
                                             spacing=10.0)
    jt, _, _ = jcoords_to_ilxl(extent=(0, 40, 0, 20), spacing=10.0)
    np.testing.assert_array_equal(t.matrix, jt.matrix)
    x, y = rng.uniform(-5, 45, 200), rng.uniform(-5, 25, 200)
    for got, want in zip(bn.assign_bins(x, y, t, n_il, n_xl),
                         jbn.assign_bins(x, y, jt, n_il, n_xl)):
        np.testing.assert_array_equal(got, want)
    il, xl, _ = bn.assign_bins(x, y, t, n_il, n_xl)
    np.testing.assert_array_equal(bn.bin_index(il, xl, n_xl),
                                  jbn.bin_index(il, xl, n_xl))
    np.testing.assert_array_equal(
        bn.bin_center_distances(x, y, il, xl, t.inverse()),
        jbn.bin_center_distances(x, y, il, xl, jt.inverse()))


def test_assign_bins_indexed_on_a_stepped_region_grid_matches_jax():
    """A nested region grid whose line list steps by 2 then 4: the
    tolerance comes from the local step."""
    rng = np.random.default_rng(8)
    t, _, _ = coords_to_ilxl_transform(extent=(0, 200, 0, 100), spacing=5.0)
    jt, _, _ = jcoords_to_ilxl(extent=(0, 200, 0, 100), spacing=5.0)
    il_idx = np.r_[np.arange(3, 21, 2), np.arange(21, 41, 4)]
    xl_idx = np.arange(2, 19, 2)
    x, y = rng.uniform(-10, 210, 500), rng.uniform(-10, 110, 500)
    got = bn.assign_bins_indexed(x, y, t, il_idx, xl_idx)
    want = jbn.assign_bins_indexed(x, y, jt, il_idx, xl_idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[2].sum() < len(x)
    with pytest.raises(ValueError, match="ascending"):
        bn.assign_bins_indexed(x, y, t, il_idx[::-1], xl_idx)


def test_pad_traces_to_global_twt_matches_jax():
    rng = np.random.default_rng(9)
    traces = rng.standard_normal((12, 20)).astype(np.float32)
    delrt = rng.choice([-0.004, 0.0, 0.002, 0.01, 0.05], 12)
    for twt0, n_out in ((0.0, 30), (0.002, 18), (-0.01, 64)):
        got = bn.pad_traces_to_global_twt(traces, delrt, twt0, 0.001, n_out)
        want = np.asarray(jbn.pad_traces_to_global_twt(traces, delrt, twt0,
                                                       0.001, n_out))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- bin_cube
N_PROFILES, N_TRACES, N_SAMPLES, DT_US = 8, 64, 128, 500


def write_survey(directory, seed=0, n_profiles=N_PROFILES):
    """Profiles along y, one per iline column of a 10 m grid over 80 x 80 m,
    x jittered inside the column and y irregular, the delay stepping 2 ms
    a profile, written by the JAX package's ``write_segy``. Two profiles
    share a column, so bins take traces from two files."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for p in range(n_profiles):
        col = p if p < n_profiles - 1 else 2
        x = 5.0 + 10.0 * col + rng.uniform(-4.0, 4.0, N_TRACES)
        y = np.sort(rng.uniform(-2.0, 82.0, N_TRACES))
        # ties: a few traces sit at mirrored offsets around a bin center
        x[:4], y[:4] = 5.0 + 10.0 * col + np.array([-2, 2, -2, 2]), \
            np.array([15.0, 15.0, 13.0, 17.0])
        data = rng.standard_normal((N_TRACES, N_SAMPLES)).astype(np.float32)
        jwrite_segy(os.path.join(directory, f"line{p:02d}_UTM.sgy"), data,
                    headers={"SourceX": np.rint(x * 100).astype(np.int64),
                             "SourceY": np.rint(y * 100).astype(np.int64),
                             "SourceGroupScalar": -100, "CoordinateUnits": 1,
                             "DelayRecordingTime": 2 * p},
                    fmt=5, dt_us=DT_US)
    return str(directory)


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return write_survey(tmp_path_factory.mktemp("survey"))


def _geometry(cls, method, **kw):
    return cls(spacing=10.0, extent=(0.0, 80.0, 0.0, 80.0),
               stacking_method=method, **kw)


def _same_cube(got, want, method):
    assert got.coords.keys() == want.coords.keys()
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
        assert got.coords[k].dtype == np.asarray(want.coords[k]).dtype
    np.testing.assert_array_equal(got["fold"], np.asarray(want["fold"]))
    assert got["fold"].dtype == np.int32
    _close(got["amp"], np.asarray(want["amp"]), method)
    assert got.attrs == want.attrs
    assert got.coord_attrs == want.coord_attrs


@pytest.mark.parametrize("method", METHODS)
def test_bin_cube_in_memory_matches_jax(survey, method):
    want = jpipe.bin_cube(survey, _geometry(jpipe.BinningGeometry, method))
    got = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, method),
                        device="cpu")
    _same_cube(got, want, method)
    assert got["amp"].shape == (8, 8, 2 * ((N_SAMPLES + 7 * 4 + 1) // 2))
    assert got["fold"].sum() > 0 and (got["fold"] == 0).any()


@pytest.mark.parametrize("method", METHODS)
def test_bin_cube_out_of_core_matches_jax(survey, method, tmp_path):
    jpath = jpipe.bin_cube(survey, _geometry(jpipe.BinningGeometry, method),
                           out_path=str(tmp_path / "j.nc"), out_of_core=True)
    path = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, method),
                         out_path=str(tmp_path / "p.nc"), out_of_core=True,
                         device="cpu")
    assert path == str(tmp_path / "p.nc")
    assert not list(tmp_path.glob("p3d_binacc_*"))  # the memmap is gone
    _same_cube(nc.read_cube(path), jnc.read_cube(jpath), method)
    # the out-of-core cube is the in-memory one
    mem = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, method),
                        device="cpu")
    _close(nc.read_cube(path)["amp"], mem["amp"], method)


@pytest.mark.parametrize("trace_block", [1, 3, 7, 64])
def test_bin_cube_streaming_nearest_over_trace_blocks_matches_jax(
        survey, trace_block):
    want = jpipe.bin_cube(survey, _geometry(jpipe.BinningGeometry, "nearest"),
                          trace_block=trace_block)
    got = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, "nearest"),
                        trace_block=trace_block, device="cpu")
    _same_cube(got, want, "nearest")


def test_bin_cube_nearest_streaming_semantics(tmp_path):
    """The port's mirror of the JAX package's test of the same name: two
    parallel lines in one iline column; line B, 2 m off the bin centers,
    wins every bin over line A, 6 m off, across files and trace blocks."""
    survey = tmp_path / "survey"
    survey.mkdir()
    rng = np.random.default_rng(1)
    data = {}
    for name, x0 in (("lineA_UTM.sgy", 4.0), ("lineB_UTM.sgy", 12.0)):
        data[name] = rng.standard_normal((8, 32)).astype(np.float32)
        ys = 4.0 + 5.0 * np.arange(8)
        jwrite_segy(str(survey / name), data[name],
                    headers={"SourceX": np.full(8, int(x0 * 100)),
                             "SourceY": np.rint(ys * 100).astype(np.int64),
                             "SourceGroupScalar": -100, "CoordinateUnits": 1},
                    fmt=5, dt_us=250)
    geom = pipe.BinningGeometry(spacing=20.0, extent=(0.0, 40.0, 0.0, 40.0),
                                stacking_method="nearest")
    cube = pipe.bin_cube(str(survey), geom, trace_block=3, device="cpu")
    amp, fold = cube["amp"], cube["fold"]
    assert amp.shape[:2] == (2, 2)
    assert fold[1].sum() == 0
    np.testing.assert_array_equal(amp[0, 0, :32], data["lineB_UTM.sgy"][1])
    np.testing.assert_array_equal(amp[0, 1, :32], data["lineB_UTM.sgy"][5])


def test_bin_cube_idw_f32_weight_arithmetic(tmp_path):
    """The port's mirror of the JAX package's test of the same name: each
    trace times its weight cast to float32 first, the weights summed in
    float64 and cast only at the division."""
    survey = tmp_path / "survey"
    survey.mkdir()
    rng = np.random.default_rng(7)
    data = rng.standard_normal((8, 128)).astype(np.float32)
    ys = 4.0 + 5.0 * np.arange(8)
    jwrite_segy(str(survey / "lineA_UTM.sgy"), data,
                headers={"SourceX": np.full(8, 1200),
                         "SourceY": np.rint(ys * 100).astype(np.int64),
                         "SourceGroupScalar": -100, "CoordinateUnits": 1},
                fmt=5, dt_us=250)
    geom = pipe.BinningGeometry(spacing=20.0, extent=(0.0, 20.0, 0.0, 40.0),
                                stacking_method="idw", idw_power=1.0)
    amp = pipe.bin_cube(str(survey), geom, device="cpu")["amp"]
    for xl, yc in ((0, 10.0), (1, 30.0)):
        rows = np.flatnonzero((ys >= 20.0 * xl) & (ys < 20.0 * (xl + 1)))
        w = 1.0 / (np.hypot(2.0, ys[rows] - yc) + 1e-10)
        num = np.add.reduceat(data[rows] * w.astype(np.float32)[:, None],
                              [0], axis=0)[0]
        want = num / np.float32(np.sum(w))
        assert np.abs(amp[0, xl] - want).max() <= SUM_TOL * np.abs(want).max()


def test_bin_cube_nested_region_grid_matches_jax(survey):
    """Line indices on a 5 m master grid, stepping by 2: the cube's
    coordinates and stack are the JAX package's."""
    kw = dict(region_extent=(0.0, 80.0, 0.0, 80.0), region_spacing=5.0)
    want = jpipe.bin_cube(survey, _geometry(jpipe.BinningGeometry, "average",
                                            **kw))
    got = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, "average",
                                          **kw), device="cpu")
    _same_cube(got, want, "average")
    assert got.coords["iline"][1] - got.coords["iline"][0] == 2


def test_bin_cube_twt_window_and_crs_attrs_match_jax(survey, tmp_path):
    kw = dict(twt_limits=(0.004, 0.05), crs="EPSG:32632")
    want = jpipe.bin_cube(survey, _geometry(jpipe.BinningGeometry, "median",
                                            **kw))
    got = pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, "median",
                                          **kw), device="cpu",
                        out_path=str(tmp_path / "crs.nc"))
    _same_cube(got, want, "median")
    assert got.attrs["epsg"] == 32632 and got.attrs["bin_units"] == "m"
    assert got["amp"].shape[-1] == 92
    assert nc.read_cube(str(tmp_path / "crs.nc")).attrs["epsg"] == 32632
    for crs in (4326, "EPSG:4326"):
        geo = pipe.BinningGeometry(spacing=(0.1, 0.2), crs=crs)
        assert geo.crs_attrs() == jpipe.BinningGeometry(
            spacing=(0.1, 0.2), crs=crs).crs_attrs()


def test_bin_cube_errors(survey, tmp_path):
    geom = _geometry(pipe.BinningGeometry, "average")
    with pytest.raises(FileNotFoundError):
        pipe.bin_cube(str(tmp_path), geom, device="cpu")
    with pytest.raises(ValueError, match="requires out_path"):
        pipe.bin_cube(survey, geom, out_of_core=True, device="cpu")
    with pytest.raises(ValueError, match="unknown stacking method"):
        pipe.bin_cube(survey, _geometry(pipe.BinningGeometry, "mode"),
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pipe.bin_cube(survey, geom)
    empty = pipe.bin_cube(survey, pipe.BinningGeometry(
        spacing=10.0, extent=(500.0, 520.0, 500.0, 520.0),
        stacking_method="median"), device="cpu")
    assert not empty["amp"].any() and not empty["fold"].any()
