"""Stage 2 of the port against the JAX package's: the ``preprocess`` and
``postprocess`` steps and their helpers (kx-ky filters, linear and scipy
upsampling, gaussian and median smoothing), the file half of
``interpolate``, and the whole chain preprocess -> fft -> interpolate ->
ifft -> postprocess through cube files, on the same seeded cube on the
CPU. The JAX solve runs its fused Pallas kernel in interpret mode
(``use_pallas``, ``pallas_interpret``) on a one-device mesh.

Tolerances, against ``max|ref|``: ``TOL`` = 1e-5 for the steps (the JAX
side's matmul DFTs against ``torch.fft``, float32 sums in another order,
at most 3e-6 measured); ``CHAIN_TOL`` = 1e-4 for the whole chain with a
soft threshold (the solve's 10 iterations and the AGC's division by the
moving rms carry the steps' differences along); the production hard
threshold flips coefficients at the threshold under reordered arithmetic,
so that chain is held by SNR against the truth within ``SNR_TOL_DB``."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.io.ncio import read_cube as jread_cube
from pseudo_3d_interpolation_tpu.io.ncio import write_cube as jwrite_cube
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import postprocess as jpost
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpocs
from pseudo_3d_interpolation_tpu.pipeline.fft import apply_fft as japply_fft
from pseudo_3d_interpolation_tpu.pipeline.ifft import apply_ifft as japply_ifft
from pseudo_3d_interpolation_tpu.pipeline.preprocess import \
    preprocess as jpreprocess
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.io.ncio import read_cube, write_cube
from pseudo_3d_interpolation_torch.models.pocs import (TPU_ONLY_FIELDS,
                                                       POCSConfig)
from pseudo_3d_interpolation_torch.pipeline import postprocess as post
from pseudo_3d_interpolation_torch.pipeline import preprocess as pre
from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

torch.set_num_threads(2)

TOL = 1e-5
CHAIN_TOL = 1e-4
SNR_TOL_DB = 0.1
CPU = "cpu"
DT = 0.25e-3  # 4 kHz sampling, the sub-bottom profiler band
BANDPASS = [30.0, 80.0, 700.0, 1200.0]


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, \
        np.abs(got - ref).max() / scale


def dense_truth(n_il=32, n_xl=32, ns=128, dt=DT, noise=0.01, seed=0):
    """Dipping band-limited reflectors (tests/test_pipeline_3d.py's
    ``dense_truth`` with steeper dips) over a noise floor: real records
    are never silent, and the AGC divides by the moving rms."""
    il = np.arange(n_il)[:, None]
    xl = np.arange(n_xl)[None, :]
    t = np.arange(ns) * dt
    cube = np.zeros((n_il, n_xl, ns), np.float32)
    for t0, amp, f0 in [(6e-3, 1.0, 300.0), (1.4e-2, -0.7, 250.0),
                        (2.4e-2, 0.5, 200.0)]:
        tt = t0 + 2e-3 * (il / n_il) + 1.5e-3 * (xl / n_xl)
        arg = (t[None, None, :] - tt[..., None]) * f0
        cube += amp * np.exp(-(arg**2) * 8).astype(np.float32) * np.cos(
            2 * np.pi * arg).astype(np.float32)
    cube += noise * np.random.default_rng(seed).standard_normal(
        cube.shape).astype(np.float32)
    return cube, t


def _decimated(truth, seed=123, keep=0.5):
    """About ``keep`` of the ilines, chosen irregularly (the first and
    last kept): the decimation POCS is for."""
    n_il, n_xl = truth.shape[:2]
    rng = np.random.default_rng(seed)
    rows = set([0, n_il - 1]) | set(int(i) for i in rng.choice(
        n_il, size=int(n_il * keep), replace=False))
    fold = np.zeros((n_il, n_xl), np.int32)
    fold[sorted(rows)] = 1
    return truth * fold[..., None], fold


def _cubes(amp, twt, fold=None, attrs=None):
    """The same time cube for both packages (fresh arrays: steps change
    cubes in place)."""
    n_il, n_xl = amp.shape[:2]
    coords = {"iline": np.arange(n_il), "xline": np.arange(n_xl) + 1000,
              "twt": np.asarray(twt, np.float64)}

    def make(cls):
        dv = {"amp": (("iline", "xline", "twt"), amp.copy())}
        if fold is not None:
            dv["fold"] = (("iline", "xline"), fold.copy())
        return cls(coords={k: v.copy() for k, v in coords.items()},
                   data_vars=dv, attrs=dict(attrs or {"history": "BIN;"}))
    return make(JCube), make(Cube)


PREPROCESS = [
    pytest.param({"balance": "rms"}, id="balance-rms"),
    pytest.param({"balance": "max", "balance_store_ref": False},
                 id="balance-max"),
    pytest.param({"gain_args": {"tpow": 1.0, "qclip": 0.98}}, id="gain"),
    pytest.param({"gain_args": {"agc_": True, "agc_win": 0.004},
                  "gain_use_samples": True}, id="gain-agc-samples"),
    pytest.param({"filter_type": "bandpass", "filter_freqs": BANDPASS},
                 id="bandpass"),
    pytest.param({"filter_type": "lowpass", "filter_freqs": [600.0, 900.0]},
                 id="lowpass"),
    pytest.param({"resample_to": 96}, id="resample-down"),
    pytest.param({"resample_interval_ms": 0.125}, id="resample-up"),
    pytest.param({"resample_factor": 2, "resample_method": "poly",
                  "resample_window": "kaiser"}, id="resample-poly"),
    pytest.param({"envelope": True}, id="envelope"),
    pytest.param({"balance": "rms", "gain_args": {"norm_rms": True},
                  "filter_type": "bandpass", "filter_freqs": BANDPASS,
                  "resample_frequency_hz": 2000.0, "envelope": True},
                 id="chain"),
]


@pytest.mark.parametrize("kw", PREPROCESS)
def test_preprocess_matches_jax(kw):
    truth, twt = dense_truth(n_il=6, n_xl=5)
    amp, fold = _decimated(truth, keep=0.6)
    jc, c = _cubes(amp, twt, fold)
    jout, out = jpreprocess(jc, **kw), pre.preprocess(c, device=CPU, **kw)
    assert out is c
    assert list(out.data_vars) == list(jout.data_vars)
    for k, (dims, ref) in jout.data_vars.items():
        assert out.dims_of(k) == dims
        assert out[k].dtype == ref.dtype, k
        _close(out[k], ref)
    np.testing.assert_allclose(out.coords["twt"], jout.coords["twt"],
                               rtol=0, atol=1e-12)
    assert out.attrs == jout.attrs


def test_preprocess_attrs_config_and_file(tmp_path):
    truth, twt = dense_truth(n_il=4, n_xl=3)
    jc, c = _cubes(truth, twt)
    cfg = {"attrs_time": {"cube": {"title": "t"}, "amp": {"units": "u"}}}
    jpreprocess(jc, balance="rms", attrs_config=cfg,
                out_path=str(tmp_path / "j.nc"))
    pre.preprocess(c, balance="rms", attrs_config=cfg,
                   out_path=tmp_path / "p.nc", device=CPU)
    a, b = jread_cube(str(tmp_path / "j.nc")), jread_cube(
        str(tmp_path / "p.nc"))
    assert a.attrs == b.attrs and a.attrs["title"] == "t"
    assert b.var_attrs["amp"]["units"] == "u"
    _close(b.data_vars["amp"][1], a.data_vars["amp"][1])
    _close(b.data_vars["amp_ref"][1], a.data_vars["amp_ref"][1])


def test_preprocess_rejects_bad_input():
    truth, twt = dense_truth(n_il=2, n_xl=2)
    _, c = _cubes(truth, twt)
    with pytest.raises(ValueError, match="filter_freqs"):
        pre.preprocess(c, filter_type="lowpass", device=CPU)
    c.data_vars["amp"] = (("twt", "iline", "xline"), c["amp"])
    with pytest.raises(ValueError, match="time-last"):
        pre.preprocess(c, device=CPU)


def _time_cube(n_il=12, n_xl=10, ns=64, seed=0):
    truth, twt = dense_truth(n_il=n_il, n_xl=n_xl, ns=ns, seed=seed)
    return truth, twt


POSTPROCESS = [
    pytest.param({"upsample_factors": {"iline": 2, "xline": 2},
                  "footprint": {}, "smoothing": {"kind": "gaussian",
                                                 "sigma": 1},
                  "agc_win": 0.005}, id="chain"),
    pytest.param({"upsample_factors": {"iline": 2}}, id="iline-antialias"),
    pytest.param({"upsample_factors": {"xline": 3}, "antialias": False},
                 id="xline-no-antialias"),
    pytest.param({"upsample_factors": "auto"}, id="auto"),
    pytest.param({"upsample_factors": {"iline": 2},
                  "upsample_method": "cubic"}, id="cubic"),
    pytest.param({"footprint": {"sigma": 3, "direction": "iline",
                                "buffer_center": 0.4}}, id="footprint"),
    pytest.param({"smoothing": {"kind": "median", "size": 4}}, id="median"),
    pytest.param({"smoothing": {"kind": "gaussian", "sigma": 1.5,
                                "rescale_percentiles": [2, 98]}},
                 id="smooth-rescale"),
    pytest.param({"agc_win": 0.004, "agc_kind": "median", "agc_sqrt": True},
                 id="agc-median-sqrt"),
    pytest.param({"upsample_factors": {"iline": 1, "xline": 1}}, id="ones"),
]


@pytest.mark.parametrize("kw", POSTPROCESS)
def test_postprocess_matches_jax(kw):
    truth, twt = _time_cube()
    fold = np.ones(truth.shape[:2], np.int32)
    attrs = {"history": "IFFT;", "bin_size_iline": 2.0,
             "bin_size_xline": 1.0}
    jc, c = _cubes(truth, twt, fold, attrs)
    jout = jpost.postprocess(jc, **kw)
    out = post.postprocess(c, device=CPU, **kw)
    assert out is c
    assert list(out.data_vars) == list(jout.data_vars)
    assert out["amp"].dtype == np.float32
    _close(out["amp"], jout.data_vars["amp"][1],
           1e-4 if kw.get("agc_sqrt") else TOL)
    for d in jout.coords:
        np.testing.assert_array_equal(out.coords[d], jout.coords[d])
    assert out.attrs == jout.attrs


@pytest.mark.parametrize("sigma,n,orient", [(7, None, "equal"),
                                            (3, (10, 11), "iline"),
                                            (2, 9, "xline")])
def test_filter_construction_matches_jax(sigma, n, orient):
    np.testing.assert_array_equal(
        post.gaussian_kernel_2d(sigma, n, orientation=orient),
        jpost.gaussian_kernel_2d(sigma, n, orientation=orient))
    for kw in ({}, {"direction": "xline", "sigma": 3},
               {"buffer_center": 0.99}):
        np.testing.assert_allclose(post.footprint_filter(40, 33, **kw),
                                   jpost.footprint_filter(40, 33, **kw),
                                   rtol=0, atol=1e-6)
    for direction, factors in (("iline", {"iline": 2}),
                               ("xline", {"xline": 3, "iline": 1})):
        np.testing.assert_allclose(
            post.antialias_filter(41, 37, direction, factors),
            jpost.antialias_filter(41, 37, direction, factors),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 16, 20), (2, 15, 17)])
def test_apply_kxky_filter_matches_jax(shape):
    """The real part of the full complex product, computed on the rfft2
    half spectrum with the filter's even part."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ff = post.footprint_filter(*shape[-2:], sigma=2)
    ff = ff * np.random.default_rng(2).uniform(0.5, 1.0, ff.shape).astype(
        np.float32)  # no symmetry at all
    _close(post.apply_kxky_filter(x, ff, device=CPU),
           jpost.apply_kxky_filter(x, ff))


@pytest.mark.parametrize("fy,fx", [(2, 2), (1, 3), (4, 1), (2, 5)])
@pytest.mark.parametrize("method", ["linear", "nearest", "cubic"])
def test_upsample_slices_matches_jax(fy, fx, method):
    x = np.random.default_rng(fy * 7 + fx).standard_normal(
        (3, 9, 13)).astype(np.float32)
    got = post.upsample_slices_linear(x, fy, fx, method=method, device=CPU)
    ref = jpost.upsample_slices_linear(x, fy, fx, method=method)
    if method == "linear":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    else:
        _close(got, ref)
    # every original sample stays on the grid, to the float32 rounding of
    # the positions (JAX's own grid puts 5·k at 5·k ± a few ulps)
    np.testing.assert_allclose(got[:, ::fy, ::fx].numpy(), x, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n", [2, 9, 513, 1023])
def test_linspace_positions_are_jax_float32_grid(n):
    import jax.numpy as jnp

    np.testing.assert_array_equal(post._linspace_f32(n - 1.0, 2 * n - 1),
                                  np.asarray(jnp.linspace(0.0, n - 1.0,
                                                          2 * n - 1)))


@pytest.mark.parametrize("n,r", [(5, 2), (4, 7), (1, 3), (9, 8)])
def test_reflect_index_matches_numpy_pad(n, r):
    a = np.arange(n)
    np.testing.assert_array_equal(a[post._reflect_index(n, r)],
                                  np.pad(a, r, mode="reflect"))


@pytest.mark.parametrize("kw", [{"kind": "gaussian", "sigma": 1.0},
                                {"kind": "gaussian", "sigma": 2.0},
                                {"kind": "median", "size": 3},
                                {"kind": "median", "size": 4},
                                {"kind": "median", "size": 3,
                                 "rescale_percentiles": [5, 95]}])
def test_smooth_slices_matches_jax(kw):
    x = np.random.default_rng(3).standard_normal((4, 6, 8)).astype(np.float32)
    _close(post.smooth_slices(x, device=CPU, **kw),
           jpost.smooth_slices(x, **kw))
    with pytest.raises(ValueError, match="gaussian"):
        post.smooth_slices(x, kind="box", device=CPU)


@pytest.mark.parametrize("attrs,want", [
    ({"bin_size_iline": 4.0, "bin_size_xline": 2.0}, {"iline": 2}),
    ({"bin_size_iline": 1.0, "bin_size_xline": 3.0}, {"xline": 3}),
    ({"bin_size": 2.0}, {}), ({}, None), ({"bin_size_iline": 1.0,
                                           "bin_size_xline": 2.5}, None)])
def test_equal_bin_factors_match_jax(attrs, want):
    cube = Cube(coords={}, data_vars={}, attrs=dict(attrs))
    jcube = JCube(coords={}, data_vars={}, attrs=dict(attrs))
    if want is None:
        with pytest.raises(ValueError):
            post.equal_bin_factors(cube)
        with pytest.raises(ValueError):
            jpost.equal_bin_factors(jcube)
    else:
        assert post.equal_bin_factors(cube) == jpost.equal_bin_factors(
            jcube) == want


def _config(thresh_op, niter):
    """The production defaults with ``thresh_op`` and ``niter``; the
    TPU-only keys steer the JAX side onto its fused kernel in interpret
    mode and are ignored by the port."""
    meta = dict(niter=niter, thresh_op=thresh_op, thresh_model="exponential",
                p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
                use_pallas=True, pallas_interpret=True)
    if thresh_op == "soft":
        meta["precision"] = "highest"
    return {"metadata": meta}


def _run_chain(pkg, src, tmp, config, truth_pp=None):
    """preprocess -> fft -> interpolate -> ifft -> postprocess, each step
    reading the previous step's file and writing its own."""
    steps = {"jax": (jpreprocess, japply_fft, jpocs.interpolate,
                     japply_ifft, jpost.postprocess),
             "port": (pre.preprocess, apply_fft, interpolate, apply_ifft,
                      post.postprocess)}[pkg]
    p, f, i, b, q = steps
    kw = {"device": CPU} if pkg == "port" else {}
    names = [str(tmp / f"{pkg}_{s}.nc")
             for s in ("pre", "fft", "pocs", "ifft", "post")]
    p(str(src), balance="rms", filter_type="bandpass",
      filter_freqs=BANDPASS, out_path=names[0], **kw)
    f(names[0], out_path=names[1], **kw)
    i(names[1], config=config, batch=8, out_path=names[2],
      **(kw or {"mesh": make_mesh(1)}))
    b(names[2], out_path=names[3], **kw)
    q(names[3], upsample_factors={"iline": 2, "xline": 2}, footprint={},
      smoothing={"kind": "gaussian", "sigma": 1}, agc_win=0.005,
      out_path=names[4], **kw)
    return [jread_cube(n) for n in names]


def _snr(ref, x):
    return 10 * np.log10(np.sum(ref**2) / np.sum((ref - x) ** 2))


@pytest.fixture(scope="module")
def chain_input(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    truth, twt = dense_truth()
    amp, fold = _decimated(truth)
    jc, _ = _cubes(amp, twt, fold)
    jwrite_cube(str(tmp / "binned.nc"), jc)
    # the truth through the same preprocess: the reference of the SNRs
    tc, _ = _cubes(truth, twt, np.ones_like(fold))
    truth_pp = jpreprocess(tc, balance="rms", filter_type="bandpass",
                           filter_freqs=BANDPASS).data_vars["amp"][1]
    return tmp, truth_pp


def test_chain_through_files_matches_jax_with_a_soft_threshold(chain_input):
    tmp, truth_pp = chain_input
    jsteps = _run_chain("jax", tmp / "binned.nc", tmp, _config("soft", 10))
    steps = _run_chain("port", tmp / "binned.nc", tmp, _config("soft", 10))
    for name, js, s in zip(("pre", "fft", "pocs", "ifft", "post"), jsteps,
                           steps):
        assert sorted(s.data_vars) == sorted(js.data_vars), name
        var = s.primary_var()
        assert js.primary_var() == var
        _close(s.data_vars[var][1], js.data_vars[var][1], CHAIN_TOL)
        assert s.attrs["history"] == js.attrs["history"]
        assert s.var_attrs.get(var) == js.var_attrs.get(var), name
    post_cube = steps[-1].data_vars["amp"][1]
    assert post_cube.shape == (63, 63, 128)
    assert np.isfinite(post_cube).all()
    masked = read_cube(tmp / "port_pre.nc")["amp"]
    assert _snr(truth_pp, steps[3]["amp"]) > _snr(truth_pp, masked) + 3.0


def test_chain_at_the_production_hard_threshold_matches_jax_snr(chain_input):
    tmp, truth_pp = chain_input
    prod = _config("hard", 50)
    jsteps = _run_chain("jax", tmp / "binned.nc", tmp, prod)
    steps = _run_chain("port", tmp / "binned.nc", tmp, prod)
    s_j = _snr(truth_pp, jsteps[3].data_vars["amp"][1])
    s_p = _snr(truth_pp, steps[3].data_vars["amp"][1])
    s_in = _snr(truth_pp, read_cube(tmp / "port_pre.nc")["amp"])
    assert abs(s_p - s_j) < SNR_TOL_DB, (s_p, s_j)
    assert s_p > s_in + 3.0
    assert steps[-1].data_vars["amp"][1].shape == (63, 63, 128)
    assert np.isfinite(steps[-1].data_vars["amp"][1]).all()
    # the parameter file beside the output: every field, readable by both
    with open(tmp / "port_pocs_parameter.yml") as fh:
        meta = yaml.safe_load(fh)["metadata"]
    with open(tmp / "jax_pocs_parameter.yml") as fh:
        jmeta = yaml.safe_load(fh)["metadata"]
    assert meta == {k: v for k, v in jmeta.items()
                    if k not in TPU_ONLY_FIELDS}
    cfg, _ = jpocs.config_from_yaml(str(tmp / "port_pocs_parameter.yml"))
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in TPU_ONLY_FIELDS} == meta


def test_interpolate_profile_dir_and_path_input(tmp_path):
    truth, twt = dense_truth(n_il=8, n_xl=8, ns=16)
    amp, fold = _decimated(truth)
    _, c = _cubes(amp, twt, fold)
    freq = apply_fft(c, device=CPU)
    write_cube(tmp_path / "f.nc", freq)
    cfg = POCSConfig(niter=3)
    prof = tmp_path / "prof"
    out = interpolate(tmp_path / "f.nc", config=cfg, profile_dir=str(prof),
                      out_path=str(tmp_path / "i.nc"), device=CPU)
    assert (prof / "interpolate_trace.json").stat().st_size > 0
    back = read_cube(tmp_path / "i.nc")
    np.testing.assert_array_equal(back["freq_amp_interp"],
                                  out["freq_amp_interp"])
    assert os.path.exists(tmp_path / "i_parameter.yml")


def test_steps_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truth, twt = dense_truth(n_il=4, n_xl=4, ns=16)
    _, c = _cubes(truth, twt, np.ones((4, 4), np.int32))
    freq = apply_fft(c, device=CPU)
    calls = {"preprocess": lambda: pre.preprocess(c, balance="rms"),
             "apply_fft": lambda: apply_fft(c),
             "interpolate": lambda: interpolate(freq, config=POCSConfig(
                 niter=2)),
             "apply_ifft": lambda: apply_ifft(freq),
             "postprocess": lambda: post.postprocess(c)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert apply_ifft(freq, device=CPU)["amp"].shape == (4, 4, 16)


@pytest.mark.parametrize("step", ["preprocess", "postprocess"])
def test_out_of_core_raises_instead_of_loading(tmp_path, step):
    """Streaming needs a file in and a file out: an in-memory cube with
    ``out_of_core=True`` raises (as in the JAX package) before anything
    runs; a path input above the threshold streams into ``out_path`` and
    returns it, with the in-memory step's cube."""
    truth, twt = dense_truth(n_il=4, n_xl=4, ns=16)
    _, c = _cubes(truth, twt, np.ones((4, 4), np.int32))
    write_cube(tmp_path / "t.nc", c)
    fn = {"preprocess": pre.preprocess, "postprocess": post.postprocess}[step]
    kw = ({"upsample_factors": {"iline": 2}} if step == "postprocess"
          else {})
    with pytest.raises(ValueError, match="requires a path input"):
        fn(c, out_of_core=True, device=CPU)
    with pytest.raises(ValueError, match="requires a path input"):
        fn(str(tmp_path / "t.nc"), out_of_core=True, device=CPU)
    assert not os.path.exists(tmp_path / "o.nc")
    streamed = fn(str(tmp_path / "t.nc"), out_path=str(tmp_path / "s.nc"),
                  ooc_threshold_bytes=100, device=CPU, **kw)
    assert streamed == str(tmp_path / "s.nc")
    # under the threshold the path runs in memory
    out = fn(str(tmp_path / "t.nc"), out_path=str(tmp_path / "o.nc"),
             device=CPU, **kw)
    assert read_cube(tmp_path / "o.nc")["amp"].shape == out["amp"].shape
    np.testing.assert_array_equal(read_cube(streamed)["amp"], out["amp"])
