"""The port's QC plotting library (``pseudo_3d_interpolation_torch.qc``)
against the JAX package's: every plotting function writes its figure,
and the arrays it plots where the port computes them (the RMS-normalized
sections, the spectra, on ``device='cpu'``) match JAX's to 1e-6 of their
largest value; ``p3d-torch qc`` writes the figures ``p3d qc`` writes."""

import os
import warnings

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pseudo_3d_interpolation_tpu import cli as jcli  # noqa: E402
from pseudo_3d_interpolation_tpu import qc as jqc  # noqa: E402
from pseudo_3d_interpolation_tpu.io.ncio import Cube, write_cube  # noqa: E402
from pseudo_3d_interpolation_torch import cli, qc  # noqa: E402
from torch_helpers import make_profile  # noqa: E402

torch.set_num_threads(2)

CPU = "cpu"
REL = 1e-6
FS = 4000.0
TWT = np.arange(200) * 0.25e-3


@pytest.fixture
def section():
    rng = np.random.default_rng(120)
    return rng.normal(size=(200, 60)).astype(np.float32)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def _images(fig):
    return [np.asarray(im.get_array()) for ax in fig.axes
            for im in ax.images]


def _lines(fig):
    return [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
            for ax in fig.axes for ln in ax.lines]


def _same_lines(fig, jfig):
    lines, jlines = _lines(fig), _lines(jfig)
    assert len(lines) == len(jlines) > 0
    for (x, y), (jx, jy) in zip(lines, jlines):
        _rel_close(x, jx)
        _rel_close(y, jy)


# ---------------------------------------------------------------------------
# the arrays the port computes, against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rms", True, "max", False])
def test_seismic_image_normalization_matches_jax(section, tmp_path, norm):
    fig = qc.plot_seismic_image(section, twt=TWT, norm=norm, device=CPU,
                                path=str(tmp_path / "img.png"))
    jfig = jqc.plot_seismic_image(section, twt=TWT, norm=norm)
    (img,), (jimg,) = _images(fig), _images(jfig)
    _rel_close(img, jimg)
    assert os.path.getsize(tmp_path / "img.png") > 1000


def test_seismic_difference_normalization_matches_jax(section, tmp_path):
    fig = qc.plot_seismic_difference(section, section * 0.5, norm="rms",
                                     device=CPU, path=str(tmp_path / "d.png"))
    jfig = jqc.plot_seismic_difference(section, section * 0.5, norm="rms")
    for img, jimg in zip(_images(fig), _images(jfig)):
        _rel_close(img, jimg)
    assert (tmp_path / "d.png").exists()


def test_seismic_wiggle_normalization_matches_jax(section, tmp_path):
    kw = dict(twt=TWT, norm=True, tr_step=4)
    fig = qc.plot_seismic_wiggle(section[:, :20], device=CPU,
                                 path=str(tmp_path / "w.png"), **kw)
    jfig = jqc.plot_seismic_wiggle(section[:, :20], **kw)
    _same_lines(fig, jfig)


def test_trace_and_average_spectra_match_jax(section, tmp_path):
    fig = qc.plot_trace_spectrum(section[:, 0], fs=FS, device=CPU,
                                 path=str(tmp_path / "sp1.png"))
    _same_lines(fig, jqc.plot_trace_spectrum(section[:, 0], fs=FS))
    fig = qc.plot_average_spectrum(section.T, fs=FS, n_traces=10,
                                   device=CPU, path=str(tmp_path / "sp2.png"))
    _same_lines(fig, jqc.plot_average_spectrum(section.T, fs=FS,
                                               n_traces=10))
    assert (tmp_path / "sp1.png").exists() and (tmp_path / "sp2.png").exists()


@pytest.mark.parametrize("norm", [False, True])
def test_frequency_spectrum_grids_match_jax(tmp_path, norm):
    """Reference plot.py:863 (per-trace grid) and :1067 (survey
    average)."""
    rng = np.random.default_rng(1)
    t = np.arange(400) / FS
    data = (np.sin(2 * np.pi * 300 * t)[None, :]
            + 0.1 * rng.normal(size=(6, 400))).astype(np.float32)
    p1 = str(tmp_path / "traces.png")
    fig = qc.plot_trace_freq_spectrum(data, FS, trace_labels=list("abcdef"),
                                      device=CPU, path=p1)
    _same_lines(fig, jqc.plot_trace_freq_spectrum(
        data, FS, trace_labels=list("abcdef")))
    p2 = str(tmp_path / "avg.png")
    fig = qc.plot_average_freq_spectrum(data, FS, norm=norm, device=CPU,
                                        path=p2)
    _same_lines(fig, jqc.plot_average_freq_spectrum(data, FS, norm=norm))
    assert os.path.getsize(p1) > 5000 and os.path.getsize(p2) > 5000


def test_spectra_need_a_card_unless_asked_for_the_cpu(section, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        qc.plot_trace_spectrum(section[:, 0], fs=FS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        qc.plot_seismic_image(section, norm="rms")


# ---------------------------------------------------------------------------
# the figures (the JAX package's QC tests)
# ---------------------------------------------------------------------------
def test_wiggle_and_statics_overlay(section, tmp_path):
    qc.plot_seismic_wiggle(section[:, :20], twt=TWT,
                           path=str(tmp_path / "wig.png"))
    horizon = 50 + 10 * np.sin(np.linspace(0, 3, 60))
    qc.plot_statics_overlay(section, horizon, static=np.ones(60), twt=TWT,
                            path=str(tmp_path / "sta.png"))
    assert (tmp_path / "wig.png").exists() and (tmp_path / "sta.png").exists()


def test_inversion_panels(tmp_path):
    rng = np.random.default_rng(121)
    x = (rng.normal(size=(32, 32))
         + 1j * rng.normal(size=(32, 32))).astype(np.complex64)
    fig = qc.plot_inversion_result(
        x * 0.5, x, metadata={"transform_kind": "FFT", "version": "fast",
                              "niterations": 42},
        path=str(tmp_path / "inv.png"))
    jfig = jqc.plot_inversion_result(
        x * 0.5, x, metadata={"transform_kind": "FFT", "version": "fast",
                              "niterations": 42})
    assert fig._suptitle.get_text() == jfig._suptitle.get_text()
    qc.plot_inversion_result(np.real(x) * 0.5, np.real(x),
                             path=str(tmp_path / "inv_real.png"))
    assert (tmp_path / "inv.png").exists()
    assert (tmp_path / "inv_real.png").exists()


def test_fold_map(tmp_path):
    fold = np.random.default_rng(122).integers(0, 5, (20, 15))
    fig = qc.plot_fold_map(fold, path=str(tmp_path / "fold.png"))
    assert fig.axes[0].get_title() == jqc.plot_fold_map(fold).axes[0] \
        .get_title()
    assert (tmp_path / "fold.png").exists()


def test_wiggle_diff_and_statics_panels(tmp_path):
    rng = np.random.default_rng(0)
    ns, ntr = 120, 24
    before = rng.normal(0, 0.1, (ns, ntr)).astype(np.float32)
    before[50:55] += 1.0
    after = np.roll(before, 2, axis=0)
    p1 = str(tmp_path / "wigdiff.png")
    qc.plot_seismic_wiggle_diff(before, after, twt=np.arange(ns) * 0.25e-3,
                                path=p1)
    p2 = str(tmp_path / "statics.png")
    qc.plot_statics_panels([before, after, after * 0.5],
                           titles=["raw", "static", "smoothed"], path=p2)
    assert os.path.getsize(p1) > 5000 and os.path.getsize(p2) > 5000


def test_plot_option_parity(tmp_path):
    """Reference option surface (plot.py:23-533): dt-or-twt axis, gain,
    norm='rms'/'max', env, reverse, traces/add_info labels, tr_step."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(64, 24)).astype(np.float32)
    qc.plot_seismic_image(data, dt=0.001, gain=2.0, norm="rms", env=True,
                          reverse=True, units="ms", show_colorbar=False,
                          device=CPU, path=str(tmp_path / "img.png"))
    qc.plot_seismic_difference(data, data[:, :20], dt=0.001, norm="max",
                               path=str(tmp_path / "diff.png"))
    traces = np.arange(100, 100 + 24)
    info = [f"d{k}" for k in range(24)]
    qc.plot_seismic_wiggle(data, dt=0.001, traces=traces, add_info=info,
                           gain=1.5, norm=True, tr_step=4, color="b",
                           device=CPU, path=str(tmp_path / "wig.png"))
    for name in ("img.png", "diff.png", "wig.png"):
        assert (tmp_path / name).exists()


def test_plot_iline_grid(tmp_path):
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(10, 16, 32)).astype(np.float32)
    fig = qc.plot_iline_grid(cube, twt=np.linspace(0, 0.5, 32),
                             path=str(tmp_path / "grid.png"))
    jfig = jqc.plot_iline_grid(cube, twt=np.linspace(0, 0.5, 32))
    for img, jimg in zip(_images(fig), _images(jfig)):
        np.testing.assert_array_equal(img, jimg)
    qc.plot_iline_grid(cube, ilines=[0, 4, 9],
                       path=str(tmp_path / "grid3.png"))
    assert (tmp_path / "grid.png").exists()
    assert (tmp_path / "grid3.png").exists()


def test_all_nan_section_renders(tmp_path):
    nan_sec = np.full((64, 16), np.nan, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        qc.plot_seismic_wiggle(nan_sec, dt=1e-3, path=str(tmp_path / "w.png"))
    assert (tmp_path / "w.png").exists()


def test_exports_the_jax_names():
    assert sorted(qc.__all__) == sorted(set(jqc.__all__)
                                        | {"plot_iline_grid"})
    for name in qc.__all__:
        assert callable(getattr(qc, name))


# ---------------------------------------------------------------------------
# p3d-torch qc against p3d qc
# ---------------------------------------------------------------------------
def _qc_both(argv, tmp_path):
    names = []
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", cli.main, ["--device", CPU])):
        out = tmp_path / f"qc_{pkg}"
        assert main(["qc", *argv, "--output-dir", str(out), "-V", "0"]
                    + extra) == 0
        names.append(sorted(p.name for p in out.iterdir()))
    assert names[0] == names[1]
    return names[1]


def test_cli_qc_of_a_profile_and_a_cube_matches_jax(tmp_path):
    p = str(tmp_path / "prof_UTM.sgy")
    make_profile(p, ntr=20, ns=64)
    names = _qc_both([p], tmp_path)
    assert any("image" in n for n in names)
    assert any("spectrum" in n for n in names)
    c = Cube(
        coords={"iline": np.arange(1, 5), "xline": np.arange(1, 5),
                "twt": np.arange(16) * 0.25e-3},
        data_vars={"amp": (("iline", "xline", "twt"),
                           np.random.default_rng(0).normal(
                               size=(4, 4, 16)).astype(np.float32)),
                   "fold": (("iline", "xline"), np.ones((4, 4), np.int32))})
    cp = str(tmp_path / "cube.nc")
    write_cube(cp, c)
    names = _qc_both([cp], tmp_path / "c")
    assert any("fold" in n for n in names)


def test_cli_qc_compare_matches_jax(tmp_path):
    """--compare writes before/after/difference panels of the shared
    iline, as p3d qc does."""
    rng = np.random.default_rng(0)
    coords = {"iline": np.arange(8, dtype=np.int32),
              "xline": np.arange(10, dtype=np.int32),
              "twt": np.arange(32, dtype=np.float64) * 1e-3}
    a = rng.normal(size=(8, 10, 32)).astype(np.float32)
    for name, arr in [("a", a), ("b", a * 0.5)]:
        write_cube(str(tmp_path / f"{name}.nc"), Cube(
            coords=dict(coords),
            data_vars={"amp": (("iline", "xline", "twt"), arr)}))
    names = _qc_both([str(tmp_path / "a.nc"), "--compare",
                      str(tmp_path / "b.nc")], tmp_path)
    assert "a_vs_b_il4.png" in names
    assert any("wiggle" in n for n in names)
