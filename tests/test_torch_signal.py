"""The port's signal chain against the JAX package's on the same seeded
numpy inputs on the CPU: ``ops/signal.py`` (rms helpers, AGC rms / mean /
median, ``gain`` with each of its options, ``balance_traces``, envelope,
Fourier resampling, the frequency spectrum), ``ops/filters.py`` (the
Butterworth design, host ``sosfiltfilt`` and spectral application),
``utils/rescale.py`` and ``ops/metrics.py``.

Tolerances, against ``max|ref|``: ``TOL`` = 1e-5 for elementwise and
reduction arithmetic (float32 sums in another order); ``DFT_TOL`` = 1e-5
where the JAX side runs matmul DFTs and the port ``torch.fft`` (the
envelope, resampling, the spectral Butterworth, the spectrum): measured
below 2e-6 at these lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.ops import filters as jflt
from pseudo_3d_interpolation_tpu.ops import metrics as jmet
from pseudo_3d_interpolation_tpu.ops import signal as jsig
from pseudo_3d_interpolation_tpu.utils.rescale import rescale as jrescale
from pseudo_3d_interpolation_torch.ops import filters as flt
from pseudo_3d_interpolation_torch.ops import metrics as met
from pseudo_3d_interpolation_torch.ops import signal as sig
from pseudo_3d_interpolation_torch.utils import device as dev
from pseudo_3d_interpolation_torch.utils.rescale import rescale

torch.set_num_threads(2)

TOL = 1e-5
DFT_TOL = 1e-5
CPU = "cpu"


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, \
        np.abs(got - ref).max() / scale


def _traces(shape=(4, 6, 200), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _twt(n, t0=0.0, dt=1e-3):
    return t0 + np.arange(n) * dt


@pytest.mark.parametrize("axis", [None, -1, (0, 2)])
def test_rms_helpers_match_jax(axis):
    x = _traces()
    x[1, 2] = 0.0  # a dead trace: zero rms is left unscaled
    _close(sig.rms(x, axis=axis, device=CPU), jsig.rms(x, axis=axis))
    ax = -1 if axis is None else axis
    _close(sig.rms_normalization(x, axis=ax, device=CPU),
           jsig.rms_normalization(x, axis=ax))
    for scale in ("rms", "peak", "max"):
        _close(sig.calc_reference_amplitude(x, axis=ax, scale=scale,
                                            device=CPU),
               jsig.calc_reference_amplitude(x, axis=ax, scale=scale))
    with pytest.raises(ValueError, match="unknown scale"):
        sig.calc_reference_amplitude(x, scale="median", device=CPU)


@pytest.mark.parametrize("kind", ["rms", "mean", "median"])
@pytest.mark.parametrize("win", [11, 12, 51])
@pytest.mark.parametrize("squared", [False, True])
def test_agc_matches_jax(kind, win, squared):
    """An even window is bumped to odd; the median takes the middle of
    the odd window. The mean gain is for non-negative traces (envelopes):
    on zero-mean noise its gain crosses zero and the output is rounding
    amplified without bound in either package."""
    x = _traces((3, 5, 160), seed=win)
    if kind == "mean":
        x = np.abs(x)
    x[0, 0, 40:90] = 0.0  # zero gain cells pass through
    out, g = sig.agc(x, win, kind=kind, squared=squared, return_gain=True,
                     device=CPU)
    jout, jg = jsig.agc(x, win, kind=kind, squared=squared,
                        return_gain=True)
    _close(g, jg)
    _close(out, jout, 1e-4 if squared else TOL)
    assert sig.agc_window_samples(0.05, 1e-3) == \
        jsig.agc_window_samples(0.05, 1e-3) == 51


def test_agc_in_chunks_equals_one_chunk(monkeypatch):
    """The row chunks cut nothing: a budget of one row gives the same."""
    x = _traces((2, 3, 120), seed=7)
    whole = sig.agc(x, 21, kind="median", device=CPU)
    monkeypatch.setattr(sig, "map_rows", lambda fn, t, rb: dev.map_rows(
        fn, t, rb, budget=1))
    torch.testing.assert_close(sig.agc(x, 21, kind="median", device=CPU),
                               whole, rtol=0, atol=0)


def test_median_and_quantile_match_numpy_conventions():
    x = _traces((5, 64), seed=2)
    t = torch.from_numpy(x)
    # even count: the mean of the two middle values (torch.median differs)
    _close(sig.median(t, dim=-1), jnp.median(x, axis=-1))
    assert not torch.equal(sig.median(t, dim=-1), t.median(dim=-1).values)
    _close(sig.median(t[:, :63], dim=-1), np.median(x[:, :63], axis=-1))
    _close(sig.median(t.reshape(5, 8, 8), dim=(-2, -1)),
           np.median(x, axis=-1))
    for q in (0.0, 0.37, 0.9, 1.0):
        _close(sig.quantile(t, q, dim=-1, keepdim=True),
               jnp.quantile(x, q, axis=-1, keepdims=True))


GAINS = [
    pytest.param({"tpow": 2.0}, id="tpow"),
    pytest.param({"epow": 1.5}, id="epow"),
    pytest.param({"epow": 0.5, "etpow": 2.0, "ebase": 3.0}, id="ebase"),
    pytest.param({"gpow": 0.5}, id="gpow"),
    pytest.param({"agc_": True, "agc_win": 0.02}, id="agc-rms"),
    pytest.param({"agc_": True, "agc_win": 0.02, "agc_kind": "median",
                  "agc_sqrt": True}, id="agc-median-sqrt"),
    pytest.param({"clip": 1.2}, id="clip"),
    pytest.param({"pclip": 0.8, "nclip": -0.5}, id="pclip-nclip"),
    pytest.param({"qclip": 0.9}, id="qclip"),
    pytest.param({"linear": (0.5, 2.0)}, id="linear"),
    pytest.param({"pgc": {0.01: 1.0, 0.1: 3.0, 0.15: 0.5}}, id="pgc"),
    pytest.param({"bias": 0.3, "norm_rms": True}, id="bias-norm-rms"),
    pytest.param({"scale": 4.0, "norm": True}, id="scale-norm"),
    pytest.param({"tpow": 1.0, "qclip": 0.95, "norm_rms": True,
                  "scale": 2.0}, id="combined"),
]


@pytest.mark.parametrize("kw", GAINS)
def test_gain_matches_jax(kw):
    x = _traces((3, 4, 180), seed=11)
    twt = _twt(180)
    _close(sig.gain(x, twt, device=CPU, **kw), jsig.gain(x, twt, **kw),
           1e-4 if "agc_sqrt" in kw else TOL)


def test_programmed_gain_control_matches_jax():
    twt = _twt(100)
    spec = {0.05: 2.0, 0.0101: 1.0, 0.09: 0.5}
    np.testing.assert_array_equal(sig.programmed_gain_control(twt, spec),
                                  jsig.programmed_gain_control(twt, spec))


@pytest.mark.parametrize("scale", ["rms", "max", "mean", "median"])
@pytest.mark.parametrize("n_traces", [None, 3, 4])
def test_balance_traces_matches_jax(scale, n_traces):
    """Median over an even count of samples (64) is the mean of the two
    middle values."""
    x = _traces((2, 7, 64), seed=5)
    x[0, 3] = 0.0
    _close(sig.balance_traces(x, scale=scale, n_traces=n_traces,
                              device=CPU),
           jsig.balance_traces(x, scale=scale, n_traces=n_traces))


@pytest.mark.parametrize("n", [128, 129])
def test_envelope_matches_jax(n):
    x = _traces((3, 4, n), seed=n)
    _close(sig.envelope(x, device=CPU), jsig.envelope(x), DFT_TOL)


@pytest.mark.parametrize("n_in,n_out", [(128, 64), (128, 63), (129, 64),
                                        (11, 10), (64, 128), (63, 128),
                                        (64, 97), (100, 100)])
def test_resample_fft_matches_jax(n_in, n_out):
    """Down and up, odd and even on either side (scipy's Nyquist-bin
    conventions)."""
    x = _traces((3, 2, n_in), seed=n_in + n_out)
    _close(sig.resample_fft(x, n_out, device=CPU),
           jsig.resample_fft(x, n_out), DFT_TOL)
    np.testing.assert_array_equal(sig.resampled_twt(_twt(n_in), n_out, n_in),
                                  jsig.resampled_twt(_twt(n_in), n_out, n_in))


@pytest.mark.parametrize("taper", [True, False])
def test_freq_spectrum_matches_jax(taper):
    x = _traces((2, 3, 256), seed=9)
    f, a, lo, hi = sig.freq_spectrum(x, 1000.0, n=300, taper=taper,
                                     return_minmax=True, device=CPU)
    jf, ja, jlo, jhi = jsig.freq_spectrum(x, 1000.0, n=300, taper=taper,
                                          return_minmax=True)
    _close(f, jf, 0)
    _close(a, ja, DFT_TOL)
    assert (lo, hi) == (jlo, jhi)


@pytest.mark.parametrize("btype,cutoff", [("lowpass", 80.0),
                                          ("highpass", 20.0),
                                          ("bandpass", [15.0, 90.0])])
def test_butterworth_design_and_host_filter_match_jax(btype, cutoff):
    x = _traces((3, 300), seed=1)
    np.testing.assert_array_equal(
        flt.butterworth_design(btype, cutoff, 500.0, order=4),
        jflt.butterworth_design(btype, cutoff, 500.0, order=4))
    np.testing.assert_array_equal(
        flt.butterworth_filter(x, btype, cutoff, 500.0, order=4),
        jflt.butterworth_filter(x, btype, cutoff, 500.0, order=4))
    with pytest.raises(ValueError, match="btype"):
        flt.butterworth_design("notch", cutoff, 500.0)


@pytest.mark.parametrize("n", [300, 301, 40])
def test_butterworth_spectral_matches_jax(n):
    """Odd extension at both ends, |H|² in the rfft domain; a trace
    shorter than the pad clamps it to n - 1."""
    x = _traces((2, 3, n), seed=n)
    sos = flt.butterworth_design("bandpass", [15.0, 90.0], 500.0, order=6)
    _close(flt.butterworth_apply_spectral(x, sos, device=CPU),
           jflt.butterworth_apply_spectral(x, sos), DFT_TOL)


@pytest.mark.parametrize("kind,freqs", [
    ("lowpass", [60.0, 100.0]), ("highpass", [40.0, 10.0]),
    ("bandpass", [5.0, 15.0, 80.0, 120.0])])
@pytest.mark.parametrize("spectral", [False, True])
def test_filter_frequency_matches_jax(kind, freqs, spectral):
    x = _traces((3, 400), seed=3)
    got = flt.filter_frequency(x, freqs, 500.0, kind, spectral=spectral,
                               device=CPU)
    ref = jflt.filter_frequency(x, freqs, 500.0, kind, device=spectral)
    if spectral:
        assert isinstance(got, torch.Tensor)
        _close(got, ref, DFT_TOL)
    else:
        np.testing.assert_array_equal(got, ref)


def test_filter_frequency_rejects_bad_bands():
    x = _traces((2, 50))
    for kind, freqs in (("bandpass", [10, 5, 20, 30]), ("lowpass", [50, 20]),
                        ("highpass", [10, 20]), ("notch", [1, 2])):
        with pytest.raises(ValueError):
            flt.filter_frequency(x, freqs, 500.0, kind)


@pytest.mark.parametrize("kw", [{}, {"vmin": -1.0, "vmax": 3.0},
                                {"amin": -2.0, "amax": 2.0}])
def test_rescale_matches_jax(kw):
    x = _traces((5, 7), seed=4)
    x[1, 2] = np.nan
    got, ref = rescale(x, device=CPU, **kw), jrescale(x, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * np.nanmax(np.abs(ref)))
    assert torch.isnan(got[1, 2])
    flat = np.full((3, 3), 2.5, np.float32)
    np.testing.assert_array_equal(rescale(flat, device=CPU), flat)
    assert torch.isnan(rescale(np.full(3, np.nan, np.float32),
                               device=CPU)).all()


@pytest.mark.parametrize("axis", [None, -1])
def test_snr_psnr_match_jax(axis):
    x = _traces((4, 50), seed=1)
    y = x + 0.1 * _traces((4, 50), seed=2)
    _close(met.snr(x, y, axis=axis, device=CPU), jmet.snr(x, y, axis=axis))
    for peak in (1.0, None):
        _close(met.psnr(x, y, max_pixel=peak, axis=axis, device=CPU),
               jmet.psnr(x, y, max_pixel=peak, axis=axis))
    assert met.snr(x, x, device=CPU) == np.inf
    assert met.psnr(x, x, device=CPU) == np.inf
    zc = x + 1j * y
    _close(met.snr(torch.from_numpy(zc), torch.from_numpy(zc * 0.9)),
           jmet.snr(zc, zc * 0.9))
    _close(met.snr(zc, x, axis=axis, device=CPU), jmet.snr(zc, x, axis=axis))
    _close(met.psnr(zc, x, max_pixel=None, device=CPU),
           jmet.psnr(zc, x, max_pixel=None))
    # reversed and read-only views arrive as they are
    flipped = x[:, ::-1]
    flipped.flags.writeable = False
    _close(met.snr(flipped, y[:, ::-1], device=CPU),
           jmet.snr(flipped, y[:, ::-1]))


def test_immerkaer_noise_level_matches_jax():
    img = _traces((40, 33), seed=8)
    _close(met.immerkaer_noise_level(img, device=CPU),
           jmet.immerkaer_noise_level(img))


def test_ops_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """numpy input without a device goes to the first CUDA card, and
    raises without one; a tensor stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _traces((2, 64))
    for call in (lambda: sig.envelope(x), lambda: sig.agc(x, 5),
                 lambda: flt.filter_frequency(x, [10.0, 20.0], 500.0,
                                              "lowpass", spectral=True),
                 lambda: rescale(x), lambda: met.snr(x, x)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert sig.envelope(torch.from_numpy(x)).device.type == "cpu"
