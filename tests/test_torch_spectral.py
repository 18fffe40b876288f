"""The port's time-axis transforms against the JAX package's: the 1-D DFTs
of ``ops/dft.py``, ``ops/spectral.py`` (odd lengths, upsampling, the
filter window, dropped bins, the full-fft layout) and the ``apply_fft`` /
``apply_ifft`` steps, on the same seeded numpy inputs on the CPU.

Tolerance: the JAX 1-D transforms are matmul DFTs at HIGHEST precision,
the port's ``torch.fft``; their float32 sums differ in order, by about
1e-6 of the largest value at these lengths. Held within
``DFT_TOL·max|ref|``. Host-built values (frequencies, windows, twt) are
equal."""

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.ops import dft as jdft
from pseudo_3d_interpolation_tpu.ops import spectral as jspec
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.pipeline.fft import apply_fft as japply_fft
from pseudo_3d_interpolation_tpu.pipeline.ifft import apply_ifft as japply_ifft
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.ops import dft, spectral
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft

torch.set_num_threads(2)

DFT_TOL = 1e-5


def _close(got, ref, tol=DFT_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _pair(z):
    """A Cplx of either package -> complex numpy."""
    re, im = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
              for v in z)
    return re + 1j * im


def _traces(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [64, 65, 96, 101])
@pytest.mark.parametrize("pad", [None, 160])
def test_rfft1_irfft1_match_jax(n, pad):
    x = _traces((3, 5, n))
    spec = dft.rfft1(torch.from_numpy(x), n=pad)
    jspec1 = jdft.rfft1(x, n=pad)
    _close(_pair(spec), _pair(jspec1))
    m = pad or n
    back = dft.irfft1(spec, n=m)
    _close(back, jdft.irfft1(jspec1, n=m))
    # the DC bin's imaginary part does not contribute on either side
    z = Cplx(spec.re.clone(), spec.im.clone())
    z.im[..., 0] = 5.0
    _close(dft.irfft1(z, n=m), jdft.irfft1(jspec1, n=m))


@pytest.mark.parametrize("axis", [-1, 1])
def test_fft1_ifft1_match_jax(axis):
    re, im = _traces((4, 48, 6)), _traces((4, 48, 6), 1)
    z = Cplx(torch.from_numpy(re), torch.from_numpy(im))
    jz = JCplx(re, im)
    f = dft.fft1(z, axis=axis)
    _close(_pair(f), _pair(jdft.fft1(jz, axis=axis)))
    _close(_pair(dft.ifft1(f, axis=axis)), re + 1j * im)
    _close(_pair(dft.ifft1(z, axis=axis)), _pair(jdft.ifft1(jz, axis=axis)))


def _twt(n, t0=0.012, dt=0.5e-3):
    return t0 + np.arange(n) * dt


@pytest.mark.parametrize("n", [128, 129])
@pytest.mark.parametrize("upsample", [1, 2, 3])
def test_forward_inverse_fft_match_jax(n, upsample):
    """Odd lengths drop their last sample; upsampling zero-pads time; the
    true-amplitude, true-phase rotation and its inverse."""
    x = _traces((4, 3, n))
    twt = _twt(n)
    s = spectral.forward_fft(x, twt, upsample=upsample, device="cpu")
    js = jspec.forward_fft(x, twt, upsample=upsample)
    assert (s.nfft, s.n_time, s.t0, s.dt, s.real) == \
        (js.nfft, js.n_time, js.t0, js.dt, js.real)
    assert s.n_time == n - n % 2 and s.nfft == upsample * s.n_time
    np.testing.assert_array_equal(s.freqs, js.freqs)
    _close(_pair(s.data), _pair(js.data))
    twt_up, back = spectral.inverse_fft(s)
    jtwt_up, jback = jspec.inverse_fft(js)
    np.testing.assert_array_equal(twt_up, jtwt_up)
    _close(back, jback)
    twt_o, orig = spectral.inverse_fft_original(s)
    np.testing.assert_array_equal(twt_o, twt[: s.n_time])
    _close(orig, x[..., : s.n_time])


def test_full_fft_layout_matches_jax():
    n = 64
    re, im = _traces((2, 3, n)), _traces((2, 3, n), 5)
    twt = _twt(n)
    s = spectral.forward_fft(Cplx(torch.from_numpy(re), torch.from_numpy(im)),
                             twt, real=False, upsample=2)
    js = jspec.forward_fft(JCplx(re, im), twt, real=False, upsample=2)
    np.testing.assert_array_equal(s.freqs, js.freqs)
    _close(_pair(s.data), _pair(js.data))
    _, xc = spectral.inverse_fft(s, full_complex=True)
    _close(_pair(xc)[..., :n], re + 1j * im)
    _, x = spectral.inverse_fft(s)
    _close(x, np.asarray(jspec.inverse_fft(js)[1]))
    with pytest.raises(ValueError, match="real=True"):
        spectral.forward_fft(Cplx(torch.zeros(2, 4), torch.zeros(2, 4)),
                             _twt(4))
    with pytest.raises(ValueError, match="positive integer"):
        spectral.forward_fft(_traces((2, 8)), _twt(8), upsample=1.5,
                             device="cpu")


@pytest.mark.parametrize("kind,freqs", [
    ("lowpass", [200.0, 400.0]), ("highpass", [100.0, 300.0]),
    ("bandpass", [50.0, 150.0, 500.0, 700.0])])
def test_freq_filter_window_matches_jax(kind, freqs):
    f = np.fft.rfftfreq(256, 0.5e-3)
    np.testing.assert_array_equal(spectral.freq_filter_window(f, freqs, kind),
                                  jspec.freq_filter_window(f, freqs, kind))
    ff = np.fft.fftfreq(256, 0.5e-3)
    np.testing.assert_array_equal(spectral.freq_filter_window(ff, freqs,
                                                              kind),
                                  jspec.freq_filter_window(ff, freqs, kind))


@pytest.mark.parametrize("drop", [False, True])
def test_apply_freq_filter_and_dropped_bins_match_jax(drop):
    n = 200
    x = _traces((3, 4, n))
    twt = _twt(n)
    s = spectral.apply_freq_filter(
        spectral.forward_fft(x, twt, device="cpu"), [150.0, 300.0],
        drop_filtered=drop)
    js = jspec.apply_freq_filter(jspec.forward_fft(x, twt), [150.0, 300.0],
                                 drop_filtered=drop)
    np.testing.assert_array_equal(s.freqs, js.freqs)
    assert s.data.shape[-1] == js.data.shape[-1] < (101 if drop else 102)
    _close(_pair(s.data), _pair(js.data))
    # the dropped bins come back as zeros: the same as the windowed signal
    _close(spectral.inverse_fft_original(s)[1],
           jspec.inverse_fft_original(js)[1])
    if drop:
        with pytest.raises(ValueError, match="lowpass"):
            spectral.apply_freq_filter(s, [1, 2, 3, 4], "bandpass",
                                       drop_filtered=True)


def _cubes(n_il=6, n_xl=5, n=129, seed=3):
    amp = _traces((n_il, n_xl, n), seed)
    fold = (np.random.default_rng(seed).uniform(size=(n_il, n_xl)) < 0.6
            ).astype(np.int32)
    coords = {"iline": np.arange(n_il), "xline": np.arange(n_xl) + 100,
              "twt": _twt(n)}
    dv = {"amp": (("iline", "xline", "twt"), amp),
          "fold": (("iline", "xline"), fold)}
    attrs = {"history": "BIN;"}
    return (JCube(coords=dict(coords), data_vars=dict(dv), attrs=dict(attrs)),
            Cube(coords=dict(coords), data_vars=dict(dv), attrs=dict(attrs)))


@pytest.mark.parametrize("kw", [
    {}, {"upsample": 2},
    {"filter_type": "lowpass", "filter_freqs": [300.0, 500.0],
     "drop_filtered": True},
    {"filter_type": "bandpass", "filter_freqs": [20.0, 60.0, 400.0, 600.0]}],
    ids=["plain", "upsample", "lowpass-drop", "bandpass"])
def test_apply_fft_and_ifft_match_jax(kw):
    jc, c = _cubes()
    jf, f = japply_fft(jc, **kw), apply_fft(c, device="cpu", **kw)
    assert list(f.data_vars) == list(jf.data_vars) == ["freq_amp", "fold"]
    assert f.var_attrs == jf.var_attrs
    assert f.coord_attrs == jf.coord_attrs
    assert f.attrs == jf.attrs
    np.testing.assert_array_equal(f.coords["freq_twt"],
                                  jf.coords["freq_twt"])
    assert f.dims_of("freq_amp") == jf.dims_of("freq_amp")
    got, ref = f["freq_amp"], jf.data_vars["freq_amp"][1]
    assert got.dtype == ref.dtype == np.complex64
    _close(got, ref)
    assert f["fold"] is c["fold"]

    ji, i = japply_ifft(jf), apply_ifft(f, device="cpu")
    assert list(i.data_vars) == list(ji.data_vars) == ["amp", "fold"]
    assert i.attrs == ji.attrs and i.coord_attrs == ji.coord_attrs
    np.testing.assert_array_equal(i.coords["twt"], ji.coords["twt"])
    assert i["amp"].dtype == np.float32
    _close(i["amp"], ji.data_vars["amp"][1])
    if not kw:
        _close(i["amp"], c["amp"][..., :128])


def test_apply_ifft_clip_and_rescale_match_jax():
    jc, c = _cubes(seed=4)
    jf, f = japply_fft(jc), apply_fft(c, device="cpu")
    kw = {"envelope_clip": True, "rescale_minmax": (-1.0, 2.0)}
    ji, i = japply_ifft(jf, **kw), apply_ifft(f, device="cpu", **kw)
    _close(i["amp"], ji.data_vars["amp"][1])
    assert i["amp"].min() == pytest.approx(-1.0)
    with pytest.raises(ValueError, match="freq_"):
        apply_ifft(c, device="cpu")
    with pytest.raises(ValueError, match="twt as its last axis"):
        apply_fft(Cube(coords=c.coords, data_vars={"amp": (
            ("twt", "iline", "xline"), c["amp"])}), device="cpu")
