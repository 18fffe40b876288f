"""The port's ops (pseudo_3d_interpolation_torch/ops: cplx, dft, threshold,
decay) held against the JAX package's on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.ops import decay as jdecay
from pseudo_3d_interpolation_tpu.ops import dft as jdft
from pseudo_3d_interpolation_tpu.ops import threshold as jthreshold
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_torch.ops import decay, dft, threshold
from pseudo_3d_interpolation_torch.ops.cplx import (Cplx, from_complex,
                                                    to_complex)

torch.set_num_threads(2)

# elementwise float32 chains evaluated in the same order: rounding of a few
# ulps at most
ELEMENTWISE_RTOL = 1e-6
# float32 schedules through log/exp/pow: a few ulps of the largest term
DECAY_RTOL = 1e-5


def _complex(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _pair(z):
    return Cplx(torch.from_numpy(np.ascontiguousarray(z.real)),
                torch.from_numpy(np.ascontiguousarray(z.imag)))


def _jpair(z):
    return JCplx(jnp.asarray(z.real), jnp.asarray(z.imag))


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


# --- cplx -----------------------------------------------------------------

def test_cplx_round_trip_and_magnitudes_match_jax():
    z = _complex((2, 8, 16))
    c = from_complex(z)
    assert c.re.dtype == torch.float32 and c.shape == (2, 8, 16)
    np.testing.assert_array_equal(to_complex(c), z)
    jc = _jpair(z)
    np.testing.assert_allclose(c.abs().numpy(), np.asarray(jc.abs()),
                               rtol=ELEMENTWISE_RTOL)
    np.testing.assert_allclose(c.abs2().numpy(), np.asarray(jc.abs2()),
                               rtol=ELEMENTWISE_RTOL)
    np.testing.assert_array_equal(to_complex(c.conj()), np.conj(z))


def test_from_complex_of_real_and_torch_inputs():
    r = np.arange(12, dtype=np.float64).reshape(3, 4)
    c = from_complex(r)
    assert c.re.dtype == torch.float32
    np.testing.assert_array_equal(c.im.numpy(), np.zeros((3, 4)))
    z = _complex((3, 4), seed=1)
    np.testing.assert_array_equal(
        to_complex(from_complex(torch.from_numpy(z))), z)


@pytest.mark.parametrize("make", [
    lambda z: np.moveaxis(z, -1, 0),  # a cube in (il, xl, freq) order
    lambda z: np.moveaxis(z, -1, 0)[1:3],  # a batch of it: not dense
    lambda z: z[::-1].swapaxes(0, 2),  # negative strides: host path
    lambda z: np.moveaxis(z.real, -1, 0),  # real input
])
def test_from_complex_with_device_keeps_views_exact(make):
    """With a device, a strided view crosses in storage order and is split
    and permuted there; the planes equal those of the contiguous copy."""
    view = make(_complex((4, 6, 5), seed=2))
    c = from_complex(view, "cpu")
    assert c.re.is_contiguous() and c.im.is_contiguous()
    assert c.re.dtype == torch.float32 and c.shape == view.shape
    np.testing.assert_array_equal(to_complex(c),
                                  np.ascontiguousarray(view, np.complex64))


# --- dft ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 128, 384, 512])
def test_dft_matrices_bit_equal_to_jax(n):
    fr, fi = dft.dft_matrices(n)
    jr, ji = jdft.dft_matrices(n)
    assert fr.dtype == jr.dtype == np.float32
    np.testing.assert_array_equal(fr, jr)
    np.testing.assert_array_equal(fi, ji)


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 48, 80), (1, 256, 256)])
def test_fft2_ifft2_match_jax(shape):
    z = _complex(shape, seed=2)
    got = _np(dft.fft2(_pair(z)))
    ref = _np(jdft.fft2(_jpair(z)))
    # torch.fft against JAX's fp32 matmul DFT: both within ~sqrt(N) ulps of
    # the exact transform
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    back = _np(dft.ifft2(dft.fft2(_pair(z))))
    np.testing.assert_allclose(back, z, atol=1e-5)
    jback = _np(jdft.ifft2(_jpair(got.astype(np.complex64))))
    np.testing.assert_allclose(_np(dft.ifft2(_pair(got.astype(np.complex64)))),
                               jback, atol=1e-5)


# --- threshold ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["soft", "hard", "garrote", "garotte"])
def test_pair_thresholds_match_jax(kind):
    z = _complex((2, 16, 16), seed=3)
    t = np.array([0.8, 1.3], np.float32)[:, None, None]
    got = _np(threshold.threshold_pair(_pair(z), torch.from_numpy(t), kind))
    ref = _np(jthreshold.threshold_pair(_jpair(z), jnp.asarray(t), kind))
    np.testing.assert_allclose(got, ref, rtol=ELEMENTWISE_RTOL, atol=1e-7)


@pytest.mark.parametrize("substitute", [0.0, -2.5])
@pytest.mark.parametrize("kind", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("is_complex", [False, True])
def test_array_thresholds_match_jax(kind, substitute, is_complex):
    z = _complex((4, 10), seed=4)
    x = z if is_complex else z.real.copy()
    got = threshold.threshold(torch.from_numpy(x), 0.9, substitute, kind)
    ref = jthreshold.threshold(jnp.asarray(x), 0.9, substitute, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=ELEMENTWISE_RTOL, atol=1e-7)


def test_threshold_kinds_not_ported_or_unknown_raise():
    """The percentile kinds are ported: each matches the JAX package's
    (a soft or garrote shrink near the threshold within 1e-6 of the
    largest value); an unknown kind raises."""
    z = _complex((2, 4, 4))
    for kind in ("soft-percentile", "hard-percentile",
                 "garrote-percentile"):
        got = _np(threshold.threshold_pair(_pair(z), 50.0, kind))
        want = _np(jthreshold.threshold_pair(_jpair(z), 50.0, kind))
        np.testing.assert_allclose(got, want, rtol=ELEMENTWISE_RTOL,
                                   atol=ELEMENTWISE_RTOL * np.abs(want).max())
        got = threshold.threshold(torch.from_numpy(z.real.copy()), 50.0,
                                  kind=kind).numpy()
        want = np.asarray(jthreshold.threshold(jnp.asarray(z.real), 50.0,
                                               kind=kind))
        np.testing.assert_allclose(got, want, rtol=ELEMENTWISE_RTOL,
                                   atol=ELEMENTWISE_RTOL * np.abs(want).max())
    with pytest.raises(ValueError, match="Unknown threshold"):
        threshold.threshold_pair(_pair(z), 0.5, "medium")


# --- decay ----------------------------------------------------------------

def _mags(seed=5, shape=(3, 24, 20), zero_slice=False):
    mag = np.abs(_complex(shape, seed)) * np.array(
        [1.0, 3.0, 0.2], np.float32)[:, None, None]
    if zero_slice:
        mag[1] = 0.0
    return mag.astype(np.float32)


@pytest.mark.parametrize("p_min", [1e-3, "adaptive"])
@pytest.mark.parametrize("model", ["linear", "exponential", "exponential-2",
                                   "exponential-0.5", "data-driven",
                                   "inverse_proportional",
                                   "inverse_proportional-2"])
def test_threshold_decay_matches_jax(model, p_min):
    mag = _mags()
    got = decay.threshold_decay(torch.from_numpy(mag), model, 12, 0.99, p_min)
    ref = jdecay.threshold_decay(jnp.asarray(mag), model, 12, 0.99, p_min)
    assert got.shape == (12, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DECAY_RTOL)


@pytest.mark.parametrize("model", ["linear", "exponential"])
def test_threshold_decay_factors_match_jax(model):
    mag = _mags()
    got = decay.threshold_decay(torch.from_numpy(mag), model, 7, 99.0, 10.0,
                                kind="factors")
    ref = jdecay.threshold_decay(jnp.asarray(mag), model, 7, 99.0, 10.0,
                                 kind="factors")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DECAY_RTOL)


@pytest.mark.parametrize("model", ["linear", "exponential", "data-driven"])
def test_decay_of_a_zero_slice_matches_jax(model):
    mag = _mags(zero_slice=True)
    got = decay.threshold_decay(torch.from_numpy(mag), model, 5, 0.99,
                                "adaptive").numpy()
    ref = np.asarray(jdecay.threshold_decay(jnp.asarray(mag), model, 5, 0.99,
                                            "adaptive"))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=DECAY_RTOL)


def test_decay_helpers_match_jax():
    mag = _mags(seed=6)
    t = torch.from_numpy(mag)
    j = jnp.asarray(mag)
    np.testing.assert_allclose(decay.adaptive_tau_min(t).numpy(),
                               np.asarray(jdecay.adaptive_tau_min(j)),
                               rtol=DECAY_RTOL)
    for got, ref in zip(decay.tau_bounds(t, 0.9, "adaptive"),
                        jdecay.tau_bounds(j, 0.9, "adaptive")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=DECAY_RTOL)
    tmax = np.array([3.0, 0.0, 1.5], np.float32)
    tmin = np.array([0.01, 0.0, 0.5], np.float32)
    np.testing.assert_allclose(
        decay.schedule("exponential-3", 9, torch.from_numpy(tmax),
                       torch.from_numpy(tmin)).numpy(),
        np.asarray(jdecay.schedule("exponential-3", 9, jnp.asarray(tmax),
                                   jnp.asarray(tmin))), rtol=DECAY_RTOL)
    np.testing.assert_allclose(
        decay.inverse_proportional("inverse_proportional", 1, t).numpy(),
        np.asarray(jdecay.inverse_proportional("inverse_proportional", 1, j)),
        rtol=DECAY_RTOL)


@pytest.mark.parametrize("call,match", [
    (lambda m: decay.threshold_decay(m, "exponential-2x"), "malformed"),
    (lambda m: decay.threshold_decay(m, "linear", p_min="adaptive",
                                     kind="factors"), "adaptive"),
    (lambda m: decay.threshold_decay(m, "linear", p_min="auto"), "unknown"),
    (lambda m: decay.threshold_decay(m, "data-driven", kind="factors"),
     "data-driven"),
    (lambda m: decay.threshold_decay(m, "inverse_proportional",
                                     kind="factors"), "values"),
    (lambda m: decay.schedule("cosine", 4, 1.0, 0.1), "closed-form"),
])
def test_decay_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.from_numpy(_mags()))
