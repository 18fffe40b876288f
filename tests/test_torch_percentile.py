"""The percentile thresholds of ``ops/threshold.py`` against the JAX
package's: ``_percentile_from_mag`` with a scalar, a per-slice and a
trailing-broadcast percentile, q at 0, 37.5, 100 and outside [0, 100];
``threshold_pair`` and ``threshold`` for the three percentile kinds; one
slice above 2**24 elements, where ``torch.quantile`` refuses; and the
solver with a percentile threshold on the FFT, DCT and WAVELET bases
(``xla-scan``) against the JAX package's solve.

Tolerances: the percentile is computed as ``jnp.percentile`` computes it
(float32 rank, two neighbours of the sorted slice, linear weights), so it
agrees within 1e-6 relative (float32 rounding of the weighted sum). With a
per-slice percentile XLA evaluates the rank q/100·(n−1) reassociated, as
q·(0.01·(n−1)), which moves it by a float32 place: within 1e-5 relative
there (one place of a rank near 700 times a neighbour spacing of 0.1 is
about 1e-5 of a value near 1). The thresholded values within 1e-6 of the
largest value: a soft or garrote shrink near the threshold moves by the
float32 rounding of the threshold itself. The solves: soft and garrote max|Δ| ≤
1e-4·max|JAX|, hard SNR against the truth within 0.1 dB."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops import threshold as jthreshold
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops import threshold
from pseudo_3d_interpolation_torch.ops.cplx import Cplx

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

PERC_RTOL = 1e-6
PER_SLICE_RTOL = 1e-5
ELEMENTWISE_RTOL = 1e-6
SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
KINDS = ("soft-percentile", "hard-percentile", "garrote-percentile")


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


# per-slice percentiles of a (2, 3) batch: one per slice, one per row of
# the batch broadcast over its second axis, and the (..., 1, 1) form a
# threshold schedule hands over
PER_SLICE = {
    "per-slice": np.array([[10.0, 37.5, 90.0], [0.0, 50.0, 100.0]],
                          np.float32),
    "row-broadcast": np.array([[20.0], [75.0]], np.float32)[..., None],
    "trailing-(1,1)": np.array([[5.0, 95.0, 60.0], [33.3, 66.6, 99.9]],
                               np.float32)[..., None, None],
}


@pytest.mark.parametrize("q", [0.0, 37.5, 100.0, 130.0, -5.0])
@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (2, 96, 128),
                                   (1, 100, 100)], ids=["64", "96x128",
                                                        "100"])
def test_percentile_from_mag_scalar_matches_jax(shape, q):
    mag = np.abs(_complex(shape, seed=1))
    got = threshold._percentile_from_mag(torch.from_numpy(mag), q).numpy()
    want = np.asarray(jthreshold._percentile_from_mag(jnp.asarray(mag), q))
    assert got.shape == want.shape == shape[:-2] + (1, 1)
    np.testing.assert_allclose(got, want, rtol=PERC_RTOL, atol=0)


@pytest.mark.parametrize("name", list(PER_SLICE))
def test_percentile_from_mag_per_slice_matches_jax(name):
    perc = PER_SLICE[name]
    mag = np.abs(_complex((2, 3, 48, 40), seed=2))
    got = threshold._percentile_from_mag(torch.from_numpy(mag),
                                         torch.from_numpy(perc)).numpy()
    want = np.asarray(jthreshold._percentile_from_mag(jnp.asarray(mag),
                                                      jnp.asarray(perc)))
    assert got.shape == want.shape == (2, 3, 1, 1)
    np.testing.assert_allclose(got, want, rtol=PER_SLICE_RTOL, atol=0)


def test_percentile_of_a_slice_with_a_nan_is_nan():
    mag = np.abs(_complex((2, 16, 16), seed=3))
    mag[1, 3, 4] = np.nan
    got = threshold._percentile_from_mag(torch.from_numpy(mag), 50.0)
    want = np.asarray(jthreshold._percentile_from_mag(jnp.asarray(mag),
                                                      50.0))
    assert np.isnan(want[1]).all() and torch.isnan(got[1]).all()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=PERC_RTOL)


@pytest.mark.parametrize("kind", KINDS + ("garotte-percentile",))
@pytest.mark.parametrize("perc", [37.5, "per-slice"])
def test_threshold_pair_percentile_matches_jax(kind, perc):
    z = _complex((2, 3, 40, 56), seed=4)
    value = PER_SLICE[perc] if isinstance(perc, str) else perc
    got = _np(threshold.threshold_pair(
        _pair(z), torch.as_tensor(value), kind))
    want = _np(jthreshold.threshold_pair(_jpair(z), jnp.asarray(value),
                                         kind))
    np.testing.assert_allclose(got, want, rtol=ELEMENTWISE_RTOL,
                               atol=ELEMENTWISE_RTOL * np.abs(want).max())
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("substitute", [0.0, -2.5])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("is_complex", [False, True])
def test_threshold_percentile_matches_jax(kind, substitute, is_complex):
    z = _complex((4, 10, 12), seed=5)
    x = z if is_complex else z.real.copy()
    got = threshold.threshold(torch.from_numpy(x), 62.5, substitute, kind)
    want = jthreshold.threshold(jnp.asarray(x), 62.5, substitute, kind)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=ELEMENTWISE_RTOL,
                               atol=ELEMENTWISE_RTOL * np.abs(want).max())


def test_percentile_above_2_to_the_24_elements():
    """One 4100x4100 slice (16.81M > 2**24 elements): ``torch.quantile``
    refuses it, the port's percentile takes it. The reference here is
    numpy's percentile (float64 rank; the float32 rank differs from it by
    at most half a place, far below the neighbours' spacing)."""
    n = 4100
    rng = np.random.default_rng(6)
    mag = rng.random((1, n, n), dtype=np.float32)
    assert mag.size > 2 ** 24
    flat = torch.from_numpy(mag.reshape(1, -1))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(flat, 0.375, dim=-1)
    got = threshold._percentile_from_mag(torch.from_numpy(mag), 37.5)
    want = np.percentile(mag.reshape(-1), 37.5)
    np.testing.assert_allclose(got.numpy().reshape(-1), [want],
                               rtol=PERC_RTOL)
    kept = threshold.hard(torch.from_numpy(mag), got)
    assert int((kept != 0).sum()) == int((mag >= got.item()).sum())


def test_unknown_threshold_kind_raises():
    z = _pair(_complex((1, 4, 4)))
    with pytest.raises(ValueError, match="Unknown threshold"):
        threshold.threshold_pair(z, 50.0, "median-percentile")
    with pytest.raises(ValueError, match="Unknown threshold"):
        threshold.threshold(z.re, 50.0, kind="medium")


def _truth(b, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for _ in range(3):
            fy, fx = rng.integers(1, 8, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5)[None, :], (h, w)), np.float32)
    return truth, mask


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


@pytest.mark.parametrize("kind", ["FFT", "DCT", "WAVELET"])
@pytest.mark.parametrize("op", KINDS)
def test_percentile_solve_matches_jax(kind, op):
    """JAX tests/test_pocs.py:189-199's setting (decay of factors, p_max
    99.9, p_min 60) on each basis: both packages take ``xla-scan``."""
    truth, mask = _truth(2, 64, 96, seed=7)
    obs = truth * mask
    jcfg = jpocs.POCSConfig(niter=8, thresh_op=op, decay_kind="factors",
                            p_max=99.9, p_min=60.0, version="fast",
                            alpha=0.75, transform_kind=kind,
                            use_pallas=True, pallas_interpret=True)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    rt = pocs.solver_route(obs.shape, mask.shape, cfg)
    assert tuple(rt) == tuple(jpocs.solver_route(obs.shape, mask.shape,
                                                 jcfg))[:2] + (rt.reason,)
    assert rt.route == "xla-scan" and "threshold" in rt.reason
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)),
        jnp.asarray(mask), jget(kind), jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                get_transform(kind), cfg)
    got, want = _np(res.data), _np(jres.data)
    if kind != "WAVELET":  # the wavelets fit these plane waves poorly
        assert _snr(truth, got) > _snr(truth, obs)
    if op == "hard-percentile":
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(res.n_iterations.numpy(),
                                  np.asarray(jres.n_iterations))
