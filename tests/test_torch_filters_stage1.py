"""The stage-1 filters of the port (``ops/filters.py``) against the JAX
package's, on the same seeded inputs, with ``device="cpu"``.

Tolerances: the STA/LTA, the moving average and the moving median are
held bit-equal (their sums add in XLA's order, and a median is an order
statistic); the polynomial fit of order 11 to 1e-5 of the largest input
(an SVD of a badly conditioned float32 system: two LAPACK builds round it
differently), of order 3 to 1e-6; the host functions are the same numpy
and held exact; the seafloor picks are held equal.
"""

import numpy as np
import pytest

from pseudo_3d_interpolation_tpu.ops import filters as jflt
from pseudo_3d_interpolation_torch.ops import filters as flt

CPU = "cpu"


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n", [1, 7, 16, 17, 33, 400, 896])
@pytest.mark.parametrize("batched", [False, True])
def test_sta_lta_and_moving_average_bit_equal(n, batched):
    a = _rng(n).normal(size=(3, n) if batched else (n,)).astype(np.float32)
    nsta, nlta = (3, 5) if n < 100 else (3, 50)
    got = flt.sta_lta(a, nsta, nlta, device=CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflt.sta_lta(a, nsta, nlta)))
    win = min(4, n)
    got = flt.moving_average(a, win, device=CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflt.moving_average(a, win)))


@pytest.mark.parametrize("n", [9, 64, 401])
@pytest.mark.parametrize("win", [3, 4, 7, 8])
@pytest.mark.parametrize("padded", [False, True])
def test_moving_median_bit_equal(n, win, padded):
    rng = _rng(n + win)
    if padded:
        a = rng.normal(size=n).astype(np.float32)
        win |= 1
    else:
        a = rng.normal(size=(2, n)).astype(np.float32)
    got = flt.moving_median(a, win, padded=padded, device=CPU).numpy()
    want = np.asarray(jflt.moving_median(a, win, padded=padded))
    np.testing.assert_array_equal(got, want)


def test_moving_median_padded_refuses_2d():
    with pytest.raises(ValueError, match="1D"):
        flt.moving_median(np.zeros((2, 5), np.float32), 3, padded=True,
                          device=CPU)


@pytest.mark.parametrize("n", [50, 121, 400, 2048])
@pytest.mark.parametrize("order", [3, 11])
@pytest.mark.parametrize("kind", ["high", "low"])
def test_polynomial_filter(n, order, kind):
    rng = _rng(n)
    h = 100 + 20 * np.linspace(0, 1, n) + rng.normal(0, 1, n)
    got = flt.polynomial_filter(h, order=order, kind=kind, device=CPU).numpy()
    want = np.asarray(jflt.polynomial_filter(h, order=order, kind=kind))
    tol = (1e-5 if order == 11 else 1e-6) * np.abs(h).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # batched rows fit each row alone
    rows = np.stack([h, h[::-1]]).astype(np.float32)
    got2 = flt.polynomial_filter(rows, order=order, kind=kind,
                                 device=CPU).numpy()
    np.testing.assert_allclose(got2[0], got, rtol=0, atol=tol)


def test_polynomial_filter_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        flt.polynomial_filter(np.arange(10.0), kind="band", device=CPU)


def test_lstsq_svd_drops_the_small_singular_values_as_jax():
    """The solve keeps the singular values at or above eps·max(M, N)·s0,
    as jnp.linalg.lstsq; a rank-deficient system gets the minimum-norm
    solution."""
    import jax.numpy as jnp
    import torch

    v = np.ones((6, 3), np.float32)
    v[:, 1] = np.arange(6)
    v[:, 2] = 2 * v[:, 1]  # rank 2
    b = _rng(3).normal(size=(6, 2)).astype(np.float32)
    got = flt._lstsq_svd(torch.from_numpy(v), torch.from_numpy(b)).numpy()
    want = np.asarray(jnp.linalg.lstsq(v, b)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(31,), (4, 9)])
def test_mad_functions_equal(shape):
    x = _rng(4).normal(size=shape)
    np.testing.assert_array_equal(flt.median_abs_deviation(x),
                                  jflt.median_abs_deviation(x))
    np.testing.assert_array_equal(flt.median_abs_deviation_double(x),
                                  jflt.median_abs_deviation_double(x))


def test_mad_double_raises_on_a_zero_side():
    with pytest.raises(ValueError, match="zero"):
        flt.median_abs_deviation_double(np.array([1.0, 1.0, 1.0, 5.0]))


@pytest.mark.parametrize("window", ["flat", "hanning", "blackman"])
@pytest.mark.parametrize("n", [40, 41])
def test_smooth_equal(window, n):
    x = np.cumsum(_rng(n).normal(size=n))
    np.testing.assert_array_equal(flt.smooth(x, 10, window),
                                  jflt.smooth(x, 10, window))


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32])
def test_outlier_index_filters_equal(dtype):
    x = 100 + 5 * _rng(5).normal(size=120)
    x[[10, 50, 51, 90]] += [40, -35, -30, 60]
    x = x.astype(dtype)
    np.testing.assert_array_equal(flt.zscore_filter(x), jflt.zscore_filter(x))
    np.testing.assert_array_equal(flt.moving_zscore_filter(x, 11),
                                  jflt.moving_zscore_filter(x, 11))
    np.testing.assert_array_equal(flt.iqr_filter(x), jflt.iqr_filter(x))
    for mode in ("single", "double"):
        np.testing.assert_array_equal(flt.mad_filter(x, 3, mode),
                                      jflt.mad_filter(x, 3, mode))
        np.testing.assert_array_equal(flt.moving_mad_filter(x, 9, 3, mode),
                                      jflt.moving_mad_filter(x, 9, 3, mode))


def test_moving_mad_filter_refuses_even_window():
    with pytest.raises(ValueError, match="odd"):
        flt.moving_mad_filter(np.arange(20.0), 4)


@pytest.mark.parametrize("method", ["IQR", "z-score", "r_z-score", "MAD",
                                    "doubleMAD", "r_doubleMAD", "r_singleMAD"])
def test_filter_interp_1d_equal(method):
    x = 100 + np.sin(np.linspace(0, 6, 150)) + 0.1 * _rng(6).normal(size=150)
    x[[0, 1, 40, 41, 42, 149]] += [9, 8, -7, -8, -9, 10]
    np.testing.assert_array_equal(
        flt.filter_interp_1d(x, method=method, win=11),
        jflt.filter_interp_1d(x, method=method, win=11))


def _section(seed, ns=400, ntr=150, floor=120, zero_traces=()):
    rng = _rng(seed)
    d = rng.normal(0, 0.02, (ns, ntr)).astype(np.float32)
    pick = floor + np.rint(6 * np.sin(np.linspace(0, 3, ntr))).astype(int)
    pick += rng.integers(-2, 3, ntr)
    for j in range(ntr):
        d[pick[j]: pick[j] + 6, j] += np.array([0.4, 1.0, 0.6, -0.5, -0.8,
                                                -0.2], np.float32)
    d[:, list(zero_traces)] = 0.0
    return d


@pytest.mark.parametrize("case", ["plain", "zero_traces", "windows",
                                  "no_post", "slice_start"])
def test_detect_seafloor_reflection_picks_equal(case):
    kw = {}
    d = _section(7)
    if case == "zero_traces":
        d = _section(8, zero_traces=(0, 30, 31, 149))
    elif case == "windows":
        kw = dict(nsta=4, nlta=30, win=15, win_mad=9, win_median=7, n=3)
    elif case == "no_post":
        kw = dict(post_detection_filter=False, threshold=2.0)
    elif case == "slice_start":
        kw = dict(idx_slice_start=20)
    got = flt.detect_seafloor_reflection(d, device=CPU, **kw)
    want = jflt.detect_seafloor_reflection(d, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_butterworth_functions_still_there():
    sos = flt.butterworth_design("lowpass", 100.0, 1000.0, order=4)
    np.testing.assert_array_equal(
        sos, jflt.butterworth_design("lowpass", 100.0, 1000.0, order=4))
