"""The DCT basis: the port's DCT matrix and transform, its folded solve
``pocs_solve(basis='dct')`` against the JAX package's
``pocs_solve_fused(basis='dct')`` in interpret mode, and the whole
``fused-folded[dct]`` route through ``pocs_interpolate`` and
``pipeline.pocs.interpolate`` against the JAX package's (``use_pallas``,
``pallas_interpret``). On the CPU the wrapper takes its plain
``torch.matmul`` version; the CUDA kernel is held against that in
tests/test_torch_cuda.py.

Tolerances: ``dct2_matrix`` is bit-equal (float64 on the host, rounded
once). Soft and garrote thresholds are continuous in the coefficients, so
fp32 sums in another order move the result by rounding only: max|Δ| ≤
1e-4·max|JAX|. Hard thresholds flip coefficients at the threshold under
reordered arithmetic: SNR against the truth within 0.1 dB and a bounded
share of outliers. Effective iteration counts are equal."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops import dft as jdft
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import pocs_solve_fused
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (DCTTransform,
                                                             get_transform)
from pseudo_3d_interpolation_torch.ops import dft
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
NITER = 8
# the production stage-2 configuration on the DCT basis, cut to NITER
META = dict(niter=NITER, thresh_op="hard", thresh_model="exponential",
            p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
            transform_kind="DCT", use_pallas=True, pallas_interpret=True)


def _truth(f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((f, h, w), np.complex64)
    for i in range(f):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5)[None, :], (h, w)), np.float32)
    return truth, mask


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


def _agree(got, want, op, truth):
    scale = np.abs(want).max()
    d = np.abs(got - want)
    if op == "hard":
        assert (d > OUTLIER * scale).mean() < OUTLIER_SHARE
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        assert d.max() <= SOFT_TOL * scale, d.max() / scale


def _np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _pair(a):
    return Cplx(torch.from_numpy(np.ascontiguousarray(a.real, np.float32)),
                torch.from_numpy(np.ascontiguousarray(a.imag, np.float32)))


def _jpair(a):
    return JCplx(jnp.asarray(a.real, jnp.float32),
                 jnp.asarray(a.imag, jnp.float32))


@pytest.mark.parametrize("n", [8, 100, 128, 512])
def test_dct_matrix_is_bit_equal(n):
    np.testing.assert_array_equal(dft.dct2_matrix(n), jdft.dct2_matrix(n))
    c, ct = dft.dct_on(n, "cpu")
    assert torch.equal(ct, c.T)


def test_dct2_2d_matches_jax_and_inverts():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 96, 128)).astype(np.float32)
    got = dft.dct2_2d(torch.from_numpy(x)).numpy()
    want = np.asarray(jdft.dct2_2d(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    back = dft.idct2_2d(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)
    tr = DCTTransform()
    z = tr.forward(_pair(x + 1j * x[::-1]))
    np.testing.assert_allclose(_np(tr.inverse(z)), x + 1j * x[::-1],
                               atol=1e-5)


def _decay(obs, niter):
    """An exponential decay from the observed DCT spectrum's maxima."""
    spec = dft.dct2_2d(torch.from_numpy(obs.real.copy())).numpy() + \
        1j * dft.dct2_2d(torch.from_numpy(obs.imag.copy())).numpy()
    amax = np.abs(spec).max(axis=(-2, -1))
    m = np.arange(niter, dtype=np.float64)[:, None] / max(niter - 1, 1)
    return (0.99 * amax[None] * np.exp(np.log(1e-3 / 0.99) * m)
            ).astype(np.float32)


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w", [(128, 128), (128, 256)],
                         ids=["128", "rect-128x256"])
def test_solve_matches_jax_kernel(h, w, version, op):
    truth, mask = _truth(2, h, w, seed=2)
    obs = truth * mask
    decay = _decay(obs, NITER)
    want, want_cost = pocs_solve_fused(
        _jpair(obs), mask, decay, alpha=0.75, thresh_op=op, version=version,
        interpret=True, basis="dct")
    got, cost = ks.pocs_solve(_pair(obs), torch.from_numpy(mask),
                              torch.from_numpy(decay), 0.75, op, version,
                              basis="dct")
    _agree(_np(got), _np(want), op, truth)
    if op != "hard":
        np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost),
                                   rtol=1e-3)


def _solve_both(obs, mask, **change):
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask),
                                  jget("DCT"), jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                get_transform("DCT"), cfg)
    return jres, res, cfg


@pytest.mark.parametrize("version", ["regular", "fast"])
def test_rectangular_solve_matches_jax(version):
    """The DCT cases of tests/test_pallas_kernel.py:59-94: 128x256, two
    plane waves, hard threshold, p_min 1e-3, eps 0."""
    rng = np.random.default_rng(7)
    h, w, b = 128, 256, 2
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for fy, fx in ((2, 3), (5, 1)):
            truth[i] += np.exp(2j * np.pi * (fy * yy / h + fx * xx / w))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5).astype(np.float32)[None, :], (h, w)))
    jres, res, cfg = _solve_both(truth * mask, mask, niter=6, p_min=1e-3,
                                 version=version)
    assert tuple(pocs.solver_route(truth.shape, mask.shape, cfg)) == \
        ("fused-folded", "dct", "")
    _agree(_np(res.data), _np(jres.data), "hard", truth)
    assert res.n_iterations.tolist() == [6, 6]
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)


def test_square_solve_matches_jax_with_a_zero_slice():
    """tests/test_pallas_kernel.py:155-183 (128², hard, fast, 8
    iterations) with a zero slice, which short-circuits on both sides."""
    rng = np.random.default_rng(1)
    n, b = 128, 3
    yy, xx = np.mgrid[0:n, 0:n]
    truth = np.zeros((b, n, n), np.complex64)
    for i in range(b - 1):
        truth[i] = np.exp(2j * np.pi * (3 * yy / n + (i + 1) * xx / n))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=n) < 0.5).astype(np.float32)[None, :], (n, n)))
    jres, res, _ = _solve_both(truth * mask, mask, p_min=1e-3)
    _agree(_np(res.data)[:2], _np(jres.data)[:2], "hard", truth[:2])
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist() == [NITER, NITER, 0]
    assert res.cost[2] == 0 and not res.data.re[2].any()
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)


@pytest.mark.parametrize("change", [
    pytest.param({"eps": 1e-12}, id="eps"),
    pytest.param({"keep_cost_history": True}, id="history"),
    pytest.param({"global_early_stop": True}, id="global-early-stop"),
    pytest.param({"version": "adaptive"}, id="adaptive"),
    pytest.param({"thresh_op": "soft-percentile", "decay_kind": "factors",
                  "p_max": 99.9, "p_min": 60.0}, id="percentile"),
])
def test_scan_configs_take_the_unported_xla_scan(change):
    """A DCT configuration that misses the folded solve runs the JAX
    package's plain XLA scan, not the FFT-only per-iteration kernel
    (tests/test_pallas_kernel.py:235-260); the port runs the same scan
    (``xla-scan[dct]``) and solves as it does."""
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    shape = (2, 128, 128)
    jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("DCT"))
    rt = pocs.solver_route(shape, shape[1:], cfg, get_transform("DCT"))
    assert tuple(rt) == tuple(jrt) and rt.route == "xla-scan"
    assert pocs.runs(rt)
    assert pocs.describe_route(rt) == f"xla-scan[dct] — {jrt.reason}"
    truth, mask = _truth(*shape, seed=9)
    obs = truth * mask
    jres, res, _ = _solve_both(obs, mask, **change)
    _agree(_np(res.data), _np(jres.data),
           "hard" if cfg.thresh_op == "hard" else "soft", truth)
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist()
    if cfg.keep_cost_history:
        assert res.cost_history.shape == (NITER, 2)


def test_route_table_matches_jax():
    jcfg = jpocs.POCSConfig(**META)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    for shape in ((32, 512, 512), (2, 128, 256)):
        jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("DCT"))
        rt = pocs.solver_route(shape, shape[1:], cfg, get_transform("DCT"))
        assert tuple(rt) == tuple(jrt) == ("fused-folded", "dct", "")
    # any shape runs here (the JAX gate wants sides of a multiple of 128)
    assert pocs.solver_route((2, 100, 60), (100, 60), cfg).route \
        == "fused-folded"


def _cubes(obs, mask):
    coords = {"iline": np.arange(obs.shape[1]),
              "xline": np.arange(obs.shape[2]),
              "freq": np.arange(obs.shape[0], dtype=np.float64)}
    data_vars = {"amp": (("iline", "xline", "freq"),
                         np.ascontiguousarray(np.moveaxis(obs, 0, -1))),
                 "fold": (("iline", "xline"), mask.astype(np.int32))}
    return (JCube(coords=dict(coords), data_vars=dict(data_vars)),
            Cube(coords=dict(coords), data_vars=dict(data_vars)))


def _rec(cube):
    return np.moveaxis(np.asarray(cube.data_vars["amp_interp"][1]), -1, 0)


@pytest.mark.parametrize("op,precision", [("soft", "highest"),
                                          ("hard", "highest"),
                                          ("hard", None)],
                         ids=["soft-highest", "hard-highest",
                              "hard-production"])
def test_cube_matches_jax(op, precision):
    """A 3-slice 128² cube through both packages' ``interpolate`` at the
    production defaults on the DCT basis; precision None is the drivers'
    production 'high' (a hand-made bf16x3 in JAX, fp32 here)."""
    truth, mask = _truth(3, 128, 128, seed=5)
    obs = truth * mask
    meta = dict(META, thresh_op=op)
    if precision:
        meta["precision"] = precision
    jcube, cube = _cubes(obs, mask)
    jout = jpipe.interpolate(jcube, config={"metadata": meta},
                             mesh=make_mesh(1))
    out = pipe.interpolate(cube, config={"metadata": meta}, device="cpu")
    got, want = _rec(out), _rec(jout)
    assert got.dtype == np.complex64 and got.shape == obs.shape
    assert _snr(truth, got) > _snr(truth, obs)
    if precision is None:
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        _agree(got, want, op, truth)
    assert out.attrs["pocs_mean_iterations"] == NITER
    assert out.attrs["history"] == jout.attrs["history"]


def test_production_transform_and_compat_carry_the_dct_over():
    cfg, extra = pipe.config_from_yaml({"metadata": META})
    assert pipe._production_transform(cfg, extra) == \
        DCTTransform(precision="high")
    assert pipe._transform_subbands(DCTTransform(), (512, 512), cfg) == 1
    jtr = jget("DCT", precision="highest")
    tr = compat.transform_from_reference(
        jtr.kind, {"precision": jtr.precision})
    assert tr == DCTTransform(precision="highest")
    # the carried transform and configuration solve as the JAX ones do
    truth, mask = _truth(2, 128, 128, seed=8)
    obs = truth * mask
    jcfg = jpocs.POCSConfig(**dict(META, thresh_op="soft"))
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask), jtr, jcfg)
    res = pocs.pocs_interpolate(
        _pair(obs), torch.from_numpy(mask), tr,
        compat.config_from_reference(dataclasses.asdict(jcfg)))
    _agree(_np(res.data), _np(jres.data), "soft", truth)
