"""The FFT basis' per-iteration route: the port's ``pocs_iteration``
(pseudo_3d_interpolation_torch/ops/kernels/pocs_solve.py) against the JAX
package's ``pocs_iteration_fused`` in interpret mode, and the scan around
it (``fused-periter``: eps ≠ 0, cost history, global early stop,
``version='adaptive'``) against the JAX package's ``pocs_interpolate`` with
``use_pallas`` and ``pallas_interpret``, down to the reference's recommended
configuration (eps = 1e-16) through ``pipeline.pocs.interpolate``. On the
CPU the wrapper takes its plain ``torch.fft`` version; the CUDA kernel is
held against that in tests/test_torch_cuda.py.

Tolerances: soft and garrote thresholds are continuous in the
coefficients, so reordered fp32 arithmetic (JAX: dense matmul DFTs; port:
torch.fft) moves the result by rounding only: max|Δ| ≤ 1e-4·max|JAX|
(measured 2e-6 after 10 iterations at 128²). One iteration under a hard
threshold is held to the same bound on thresholds placed in gaps between
the coefficient magnitudes (``gap_taus``); hard solves by SNR against the
truth within 0.1 dB and a bounded share of outliers. Effective iteration
counts are equal."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import \
    pocs_iteration_fused
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (FFTTransform,
                                                             get_transform)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
# hard solves: at most this share of elements beyond OUTLIER·max
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
# the reference's recommended workload shape (BASELINE.md:14,
# functions/POCS.py:379-386), cut to 8 iterations
RECOMMENDED = dict(niter=8, thresh_op="hard", thresh_model="exponential",
                   p_min="adaptive", version="fast", alpha=0.75, eps=1e-16,
                   use_pallas=True, pallas_interpret=True)


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


def _agree(got, want, op, truth=None):
    scale = np.abs(want).max()
    d = np.abs(got - want)
    if op == "hard" and truth is not None:
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


def _iteration_inputs(b, h, w, op, seed=110):
    """The inputs of tests/test_pallas_kernel.py:24-43: normal x, obs =
    x/2, a random 50% mask, tau at 30% of each slice's largest spectral
    magnitude; for the hard threshold a tau in a gap of the magnitudes."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w)) + 1j * rng.normal(size=(b, h, w))
         ).astype(np.complex64)
    obs = (0.5 * x).astype(np.complex64)
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    mags = np.abs(np.fft.fft2(x.astype(np.complex128)))
    tau = (0.3 * mags.max(axis=(-2, -1))).astype(np.float32)
    if op == "hard":
        tau = gap_taus(mags.reshape(b, 1, -1))[:, 0]
    return x, obs, mask, tau


@pytest.mark.parametrize("op", ["hard", "soft", "garrote"])
@pytest.mark.parametrize("h,w", [(128, 128), (128, 256)],
                         ids=["128", "rect-128x256"])
def test_iteration_matches_jax_kernel(h, w, op):
    x, obs, mask, tau = _iteration_inputs(3, h, w, op)
    want = pocs_iteration_fused(_jpair(x), _jpair(obs), mask, tau,
                                alpha=0.75, thresh_op=op, interpret=True)
    got = ks.pocs_iteration(_pair(x), _pair(obs), torch.from_numpy(mask),
                            torch.from_numpy(tau), 0.75, op)
    _agree(_np(got), _np(want), op)


def test_iteration_wrapper_takes_plain_on_cpu_without_counting():
    x, obs, mask, tau = _iteration_inputs(2, 64, 64, "soft")
    args = (_pair(x), _pair(obs), torch.from_numpy(mask),
            torch.from_numpy(tau), 0.75)
    before = ks.pocs_iteration.launches
    got = ks.pocs_iteration(*args, "garotte", "high")
    want = ks.pocs_iteration_plain(*args, "garrote")
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert ks.pocs_iteration.launches == before
    empty = Cplx(torch.zeros(0, 8, 8), torch.zeros(0, 8, 8))
    out = ks.pocs_iteration(empty, empty, torch.ones(8, 8), torch.zeros(0))
    assert out.re.shape == (0, 8, 8)


_Z = torch.zeros(2, 32, 32)


@pytest.mark.parametrize("change,error", [
    ({"thresh_op": "soft-percentile"}, ValueError),
    ({"precision": "fastest"}, ValueError),
    ({"mask": torch.ones(64, 64)}, ValueError),
    ({"tau": torch.ones(3)}, ValueError),
    ({"tau": torch.ones(2, dtype=torch.float64)}, TypeError),
    ({"obs": Cplx(torch.zeros(3, 32, 32), torch.zeros(3, 32, 32))},
     ValueError),
    ({"x": Cplx(_Z.transpose(1, 2), _Z)}, ValueError),  # non-contiguous
])
def test_iteration_wrapper_rejects_what_the_kernel_does_not_take(change,
                                                                  error):
    args = {"x": Cplx(_Z, _Z), "obs": Cplx(_Z, _Z), "mask": torch.ones(32, 32),
            "tau": torch.ones(2), "thresh_op": "hard", "precision": "high"}
    args.update(change)
    with pytest.raises(error):
        ks.pocs_iteration(**args)


def _solve_both(obs, mask, transform="FFT", **change):
    jcfg = jpocs.POCSConfig(**dict(RECOMMENDED, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask),
                                  jget(transform), jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                get_transform(transform), cfg)
    return jres, res, cfg


@pytest.mark.parametrize("version", ["regular", "fast"])
def test_rectangular_scan_matches_jax(version):
    """The FFT cases of tests/test_pallas_kernel.py:59-94 on 128x256: eps
    1e-12 on 'regular' takes the per-iteration route, 'fast' at eps 0 the
    folded solve, both as in the JAX package."""
    rng = np.random.default_rng(7)
    h, w, b = 128, 256, 2
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for fy, fx in ((2, 3), (5, 1)):
            truth[i] += np.exp(2j * np.pi * (fy * yy / h + fx * xx / w))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5).astype(np.float32)[None, :], (h, w)))
    eps = 1e-12 if version == "regular" else 0.0
    jres, res, cfg = _solve_both(truth * mask, mask, niter=6, p_min=1e-3,
                                 version=version, eps=eps)
    route = pocs.solver_route(truth.shape, mask.shape, cfg)
    assert route.route == ("fused-periter" if eps else "fused-folded")
    _agree(_np(res.data), _np(jres.data), "hard", truth)
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist() == [6, 6]
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)


@pytest.mark.parametrize("change", [
    pytest.param(dict(thresh_op="soft", eps=1e-12), id="soft-eps1e-12"),
    pytest.param(dict(thresh_op="garrote", eps=1e-4), id="garrote-freezing"),
    pytest.param(dict(thresh_op="soft", eps=1e-4, keep_cost_history=True),
                 id="soft-history"),
    pytest.param(dict(thresh_op="soft", eps=0.0, keep_cost_history=True,
                      version="regular"), id="soft-history-regular"),
    pytest.param(dict(thresh_op="soft", eps=1e-4, global_early_stop=True),
                 id="soft-global-early-stop"),
    pytest.param(dict(thresh_op="garrote", eps=0.0, version="adaptive",
                      p_min=1e-3), id="garrote-adaptive"),
    pytest.param(dict(eps=1e-4, global_early_stop=True),
                 id="hard-global-early-stop"),
])
def test_scan_options_match_jax(change):
    """Lane freezing, cost history, global early stop and 'adaptive' on
    the per-iteration route: the same iterates, costs and effective
    iteration counts as the JAX package's scan over its kernel."""
    truth, mask = _truth(3, 128, 128)
    jres, res, cfg = _solve_both(truth * mask, mask, niter=10, **change)
    assert pocs.solver_route(truth.shape, mask.shape, cfg).route \
        == "fused-periter"
    op = change.get("thresh_op", "hard")
    _agree(_np(res.data), _np(jres.data), op, truth)
    n = res.n_iterations.tolist()
    assert n == np.asarray(jres.n_iterations).tolist()
    if change.get("eps") == 1e-4 and op == "garrote":
        assert len(set(n)) > 1 and max(n) < 10  # lanes froze apart
    if change.get("global_early_stop"):
        assert max(n) < 10
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)
    if change.get("keep_cost_history"):
        assert tuple(res.cost_history.shape) == (10, 3)
        np.testing.assert_allclose(res.cost_history.numpy(),
                                   np.asarray(jres.cost_history), rtol=1e-3)
    else:
        assert res.cost_history is None


def test_zero_slice_short_circuits_on_the_periter_route():
    truth, mask = _truth(3, 128, 128, seed=4)
    obs = truth * mask
    obs[1] = 0
    jres, res, _ = _solve_both(obs, mask, thresh_op="soft", eps=1e-4,
                               niter=6)
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist()
    assert res.n_iterations[1] == 0 and res.cost[1] == 0
    assert not res.data.re[1].any() and not res.data.im[1].any()


@pytest.mark.parametrize("change", [
    pytest.param({}, id="recommended"),
    pytest.param({"eps": 1e-3}, id="eps"),
    pytest.param({"eps": 0.0, "keep_cost_history": True}, id="history"),
    pytest.param({"eps": 0.0, "global_early_stop": True},
                 id="global-early-stop"),
    pytest.param({"eps": 0.0, "version": "adaptive"}, id="adaptive"),
])
def test_route_table_matches_jax(change):
    jcfg = jpocs.POCSConfig(**dict(RECOMMENDED, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    for shape in ((32, 512, 512), (2, 128, 256)):
        jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("FFT"))
        rt = pocs.solver_route(shape, shape[1:], cfg, get_transform("FFT"))
        assert tuple(rt) == tuple(jrt) and rt.route == "fused-periter"
        assert pocs.runs(rt)
        assert pocs.describe_route(rt) == f"fused-periter[fft] — {rt.reason}"


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


@pytest.mark.parametrize("precision", ["highest", None],
                         ids=["highest", "production"])
def test_recommended_config_through_interpolate_matches_jax(precision):
    """The reference's recommended configuration (eps = 1e-16) on a 3-slice
    128² cube through both packages' ``interpolate``; precision None is the
    drivers' production 'high' (a hand-made bf16x3 in JAX, fp32 here)."""
    truth, mask = _truth(3, 128, 128, seed=5)
    obs = truth * mask
    meta = dict(RECOMMENDED)
    if precision:
        meta["precision"] = precision
    jcube, cube = _cubes(obs, mask)
    jout = jpipe.interpolate(jcube, config={"metadata": meta},
                             mesh=make_mesh(1))
    out = pipe.interpolate(cube, config={"metadata": meta}, device="cpu")
    got, want = _rec(out), _rec(jout)
    assert got.dtype == np.complex64 and got.shape == obs.shape
    assert _snr(truth, got) > _snr(truth, obs) + 3.0
    if precision is None:
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        _agree(got, want, "hard", truth)
    assert out.attrs["pocs_mean_iterations"] == \
        jout.attrs["pocs_mean_iterations"]
    assert out.attrs["history"] == jout.attrs["history"]


def test_periter_working_set():
    """The driver budgets the per-iteration loop's pairs per slice:
    expansion 2 (sixteen pairs) on ``fused-periter`` and on the plain
    scan (``xla-scan``), 1 on the folded solves."""
    cfg, extra = pipe.config_from_yaml({"metadata": RECOMMENDED})
    tr = pipe._production_transform(cfg, extra)
    assert tr == FFTTransform(precision="high")
    assert pipe._transform_subbands(tr, (512, 512), cfg) == 2
    folded = dataclasses.replace(cfg, eps=0.0)
    assert pipe._transform_subbands(tr, (512, 512), folded) == 1
    dct = dataclasses.replace(cfg, transform_kind="DCT")
    # DCT with eps != 0 is the plain XLA scan, budgeted as this scan
    assert pipe._transform_subbands(get_transform("DCT"), (512, 512),
                                    dct) == 2
