"""The SHEARLET solve as a whole: the port's ``pocs_interpolate`` on the
directional route and ``pipeline.pocs.interpolate`` against the JAX
package's (its subband kernels in interpret mode), the route table and the
driver budget.

Tolerances: at 'highest' both sides compute in fp32, so soft thresholds
agree to rounding amplified over the iterations (measured 2.2e-5 of max
after 4 FPOCS iterations at 256²), held to 1e-4. Hard thresholds flip
boundary coefficients when the arithmetic is reordered: the solves are
held to a bounded share of outliers, as tests/test_shearlet.py holds the
JAX package's own routes, and to the same SNR against the truth. The
production 'high' is a hand-made bf16x3 in JAX and fp32 here: SNR within
0.1 dB."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import \
    ShearletTransform as JShearlet
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (
    ShearletTransform, get_transform)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
# hard thresholds: at most this share of elements beyond OUTLIER·max
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
META = dict(niter=4, thresh_op="hard", thresh_model="exponential",
            p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
            transform_kind="SHEARLET", use_pallas=True, pallas_interpret=True)


def _truth(f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((f, h, w), np.complex64)
    for i in range(f):
        for _ in range(5):
            fy, fx = rng.integers(1, 20, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    cols = rng.uniform(size=w) < 0.5
    mask = np.ascontiguousarray(np.broadcast_to(cols[None, :], (h, w)),
                                np.float32)
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


def _solve_both(obs, mask, **change):
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)),
        jnp.asarray(mask), JShearlet(), jcfg)
    res = pocs.pocs_interpolate(
        Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy())),
        torch.from_numpy(mask), ShearletTransform(), cfg)
    return jres, res


def _np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


@pytest.mark.parametrize("change", [
    pytest.param(dict(thresh_op="soft"), id="soft-fast"),
    pytest.param(dict(thresh_op="garrote", version="regular",
                      keep_cost_history=True), id="garrote-regular-history"),
    pytest.param(dict(thresh_op="soft", version="adaptive", p_min=1e-3),
                 id="soft-adaptive"),
    pytest.param(dict(), id="hard-fast"),
])
def test_pocs_interpolate_matches_jax(change):
    truth, mask = _truth(2, 256, 256)
    obs = truth * mask
    jres, res = _solve_both(obs, mask, **change)
    _agree(_np(res.data), _np(jres.data), change.get("thresh_op", "hard"),
           truth)
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist() == [4, 4]
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-2)
    if change.get("keep_cost_history"):
        assert tuple(res.cost_history.shape) == (4, 2)
        np.testing.assert_allclose(res.cost_history.numpy(),
                                   np.asarray(jres.cost_history), rtol=1e-2)
    else:
        assert res.cost_history is None


@pytest.mark.parametrize("global_stop", [False, True])
def test_eps_freezes_converged_lanes_like_jax(global_stop):
    """eps > 0: a slice whose cost falls below eps after iteration 3 keeps
    its state; with global_early_stop the loop ends once every slice has
    (and the zero slice counts 0 iterations)."""
    truth, mask = _truth(3, 128, 128, seed=3)
    obs = truth * mask
    obs[1] = 0
    jres, res = _solve_both(obs, mask, niter=7, eps=0.05, thresh_op="soft",
                            global_early_stop=global_stop)
    n = res.n_iterations.tolist()
    assert n == np.asarray(jres.n_iterations).tolist()
    assert n[1] == 0 and 4 <= n[0] < 7 and 4 <= n[2] < 7
    _agree(_np(res.data), _np(jres.data), "soft", truth)
    assert not res.data.re[1].any()


def test_route_table_matches_jax():
    jcfg = jpocs.POCSConfig(**META)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    for shape in ((32, 512, 512), (4, 384, 512)):
        jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("SHEARLET"))
        rt = pocs.solver_route(shape, shape[1:], cfg,
                               get_transform("SHEARLET"))
        assert tuple(rt) == ("streamed-subband", "", "")
        assert pocs.describe_route(rt) == "streamed-subband"
        if shape[1] % 128 == 0 and shape[2] % 128 == 0:
            assert tuple(jrt) == tuple(rt)
    # percentile thresholds: JAX's plain streamed apply, the port's split
    # subband kernels (plain versions on the CPU), under one reason
    jcfg = dataclasses.replace(jcfg, thresh_op="soft-percentile")
    cfg = dataclasses.replace(cfg, thresh_op="soft-percentile")
    shape = (2, 128, 128)
    jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("SHEARLET"))
    rt = pocs.solver_route(shape, shape[1:], cfg)
    assert tuple(rt) == tuple(jrt)
    assert pocs.runs(rt)
    z = Cplx(torch.ones(shape), torch.zeros(shape))
    res = pocs.pocs_interpolate(z, torch.ones(shape[1:]), config=cfg)
    assert res.data.re.shape == shape
    assert bool(torch.isfinite(res.data.re).all())


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
    """A 3-slice 128² cube through both packages' ``interpolate``, the
    production configuration cut to 6 iterations; precision None is the
    drivers' production default 'high'."""
    truth, mask = _truth(3, 128, 128, seed=5)
    obs = truth * mask
    meta = dict(META, niter=6, thresh_op=op)
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
    assert out.attrs["history"] == jout.attrs["history"]
    assert out.attrs["pocs_mean_iterations"] == 6


def test_production_precision_and_working_set():
    cfg, extra = pipe.config_from_yaml({"metadata": META})
    tr = pipe._production_transform(cfg, extra)
    assert tr == ShearletTransform(precision="high")
    assert pipe._production_transform(cfg, {"box_precision": "highest"}) \
        == ShearletTransform(precision="high", box_precision="highest")
    assert pipe._transform_subbands(tr, (512, 512), cfg) == 2
    full = dataclasses.replace(cfg, thresh_model="data-driven")
    assert pipe._transform_subbands(tr, (512, 512), full) == 61
    assert pipe._transform_subbands(get_transform("FFT"), (512, 512),
                                     cfg) == 1
    # windows twice, the kernel scratch, capped at 1 GiB, and the larger
    # box group's call (8 bands of 40 field columns, a 40-side result)
    assert pipe._transform_device_bytes(tr, 32, 512, 512) == \
        2 * 61 * 512 * 512 * 4 + ksb.SCRATCH_BYTES \
        + ksb.box_scratch_bytes(32, 8, 40, 40, 512)
    assert ksb.scratch_bytes(1, 512, 512, 48) == 48 * 512 * 512 * 8
    assert pipe._transform_device_bytes(get_transform("FFT"), 32, 512,
                                        512) == 0
