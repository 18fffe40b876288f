"""The decimated CURVELET (``get_transform("CURVELET", decimated=True)``,
CurveLab's wrapped coefficient storage) against the JAX package's: the
layout of wrapped grids, bit for bit; the coefficient count at 512²; the
forward and inverse transforms; perfect reconstruction; the decay; the
solve on the plain scan (``xla-scan``), soft elementwise and hard by SNR;
and ``pipeline.pocs.interpolate`` with ``decimated: true``.

Tolerances: the layout is numpy on both sides, built the same way: equal.
The transforms are ``torch.fft`` against the JAX package's HIGHEST matmul
DFTs: within 1e-5·max. Soft solves max|Δ| ≤ 1e-4·max|JAX|; hard solves
SNR against the truth within 0.1 dB."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops import curvelet as jcv
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (
    DecimatedCurveletTransform, get_transform)
from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

TRANSFORM_TOL = 1e-5
SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
SHAPES = [(64, 64), (96, 128), (100, 100)]
SHAPE_IDS = ["64", "96x128", "100"]


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _pair(a):
    return Cplx(torch.from_numpy(np.ascontiguousarray(a.real, np.float32)),
                torch.from_numpy(np.ascontiguousarray(a.imag, np.float32)))


def _jpair(a):
    return JCplx(jnp.asarray(a.real, jnp.float32),
                 jnp.asarray(a.imag, jnp.float32))


def _np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


@pytest.mark.parametrize("h,w", SHAPES + [(512, 512)],
                         ids=SHAPE_IDS + ["512"])
def test_layout_is_bit_equal(h, w):
    got = cv.decimated_layout(h, w)
    want = jcv.decimated_layout(h, w)
    assert len(got) == len(want) == cv.n_subbands(cv.default_nbscales(h, w))
    for (rows, cols, psi), (jrows, jcols, jpsi) in zip(got, want):
        assert (rows is None) == (jrows is None)
        if rows is not None:
            np.testing.assert_array_equal(rows, jrows)
            np.testing.assert_array_equal(cols, jcols)
            assert len(rows) % 8 == 0 and len(cols) % 8 == 0
        assert psi.dtype == np.float32 and psi.shape == np.shape(jpsi)
        np.testing.assert_array_equal(psi, np.asarray(jpsi))


def test_coeff_elements_at_512():
    got = cv.decimated_coeff_elements(512, 512)
    assert got == jcv.decimated_coeff_elements(512, 512)
    dec, full = got
    assert 2.5 < full / dec < 3.1  # about 2.8x fewer (the JAX docstring)


@pytest.mark.parametrize("h,w", SHAPES, ids=SHAPE_IDS)
def test_forward_inverse_match_jax_and_reconstruct(h, w):
    z = _complex((2, h, w), seed=h + w)
    tr = get_transform("CURVELET", decimated=True).with_shape((h, w))
    jtr = jget("CURVELET", decimated=True).with_shape((h, w))
    got = tr.forward(_pair(z))
    want = jtr.forward(_jpair(z))
    assert len(got) == len(want)
    scale = max(np.abs(_np(c)).max() for c in want)
    for g, j in zip(got, want):
        assert g.shape == j.re.shape
        assert np.abs(_np(g) - _np(j)).max() <= TRANSFORM_TOL * scale
    # the inverse of the JAX coefficients, and perfect reconstruction
    back = _np(tr.inverse([Cplx(torch.tensor(np.asarray(c.re)),
                                torch.tensor(np.asarray(c.im)))
                           for c in want]))
    jback = _np(jtr.inverse(want))
    assert np.abs(back - jback).max() <= TRANSFORM_TOL * np.abs(jback).max()
    rec = _np(tr.inverse(got))
    assert np.abs(rec - z).max() <= TRANSFORM_TOL * np.abs(z).max()
    # an N-D batch goes through unchanged
    nd = tr.forward(_pair(z[None]))
    assert all(a.shape == (1,) + b.shape for a, b in zip(nd, got))


def test_decay_matches_jax():
    z = _complex((3, 64, 64), seed=1)
    tr = get_transform("CURVELET", decimated=True)
    jtr = jget("CURVELET", decimated=True)
    for model, kind, p_max, p_min in (("exponential", "values", 0.99, 1e-3),
                                      ("linear", "values", 0.9, 1e-2),
                                      ("exponential", "factors", 99.9, 60)):
        got = tr.decay(tr.forward(_pair(z)), model, 8, p_max, p_min, kind)
        want = jtr.decay(jtr.forward(_jpair(z)), model, 8, p_max, p_min,
                         kind)
        assert got.shape == want.shape == (8, 3, len(tr._layout(64, 64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for p_min, model, match in (("adaptive", "exponential", "shearlet"),
                                (1e-3, "data-driven", "data-driven")):
        with pytest.raises(ValueError, match=match):
            tr.decay(tr.forward(_pair(z)), model, 8, 0.99, p_min, "values")


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


@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("h,w", SHAPES, ids=SHAPE_IDS)
def test_solve_matches_jax(h, w, op):
    truth, mask = _truth(2, h, w, seed=3)
    obs = truth * mask
    jcfg = jpocs.POCSConfig(niter=8, thresh_op=op, p_min=1e-3,
                            version="fast", alpha=0.75,
                            transform_kind="CURVELET", use_pallas=True,
                            pallas_interpret=True)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jtr = jget("CURVELET", decimated=True)
    tr = compat.transform_from_reference("CURVELET", {"decimated": True})
    jrt = jpocs.solver_route(obs.shape, mask.shape, jcfg, jtr)
    rt = pocs.solver_route(obs.shape, mask.shape, cfg, tr)
    assert tuple(rt) == tuple(jrt) == (
        "xla-scan", "", "transform 'CURVELET' has no fused kernel")
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask), jtr, jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask), tr, cfg)
    got, want = _np(res.data), _np(jres.data)
    if op == "hard":
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
        np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                                   rtol=1e-3)
    np.testing.assert_array_equal(res.n_iterations.numpy(),
                                  np.asarray(jres.n_iterations))


def test_factory_route_and_budget():
    tr = get_transform("CURVELET", decimated=True)
    assert tr == DecimatedCurveletTransform()
    assert tr.with_shape((2, 64, 96)).shape == (64, 96)
    with pytest.raises(ValueError, match="box_precision does not apply"):
        get_transform("CURVELET", decimated=True, box_precision="high")
    with pytest.raises(ValueError, match="with_shape"):
        tr.inverse(tr.forward(_pair(_complex((1, 64, 64), seed=2))))
    cfg, _ = pipe.config_from_yaml({"metadata": dict(
        transform_kind="CURVELET", p_min=1e-3, version="fast")})
    # no precision mix: the decimated form keeps its own 'highest'
    assert pipe._production_transform(cfg, {"decimated": True}) == tr
    assert jpipe._production_transform(
        jpocs.POCSConfig(transform_kind="CURVELET"),
        {"decimated": True})[1] == {"decimated": True}
    rt = pocs.solver_route((32, 512, 512), (512, 512), cfg, tr)
    assert pocs.describe_route(rt) == \
        "xla-scan — transform 'CURVELET' has no fused kernel"
    # no streamed apply: L bands a slice, as the JAX package budgets it
    n_bands = len(cv.decimated_layout(512, 512))
    assert pipe._transform_subbands(tr, (512, 512), cfg) == n_bands == \
        jpipe._transform_subbands(jget("CURVELET", decimated=True),
                                  (512, 512), jpocs.POCSConfig())
    dec, _ = cv.decimated_coeff_elements(512, 512)
    assert 4 * dec <= pipe._transform_device_bytes(tr, 32, 512, 512) \
        <= 12 * dec


def test_interpolate_decimated_matches_jax():
    """A 3-slice 64² cube through both packages' ``interpolate`` with
    ``decimated: true`` and a soft threshold."""
    truth, mask = _truth(3, 64, 64, seed=4)
    obs = truth * mask
    meta = dict(niter=8, thresh_op="soft", p_min=1e-3, version="fast",
                alpha=0.75, transform_kind="CURVELET", decimated=True)
    coords = {"iline": np.arange(64), "xline": np.arange(64),
              "freq": np.arange(3, dtype=np.float64)}
    data_vars = {"amp": (("iline", "xline", "freq"),
                         np.ascontiguousarray(np.moveaxis(obs, 0, -1))),
                 "fold": (("iline", "xline"), mask.astype(np.int32))}
    jout = jpipe.interpolate(JCube(coords=dict(coords),
                                   data_vars=dict(data_vars)),
                             config={"metadata": meta}, mesh=make_mesh(1))
    out = pipe.interpolate(Cube(coords=dict(coords),
                                data_vars=dict(data_vars)),
                           config={"metadata": meta}, device="cpu")
    got = np.moveaxis(out.data_vars["amp_interp"][1], -1, 0)
    want = np.moveaxis(np.asarray(jout.data_vars["amp_interp"][1]), -1, 0)
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
    assert np.isfinite(got).all() and got.shape == obs.shape
