"""The WAVELET basis: the port's own filter builders and periodized DWT
(pseudo_3d_interpolation_torch/ops/wavelet.py) against the JAX package's,
its folded solve ``pocs_solve(basis='wavelet')`` against the JAX package's
``pocs_solve_fused(basis='wavelet')`` in interpret mode, and the whole
``fused-folded[wavelet]`` route through ``pocs_interpolate`` and
``pipeline.pocs.interpolate`` against the JAX package's (``use_pallas``,
``pallas_interpret``). On the CPU the wrapper takes its plain
``torch.matmul`` cascade; the CUDA kernel is held against that in
tests/test_torch_cuda.py.

Tolerances: the filters and ``dwt_matrix`` are bit-equal (the same numpy
code). The transforms are fp32 sums in another order (JAX: strided
convolutions; port: matrix products): 1e-5·max. Soft and garrote solves:
max|Δ| ≤ 1e-4·max|JAX|; hard solves: SNR against the truth within 0.1 dB
and a bounded share of outliers; effective iteration counts equal. The
band order is checked with a distinct threshold per band against the
conv cascade's own decay tree."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops import wavelet as jwv
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import pocs_solve_fused
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (
    WaveletTransform, get_transform)
from pseudo_3d_interpolation_torch.ops import wavelet as wv
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

TRANSFORM_TOL = 1e-5
SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
NITER = 8
# the production stage-2 configuration on the WAVELET basis, where the
# adaptive minimum is undefined (JAX models/transforms.py:179-183)
META = dict(niter=NITER, thresh_op="hard", thresh_model="exponential",
            p_min=1e-5, version="fast", alpha=0.75, eps=0.0,
            transform_kind="WAVELET", use_pallas=True, pallas_interpret=True)
NAMES = ["haar", "db1", "db2", "db4", "db8", "db20", "sym2", "sym4", "sym8",
         "sym12", "coif1", "coif3", "coif5"]


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


@pytest.mark.parametrize("name", NAMES)
def test_filters_are_bit_equal(name):
    for mine, theirs in zip(wv.wavelet_filters(name),
                            jwv.wavelet_filters(name), strict=True):
        assert mine.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)
    assert wv.filter_length(name) == jwv.filter_length(name)
    for n in (16, 100, 128, 512):
        assert wv.max_level(n, name) == jwv.max_level(n, name)


@pytest.mark.parametrize("n,name", [(8, "db4"), (64, "db4"), (512, "db4"),
                                    (128, "coif5"), (32, "coif5"),
                                    (40, "sym8")])
def test_dwt_matrix_is_bit_equal(n, name):
    np.testing.assert_array_equal(wv.dwt_matrix(n, name),
                                  jwv.dwt_matrix(n, name))


def test_unknown_or_short_wavelets_raise():
    with pytest.raises(ValueError, match="not available"):
        wv.wavelet_filters("bior2.2")
    with pytest.raises(ValueError, match="too short"):
        wv.dwt_matrix(16, "coif5")
    with pytest.raises(ValueError, match="too deep"):
        wv.wavedec2(torch.zeros(64, 64), "coif5", 3)


@pytest.mark.parametrize("name,level,shape", [
    ("db4", 3, (2, 128, 128)), ("db4", None, (96, 64)),
    ("coif5", 2, (2, 128, 64)), ("haar", 4, (32, 48))])
def test_wavedec2_and_waverec2_match_jax(name, level, shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = wv.wavedec2(torch.from_numpy(x), name, level)
    want = jwv.wavedec2(jnp.asarray(x), name, level)
    assert len(got) == len(want)
    scale = np.abs(x).max()
    flat_got = [got[0]] + [c for det in got[1:] for c in det]
    flat_want = [want[0]] + [c for det in want[1:] for c in det]
    for a, b in zip(flat_got, flat_want, strict=True):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.abs(a.numpy() - np.asarray(b)).max() <= \
            TRANSFORM_TOL * scale
    back = wv.waverec2(got, name).numpy()
    np.testing.assert_allclose(back, x, atol=TRANSFORM_TOL * scale)


@pytest.mark.parametrize("kw,shape", [
    ({}, (2, 128, 128)), ({"wavelet": "coif5"}, (2, 100, 70)),
    ({"wavelet": "db2", "level": 2}, (3, 37, 50))])
def test_transform_with_shape_pads_and_decays_like_jax(kw, shape):
    tr = WaveletTransform(**kw).with_shape(shape)
    jtr = jget("WAVELET", **kw).with_shape(shape)
    assert (tr.level, tr.crop, tr.target) == (jtr.level, jtr.crop,
                                              jtr.target)
    rng = np.random.default_rng(4)
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
         ).astype(np.complex64)
    coeffs = tr.forward(_pair(z))
    jcoeffs = jtr.forward(_jpair(z))
    scale = np.abs(z).max()
    assert np.abs(_np(coeffs[0]) - _np(jcoeffs[0])).max() <= \
        TRANSFORM_TOL * scale
    np.testing.assert_allclose(_np(tr.inverse(coeffs)), z,
                               atol=TRANSFORM_TOL * scale)
    decay = tr.decay(coeffs, "exponential", 5, 0.99, 1e-3, "values")
    jdecay = jtr.decay(jcoeffs, "exponential", 5, 0.99, 1e-3, "values")
    assert not decay[0].any() and tuple(decay[0].shape) == (5, shape[0])
    for det, jdet in zip(decay[1:], jdecay[1:], strict=True):
        for leaf, jleaf in zip(det, jdet, strict=True):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="adaptive"):
        tr.decay(coeffs, "exponential", 5, 0.99, "adaptive", "values")


def _flat_decay(tr, obs, niter, seed=None):
    """The transform's decay tree flattened to (niter, B, 3·level), deepest
    level first; with ``seed``, each band's schedule scaled by its own
    factor so that every band has a distinct threshold."""
    tree = tr.decay(tr.forward(_pair(obs)), "exponential", niter, 0.99,
                    1e-3, "values")
    flat = torch.stack([leaf for det in tree[1:] for leaf in det], dim=-1)
    if seed is not None:
        f = np.random.default_rng(seed).uniform(0.3, 1.0, flat.shape[-1])
        flat = flat * torch.from_numpy(f.astype(np.float32))
    return flat.contiguous()


def test_band_order_matches_the_conv_cascade():
    """One regular iteration of the kernel's quadrant map with a distinct
    soft threshold per band equals the transform's own forward, per-band
    threshold of its decay tree, inverse and reinsertion."""
    truth, mask = _truth(2, 128, 128, seed=6)
    obs = truth * mask
    tr = WaveletTransform().with_shape(obs.shape)
    flat = _flat_decay(tr, obs, 1, seed=9)
    mats = [wv.dwt_matrix(128 >> j, "db4") for j in range(tr.level)]
    got, _ = ks.pocs_solve(_pair(obs), torch.from_numpy(mask), flat, 0.75,
                           "soft", "regular", basis="wavelet",
                           wavelet_mats=mats)
    level = tr.level
    tree = [None] + [tuple(flat[:, :, 3 * d + k][0] for k in range(3))
                     for d in range(level)]
    rec = tr.inverse(tr.threshold(tr.forward(_pair(obs)), tree, "soft"))
    keep = 1.0 - 0.75 * mask
    want = _np(rec) * keep + 0.75 * obs
    assert np.abs(_np(got) - want).max() <= SOFT_TOL * np.abs(want).max()
    # the same distinct thresholds through the JAX kernel
    jgot, _ = pocs_solve_fused(_jpair(obs), mask, flat.numpy(), alpha=0.75,
                               thresh_op="soft", version="regular",
                               interpret=True, basis="wavelet",
                               wavelet_mats=mats)
    assert np.abs(_np(got) - _np(jgot)).max() <= \
        SOFT_TOL * np.abs(want).max()


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("name", ["db4", "coif5"])
def test_solve_matches_jax_kernel(name, version, op):
    truth, mask = _truth(2, 128, 128, seed=2)
    obs = truth * mask
    tr = WaveletTransform(wavelet=name, level=3).with_shape(obs.shape)
    assert tr.target is None
    flat = _flat_decay(tr, obs, NITER)
    mats = [wv.dwt_matrix(128 >> j, name) for j in range(3)]
    want, want_cost = pocs_solve_fused(
        _jpair(obs), mask, flat.numpy(), alpha=0.75, thresh_op=op,
        version=version, interpret=True, basis="wavelet", wavelet_mats=mats)
    got, cost = ks.pocs_solve(_pair(obs), torch.from_numpy(mask), flat,
                              0.75, op, version, basis="wavelet",
                              wavelet_mats=mats)
    _agree(_np(got), _np(want), op, truth)
    if op != "hard":
        np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost),
                                   rtol=1e-3)


_Z = torch.zeros(2, 32, 32)
_MATS = [wv.dwt_matrix(32 >> j, "db4") for j in range(2)]


@pytest.mark.parametrize("change,error", [
    ({"obs": Cplx(torch.zeros(2, 32, 64), torch.zeros(2, 32, 64)),
      "mask": torch.ones(32, 64)}, ValueError),  # not square
    ({"wavelet_mats": None}, ValueError),
    ({"wavelet_mats": _MATS[::-1]}, ValueError),
    ({"decay": torch.ones(3, 2)}, ValueError),
    ({"decay": torch.ones(3, 2, 5)}, ValueError),
])
def test_wavelet_solve_rejects_what_the_kernel_does_not_take(change, error):
    args = {"obs": Cplx(_Z, _Z), "mask": torch.ones(32, 32),
            "decay": torch.ones(3, 2, 6), "thresh_op": "hard",
            "version": "fast", "basis": "wavelet", "wavelet_mats": _MATS}
    args.update(change)
    with pytest.raises(error):
        ks.pocs_solve(**args)


def _solve_both(obs, mask, jtr=None, tr=None, **change):
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask),
                                  jtr or jget("WAVELET"), jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                tr or get_transform("WAVELET"), cfg)
    return jres, res, cfg


@pytest.mark.parametrize("op", ["soft", "hard"])
def test_pocs_interpolate_matches_jax_with_a_zero_slice(op):
    truth, mask = _truth(3, 128, 128, seed=3)
    truth[1] = 0
    obs = truth * mask
    jres, res, cfg = _solve_both(obs, mask, thresh_op=op)
    assert tuple(pocs.solver_route(obs.shape, mask.shape, cfg)) == \
        ("fused-folded", "wavelet", "")
    keep = [0, 2]
    _agree(_np(res.data)[keep], _np(jres.data)[keep], op, truth[keep])
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist() == [NITER, 0, NITER]
    assert res.cost[1] == 0 and not res.data.re[1].any()
    if op == "soft":
        np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                                   rtol=1e-3)


@pytest.mark.parametrize("shape,change,route", [
    ((32, 512, 512), {}, "fused-folded"),
    ((2, 128, 128), {"eps": 1e-12}, "xla-scan"),
    ((2, 128, 128), {"version": "adaptive"}, "xla-scan"),
    ((2, 128, 256), {}, "xla-scan"),  # not square
    ((2, 128, 128), {"thresh_op": "soft-percentile", "decay_kind": "factors",
                     "p_max": 99.9, "p_min": 60.0}, "xla-scan"),
])
def test_route_table_matches_jax(shape, change, route):
    """The routes are the JAX package's, and every one runs: the XLA-scan
    rows solve as the JAX package's plain scan does."""
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jrt = jpocs.solver_route(shape, shape[1:], jcfg, jget("WAVELET"))
    rt = pocs.solver_route(shape, shape[1:], cfg, get_transform("WAVELET"))
    assert (rt.route, rt.basis) == (jrt.route, jrt.basis) == \
        (route, "wavelet")
    assert pocs.runs(rt)
    if route == "xla-scan":
        truth, mask = _truth(*shape, seed=9)
        obs = truth * mask
        jres, res, _ = _solve_both(obs, mask, **change)
        op = "hard" if cfg.thresh_op == "hard" else "soft"
        _agree(_np(res.data), _np(jres.data), op, truth)
        assert res.n_iterations.tolist() == np.asarray(
            jres.n_iterations).tolist()


def test_padded_wavelet_takes_the_unported_scan():
    """A slice that needs the zero-padded target (101², odd) has no
    kernel: the JAX package also sends it to its XLA scan."""
    cfg = compat.config_from_reference(
        dataclasses.asdict(jpocs.POCSConfig(**META)))
    rt = pocs.solver_route((2, 101, 101), (101, 101), cfg)
    jrt = jpocs.solver_route((2, 101, 101), (101, 101),
                             jpocs.POCSConfig(**META), jget("WAVELET"))
    assert (rt.route, rt.basis) == (jrt.route, jrt.basis) == \
        ("xla-scan", "wavelet")
    assert "resize target" in rt.reason
    # the port's gate is the kernel's own: 96² at level 3 (the JAX gate
    # wants 128-multiples) runs here
    assert pocs.solver_route((2, 96, 96), (96, 96), cfg).route == \
        "fused-folded"


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


@pytest.mark.parametrize("extra", [{}, {"wavelet": "coif5", "level": 3}],
                         ids=["db4-production", "coif5-level3"])
def test_cube_matches_jax_at_production_defaults(extra):
    """A 3-slice 128² cube through both packages' ``interpolate`` at the
    production defaults (precision 'high': a hand-made bf16x3 in JAX, fp32
    here) with p_min 1e-5; the YAML extras ``wavelet`` and ``level`` reach
    the transform."""
    truth, mask = _truth(3, 128, 128, seed=5)
    obs = truth * mask
    meta = dict(META, **extra)
    jcube, cube = _cubes(obs, mask)
    jout = jpipe.interpolate(jcube, config={"metadata": meta},
                             mesh=make_mesh(1))
    out = pipe.interpolate(cube, config={"metadata": meta}, device="cpu")
    got, want = _rec(out), _rec(jout)
    assert got.dtype == np.complex64 and got.shape == obs.shape
    assert _snr(truth, got) > _snr(truth, obs)
    assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    assert out.attrs["pocs_mean_iterations"] == NITER
    assert out.attrs["history"] == jout.attrs["history"]
    cfg, ext = pipe.config_from_yaml({"metadata": meta})
    assert pipe._production_transform(cfg, ext) == WaveletTransform(
        precision="high", **extra)


def test_compat_carries_the_wavelet_over():
    jtr = jget("WAVELET", wavelet="coif5", level=2)
    tr = compat.transform_from_reference(
        "WAVELET", {"wavelet": jtr.wavelet, "level": np.int64(jtr.level)})
    assert tr == WaveletTransform(wavelet="coif5", level=2)
    assert pipe._transform_subbands(tr, (128, 128), pocs.POCSConfig()) == 1
    truth, mask = _truth(2, 128, 128, seed=8)
    obs = truth * mask
    jres, res, _ = _solve_both(obs, mask, jtr=jtr, tr=tr, thresh_op="soft")
    _agree(_np(res.data), _np(jres.data), "soft", truth)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)
