"""The port's CURVELET basis against the JAX package's: the windows, the
support-cropped plan and its kernel packing (bit-equal), the fused subband
apply and the streamed decay statistics on the curvelet plan, the box
kernel's plain version on the curvelet's 72-side group, the solve and the
cube driver, the options that raise, the production precision mix, the
driver budget and the compat helpers.

Tolerances as tests/test_torch_shearlet.py and test_torch_shearlet_solve.py
state them: operators soft within 1e-5 of max (fp32 rounding of
differently ordered sums), hard on thresholds in gaps between the
coefficient magnitudes (``gap_taus``) to the same bound; solves soft
within 1e-4 of max, hard by a bounded share of outliers and the SNR
against the truth within 0.1 dB."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models import transforms as jtr
from pseudo_3d_interpolation_tpu.ops import curvelet as jcv
from pseudo_3d_interpolation_tpu.ops import shearlet as jsh
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas import subband as jsb
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (
    CurveletTransform, DecimatedCurveletTransform, get_transform)
from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

TOL = 1e-5
SOFT_TOL = 1e-4
SNR_TOL_DB = 0.1
# hard-threshold solves: at most this share of elements beyond OUTLIER·max
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
HIGHEST = jax.lax.Precision.HIGHEST
OPS = ["soft", "garrote", "hard"]
META = dict(niter=4, thresh_op="hard", thresh_model="exponential",
            p_min=1e-3, version="fast", alpha=0.75, eps=0.0,
            transform_kind="CURVELET", use_pallas=True, pallas_interpret=True)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=shape) * scale).astype(np.float32),
            (rng.normal(size=shape) * scale).astype(np.float32))


def _both(re, im):
    return (JCplx(jnp.asarray(re), jnp.asarray(im)),
            Cplx(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())))


def _np(z) -> np.ndarray:
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _coeff_mags(re, im, psi):
    """|ifft2(fft2(z)·ψ_l)| in float64, (B, L, H·W), for gap thresholds."""
    zf = np.fft.fft2(re.astype(np.float64) + 1j * im)
    c = np.fft.ifft2(zf[:, None] * psi.astype(np.float64)[None])
    return np.abs(c).reshape(c.shape[0], c.shape[1], -1)


@pytest.mark.parametrize("h,w,kw", [
    (512, 512, {}), (256, 256, {}), (128, 128, {}), (128, 256, {}),
    (256, 256, {"allcurvelets": True}), (256, 256, {"nbangles_coarse": 8})],
    ids=["512", "256", "128", "128x256", "allcurvelets", "8-angles"])
def test_spectra_and_plan_bit_equal_to_jax(h, w, kw):
    psi, jpsi = cv.curvelet_spectra(h, w, **kw), jcv.curvelet_spectra(h, w,
                                                                      **kw)
    assert psi.dtype == jpsi.dtype == np.float32
    np.testing.assert_array_equal(psi, jpsi)
    plan, jplan = cv.curvelet_plan(h, w, **kw), jcv.curvelet_plan(h, w, **kw)
    assert len(plan) == len(jplan)
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    for g, jg in zip(plan, jplan):
        assert (g.idx_h is None) == (jg.idx_h is None)
        if g.idx_h is not None:
            np.testing.assert_array_equal(g.idx_h, jg.idx_h)
            np.testing.assert_array_equal(g.idx_w, jg.idx_w)
        np.testing.assert_array_equal(g.psi, jg.psi)


def test_ring_angles_subbands_and_scales_match_jax():
    for h, w in ((512, 512), (256, 256), (100, 3000), (16, 16), (8, 8)):
        assert cv.default_nbscales(h, w) == jcv.default_nbscales(h, w)
    for nbscales in (2, 3, 5, 6):
        for coarse in (4, 8, 16):
            for allc in (False, True):
                assert cv.ring_angles(nbscales, coarse, allc) == \
                    jcv.ring_angles(nbscales, coarse, allc)
                assert cv.n_subbands(nbscales, coarse, allc) == \
                    jcv.n_subbands(nbscales, coarse, allc)
    with pytest.raises(ValueError, match="multiple of 4"):
        cv.ring_angles(4, 6)
    with pytest.raises(ValueError, match=">= 2"):
        cv.curvelet_spectra(64, 64, 1)
    # the split plan (the finest ring re-grouped by each wedge's exact
    # support) is the JAX package's: groups, index lists, perm, windows
    plan = cv.curvelet_plan(64, 64, split_threshold=64)
    jplan = jcv.curvelet_plan(64, 64, split_threshold=64)
    assert len(plan) == len(jplan) > len(cv.curvelet_plan(64, 64))
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    for g, jg in zip(plan, jplan):
        assert (g.idx_h is None) == (jg.idx_h is None)
        if g.idx_h is not None:
            np.testing.assert_array_equal(g.idx_h, jg.idx_h)
            np.testing.assert_array_equal(g.idx_w, jg.idx_w)
        np.testing.assert_array_equal(g.psi, jg.psi)


def test_kernel_pack_matches_jax():
    """The 512² plan packs into 41 full-size bands (the 136- and 264-side
    rings zero-padded) and one 72-side box group of 9 bands, as the JAX
    package's natural-order pack."""
    n = 512
    plan, jplan = cv.curvelet_plan(n, n), jcv.curvelet_plan(n, n)
    full, idx, boxes = sh._plan_kernel_pack(plan, n, n)
    jfull, jidx, jboxes = jsh._plan_pallas_pack(jplan, n, n, "natural")
    assert full.psi.shape == (41, n, n)
    np.testing.assert_array_equal(full.psi, np.asarray(jfull))
    np.testing.assert_array_equal(idx, jidx)
    assert [(l0, lg, len(g.idx_h)) for l0, lg, g in boxes] == \
        [(l0, lg, len(g.idx_h)) for l0, lg, g in jboxes] == [(0, 9, 72)]
    jm = [np.asarray(a) for a in jboxes[0][2].box_mats_device(n, n)]
    for mine, theirs in zip(boxes[0][2].box_mats_on(n, n, "cpu"),
                            (jm[0], jm[1], jm[4], jm[5])):
        np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("op", ["soft", "hard"])
def test_box_plain_matches_jax_kernel_on_the_72_side_group(op):
    n = 512
    _, _, boxes = sh._plan_kernel_pack(cv.curvelet_plan(n, n), n, n)
    jg = jsh._plan_pallas_pack(jcv.curvelet_plan(n, n), n, n,
                               "natural")[2][0][2]
    _, lg, g = boxes[0]
    sr, sc = len(g.idx_h), len(g.idx_w)
    xr, xi = _rand((2, sr, sc), 13, scale=100.0)
    mats = g.box_mats_on(n, n, "cpu")
    if op == "hard":
        ah = (mats[0].numpy() + 1j * mats[1].numpy()).astype(np.complex128)
        aw = (mats[2].numpy() + 1j * mats[3].numpy()).astype(np.complex128)
        v = (xr + 1j * xi)[:, None] * g.psi.astype(np.float64)[None]
        c = ah.conj().T @ v @ aw.conj() / (n * n)
        tau = gap_taus(np.abs(c).reshape(2, lg, -1))
    else:
        tau = np.random.default_rng(14).uniform(
            0.0005, 0.005, size=(2, lg)).astype(np.float32)
    jx, x = _both(xr, xi)
    want = jsb.box_group_update_fused(
        jx, jg.psi_device(), jnp.asarray(tau), jg.box_mats_device(n, n), n,
        n, thresh_op=op, precision=HIGHEST, interpret=True)
    got = ksb.box_group_update(x, g.psi_on("cpu"), torch.from_numpy(tau),
                               mats, n, n, op, "highest")
    _close(got, want)


@pytest.mark.parametrize("op", OPS)
def test_subband_apply_matches_jax_kernel_route(op):
    """The streamed route CPU tensors take, and the spectral kernel route on
    the kernels' plain versions, against the JAX package's kernel route in
    interpret mode on the 256² curvelet plan, B=2."""
    n = 256
    plan, jplan = cv.curvelet_plan(n, n), jcv.curvelet_plan(n, n)
    re, im = _rand((2, n, n), 15)
    n_bands = cv.n_subbands(cv.default_nbscales(n, n))
    if op == "hard":
        tau = gap_taus(_coeff_mags(re, im, cv.curvelet_spectra(n, n)))
    else:
        tau = np.random.default_rng(16).uniform(
            0.1, 1.0, size=(2, n_bands)).astype(np.float32)
    jz, z = _both(re, im)
    want = jsh.pocs_subband_apply(jz, jplan, jnp.asarray(tau), op,
                                  use_pallas=True, pallas_interpret=True)
    t = torch.from_numpy(tau)
    _close(sh.pocs_subband_apply(z, plan, t, op), want)
    _close(sh._pocs_subband_apply_kernels(z, plan, t, op, "high", "highest"),
           want)


def test_subband_stats_and_streamed_decay_match_jax():
    n = 256
    re, im = _rand((2, n, n), 17)
    jz, z = _both(re, im)
    amax, sumsq = sh.subband_stats(z, cv.curvelet_plan(n, n))
    jamax, jsumsq = jsh.subband_stats(jz, jcv.curvelet_plan(n, n))
    np.testing.assert_allclose(amax.numpy(), np.asarray(jamax), rtol=TOL)
    np.testing.assert_allclose(sumsq.numpy(), np.asarray(jsumsq), rtol=TOL)
    tr, jt = CurveletTransform(), jtr.CurveletTransform()
    for model in ("exponential", "linear"):
        got = tr.decay_from_input(z, model, 7, 0.99, 1e-3, "values")
        want = jt.decay_from_input(jz, model, 7, 0.99, 1e-3, "values")
        assert tuple(got.shape) == (7, 2, 34)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_planned_transforms_and_full_decay_match_jax():
    """forward / inverse / threshold / decay of the materialised stack (the
    decay route of data-driven and non-'values' models)."""
    n = 128
    re, im = _rand((2, n, n), 18)
    jz, z = _both(re, im)
    tr, jt = CurveletTransform(), jtr.CurveletTransform()
    n_bands = cv.n_subbands(cv.default_nbscales(n, n))
    c, jc = tr.forward(z), jt.forward(jz)
    assert tuple(c.re.shape) == (2, n_bands, n, n)
    _close(c, jc)
    _close(tr.inverse(c), jt.inverse(jc))
    _close(tr.inverse(c), z, tol=2e-6)  # tight frame: exact round trip
    t = np.full((2, n_bands), 0.02, np.float32)
    _close(tr.threshold(c, torch.from_numpy(t), "soft"),
           jt.threshold(jc, jnp.asarray(t), "soft"))
    got = tr.decay_from_input(z, "data-driven", 5, 0.99, 1e-3, "values")
    want = np.asarray(jt.decay_from_input(jz, "data-driven", 5, 0.99, 1e-3,
                                          "values"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * want.max())


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


@pytest.mark.parametrize("change", [
    pytest.param(dict(thresh_op="soft"), id="soft-fast"),
    pytest.param(dict(thresh_op="garrote", version="regular",
                      keep_cost_history=True), id="garrote-regular-history"),
    pytest.param(dict(), id="hard-fast"),
])
def test_pocs_interpolate_matches_jax(change):
    truth, mask = _truth(2, 256, 256, seed=1)
    obs = truth * mask
    jcfg = jpocs.POCSConfig(**dict(META, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)),
        jnp.asarray(mask), jtr.CurveletTransform(), jcfg)
    res = pocs.pocs_interpolate(
        Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy())),
        torch.from_numpy(mask), CurveletTransform(), cfg)
    _agree(_np(res.data), _np(jres.data), change.get("thresh_op", "hard"),
           truth)
    assert res.n_iterations.tolist() == np.asarray(
        jres.n_iterations).tolist() == [4, 4]
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-2)
    if change.get("keep_cost_history"):
        np.testing.assert_allclose(res.cost_history.numpy(),
                                   np.asarray(jres.cost_history), rtol=1e-2)


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
                                          ("hard", None)],
                         ids=["soft-highest", "hard-production"])
def test_cube_matches_jax(op, precision):
    """A 3-slice 128² cube through both packages' ``interpolate``, cut to 6
    iterations; precision None is the drivers' production mix ('high'
    full-size bands, 'highest' box groups), which must beat the masked
    input (six soft iterations from p_max 0.99 have not yet)."""
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
    if precision is None:
        assert _snr(truth, got) > _snr(truth, obs)
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        _agree(got, want, op, truth)
    assert out.attrs["history"] == jout.attrs["history"]


def test_route_table_lists_curvelet():
    jcfg = jpocs.POCSConfig(**META)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    for shape in ((32, 512, 512), (4, 384, 512)):
        jrt = jpocs.solver_route(shape, shape[1:], jcfg,
                                 jtr.get_transform("CURVELET"))
        rt = pocs.solver_route(shape, shape[1:], cfg,
                               get_transform("CURVELET"))
        assert tuple(rt) == ("streamed-subband", "", "")
        assert pocs.describe_route(rt) == "streamed-subband"
        assert tuple(jrt) == tuple(rt)


def test_options_that_raise():
    tr = CurveletTransform()
    z = Cplx(torch.ones(1, 64, 64), torch.zeros(1, 64, 64))
    for fn in (tr.decay_from_input, lambda *a: tr.decay(tr.forward(z),
                                                        *a[1:])):
        with pytest.raises(ValueError, match="shearlet-specific"):
            fn(z, "exponential", 3, 0.99, "adaptive", "values")
    # the decimated form runs on the plain scan
    assert get_transform("CURVELET", decimated=True) == \
        DecimatedCurveletTransform()
    with pytest.raises(ValueError, match="box_precision does not apply"):
        get_transform("CURVELET", decimated=True, box_precision="high")
    with pytest.raises(ValueError, match="unknown precision"):
        get_transform("CURVELET", box_precision="fastest")


def test_production_precision_mix_applies_only_when_unset():
    cfg, _ = pipe.config_from_yaml({"metadata": META})
    mix = CurveletTransform(precision="high", box_precision="highest")
    assert pipe._production_transform(cfg, {}) == mix
    assert jpipe._production_transform(
        jpocs.POCSConfig(**META), {})[1] == {"precision": "high",
                                             "box_precision": "highest"}
    # an explicit uniform precision gets no box precision injected
    assert pipe._production_transform(cfg, {"precision": "highest"}) == \
        CurveletTransform(precision="highest")
    assert pipe._production_transform(
        cfg, {"precision": "high", "box_precision": "high"}) == \
        CurveletTransform(precision="high", box_precision="high")
    # the decimated form keeps its own 'highest' (JAX pipeline/pocs.py:85)
    assert pipe._production_transform(cfg, {"decimated": True}) == \
        DecimatedCurveletTransform(precision="highest")


def test_budget_counts_curvelet_as_a_spectral_stack(monkeypatch):
    """The driver budgets CURVELET as SHEARLET: the streamed scan's two
    pairs per slice, its 50 wedges at 512² when the decay needs the stack,
    the windows twice, the kernel scratch and the box group's; with
    ``P3D_SPATIAL_IO`` set one (B, H, W) spectrum more."""
    monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    cfg, _ = pipe.config_from_yaml({"metadata": META})
    tr = CurveletTransform(precision="high", box_precision="highest")
    n_bands = cv.n_subbands(cv.default_nbscales(512, 512))
    assert n_bands == 50
    assert pipe._transform_subbands(tr, (512, 512), cfg) == 2
    full = dataclasses.replace(cfg, thresh_model="data-driven")
    assert pipe._transform_subbands(tr, (512, 512), full) == 50
    assert pipe._transform_subbands(
        CurveletTransform(allcurvelets=True), (512, 512), full) == \
        cv.n_subbands(6, 16, True)
    # and the 72-side box group's call: 9 bands of 72 field columns
    box = ksb.box_scratch_bytes(32, 9, 72, 72, 512)
    assert pipe._transform_device_bytes(tr, 32, 512, 512) == \
        2 * 50 * 512 * 512 * 4 + ksb.SCRATCH_BYTES + box
    monkeypatch.setenv("P3D_SPATIAL_IO", "1")
    assert pipe._transform_device_bytes(tr, 32, 512, 512) == \
        2 * 50 * 512 * 512 * 4 + ksb.SCRATCH_BYTES + 32 * 512 * 512 * 8 + box


def test_compat_carries_curvelet_options_and_plans():
    jt = jtr.CurveletTransform(nbscales=4, nbangles_coarse=8,
                               allcurvelets=True, precision="high",
                               box_precision="highest")
    kw = {k: v for k, v in vars(jt).items() if k != "kind"}
    assert compat.transform_from_reference("CURVELET", kw) == \
        CurveletTransform(nbscales=4, nbangles_coarse=8, allcurvelets=True,
                          precision="high", box_precision="highest")
    jplan = jcv.curvelet_plan(128, 128, 4, 8, True)
    plan = compat.plan_from_reference(
        [(g.idx_h, g.idx_w, g.psi) for g in jplan], jplan.perm)
    mine = cv.curvelet_plan(128, 128, 4, 8, True)
    assert len(plan) == len(mine)
    for g, h in zip(plan, mine):
        np.testing.assert_array_equal(g.psi, h.psi)
        assert (g.idx_h is None) == (h.idx_h is None)
    re, im = _rand((1, 128, 128), 19)
    z = Cplx(torch.from_numpy(re), torch.from_numpy(im))
    tau = torch.full((1, cv.n_subbands(4, 8, True)), 0.05)
    a = sh.pocs_subband_apply(z, plan, tau, "soft")
    b = sh.pocs_subband_apply(z, mine, tau, "soft")
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
