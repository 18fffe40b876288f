"""The rest of the transforms' public API against the JAX package:
the unplanned shearlet pair, the split plans (``build_plan`` and
``curvelet_plan`` with ``split_threshold``) and the fused apply on them,
the pywt-mode wavelet functions, and ``cplx.zeros`` / ``cplx.where``.

Tolerances: the unplanned pair within 1e-5 of max (two FFT libraries in
float32); the plans exactly (groups, index lists, ``perm``, windows bit
for bit, the kernel packing); the split-plan apply within 1e-5 of max of
the JAX package's and of the port's box plan (the same linear maps
grouped otherwise; hard thresholds sit in gaps of the coefficients'
magnitudes, ``torch_helpers.gap_taus``, so none flips); the wavelet
functions bit for bit (the same float64 numpy code) and as JAX's own
tests hold them (tests/test_wavelet.py:195-245)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.ops import cplx as jcplx
from pseudo_3d_interpolation_tpu.ops import curvelet as jcv
from pseudo_3d_interpolation_tpu.ops import shearlet as jsh
from pseudo_3d_interpolation_tpu.ops import wavelet as jwv
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_torch.ops import cplx
from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops import wavelet as wv
from pseudo_3d_interpolation_torch.ops.cplx import Cplx

torch.set_num_threads(2)

TOL = 1e-5
OPS = ["soft", "garrote", "hard"]
# (basis, h, w, split_threshold): the fine scales split; at 512² the k=0
# shear pair lands on 447 x 63 columns and 63 x 447 rows
SPLITS = [("shearlet", 128, 128, 60), ("shearlet", 128, 256, 100),
          ("shearlet", 512, 512, 200), ("curvelet", 128, 128, 64),
          ("curvelet", 256, 256, 200), ("shearlet", 64, 64, 30),
          ("shearlet", 64, 128, 50)]


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _both(re, im):
    return (JCplx(jnp.asarray(re), jnp.asarray(im)),
            Cplx(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())))


def _np(z) -> np.ndarray:
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _plans(basis, h, w, split):
    if basis == "shearlet":
        return (sh.shearlet_plan(h, w, split_threshold=split),
                jsh.shearlet_plan(h, w, split_threshold=split))
    return (cv.curvelet_plan(h, w, split_threshold=split),
            jcv.curvelet_plan(h, w, split_threshold=split))


@pytest.mark.parametrize("h,w", [(64, 64), (96, 128)])
def test_unplanned_shearlet_pair_matches_jax(h, w):
    psi = sh.shearlet_spectra(h, w)
    re, im = _rand((2, h, w), 1)
    jz, z = _both(re, im)
    coeffs = sh.shearlet_transform(z, psi)
    jcoeffs = jsh.shearlet_transform(jz, psi)
    assert coeffs.re.shape == (2, psi.shape[0], h, w)
    _close(coeffs, jcoeffs)
    _close(sh.inverse_shearlet_transform(coeffs, psi),
           jsh.inverse_shearlet_transform(jcoeffs, psi))
    # a tight frame: the pair reconstructs, and the planned forward is the
    # unplanned one in plan order
    _close(sh.inverse_shearlet_transform(coeffs, torch.from_numpy(psi)), z)
    plan = sh.shearlet_plan(h, w)
    _close(sh.shearlet_transform_planned(z, plan),
           Cplx(coeffs.re[:, plan.perm], coeffs.im[:, plan.perm]))


@pytest.mark.parametrize("basis,h,w,split", SPLITS,
                         ids=[f"{b}-{h}x{w}-{s}" for b, h, w, s in SPLITS])
def test_split_plan_equals_jax(basis, h, w, split):
    plan, jplan = _plans(basis, h, w, split)
    assert len(plan) == len(jplan)
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    assert sorted(plan.perm) == list(range(len(plan.perm)))
    n_split = 0
    for g, jg in zip(plan, jplan):
        assert (g.idx_h is None) == (jg.idx_h is None)
        if g.idx_h is not None:
            np.testing.assert_array_equal(g.idx_h, jg.idx_h)
            np.testing.assert_array_equal(g.idx_w, jg.idx_w)
            assert g.idx_h.dtype == jg.idx_h.dtype
            n_split += len(g.idx_h) != len(g.idx_w)
        assert g.psi.dtype == jg.psi.dtype
        np.testing.assert_array_equal(g.psi, jg.psi)
    assert n_split > 0  # some group is not a centred square box
    full, idx, boxes = sh._plan_kernel_pack(plan, h, w)
    jfull, jidx, jboxes = jsh._plan_pallas_pack(jplan, h, w, "natural")
    np.testing.assert_array_equal(full.psi, np.asarray(jfull))
    np.testing.assert_array_equal(idx, jidx)
    assert [(l0, lg, len(g.idx_h), len(g.idx_w)) for l0, lg, g in boxes] \
        == [(l0, lg, len(g.idx_h), len(g.idx_w)) for l0, lg, g in jboxes]
    # without a threshold the plan is the box plan, perm the identity
    box, _ = _plans(basis, h, w, None)
    assert np.array_equal(box.perm, np.arange(len(box.perm)))


def test_split_plan_at_512_has_the_cone_boxes():
    """The 512² SHEARLET split plan's box groups: the two coarse boxes and
    the fine scale's narrow shears, whose index lists are the exact
    support (non-contiguous), not a centred box."""
    plan = sh.shearlet_plan(512, 512, split_threshold=200)
    _, _, boxes = sh._plan_kernel_pack(plan, 512, 512)
    assert [(lg, len(g.idx_h), len(g.idx_w)) for _, lg, g in boxes] == [
        (5, 16, 16), (8, 40, 40), (2, 447, 126), (2, 126, 447),
        (1, 447, 63), (1, 63, 447)]
    for _, _, g in boxes[2:]:
        for idx in (g.idx_h, g.idx_w):
            assert len(np.unique(idx)) == len(idx)
            assert idx.min() >= 0 and idx.max() < 512
        h_idx, w_idx = g.box_index_on(512, 512, "cpu")
        assert h_idx.dtype == torch.int32 and w_idx.dtype == torch.int32
    # the leak guard still holds the unsplit groups to their boxes
    psi = sh.shearlet_spectra(64, 64)
    with pytest.raises(ValueError, match="leaks outside its box"):
        sh.build_plan(psi, [5, psi.shape[0] - 5], [1, None],
                      split_threshold=10 ** 6)


def _taus(basis, h, w, re, im, op, plan):
    """(B, L) thresholds in plan order: in gaps of the magnitudes for a
    hard threshold, else uniform."""
    psi = (sh.shearlet_spectra(h, w) if basis == "shearlet"
           else cv.curvelet_spectra(h, w))
    if op == "hard":
        zf = np.fft.fft2(re.astype(np.float64) + 1j * im)
        c = np.fft.ifft2(zf[:, None] * psi.astype(np.float64)[None])
        tau = gap_taus(np.abs(c).reshape(c.shape[0], c.shape[1], -1))
    else:
        tau = np.random.default_rng(6).uniform(
            0.05, 0.5, size=(re.shape[0], psi.shape[0])).astype(np.float32)
    return tau, tau[:, plan.perm]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("basis,h,w,split",
                         [SPLITS[5], SPLITS[6], SPLITS[3]],
                         ids=["shearlet-64", "shearlet-64x128",
                              "curvelet-128"])
def test_split_plan_apply_matches_jax_and_the_box_plan(basis, h, w, split,
                                                       op):
    """Both routes of the port's fused apply on the split plan (the
    streamed route of CPU tensors, and the kernel route on the kernels'
    plain versions, with the split groups through the box kernel's
    wrapper) against the JAX package's apply on its split plan and the
    port's on the box plan (thresholds re-ordered by ``perm``)."""
    plan, jplan = _plans(basis, h, w, split)
    box, _ = _plans(basis, h, w, None)
    re, im = _rand((2, h, w), 5)
    tau_box, tau_split = _taus(basis, h, w, re, im, op, plan)
    jz, z = _both(re, im)
    want = jsh.pocs_subband_apply(jz, jplan, jnp.asarray(tau_split), op)
    t = torch.from_numpy(tau_split)
    streamed = sh.pocs_subband_apply(z, plan, t, op)
    kernels = sh._pocs_subband_apply_kernels(z, plan, t, op, "high", "high")
    for got in (streamed, kernels):
        _close(got, want)
        _close(got, sh.pocs_subband_apply(z, box, torch.from_numpy(tau_box),
                                          op))


@pytest.mark.parametrize("op", ["soft-percentile", "hard-percentile"])
def test_split_plan_percentile_apply_matches_the_box_plan(op):
    """The percentile route on a split plan (the split kernels' plain
    versions for the full-size and the split box groups): each band's
    threshold is a percentile of its own |c|, so regrouping the bands
    changes nothing but the order."""
    basis, h, w, split = SPLITS[0]
    plan, _ = _plans(basis, h, w, split)
    box, _ = _plans(basis, h, w, None)
    re, im = _rand((2, h, w), 8)
    _, z = _both(re, im)
    q = np.random.default_rng(9).uniform(
        70, 95, size=(2, len(plan.perm))).astype(np.float32)
    got = sh._pocs_subband_apply_kernels(z, plan, torch.from_numpy(
        q[:, plan.perm]), op, "high", "high")
    want = sh.pocs_subband_apply(z, box, torch.from_numpy(q), op)
    tol = TOL if op.startswith("soft") else 1e-3
    _close(got, want, tol)
    _close(sh.pocs_subband_apply(z, plan, torch.from_numpy(q[:, plan.perm]),
                                 op), want, tol)


@pytest.mark.parametrize("name", ["db4", "sym5", "coif3"])
@pytest.mark.parametrize("mode", ["smooth", "symmetric", "zero"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 51)])
def test_wavelet_modes_reconstruct_and_match_jax(name, mode, shape):
    x = np.random.default_rng(0).normal(size=shape)
    c, shp = wv.wavedec2_mode(x, name, level=2, mode=mode)
    jc, jshp = jwv.wavedec2_mode(x, name, level=2, mode=mode)
    assert [tuple(s) for s in shp] == [tuple(s) for s in jshp]
    np.testing.assert_array_equal(c[0], jc[0])
    for det, jdet in zip(c[1:], jc[1:]):
        for a, b in zip(det, jdet):
            np.testing.assert_array_equal(a, b)
    back = wv.waverec2_mode(c, shp, name)
    np.testing.assert_array_equal(back, jwv.waverec2_mode(jc, jshp, name))
    assert np.abs(back - x).max() < 1e-10


def test_wavelet_mode_shapes_and_anchors():
    """JAX's tests/test_wavelet.py:211-245 on the port: coif5 'smooth'
    at 64² follows pywt's shape law; haar 'smooth' equals the periodized
    transform up to the highpass sign convention; a ramp's 'smooth'
    details vanish where 'zero''s do not; a default level and an
    unknown mode."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 64))
    c, shp = wv.wavedec2_mode(x, "coif5", level=2, mode="smooth")
    assert c[-1][0].shape == ((64 + 29) // 2, (64 + 29) // 2) == (46, 46)
    assert c[1][0].shape == ((46 + 29) // 2, (46 + 29) // 2) == (37, 37)
    assert np.abs(wv.waverec2_mode(c, shp, "coif5") - x).max() < 1e-10
    x = np.random.default_rng(2).normal(size=(16, 16))
    c1, _ = wv.wavedec2_mode(x, "db1", level=1, mode="smooth")
    c2 = wv.wavedec2(torch.from_numpy(x.astype(np.float32)), "db1", 1)
    np.testing.assert_allclose(c1[0], c2[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(c1[1][0], -c2[1][0].numpy(), atol=1e-6)
    np.testing.assert_allclose(c1[1][1], -c2[1][1].numpy(), atol=1e-6)
    np.testing.assert_allclose(c1[1][2], c2[1][2].numpy(), atol=1e-6)
    ramp = np.outer(np.ones(32), np.arange(32, dtype=np.float64))
    _, (lh_s, _, _) = wv.dwt2_mode(ramp, "db2", "smooth")
    _, (lh_z, _, _) = wv.dwt2_mode(ramp, "db2", "zero")
    assert np.abs(lh_s).max() < 1e-10 and np.abs(lh_z).max() > 1.0
    ll, det = wv.dwt2_mode(ramp, "sym4", "symmetric")
    jll, jdet = jwv.dwt2_mode(ramp, "sym4", "symmetric")
    np.testing.assert_array_equal(ll, jll)
    np.testing.assert_array_equal(wv.idwt2_mode(ll, det, "sym4"),
                                  jwv.idwt2_mode(jll, jdet, "sym4"))
    c, shp = wv.wavedec2_mode(np.ones((40, 40)), "db2")
    jc, jshp = jwv.wavedec2_mode(np.ones((40, 40)), "db2")
    assert len(c) == len(jc) and [tuple(s) for s in shp] == \
        [tuple(s) for s in jshp]
    with pytest.raises(ValueError, match="unsupported boundary mode"):
        wv.dwt2_mode(ramp, "db2", "periodic")
    with pytest.raises(ValueError, match="not available"):
        wv.dwt2_mode(ramp, "db99", "zero")


def test_cplx_zeros_and_where_match_jax():
    z = cplx.zeros((2, 3))
    jz = jcplx.zeros((2, 3))
    assert z.re.dtype == torch.float32 and z.re.shape == (2, 3)
    np.testing.assert_array_equal(_np(z), _np(jz))
    assert cplx.zeros(4, torch.float64).im.dtype == torch.float64
    re, im = _rand((2, 5), 3)
    re2, im2 = _rand((2, 5), 4)
    cond = np.random.default_rng(5).uniform(size=(2, 5)) < 0.5
    ja, a = _both(re, im)
    jb, b = _both(re2, im2)
    got = cplx.where(torch.from_numpy(cond), a, b)
    want = jcplx.where(jnp.asarray(cond), ja, jb)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the condition broadcasts, as jnp.where's does
    row = torch.tensor([True, False, True, False, True])
    np.testing.assert_array_equal(
        _np(cplx.where(row, a, b)),
        _np(jcplx.where(jnp.asarray(row.numpy()), ja, jb)))
