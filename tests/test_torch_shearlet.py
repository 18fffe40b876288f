"""The port's SHEARLET operators against the JAX package's: the windows and
the support-cropped plan (bit-equal), the plain versions of the two subband
kernels against the JAX kernels in interpret mode, the fused subband apply
(both of the port's routes) against the JAX kernel route, the streamed
decay statistics and schedule, the planned transforms and the decay
helpers.

Tolerances: soft and garrote thresholds are continuous in the
coefficients, so the port (``torch.fft``, complex ``torch.matmul``) and
the JAX package (fp32 matrix DFTs at 'highest') differ by float32 rounding
of differently ordered sums: measured ≤ 8e-7 of max, held to 1e-5. A hard
threshold flips a coefficient that sits within rounding of its tau; the
hard cases take thresholds in a gap between coefficient magnitudes
(``gap_taus``) and are then held to the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.models import transforms as jtr
from pseudo_3d_interpolation_tpu.ops import decay as jdecay
from pseudo_3d_interpolation_tpu.ops import shearlet as jsh
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas import subband as jsb
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.models.transforms import (
    ShearletTransform, get_transform)
from pseudo_3d_interpolation_torch.ops import decay
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb

torch.set_num_threads(2)

TOL = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST
OPS = ["soft", "garrote", "hard"]


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


@pytest.mark.parametrize("h,w", [(128, 128), (128, 256), (512, 512)])
def test_spectra_and_plan_bit_equal_to_jax(h, w):
    psi, jpsi = sh.shearlet_spectra(h, w), jsh.shearlet_spectra(h, w)
    assert psi.dtype == jpsi.dtype == np.float32
    np.testing.assert_array_equal(psi, jpsi)
    assert sh.n_subbands(sh.default_scales(h, w)) == psi.shape[0] \
        == jsh.n_subbands(jsh.default_scales(h, w))
    plan, jplan = sh.shearlet_plan(h, w), jsh.shearlet_plan(h, w)
    assert len(plan) == len(jplan)
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    for g, jg in zip(plan, jplan):
        assert (g.idx_h is None) == (jg.idx_h is None)
        if g.idx_h is not None:
            np.testing.assert_array_equal(g.idx_h, jg.idx_h)
            np.testing.assert_array_equal(g.idx_w, jg.idx_w)
        np.testing.assert_array_equal(g.psi, jg.psi)
    full, idx, boxes = sh._plan_kernel_pack(plan, h, w)
    jfull, jidx, jboxes = jsh._plan_pallas_pack(jplan, h, w, "natural")
    np.testing.assert_array_equal(full.psi, np.asarray(jfull))
    np.testing.assert_array_equal(idx, jidx)
    assert [(l0, lg) for l0, lg, _ in boxes] == \
        [(l0, lg) for l0, lg, _ in jboxes]
    # the box kernel's partial-DFT matrices are JAX's, without transposes
    for (_, _, g), (_, _, jg) in zip(boxes, jboxes):
        jm = [np.asarray(a) for a in jg.box_mats_device(h, w)]
        for mine, theirs in zip(g.box_mats_on(h, w, "cpu"),
                                (jm[0], jm[1], jm[4], jm[5])):
            np.testing.assert_array_equal(mine.numpy(), theirs)


def test_plan_leak_guard_and_coverage():
    psi = sh.shearlet_spectra(64, 64)
    with pytest.raises(ValueError, match="leaks outside its box"):
        sh.build_plan(psi, [5, psi.shape[0] - 5], [1, None])
    with pytest.raises(ValueError, match="cover"):
        sh.build_plan(psi, [5], [4])
    with pytest.raises(RuntimeError, match="does not cover"):
        sh.symmetrize_and_tighten(np.zeros((2, 8, 8)), "empty")


def test_compat_carries_the_jax_plan_and_transform():
    jplan = jsh.shearlet_plan(256, 256)
    plan = compat.plan_from_reference(
        [(g.idx_h, g.idx_w, g.psi) for g in jplan], jplan.perm)
    mine = sh.shearlet_plan(256, 256)
    for g, h in zip(plan, mine):
        np.testing.assert_array_equal(g.psi, h.psi)
        assert (g.idx_h is None) == (h.idx_h is None)
    jt = jtr.ShearletTransform(n_scales=3, precision="high",
                               box_precision="highest")
    kw = {k: v for k, v in vars(jt).items() if k != "kind"}
    assert compat.transform_from_reference("SHEARLET", kw) == \
        ShearletTransform(n_scales=3, precision="high",
                          box_precision="highest")
    # the carried plan solves with the same windows as the port's own
    re, im = _rand((1, 256, 256), 11)
    z = Cplx(torch.from_numpy(re), torch.from_numpy(im))
    tau = torch.full((1, 61), 0.05)
    a = sh.pocs_subband_apply(z, plan, tau, "soft")
    b = sh.pocs_subband_apply(z, mine, tau, "soft")
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    with pytest.raises(ValueError, match="both be None"):
        compat.plan_from_reference([(None, np.arange(4), np.ones((1, 4, 4)))],
                                   [0])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("h,w", [(128, 128), (128, 256)])
def test_subband_plain_matches_jax_kernel(h, w, op):
    full, _, _ = sh._plan_kernel_pack(sh.shearlet_plan(h, w), h, w)
    re, im = _rand((2, h, w), 1)
    xf = np.fft.fft2(re + 1j * im).astype(np.complex64)
    xr, xi = np.ascontiguousarray(xf.real), np.ascontiguousarray(xf.imag)
    rng = np.random.default_rng(2)
    if op == "hard":
        tau = gap_taus(_coeff_mags(re, im, full.psi))
    else:
        tau = rng.uniform(0.001, 0.05, size=(2, full.psi.shape[0])).astype(
            np.float32)
    jx, x = _both(xr, xi)
    want = jsb.subband_update_fused(
        jx, full.psi, jnp.asarray(tau), thresh_op=op, precision=HIGHEST,
        interpret=True, layout="natural")
    before = ksb.subband_update.launches
    got = ksb.subband_update(x, torch.from_numpy(full.psi),
                             torch.from_numpy(tau), op, "high",
                             support=full.support_on("cpu"))
    assert ksb.subband_update.launches == before  # the CPU takes plain
    _close(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("group", [0, 1], ids=["16-side", "40-side"])
def test_box_plain_matches_jax_kernel(group, op):
    n = 256
    _, _, boxes = sh._plan_kernel_pack(sh.shearlet_plan(n, n), n, n)
    jboxes = jsh._plan_pallas_pack(jsh.shearlet_plan(n, n), n, n,
                                   "natural")[2]
    l0, lg, g = boxes[group]
    jg = jboxes[group][2]
    sr, sc = len(g.idx_h), len(g.idx_w)
    assert (sr, sc) == ((16, 16), (40, 40))[group]
    xr, xi = _rand((2, sr, sc), 3 + group, scale=100.0)
    mats = g.box_mats_on(n, n, "cpu")
    if op == "hard":
        ah = (mats[0].numpy() + 1j * mats[1].numpy()).astype(np.complex128)
        aw = (mats[2].numpy() + 1j * mats[3].numpy()).astype(np.complex128)
        v = (xr + 1j * xi)[:, None] * g.psi.astype(np.float64)[None]
        c = ah.conj().T @ v @ aw.conj() / (n * n)
        tau = gap_taus(np.abs(c).reshape(2, lg, -1))
    else:
        tau = np.random.default_rng(4).uniform(
            0.0005, 0.005, size=(2, lg)).astype(np.float32)
    jx, x = _both(xr, xi)
    want = jsb.box_group_update_fused(
        jx, jg.psi_device(), jnp.asarray(tau), jg.box_mats_device(n, n), n,
        n, thresh_op=op, precision=HIGHEST, interpret=True)
    before = ksb.box_group_update.launches
    got = ksb.box_group_update(x, g.psi_on("cpu"), torch.from_numpy(tau),
                               mats, n, n, op, "highest")
    assert ksb.box_group_update.launches == before
    _close(got, want)


@pytest.mark.parametrize("op", OPS)
def test_subband_apply_matches_jax_kernel_route(op):
    """Both routes of the port's fused apply (the streamed route CPU
    tensors take, and the kernel route on the kernels' plain versions)
    against the JAX package's kernel route in interpret mode, at 256² (the
    512² plan's group structure), B=2."""
    n = 256
    plan, jplan = sh.shearlet_plan(n, n), jsh.shearlet_plan(n, n)
    re, im = _rand((2, n, n), 5)
    n_bands = sh.n_subbands(sh.default_scales(n, n))
    if op == "hard":
        tau = gap_taus(_coeff_mags(re, im, sh.shearlet_spectra(n, n)))
    else:
        tau = np.random.default_rng(6).uniform(
            0.1, 1.0, size=(2, n_bands)).astype(np.float32)
    jz, z = _both(re, im)
    want = jsh.pocs_subband_apply(jz, jplan, jnp.asarray(tau), op,
                                  use_pallas=True, pallas_interpret=True)
    t = torch.from_numpy(tau)
    _close(sh.pocs_subband_apply(z, plan, t, op), want)
    _close(sh._pocs_subband_apply_kernels(z, plan, t, op, "high", "high"),
           want)
    # a shared (L,) tau is broadcast over the batch
    _close(sh._pocs_subband_apply_kernels(z, plan, t[0], op, "high",
                                          "high"),
           jsh.pocs_subband_apply(jz, jplan, jnp.asarray(tau[0]), op,
                                  use_pallas=True, pallas_interpret=True))


def test_subband_stats_and_streamed_decay_match_jax():
    n = 256
    re, im = _rand((2, n, n), 7)
    jz, z = _both(re, im)
    amax, sumsq = sh.subband_stats(z, sh.shearlet_plan(n, n))
    jamax, jsumsq = jsh.subband_stats(jz, jsh.shearlet_plan(n, n))
    np.testing.assert_allclose(amax.numpy(), np.asarray(jamax), rtol=TOL)
    np.testing.assert_allclose(sumsq.numpy(), np.asarray(jsumsq), rtol=TOL)
    tr, jt = ShearletTransform(), jtr.ShearletTransform()
    for p_min in ("adaptive", 1e-3):
        for model in ("exponential", "linear"):
            got = tr.decay_from_input(z, model, 7, 0.99, p_min, "values")
            want = jt.decay_from_input(jz, model, 7, 0.99, p_min, "values")
            assert tuple(got.shape) == (7, 2, 61)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4)


def test_planned_transforms_and_full_decay_match_jax():
    """forward / inverse / threshold / decay of the materialised stack (the
    decay route of data-driven and non-'values' models)."""
    n = 128
    re, im = _rand((2, n, n), 8)
    jz, z = _both(re, im)
    tr, jt = ShearletTransform(), jtr.ShearletTransform()
    n_bands = sh.n_subbands(sh.default_scales(n, n))
    c, jc = tr.forward(z), jt.forward(jz)
    assert tuple(c.re.shape) == (2, n_bands, n, n)
    _close(c, jc)
    _close(tr.inverse(c), jt.inverse(jc))
    _close(tr.inverse(c), z, tol=2e-6)  # tight frame: exact round trip
    t = np.full((2, n_bands), 0.02, np.float32)
    _close(tr.threshold(c, torch.from_numpy(t), "soft"),
           jt.threshold(jc, jnp.asarray(t), "soft"))
    # data-driven samples the sorted magnitudes by rank: a rounding-level
    # difference can move a sample to its neighbour, so it is also allowed
    # an absolute 1e-5 of the schedule's largest value
    for model, p_min in (("data-driven", 1e-3), ("exponential", "adaptive")):
        got = tr.decay_from_input(z, model, 5, 0.99, p_min, "values")
        want = np.asarray(jt.decay_from_input(jz, model, 5, 0.99, p_min,
                                              "values"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * want.max())


def test_shearlet_decay_helpers_match_jax():
    rng = np.random.default_rng(9)
    for n_scales in (1, 3, 4):
        L = sh.n_subbands(n_scales)
        norms = rng.uniform(0.1, 2.0, size=(3, L)).astype(np.float32)
        np.testing.assert_allclose(
            decay.shearlet_adaptive_tau_min_from_norms(
                torch.from_numpy(norms), n_scales).numpy(),
            np.asarray(jdecay.shearlet_adaptive_tau_min_from_norms(
                jnp.asarray(norms), n_scales)), rtol=1e-6)
    mags = rng.uniform(0, 3, size=(2, 13, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        decay.shearlet_adaptive_tau_min(torch.from_numpy(mags), 2).numpy(),
        np.asarray(jdecay.shearlet_adaptive_tau_min(jnp.asarray(mags), 2)),
        rtol=1e-5)
    override = rng.uniform(0.01, 0.1, size=(2, 1)).astype(np.float32)
    np.testing.assert_allclose(
        decay.threshold_decay(torch.from_numpy(mags), "exponential", 6,
                              tau_min_override=torch.from_numpy(
                                  override)).numpy(),
        np.asarray(jdecay.threshold_decay(jnp.asarray(mags), "exponential",
                                          6, tau_min_override=override)),
        rtol=1e-5)
    for shape in ((512, 512), (100, 3000), (2, 2), (1, 1)):
        assert decay.n_shearlet_scales(shape) == \
            jdecay.n_shearlet_scales(shape)


def test_shearlet_options_and_errors():
    assert get_transform("SHEARLET") == ShearletTransform()
    assert get_transform("shearlet", n_scales=2, precision="high") == \
        ShearletTransform(n_scales=2, precision="high")
    with pytest.raises(ValueError, match="unknown precision"):
        get_transform("SHEARLET", box_precision="fastest")
    z = Cplx(torch.ones(2, 32, 32), torch.zeros(2, 32, 32))
    plan = sh.shearlet_plan(32, 32)
    with pytest.raises(ValueError, match="unknown precision 'fastest'"):
        sh._pocs_subband_apply_kernels(z, plan, torch.ones(2, 13), "hard",
                                       "fastest", "fastest")
    for op in ("bogus", "bogus-percentile"):
        with pytest.raises(ValueError, match="thresholds"):
            sh._pocs_subband_apply_kernels(z, plan, torch.ones(2, 13), op,
                                           "high", "high")
    # a percentile threshold takes the split kernels (plain versions here)
    out = sh._pocs_subband_apply_kernels(z, plan, torch.full((2, 13), 90.0),
                                         "soft-percentile", "high", "high")
    assert out.re.shape == (2, 32, 32)
    full, _, _ = sh._plan_kernel_pack(plan, 32, 32)
    # the unsplit kernels take no percentile threshold
    with pytest.raises(ValueError, match="thresholds"):
        ksb.subband_update(z, full.psi_on("cpu"),
                           torch.ones(2, full.psi.shape[0]),
                           "soft-percentile",
                           support=full.support_on("cpu"))
    with pytest.raises(ValueError, match="tau must be"):
        ksb.subband_update(z, full.psi_on("cpu"), torch.ones(2, 3),
                           support=full.support_on("cpu"))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        sh.pocs_subband_apply(Cplx(z.re[0], z.im[0]), plan,
                              torch.ones(13), "hard")
