"""The spatial-I/O subband update (``subband_update_spatial``, the port's
counterpart of the JAX ``_kernel_spatial``) and the spatial route of the
fused subband apply, against the JAX package's: the plain version against
``subband_update_fused(..., spatial_io=True)`` in interpret mode, and the
route's assembly (``_pocs_subband_apply_kernels(spatial_io=True)`` on the
kernels' plain versions) against the JAX apply under ``P3D_SPATIAL_IO=1``
on the shearlet and curvelet plans.

Tolerances: at tau 0 nothing is thresholded, and the two sides are held
to the JAX package's own test of the kernel (tests/test_shearlet.py:
atol 5e-5); soft and garrote thresholds within 1e-5 of max (fp32 rounding
of differently ordered sums); hard thresholds on taus in gaps between the
coefficient magnitudes (``gap_taus``), to the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.ops import curvelet as jcv
from pseudo_3d_interpolation_tpu.ops import shearlet as jsh
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas import subband as jsb
from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb

torch.set_num_threads(2)

TOL = 1e-5
TAU0_ATOL = 5e-5
HIGHEST = jax.lax.Precision.HIGHEST
N = 256  # the smallest side with a fast split: JAX's permuted layout
PLANS = {"shearlet": (sh.shearlet_plan, jsh.shearlet_plan,
                      sh.shearlet_spectra),
         "curvelet": (cv.curvelet_plan, jcv.curvelet_plan,
                      cv.curvelet_spectra)}


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
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _coeff_mags(re, im, psi):
    """|ifft2(fft2(z)·ψ_l)| in float64, (B, L, H·W), for gap thresholds."""
    zf = np.fft.fft2(re.astype(np.float64) + 1j * im)
    c = np.fft.ifft2(zf[:, None] * psi.astype(np.float64)[None])
    return np.abs(c).reshape(c.shape[0], c.shape[1], -1)


@pytest.mark.parametrize("op", ["tau0", "soft", "hard"])
@pytest.mark.parametrize("basis", sorted(PLANS))
def test_spatial_plain_matches_jax_kernel(basis, op):
    """``subband_update_spatial_plain`` against the JAX ``_kernel_spatial``
    (permuted layout, interpret mode) at 256², B = 2: the two slices also
    check that each slice's spectrum is its own."""
    plan_of, jplan_of, _ = PLANS[basis]
    full, idx, _ = sh._plan_kernel_pack(plan_of(N, N), N, N)
    jfull, jidx, _ = jsh._plan_pallas_pack(jplan_of(N, N), N, N, "permuted")
    np.testing.assert_array_equal(idx, jidx)
    re, im = _rand((2, N, N), 21)
    if op == "hard":
        tau = gap_taus(_coeff_mags(re, im, full.psi))
    elif op == "soft":
        tau = np.random.default_rng(22).uniform(
            0.001, 0.05, size=(2, len(idx))).astype(np.float32)
    else:
        tau = np.zeros((2, len(idx)), np.float32)
    thresh = "hard" if op == "tau0" else op
    jz, z = _both(re, im)
    want = jsb.subband_update_fused(
        jz, jfull, jnp.asarray(tau), thresh_op=thresh, precision=HIGHEST,
        interpret=True, layout="permuted", spatial_io=True)
    before = ksb.subband_update_spatial.launches
    got = ksb.subband_update_spatial(z, torch.from_numpy(full.psi),
                                     torch.from_numpy(tau), thresh, "high",
                                     support=full.support_on("cpu"))
    assert ksb.subband_update_spatial.launches == before  # plain on the CPU
    if op == "tau0":
        np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                                   atol=TAU0_ATOL)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                                   atol=TAU0_ATOL)
    else:
        _close(got, want)


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("basis", sorted(PLANS))
def test_spatial_route_matches_jax(basis, op, monkeypatch):
    """The spatial route's assembly (the kernels' plain versions on CPU
    tensors: ``subband_update_spatial``, then each box group's partial
    fft2, ``box_group_update`` and partial ifft2) against the JAX apply
    with ``P3D_SPATIAL_IO=1``; the shearlet plan has two box groups at
    256², the curvelet plan none (its 72-side ring is zero-padded)."""
    plan_of, jplan_of, spectra = PLANS[basis]
    plan, jplan = plan_of(N, N), jplan_of(N, N)
    re, im = _rand((2, N, N), 23)
    n_bands = sum(g.psi.shape[0] for g in plan)
    if op == "hard":
        tau = gap_taus(_coeff_mags(re, im, spectra(N, N)))
    else:
        tau = np.random.default_rng(24).uniform(
            0.1, 1.0, size=(2, n_bands)).astype(np.float32)
    jz, z = _both(re, im)
    monkeypatch.setenv("P3D_SPATIAL_IO", "1")
    want = jsh.pocs_subband_apply(jz, jplan, jnp.asarray(tau), op,
                                  use_pallas=True, pallas_interpret=True)
    t = torch.from_numpy(tau)
    before = ksb.subband_update_spatial.launches
    _close(sh._pocs_subband_apply_kernels(z, plan, t, op, "high", "highest",
                                          spatial_io=True), want)
    assert ksb.subband_update_spatial.launches == before
    # the CPU tensor's entry point keeps the plain streamed route
    _close(sh.pocs_subband_apply(z, plan, t, op), want)


def test_switch_reads_the_environment(monkeypatch):
    plan = sh.shearlet_plan(64, 64)
    re, im = _rand((2, 64, 64), 25)
    z = Cplx(torch.from_numpy(re), torch.from_numpy(im))
    tau = torch.full((2, sum(g.psi.shape[0] for g in plan)), 0.05)
    monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    assert not sh.spatial_io_default()
    a = sh.pocs_subband_apply(z, plan, tau, "soft")
    monkeypatch.setenv("P3D_SPATIAL_IO", "1")
    assert sh.spatial_io_default()
    # on CPU tensors both settings take the plain streamed route
    b = sh.pocs_subband_apply(z, plan, tau, "soft")
    c = sh._pocs_subband_apply_streamed(z, plan, tau, "soft")
    assert torch.equal(a.re, c.re) and torch.equal(b.re, c.re)


def test_rectangles_and_small_batches_on_the_plain_route():
    """The port's spatial route takes any H×W (the JAX package's only the
    permuted squares): on a 96×80 rectangle and on batches of 1 and 0 it
    equals the spectral route's assembly within rounding."""
    h, w = 96, 80
    plan = sh.shearlet_plan(h, w)
    n_bands = sum(g.psi.shape[0] for g in plan)
    for b in (1, 3):
        re, im = _rand((b, h, w), 26 + b)
        z = Cplx(torch.from_numpy(re), torch.from_numpy(im))
        tau = torch.from_numpy(np.random.default_rng(28).uniform(
            0.05, 0.5, size=(b, n_bands)).astype(np.float32))
        _close(sh._pocs_subband_apply_kernels(z, plan, tau, "soft", "high",
                                              "high", spatial_io=True),
               sh._pocs_subband_apply_kernels(z, plan, tau, "soft", "high",
                                              "high"))
    full, _, _ = sh._plan_kernel_pack(plan, h, w)
    empty = Cplx(torch.empty(0, h, w), torch.empty(0, h, w))
    out = ksb.subband_update_spatial(empty, full.psi_on("cpu"),
                                     torch.empty(0, full.psi.shape[0]),
                                     support=full.support_on("cpu"))
    assert tuple(out.re.shape) == (0, h, w)


def test_wrapper_checks():
    full, _, _ = sh._plan_kernel_pack(sh.shearlet_plan(32, 32), 32, 32)
    psi = full.psi_on("cpu")
    sup = full.support_on("cpu")
    x = Cplx(torch.ones(2, 32, 32), torch.zeros(2, 32, 32))
    with pytest.raises(ValueError, match="tau must be"):
        ksb.subband_update_spatial(x, psi, torch.ones(2, 3), support=sup)
    with pytest.raises(ValueError, match=r"x must be a \(B, H, W\) pair"):
        ksb.subband_update_spatial(Cplx(x.re[0], x.im[0]), psi,
                                   torch.ones(2, psi.shape[0]), support=sup)
    with pytest.raises(ValueError, match="psi must be"):
        ksb.subband_update_spatial(x, psi[:, :16], torch.ones(2, 3),
                                   support=sup)
    with pytest.raises(TypeError, match="float32"):
        ksb.subband_update_spatial(Cplx(x.re.double(), x.im.double()), psi,
                                   torch.ones(2, psi.shape[0]), support=sup)
    with pytest.raises(ValueError, match="unknown precision 'fastest'"):
        ksb.subband_update_spatial(x, psi, torch.ones(2, psi.shape[0]),
                                   "hard", "fastest", support=sup)
    assert ksb.scratch_bytes(32, 512, 512, 48, spatial=True) == \
        ksb.scratch_bytes(32, 512, 512, 48) + 32 * 512 * 512 * 8
