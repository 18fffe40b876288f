"""The box kernel's pruned line-FFT schedule (``csrc/subband.cu`` kernel
B), on the CPU.

The kernel computes a support-cropped group's update through the full
N_h × N_w field instead of the partial-DFT matrices: the box columns are
scattered into zero N_h-lines at ``idx_h`` and inverted, every field row is
scattered into a zero N_w-line at ``idx_w``, inverted, scaled, shrunk,
transformed and gathered back at ``idx_w``, and the field columns are
transformed, gathered at ``idx_h``, weighted and summed over the bands in
order. These tests replay that schedule with ``torch.fft`` and hold it
against ``box_group_update_plain`` and the JAX package's
``box_group_update_fused`` (interpret mode) on the real 512² SHEARLET and
CURVELET groups and on a 384×512 rectangle, hold the box indices to the
contract the scatter and gather rely on, and check the device budgets
against what the wrappers allocate at the main path's 32×512².

Tolerances: soft and garrote thresholds are continuous, so the schedule
and the matrix forms differ by float32 rounding of differently ordered
sums, held to 1e-5 of max. Hard thresholds take thresholds in a gap
between coefficient magnitudes (``gap_taus``) and are then held to the
same bound."""

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
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
from pseudo_3d_interpolation_torch.ops.kernels.pocs_solve import _shrink
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

torch.set_num_threads(2)

TOL = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST
PLANS = {"SHEARLET": (sh.shearlet_plan, jsh.shearlet_plan),
         "CURVELET": (cv.curvelet_plan, jcv.curvelet_plan)}
# (basis, h, w, box group): the main paths' 16-, 40- and 72-side groups at
# 512², and the SHEARLET groups on a 384×512 grid (its H-lines are not a
# power of two: the engine's direct-DFT lines)
CASES = [("SHEARLET", 512, 512, 0), ("SHEARLET", 512, 512, 1),
         ("CURVELET", 512, 512, 0), ("SHEARLET", 384, 512, 0),
         ("SHEARLET", 384, 512, 1)]
IDS = ["16-side", "40-side", "72-side-curvelet", "16-side-384x512",
       "40-side-384x512"]


def _group(basis, h, w, k):
    return sh._plan_kernel_pack(PLANS[basis][0](h, w), h, w)[2][k]


def _pruned_schedule(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                     idx_h, idx_w, n_h: int, n_w: int, op: str) -> Cplx:
    """Kernel B's three passes with torch.fft, one band at a time: (1) the
    box columns scattered at idx_h and inverted along H, unscaled; (2)
    every field row scattered at idx_w, inverted along W, scaled by
    1/(N_h·N_w), shrunk, transformed along W and gathered at idx_w; (3)
    the field columns transformed along H, gathered at idx_h, weighted by
    ψ_l and added to the sum in band order."""
    b, sr, sc = xbox.re.shape
    ih = torch.from_numpy(np.asarray(idx_h)).long()
    iw = torch.from_numpy(np.asarray(idx_w)).long()
    xb = torch.complex(xbox.re, xbox.im)
    acc = torch.zeros_like(xb)
    for band in range(psi.shape[0]):
        p = psi[band]
        cols = torch.zeros(b, n_h, sc, dtype=xb.dtype)
        cols[:, ih] = xb * p
        g = torch.fft.ifft(cols, dim=-2, norm="forward")
        rows = torch.zeros(b, n_h, n_w, dtype=xb.dtype)
        rows[:, :, iw] = g
        c = torch.fft.ifft(rows, dim=-1, norm="forward") / (n_h * n_w)
        c = c * _shrink(c.real * c.real + c.imag * c.imag,
                        tau[:, band, None, None], op)
        kept = torch.fft.fft(c, dim=-1)[:, :, iw]
        acc += torch.fft.fft(kept, dim=-2)[:, ih] * p
    return Cplx(acc.real.contiguous(), acc.imag.contiguous())


def _inputs(g, lg, h, w, op, seed):
    """A (2, sr, sc) box spectrum and its thresholds: for a hard threshold
    in a gap of the field's magnitudes, else drawn."""
    rng = np.random.default_rng(seed)
    sr, sc = len(g.idx_h), len(g.idx_w)
    xr, xi = ((rng.normal(size=(2, sr, sc)) * 100).astype(np.float32)
              for _ in range(2))
    if op == "hard":
        mats = g.box_mats_on(h, w, "cpu")
        ah = mats[0].numpy() + 1j * mats[1].numpy().astype(np.float64)
        aw = mats[2].numpy() + 1j * mats[3].numpy().astype(np.float64)
        v = (xr + 1j * xi.astype(np.float64))[:, None] * g.psi[None]
        c = ah.conj().T @ v @ aw.conj() / (h * w)
        tau = gap_taus(np.abs(c).reshape(2, lg, -1))
    else:
        tau = rng.uniform(0.0005, 0.005, size=(2, lg)).astype(np.float32)
    return xr, xi, tau


def _close(got, want):
    got = np.asarray(got.re) + 1j * np.asarray(got.im)
    want = np.asarray(want.re) + 1j * np.asarray(want.im)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    assert err <= TOL, err


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("basis,h,w,k", CASES, ids=IDS)
def test_pruned_schedule_matches_plain(basis, h, w, k, op):
    _, lg, g = _group(basis, h, w, k)
    xr, xi, tau = _inputs(g, lg, h, w, op, seed=h + k)
    x = Cplx(torch.from_numpy(xr), torch.from_numpy(xi))
    psi = g.psi_on("cpu")
    tau = torch.from_numpy(tau)
    got = _pruned_schedule(x, psi, tau, g.idx_h, g.idx_w, h, w, op)
    before = ksb.box_group_update.launches
    want = ksb.box_group_update(x, psi, tau, g.box_mats_on(h, w, "cpu"), h,
                                w, op, "highest")
    assert ksb.box_group_update.launches == before  # the CPU takes plain
    _close(got, want)


@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("basis,h,w,k", CASES, ids=IDS)
def test_pruned_schedule_matches_jax_kernel(basis, h, w, k, op):
    _, lg, g = _group(basis, h, w, k)
    jg = jsh._plan_pallas_pack(PLANS[basis][1](h, w), h, w, "natural")[2][k][2]
    np.testing.assert_array_equal(g.idx_h, jg.idx_h)
    np.testing.assert_array_equal(g.idx_w, jg.idx_w)
    xr, xi, tau = _inputs(g, lg, h, w, op, seed=2 * h + k)
    want = jsb.box_group_update_fused(
        JCplx(jnp.asarray(xr), jnp.asarray(xi)), jg.psi_device(),
        jnp.asarray(tau), jg.box_mats_device(h, w), h, w, thresh_op=op,
        precision=HIGHEST, interpret=True)
    got = _pruned_schedule(Cplx(torch.from_numpy(xr), torch.from_numpy(xi)),
                           g.psi_on("cpu"), torch.from_numpy(tau), g.idx_h,
                           g.idx_w, h, w, op)
    _close(got, want)


# every box group of the plans the tests and the main paths use
BOX_GROUPS = [("SHEARLET", 512, 512, 0), ("SHEARLET", 512, 512, 1),
              ("SHEARLET", 384, 512, 0), ("SHEARLET", 384, 512, 1),
              ("SHEARLET", 256, 256, 0), ("SHEARLET", 256, 256, 1),
              ("CURVELET", 512, 512, 0)]


@pytest.mark.parametrize("basis,h,w,k", BOX_GROUPS)
def test_box_indices_are_wrapped_padded_and_distinct(basis, h, w, k):
    """The scatter and gather rely on this: each side lists 0..b, then the
    wrapped negative frequencies n-b..n-1, then a padded tail just above
    +b, each index once; the windows vanish on the tail, and the box holds
    every nonzero of the group's full-size windows."""
    plan = PLANS[basis][0](h, w)
    boxes = sh._plan_kernel_pack(plan, h, w)[2]
    assert len(boxes) == (1 if basis == "CURVELET" else 2)
    l0, lg, g = boxes[k]
    for idx, n, axis in ((g.idx_h, h, 1), (g.idx_w, w, 2)):
        bound = int(np.sum(idx > n // 2))
        tail = len(idx) - (2 * bound + 1)
        assert 0 <= tail < 8 and len(idx) % 8 == 0
        np.testing.assert_array_equal(idx, np.concatenate([
            np.arange(bound + 1), np.arange(n - bound, n),
            np.arange(bound + 1, bound + 1 + tail)]))
        assert len(np.unique(idx)) == len(idx)
        assert not np.take(g.psi, np.arange(2 * bound + 1, len(idx)),
                           axis=axis).any()
    if basis == "SHEARLET":
        full = sh.shearlet_spectra(h, w)
    else:
        full = cv.curvelet_spectra(h, w)
    want = full[plan.perm[l0:l0 + lg]]
    boxed = np.zeros_like(want)
    boxed[:, g.idx_h[:, None], g.idx_w[None, :]] = g.psi
    np.testing.assert_array_equal(boxed, want)
    ih, iw = g.box_index_on(h, w, "cpu")
    assert ih.dtype == iw.dtype == torch.int32
    np.testing.assert_array_equal(ih.numpy(), g.idx_h)
    np.testing.assert_array_equal(iw.numpy(), g.idx_w)
    assert g.box_index_on(h, w, "cpu")[0] is ih  # checked and copied once


@pytest.mark.parametrize("idx_h", [
    np.array([0, 1, 2, 1], np.int32),      # a duplicate
    np.array([0, 1, 2, 64], np.int32),     # outside a side of 64
    np.array([-1, 0, 1, 2], np.int32)])    # negative
def test_box_index_refuses_what_the_scatter_cannot_take(idx_h):
    g = sh._ScaleGroup(idx_h, np.arange(4, dtype=np.int32),
                       np.ones((1, 4, 4), np.float32))
    with pytest.raises(ValueError, match="distinct"):
        g.box_index_on(64, 64, "cpu")


@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
def test_box_budget_covers_each_call(basis, monkeypatch):
    """At the main path's 32×512², ``pipeline.pocs``'s device budget holds
    the windows, the subband kernel's scratch and what each box group's call
    allocates: its (B, lg, sc, N_h) field columns and its result."""
    monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    b, n = 32, 512
    tr = get_transform(basis, precision="high")
    full, _, boxes = sh._plan_kernel_pack(tr._plan(n, n), n, n)
    budget = pipe._transform_device_bytes(tr, b, n, n)
    n_bands = pipe._n_subbands(tr, n, n)
    base = 2 * n_bands * n * n * 4 + ksb.scratch_bytes(b, n, n, n_bands)
    assert boxes
    for _, lg, g in boxes:
        sr, sc = len(g.idx_h), len(g.idx_w)
        call = 4 * ksb.box_work_floats(b, lg, sc, n) + 2 * 4 * b * sr * sc
        assert call == ksb.box_scratch_bytes(b, lg, sr, sc, n)
        assert budget >= base + call
    # the 72-side group's field columns: 85 MB at batch 32
    if basis == "CURVELET":
        assert 4 * ksb.box_work_floats(b, 9, 72, n) == 84934656


@pytest.mark.parametrize("basis", ks.BASES)
def test_solve_budget_covers_the_kernel_work(basis):
    """The folded solve's scratch (``solve_work_floats``, which
    ``p3d_pocs_solve_work_floats`` returns on the card) with the batch's
    input, its result and the decay's spectrum stays inside
    ``fits_resident``'s eight pairs a slice at 32×512²; the FFT and DCT
    solves hold two plane pairs and one partial-sum pair per row block of
    their last pass (8 rows of 512 a block: 64 a slice), the wavelet solve
    two and one per 32×32 tile of its level-0 inverse pass (256 a
    slice)."""
    b, n = 32, 512
    work = ks.solve_work_floats(b, n, n, basis)
    pair = b * n * n * 8
    nblk = 256 if basis == "wavelet" else 64
    assert work == 2 * 2 * b * n * n + 2 * b * nblk + 4 * b
    assert 4 * work + 3 * pair <= 8 * pair


@pytest.mark.parametrize("h,w,nblk", [(512, 512, 64), (100, 130, 7),
                                      (60, 2048, 30), (16, 8, 1),
                                      (8, 4096, 8)])
def test_solve_row_blocks_follow_the_line_groups(h, w, nblk):
    """The FFT solve's partial sums: one pair per block of its last row
    pass, a block of 512 threads holding 512 / t rows of t threads (t the
    power of two at or above w/8), one row a block at w = 4096."""
    got = ks.solve_work_floats(1, h, w, "fft") - 4 * h * w - 4
    assert got == 2 * nblk
