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

The percentile route's row pass (``box_keys``, ``box_shrink``) takes a
pruned form where the box's W indices are a wrapped range of s
frequencies (``box_line_plan``: s′ the power of two at or above s and
16): each field row's inverse is N_w/s′ s′-point lines, one per class r of
pixels r, r + N_w/s′, …, fed x_j·ω^{j·r} at slot j mod s′, each line a
16-point DFT of a thread's elements, the line's twiddles, an exchange and
t = s′/16-point DFTs; the transpose runs the lines forward and sums the
classes at each box column. The later tests replay that, class by class
and thread by thread as the kernel indexes it, and hold it against
``torch.fft``, the JAX package's dense partial inverse (``_partial_ifft2``)
and ``box_group_update_fused`` (interpret mode), on the 512² groups, the
256² groups, a 384-wide CURVELET group (6 classes a row) and the 384×512
rectangle; they also hold ``box_line_plan`` to the plans.

Tolerances: soft and garrote thresholds are continuous, so the schedule
and the matrix forms differ by float32 rounding of differently ordered
sums, held to 1e-5 of max. Hard thresholds take thresholds in a gap
between coefficient magnitudes (``gap_taus``) and are then held to the
same bound; τ = 0 keeps every coefficient."""

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
from pseudo_3d_interpolation_torch.ops.kernels.pocs_solve import (_shrink,
                                                                 twiddles)
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


# --- the pruned row pass of the percentile route ---------------------------

# (basis, h, w, box group, the plan's (o, s′)): the main paths' groups at
# 512², the 256² groups (s′ = N_w/4 on the 40-side one), a 384² CURVELET
# group (6 classes, rows of 24 threads) and the 384×512 rectangle
PRUNED = [("SHEARLET", 512, 512, 0, (508, 16)),
          ("SHEARLET", 512, 512, 1, (496, 64)),
          ("CURVELET", 512, 512, 0, (480, 128)),
          ("SHEARLET", 256, 256, 0, (252, 16)),
          ("SHEARLET", 256, 256, 1, (240, 64)),
          ("CURVELET", 384, 384, 0, (360, 64)),
          ("SHEARLET", 384, 512, 1, (496, 64))]
PRUNED_IDS = ["16-side", "40-side", "72-side-curvelet", "16-side-256",
              "40-side-256", "56-side-curvelet-384", "40-side-384x512"]


def _table(n: int) -> torch.Tensor:
    """The kernels' twiddle table exp(-2πi m/n), float32, as complex."""
    t = torch.from_numpy(twiddles(n))
    return torch.complex(t[:, 0], t[:, 1])


def _fft(x, dim, inverse):
    return (torch.fft.ifft(x, dim=dim, norm="forward") if inverse
            else torch.fft.fft(x, dim=dim))


def _line_stages(a, t: int, inverse: bool, tw, p: int):
    """``pruned_line``: ``a`` (..., t, 16), a[..., j, e] element j + t·e of
    an s′ = 16t line (thread j's registers); returns the line's DFT
    (unscaled inverse) in the same layout. A 16-point DFT over each
    thread's e, the twiddles exp(∓2πi j·k1/s′) from the N_w-entry table at
    (j·k1 mod s′)·p, then for each f < 16/t thread j gathers k1 = j + t·f
    of every thread and writes its t-point DFT's output k2 to e = f +
    (16/t)·k2."""
    sl = 16 * t
    b = _fft(a, -1, inverse)  # [.., j, k1]
    j = torch.arange(t)[:, None]
    k1 = torch.arange(16)[None, :]
    w = tw[(j * k1 % sl) * p]
    b = b * (w.conj() if inverse else w)
    out = torch.empty_like(a)
    per = 16 // t
    for f in range(per):
        c = _fft(b[..., :, f * t:(f + 1) * t], -2, inverse)  # [.., k2, j']
        for k2 in range(t):
            out[..., :, f + per * k2] = c[..., k2, :]
    return out


def _layout(n: int, line: int):
    """(the thread's slots [j, e] = j + t·e of a class's line, the row
    pixel [r, j, e] = r + p·j + (n/16)·e it holds)."""
    p, t = n // line, line // 16
    e = np.arange(16)
    slots = np.arange(t)[:, None] + t * e[None, :]
    pix = (np.arange(p)[:, None, None] + p * np.arange(t)[None, :, None]
           + (n // 16) * e[None, None, :])
    return slots, pix


def _class_twiddles(idx_w, n: int, line: int, tw):
    """The classes' twiddles exp(-2πi idx_k·r/n), (sc, p), from the table."""
    r = np.arange(n // line)
    return tw[torch.from_numpy(np.asarray(idx_w, np.int64)[:, None]
                               * r[None, :] % n)]


def _pruned_rows_c(rows, idx_w, n: int, line: int, scale):
    """``pruned_row_c`` on every field row: ``rows`` (..., sc) complex, a
    row's box columns, to c (..., n), scaled. Thread (r, j) gathers the
    columns k at its slots j + t·e (slot = idx_k mod s′), times
    conj(ω^{-idx_k·r}), runs the line's inverse and holds pixels
    r + p·j + (n/16)·e."""
    p, t = n // line, line // 16
    tw = _table(n)
    slots, pix = _layout(n, line)
    kslot = np.full(line, -1)
    kslot[np.asarray(idx_w) % line] = np.arange(len(idx_w))
    k = kslot[slots]
    kk = torch.from_numpy(np.where(k >= 0, k, 0))
    twc = _class_twiddles(idx_w, n, line, tw)  # (sc, p)
    x = rows[..., kk][..., None, :, :] * twc[kk].permute(2, 0, 1).conj()  # [.., r, j, e]
    x = torch.where(torch.from_numpy(k >= 0), x, torch.zeros((), dtype=x.dtype))
    u = _line_stages(x, t, True, tw, p)
    c = torch.empty(rows.shape[:-1] + (n,), dtype=rows.dtype)
    c[..., torch.from_numpy(pix.ravel())] = u.reshape(rows.shape[:-1] + (-1,))
    return torch.complex(c.real * scale, c.imag * scale)


def _pruned_rows_shrink(rows, idx_w, n: int, line: int, scale, tau, op):
    """``box_shrink_pruned_kernel``'s row pass on every field row: c as
    ``_pruned_rows_c`` computes it, shrunk with |c|² rounded as the keys
    were, each class's line forward, and each box column k the sum over
    the classes r, in order, of ω^{-idx_k·r}·Z_r[idx_k mod s′]."""
    p, t = n // line, line // 16
    tw = _table(n)
    slots, pix = _layout(n, line)
    c = _pruned_rows_c(rows, idx_w, n, line, scale)
    c = c * _shrink(c.real * c.real + c.imag * c.imag, tau, op)
    z = _line_stages(c[..., torch.from_numpy(pix)], t, False, tw, p)
    zr = torch.empty(rows.shape[:-1] + (p, line), dtype=rows.dtype)
    zr[..., torch.from_numpy(slots.ravel())] = z.reshape(
        rows.shape[:-1] + (p, -1))
    twc = _class_twiddles(idx_w, n, line, tw)
    at = torch.from_numpy(np.asarray(idx_w, np.int64) % line)
    out = torch.zeros_like(rows)
    for r in range(p):
        out = out + twc[:, r] * zr[..., r, at]
    return out


def _field_rows(xb, p, idx_h, n_h):
    """Pass (1): the box columns of xb·ψ_l scattered at idx_h and inverted
    along H, unscaled, as field rows (..., N_h, sc)."""
    cols = torch.zeros(xb.shape[:-2] + (n_h, xb.shape[-1]), dtype=xb.dtype)
    cols[..., torch.from_numpy(np.asarray(idx_h)).long(), :] = xb * p
    return torch.fft.ifft(cols, dim=-2, norm="forward")


def _pruned_group(xbox: Cplx, psi, tau, g, n_h: int, n_w: int, op: str):
    """The percentile route's box_keys and box_shrink in the pruned form
    with pass (3) as the kernel runs it: (the keys (B, lg, N_h, N_w), c of
    both passes, the summed box)."""
    line = ksb.box_line_plan(g.idx_w, n_w)[1]
    scale = torch.tensor(1.0 / (n_h * n_w), dtype=torch.float32)
    ih = torch.from_numpy(np.asarray(g.idx_h)).long()
    xb = torch.complex(xbox.re, xbox.im)
    keys, c_keys, c_shrink = [], [], []
    acc = torch.zeros_like(xb)
    for band in range(psi.shape[0]):
        rows = _field_rows(xb, psi[band], g.idx_h, n_h)
        c = _pruned_rows_c(rows, g.idx_w, n_w, line, scale)
        keys.append(torch.sqrt(c.real * c.real + c.imag * c.imag))
        c_keys.append(c)
        # pass 2 computes c again from the same rows, with the same code
        c_shrink.append(_pruned_rows_c(rows, g.idx_w, n_w, line, scale))
        out = _pruned_rows_shrink(rows, g.idx_w, n_w, line, scale,
                                  tau[:, band, None, None], op)
        acc += torch.fft.fft(out, dim=-2)[:, ih] * psi[band]
    return (torch.stack(keys, 1), torch.stack(c_keys, 1),
            torch.stack(c_shrink, 1),
            Cplx(acc.real.contiguous(), acc.imag.contiguous()))


def _pruned_case(basis, h, w, k):
    plan = PLANS[basis][0](h, w)
    return sh._plan_kernel_pack(plan, h, w)[2][k]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("t", [1, 2, 4, 8, 16])
def test_pruned_line_stages_match_fft(t, inverse):
    """A class's s′-point line as the kernel's threads hold it, in and
    out: thread j element j + t·e, on a 512-entry table (p = 512/s′)."""
    rng = np.random.default_rng(t + 10 * inverse)
    sl, n = 16 * t, 512
    a = (rng.normal(size=(3, sl)) + 1j * rng.normal(size=(3, sl)))
    slots = _layout(n, sl)[0]
    got = _line_stages(torch.from_numpy(a.astype(np.complex64))[:, slots],
                       t, inverse, _table(n), n // sl)
    want = (np.fft.ifft(a, axis=-1) * sl if inverse
            else np.fft.fft(a, axis=-1))[:, slots]
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL, err


@pytest.mark.parametrize("basis,h,w,k,want", PRUNED, ids=PRUNED_IDS)
def test_box_line_plan_on_the_standard_groups(basis, h, w, k, want):
    """The standard plans' groups are wrapped ranges from n − b: the pruned
    form, s′ the power of two at or above the side (at least 16); the
    index pair the kernels get carries it."""
    _, _, g = _pruned_case(basis, h, w, k)
    assert ksb.box_line_plan(g.idx_w, w) == want
    o, line = want
    sc = len(g.idx_w)
    assert sc <= line and w % line == 0 and line <= w // 4
    np.testing.assert_array_equal(np.sort((g.idx_w - o) % w), np.arange(sc))
    assert g.box_index_on(h, w, "cpu").line == want
    assert ksb.box_line_plan(np.roll(g.idx_w, 5), w) == want  # any order


@pytest.mark.parametrize("sr,sc,want", [
    (16, 16, (508, 16)), (40, 40, (496, 64)), (447, 126, None),
    (126, 447, None), (447, 63, (481, 64)), (63, 447, None)])
def test_box_line_plan_on_the_split_plan(sr, sc, want):
    """The split plan (threshold 200): its two box groups keep the pruned
    form; the narrow groups take the general one where their W indices
    have a gap (447×126) or span more than N_w/4 (the 447-wide ones). The
    447×63 group's W indices are the wrapped range 481..511, 0..31, so
    its row pass is pruned too (s′ = 64)."""
    plan = sh.shearlet_plan(512, 512, split_threshold=200)
    groups = {(len(g.idx_h), len(g.idx_w)): g
              for _, _, g in sh._plan_kernel_pack(plan, 512, 512)[2]}
    assert ksb.box_line_plan(groups[sr, sc].idx_w, 512) == want


@pytest.mark.parametrize("idx,n", [
    (np.arange(16), 500),                           # no s′ divides 500
    (np.r_[np.arange(8), np.arange(500, 508)], 500),
    (np.r_[np.arange(8), np.arange(9, 17)], 512),   # a gap
    (np.r_[np.arange(8), np.arange(8)], 512),       # duplicates
    (np.arange(12), 48),                            # s′ = 16 > 48/4
    (np.arange(200), 512),                          # s′ = 256 > 512/4
    (np.arange(257), 4096),                         # s′ = 512 > 256
    (np.arange(512), 512),                          # the whole side
    (np.array([0, 600]), 512)])                     # outside the side
def test_box_line_plan_refuses_what_the_pruned_pass_cannot_take(idx, n):
    assert ksb.box_line_plan(idx, n) is None


def test_box_line_plan_takes_the_least_line():
    assert ksb.box_line_plan(np.arange(5), 512) == (0, 16)
    assert ksb.box_line_plan(np.arange(17), 512) == (0, 32)
    assert ksb.box_line_plan(np.arange(250, 258) % 256, 256) == (250, 16)
    assert ksb.box_line_plan(np.arange(200), 1024) == (0, 256)


@pytest.mark.parametrize("basis,h,w,k,want", PRUNED, ids=PRUNED_IDS)
def test_pruned_keys_match_the_dense_partial_inverse(basis, h, w, k, want):
    """box_keys's field, class by class, against the JAX package's dense
    ``_partial_ifft2`` of xb·ψ_l and the plain keys; c of pass 2 is c of
    pass 1 bit for bit, so |c|² there is the key squared."""
    _, lg, g = _pruned_case(basis, h, w, k)
    xr, xi, tau = _inputs(g, lg, h, w, "soft", seed=3 * h + k)
    x = Cplx(torch.from_numpy(xr), torch.from_numpy(xi))
    psi = g.psi_on("cpu")
    keys, c1, c2, _ = _pruned_group(x, psi, torch.from_numpy(tau), g, h, w,
                                    "soft")
    assert torch.equal(c1, c2)
    assert torch.equal(keys, torch.sqrt(c2.real * c2.real
                                        + c2.imag * c2.imag))
    v = (xr + 1j * xi)[:, None] * g.psi[None]
    want_c = jsh._partial_ifft2(
        JCplx(jnp.asarray(v.real.astype(np.float32)),
              jnp.asarray(v.imag.astype(np.float32))),
        g.idx_h, g.idx_w, h, w, HIGHEST)
    want_c = np.asarray(want_c.re) + 1j * np.asarray(want_c.im)
    got_c = c1.numpy()
    scale = np.abs(want_c).max()
    assert scale > 0
    assert np.abs(got_c - want_c).max() / scale <= TOL
    plain = ksb.box_keys_plain(x, psi, g.box_mats_on(h, w, "cpu"), h, w)
    assert float((keys - plain).abs().max() / plain.max()) <= TOL


@pytest.mark.parametrize("op", ["soft", "garrote", "tau0"])
@pytest.mark.parametrize("basis,h,w,k,want", PRUNED, ids=PRUNED_IDS)
def test_pruned_group_matches_jax_kernel(basis, h, w, k, want, op):
    """The whole group, the pruned row pass between the column passes,
    against ``box_group_update_fused`` (interpret mode): soft and garrote
    thresholds, and τ = 0 (hard, every coefficient kept)."""
    _, lg, g = _pruned_case(basis, h, w, k)
    kind = "hard" if op == "tau0" else op
    xr, xi, tau = _inputs(g, lg, h, w, "soft", seed=4 * h + k)
    if op == "tau0":
        tau = np.zeros_like(tau)
    jg = jsh._plan_pallas_pack(PLANS[basis][1](h, w), h, w, "natural")[2][k][2]
    np.testing.assert_array_equal(g.idx_w, jg.idx_w)
    want = jsb.box_group_update_fused(
        JCplx(jnp.asarray(xr), jnp.asarray(xi)), jg.psi_device(),
        jnp.asarray(tau), jg.box_mats_device(h, w), h, w, thresh_op=kind,
        precision=HIGHEST, interpret=True)
    got = _pruned_group(Cplx(torch.from_numpy(xr), torch.from_numpy(xi)),
                        g.psi_on("cpu"), torch.from_numpy(tau), g, h, w,
                        kind)[3]
    _close(got, want)


@pytest.mark.parametrize("basis,h,w,k,want", PRUNED, ids=PRUNED_IDS)
def test_pruned_group_matches_plain_hard(basis, h, w, k, want):
    """Hard thresholds in a gap of the field's magnitudes: the pruned
    schedule keeps what ``box_group_update_plain`` keeps."""
    _, lg, g = _pruned_case(basis, h, w, k)
    xr, xi, tau = _inputs(g, lg, h, w, "hard", seed=5 * h + k)
    x = Cplx(torch.from_numpy(xr), torch.from_numpy(xi))
    psi, tau = g.psi_on("cpu"), torch.from_numpy(tau)
    got = _pruned_group(x, psi, tau, g, h, w, "hard")[3]
    want = ksb.box_group_update_plain(x, psi, tau, g.box_mats_on(h, w, "cpu"),
                                      h, w, "hard")
    _close(got, want)
