"""The row support the subband kernels skip by (ops/kernels/subband.py
``row_support``, ``band_chunks``), on the CPU.

The kernels transform only the rows of each window that hold a nonzero.
These tests hold the support tables against the real plans' windows, show
with ``torch.fft`` that a schedule transforming only those rows computes
``subband_update_plain`` (the skip is exact), and check the chunking of
the bands against the scratch bound the device budget reads.
"""

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
from pseudo_3d_interpolation_torch.ops.kernels.pocs_solve import _shrink

# the skipped schedule and the plain version sum the same float32 terms in
# the same band order; they differ by the FFTs' rounding only
TOL = 1e-5

PLANS = {"SHEARLET": sh.shearlet_plan, "CURVELET": cv.curvelet_plan}


def _full(basis: str, h: int, w: int):
    return sh._plan_kernel_pack(PLANS[basis](h, w), h, w)[0]


@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
@pytest.mark.parametrize("h,w", [(512, 512), (384, 512)])
def test_support_lists_exactly_the_nonzero_rows(basis, h, w):
    psi = _full(basis, h, w).psi
    offsets, rows = ksb.row_support(psi)
    assert offsets.dtype == np.int32 and rows.dtype == np.int32
    assert offsets[0] == 0 and len(offsets) == psi.shape[0] + 1
    assert np.all(np.diff(offsets) >= 0) and offsets[-1] == len(rows)
    for band in range(psi.shape[0]):
        listed = rows[offsets[band]:offsets[band + 1]]
        assert np.all(np.diff(listed) > 0)
        assert np.all(np.any(psi[band, listed] != 0, axis=-1))
        left_out = np.setdiff1d(np.arange(h), listed)
        assert not np.any(psi[band, left_out])


@pytest.mark.parametrize("h,w", [(512, 512), (384, 512)])
def test_curvelet_band_with_every_row_lists_every_row(h, w):
    psi = _full("CURVELET", h, w).psi
    offsets, rows = ksb.row_support(psi)
    full_rows = [band for band in range(psi.shape[0])
                 if offsets[band + 1] - offsets[band] == h]
    assert len(full_rows) == 1
    band = full_rows[0]
    np.testing.assert_array_equal(rows[offsets[band]:offsets[band + 1]],
                                  np.arange(h))


@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
def test_support_leaves_out_about_half_the_rows_at_512(basis):
    """The row skip's gain: the 512² windows touch about half their rows
    (SHEARLET 54%, CURVELET 47% on average)."""
    offsets, _ = ksb.row_support(_full(basis, 512, 512).psi)
    share = offsets[-1] / ((len(offsets) - 1) * 512)
    assert 0.4 < share < 0.6


@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
def test_device_table_inverts_the_list(basis):
    """The table the kernels read: the rows, their bands, and the packed
    index of each (band, row), -1 off the support."""
    full = _full(basis, 64, 64)
    sup = full.support_on("cpu")
    assert full.support_on("cpu") is sup  # cached beside the windows
    offsets, rows = ksb.row_support(full.psi)
    np.testing.assert_array_equal(sup.offsets, offsets)
    nbands, nnz = full.psi.shape[0], len(rows)
    table = sup.table.numpy()
    assert table.dtype == np.int32 and table.shape == (2 * nnz + nbands * 64,)
    np.testing.assert_array_equal(table[:nnz], rows)
    bands = table[nnz:2 * nnz]
    slot = table[2 * nnz:].reshape(nbands, 64)
    for band in range(nbands):
        np.testing.assert_array_equal(
            bands[offsets[band]:offsets[band + 1]], band)
    for q in range(nnz):
        assert slot[bands[q], rows[q]] == q
    assert (slot >= 0).sum() == nnz


def _skipped_schedule(x: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                      op: str) -> Cplx:
    """The kernels' three passes, written with torch.fft, transforming
    only the support rows in passes (a) and (c) and writing zeros
    elsewhere: (a) inverse FFT along W of the support rows of X·ψ_l;
    (b) inverse FFT along H of every column, scale, shrink, forward FFT
    along H, keeping the support rows; (c) forward FFT along W of the
    support rows, times ψ_l, added to the accumulator in band order."""
    b, h, w = x.re.shape
    offsets, rows = ksb.row_support(psi.numpy())
    xc = torch.complex(x.re, x.im)
    acc = torch.zeros_like(xc)
    for band in range(psi.shape[0]):
        r = torch.from_numpy(rows[offsets[band]:offsets[band + 1]]).long()
        p = psi[band, r]
        lines = torch.zeros_like(xc)
        lines[:, r] = torch.fft.ifft(xc[:, r] * p, dim=-1) * w
        c = torch.fft.ifft(lines, dim=-2) * h / (h * w)
        c = c * _shrink(c.real * c.real + c.imag * c.imag,
                        tau[:, band, None, None], op)
        kept = torch.fft.fft(c, dim=-2)[:, r]
        acc[:, r] += torch.fft.fft(kept, dim=-1) * p
    return Cplx(acc.real.contiguous(), acc.imag.contiguous())


@pytest.mark.parametrize("op", ["soft", "garrote"])
@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 64)])
def test_skipped_rows_schedule_equals_plain(basis, h, w, op):
    full = _full(basis, h, w)
    psi = torch.from_numpy(full.psi)
    rng = np.random.default_rng(h + w)
    x = Cplx(*(torch.from_numpy(rng.normal(size=(2, h, w)).astype(
        np.float32)) for _ in range(2)))
    tau = torch.from_numpy(rng.uniform(0.2, 1.0, size=(2, psi.shape[0]))
                           .astype(np.float32) / np.sqrt(h * w))
    offsets, _ = ksb.row_support(full.psi)
    assert offsets[-1] < psi.shape[0] * h  # some rows are skipped
    got = _skipped_schedule(x, psi, tau, op)
    want = ksb.subband_update_plain(x, psi, tau, op)
    got = torch.complex(got.re, got.im)
    want = torch.complex(want.re, want.im)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("basis", ["SHEARLET", "CURVELET"])
@pytest.mark.parametrize("batch", [1, 32])
def test_band_chunks_stay_inside_the_scratch_bound(basis, batch):
    """Each chunk's support rows fit the scratch :func:`scratch_bytes`
    promises the device budget; at batch 32 the 512² bands need more
    than one chunk, at batch 1 they take one."""
    n = 512
    offsets, _ = ksb.row_support(_full(basis, n, n).psi)
    nbands = len(offsets) - 1
    chunks = ksb.band_chunks(offsets, batch, n, n)
    assert chunks[0] == 0 and chunks[-1] == nbands
    assert np.all(np.diff(chunks) > 0)
    most = int(np.max(offsets[chunks[1:]] - offsets[chunks[:-1]]))
    assert batch * most * n * 8 <= ksb.scratch_bytes(batch, n, n, nbands)
    assert (len(chunks) - 1 > 1) == (batch == 32)


def test_band_chunks_fill_the_scratch_in_band_order(monkeypatch):
    """A scratch of one band's rows still takes every band: a band with
    every row fills a chunk (an empty band rides along), the others share
    the next."""
    h = w = 16
    psi = np.zeros((4, h, w), np.float32)
    psi[0] = 1.0              # every row
    psi[2, 3] = 1.0           # a single row
    psi[3, ::2] = 1.0         # half the rows; band 1 is empty
    offsets, _ = ksb.row_support(psi)
    np.testing.assert_array_equal(offsets, [0, 16, 16, 17, 25])
    monkeypatch.setattr(ksb, "SCRATCH_BYTES", 2 * h * w * 8)
    assert ksb.band_chunk(2, h, w, 4) == 1
    np.testing.assert_array_equal(ksb.band_chunks(offsets, 2, h, w),
                                  [0, 2, 4])


def test_support_for_checks_a_given_support():
    """The wrappers take the support built once per window stack, checked
    against the windows, and never build one themselves."""
    full = _full("SHEARLET", 64, 64)
    psi = torch.from_numpy(full.psi)
    sup = ksb.row_support_on(full.psi, "cpu")
    ksb._check_support(psi, sup)
    with pytest.raises(ValueError, match="support"):
        ksb._check_support(psi[:-1], sup)
    x = Cplx(torch.zeros(2, 64, 64), torch.zeros(2, 64, 64))
    tau = torch.ones(2, psi.shape[0])
    for kernel in (ksb.subband_update, ksb.subband_update_spatial):
        with pytest.raises(TypeError, match="support"):
            kernel(x, psi, tau)
        with pytest.raises(ValueError, match="support"):
            kernel(x, psi[:-1], tau[:, :-1].contiguous(), support=sup)


def test_support_keeps_each_batch_chunks():
    """A support computes a batch's band chunks once, and again only when
    the scratch they must fit changes."""
    full = _full("SHEARLET", 64, 64)
    sup = ksb.row_support_on(full.psi, "cpu")
    chunks, rows = sup.chunks(4, 64, 64)
    assert sup.chunks(4, 64, 64)[0] is chunks
    np.testing.assert_array_equal(chunks,
                                  ksb.band_chunks(sup.offsets, 4, 64, 64))
    assert rows == int(np.max(sup.offsets[chunks[1:]]
                              - sup.offsets[chunks[:-1]]))
    assert len(chunks) == 2  # the 64² bands fit one chunk


def test_support_chunks_follow_the_scratch_size(monkeypatch):
    full = _full("SHEARLET", 64, 64)
    sup = ksb.row_support_on(full.psi, "cpu")
    whole, _ = sup.chunks(4, 64, 64)
    monkeypatch.setattr(ksb, "SCRATCH_BYTES", 4 * 64 * 64 * 8)
    cut, rows = sup.chunks(4, 64, 64)
    np.testing.assert_array_equal(cut, ksb.band_chunks(sup.offsets, 4, 64,
                                                       64))
    assert len(cut) > len(whole) and rows <= 64


def test_line_fft_plain_is_the_unscaled_dft():
    """On CPU tensors the line engine's wrapper takes ``torch.fft``."""
    rng = np.random.default_rng(3)
    z = rng.normal(size=(3, 24)) + 1j * rng.normal(size=(3, 24))
    x = Cplx(torch.from_numpy(z.real.astype(np.float32)),
             torch.from_numpy(z.imag.astype(np.float32)))
    for inverse, want in ((False, np.fft.fft(z)),
                          (True, np.fft.ifft(z) * 24)):
        got = ksb.line_fft(x, inverse)
        np.testing.assert_allclose(got.re.numpy() + 1j * got.im.numpy(),
                                   want, rtol=0, atol=1e-4)
