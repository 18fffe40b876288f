"""Subband updates of the spectral-stack (SHEARLET, CURVELET) POCS
iteration: the CUDA kernels' wrappers and their plain PyTorch versions.

:func:`subband_update` replaces
``pseudo_3d_interpolation_tpu/ops/pallas/subband.py :: subband_update_fused``
(bodies ``_kernel``, radix-permuted layout, and ``_kernel_dense``, natural
layout): the full-size bands' ``Σ_l fft2(shrink(ifft2(X·ψ_l)))·ψ_l``. The
port keeps the spectrum in natural order for every shape; the permuted
layout was a TPU choice to skip an interleave.
:func:`subband_update_spatial` replaces ``subband_update_fused(...,
spatial_io=True)`` (body ``_kernel_spatial``): the same update with the
top-level ``fft2`` and ``ifft2`` inside the kernel, spatial in and out.
The JAX package runs it only in the permuted layout (square slices with a
fast split); the port's kernel takes any H×W. :func:`box_group_update`
replaces ``box_group_update_fused`` (body ``_box_kernel``): one support-
cropped group's ``Σ_l ψ_l·A_h·shrink(A_hᴴ(xb·ψ_l)A_w*/(N_h·N_w))·A_wᵀ``,
whose partial-DFT products the kernel computes as line FFTs of the full
field with the box scattered in and gathered out at its indices.
``csrc/subband.cu`` has the three kernels, with their design and what
bounds them; ``csrc/fft_lines.cuh`` their line FFTs, which :func:`line_fft`
also runs alone.

The first two kernels transform only the rows of each window that hold a
nonzero (:func:`row_support`, a CSR list built once per window stack on
the host, :class:`RowSupport` on the device): a row of X·ψ_l whose window
row is zero is a zero line wherever it would be transformed, so the skip
is exact.

With a ``*-percentile`` threshold (the JAX package's plain streamed apply
takes it, ``threshold_pair`` on each band's c_l) each band's threshold is
a percentile of |c_l| over the whole field, which the kernels cannot know
before c_l is whole. :func:`subband_update_percentile` and
:func:`box_group_update_percentile` run kernels A and B split at the
threshold: pass 1 (:func:`subband_keys`, :func:`box_keys`) writes |c_l|
and the histogram of its first digit, ``percentile.band_percentile``
selects the thresholds on the card, pass 2 (:func:`subband_shrink`,
:func:`box_shrink`) shrinks c_l and runs the rest of the kernel. Kernel A
keeps c_l from pass 1 (the faster design on the card); kernel B computes
it once more from pass 1's scratch, with pruned line transforms where the
box's W indices are a wrapped range (:func:`box_line_plan`).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors; a failed build or launch raises. The
solver kernels' wrappers count their launches (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..cplx import Cplx
from . import _build
from .pocs_solve import PRECISIONS, THRESH_OPS, _shrink, raise_on, twiddles_on

# at most this much device scratch for kernel A's bands in flight: a
# (B, chunk, H, W) complex stack
SCRATCH_BYTES = 1 << 30


def band_chunk(batch: int, h: int, w: int, nbands: int) -> int:
    """Full-size bands of kernel A's scratch in flight at a time: the
    scratch holds this many bands' worth of support rows."""
    return max(1, min(nbands, SCRATCH_BYTES // max(1, batch * h * w * 8)))


def scratch_bytes(batch: int, h: int, w: int, nbands: int,
                  spatial: bool = False) -> int:
    """Upper bound of the device scratch of one :func:`subband_update`
    call, or with ``spatial`` of one :func:`subband_update_spatial` call
    (one (B, H, W) spectrum more), whatever the windows' support."""
    return (band_chunk(batch, h, w, nbands) + int(spatial)) * batch * h * w * 8


def box_work_floats(batch: int, lg: int, sc: int, n_h: int) -> int:
    """Floats of the device scratch one :func:`box_group_update` call
    allocates: the field columns of every box column of every band,
    (B, lg, sc, N_h) complex."""
    return batch * lg * sc * n_h * 2


def box_scratch_bytes(batch: int, lg: int, sr: int, sc: int,
                      n_h: int) -> int:
    """Device bytes one :func:`box_group_update` call allocates on the
    card: its scratch and its (B, sr, sc) result pair."""
    return 4 * box_work_floats(batch, lg, sc, n_h) + 8 * batch * sr * sc


# the pruned row pass's lines: 16 elements a thread, at most two stages
PRUNED_LINE_MIN, PRUNED_LINE_MAX = 16, 256


def box_line_plan(idx, n: int) -> tuple[int, int] | None:
    """The form of the percentile route's box row pass for a box whose W
    indices are ``idx`` into a side of ``n``: (o, s′) when the indices are
    the wrapped range o, o + 1, …, o + s − 1 (mod n), each once and in any
    order, and s′, the least power of two at or above both s and 16, is at
    most min(n/4, 256) and divides n; else None (the general form).

    Each field row's inverse along W then takes n/s′ s′-point lines, one
    per class r of pixels r, r + n/s′, …, and the frequency j lands on
    slot j mod s′ = idx mod s′ of each line (``csrc/subband.cu``, the
    pruned row pass). 16 and 256 are that kernel's: a thread holds 16
    elements of a line, and a line is two stages of at most 16 points. A
    pure function of the plan's indices: the standard plans' box groups
    (``ops/shearlet._box_indices``: 0..b, n−b..n−1, then a padded tail
    b+1..) take the pruned form; a split plan's group whose indices have a
    gap, and a side such as 500 that no such s′ divides, the general
    one."""
    idx = np.asarray(idx, dtype=np.int64).ravel()
    s = len(idx)
    if s == 0 or idx.min() < 0 or idx.max() >= n or len(np.unique(idx)) != s:
        return None
    present = np.zeros(n, bool)
    present[idx] = True
    starts = np.flatnonzero(present & ~np.roll(present, 1))
    if len(starts) != 1:  # more than one run, or the whole side
        return None
    line = PRUNED_LINE_MIN
    while line < s:
        line *= 2
    if line > min(n // 4, PRUNED_LINE_MAX) or n % line:
        return None
    return int(starts[0]), line


class BoxIndex(tuple):
    """A box's (idx_h, idx_w) as int32 on the kernels' device, with
    ``line``, :func:`box_line_plan` of idx_w: the form the percentile
    route's row pass takes (None: the general form). What
    ``_ScaleGroup.box_index_on`` returns; a plain pair takes the general
    form."""

    def __new__(cls, idx_h: torch.Tensor, idx_w: torch.Tensor, line):
        self = super().__new__(cls, (idx_h, idx_w))
        self.line = line
        return self


def _box_line(index) -> int:
    """The s′ the box kernels take for ``index``: the pruned row pass's
    line, 0 for the general form."""
    line = index.line if isinstance(index, BoxIndex) else None
    return 0 if line is None else line[1]


class RowSupport:
    """A window stack's row support as the kernels take it: ``offsets``,
    (L + 1,) int32 on the host, the CSR offsets of each band's rows; and
    ``table``, int32 on the kernels' device: the support rows in band
    order, their bands, then the (L, H) packed index of each (band, row),
    -1 off the support. :meth:`chunks` keeps each batch's band chunks."""

    __slots__ = ("offsets", "table", "_chunks")

    def __init__(self, offsets: np.ndarray, table: torch.Tensor):
        self.offsets = offsets
        self.table = table
        self._chunks = {}

    def chunks(self, batch: int, h: int, w: int) -> tuple[np.ndarray, int]:
        """:func:`band_chunks` of a (batch, h, w) call and the most support
        rows of one chunk, computed once per scratch size."""
        cap = band_chunk(batch, h, w, len(self.offsets) - 1) * h
        if cap not in self._chunks:
            c = band_chunks(self.offsets, batch, h, w)
            self._chunks[cap] = (c, int(np.max(self.offsets[c[1:]]
                                               - self.offsets[c[:-1]])))
        return self._chunks[cap]


def row_support(psi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The rows r with ψ_l[r, :] ≠ 0 of each band l of a (L, H, W) window
    stack, as a CSR list: (offsets (L + 1,), rows (nnz,)), both int32, the
    rows of band l ``rows[offsets[l]:offsets[l + 1]]`` in ascending
    order."""
    nz = np.any(psi != 0, axis=-1)
    offsets = np.zeros(nz.shape[0] + 1, np.int32)
    offsets[1:] = np.cumsum(nz.sum(axis=1))
    return offsets, np.nonzero(nz)[1].astype(np.int32)


def row_support_on(psi: np.ndarray, device) -> RowSupport:
    """:func:`row_support` of ``psi`` with its device table on
    ``device``."""
    offsets, rows = row_support(psi)
    nbands, h = psi.shape[:2]
    bands = np.repeat(np.arange(nbands, dtype=np.int32), np.diff(offsets))
    slot = np.full((nbands, h), -1, np.int32)
    slot[bands, rows] = np.arange(len(rows), dtype=np.int32)
    table = np.concatenate([rows, bands, slot.ravel()])
    return RowSupport(offsets, torch.from_numpy(table).to(device))


def band_chunks(offsets: np.ndarray, batch: int, h: int, w: int
                ) -> np.ndarray:
    """The band chunks of one call: int32 first band of each chunk, then
    L. A chunk takes bands in order while their support rows fit
    ``band_chunk(...)·H`` rows, so the scratch never outgrows
    :func:`scratch_bytes`."""
    nbands = len(offsets) - 1
    cap = band_chunk(batch, h, w, nbands) * h
    starts = [0]
    for l in range(nbands):
        if offsets[l + 1] - offsets[starts[-1]] > cap:
            starts.append(l)
    return np.asarray(starts + [nbands], np.int32)


def _split_op(thresh_op: str, precision: str) -> str:
    """:func:`_op` of a percentile route's threshold: 'hard-percentile' or
    its base 'hard' (soft, garrote alike) name the same pass 2."""
    return _op(thresh_op.removesuffix("-percentile"), precision)


def _op(thresh_op: str, precision: str) -> str:
    op = "garrote" if thresh_op == "garotte" else thresh_op
    if op not in THRESH_OPS:
        raise ValueError(f"the subband kernels support {sorted(THRESH_OPS)} "
                         f"thresholds, not {thresh_op!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose one of "
                         f"{PRECISIONS}")
    return op


def _check(named: dict, device) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the subband kernels run on cuda or cpu tensors, "
                         f"not {t.device}")
    return t.device


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("subband")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.p3d_subband_update.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.p3d_subband_update.restype = i
    lib.p3d_subband_update_spatial.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.p3d_subband_update_spatial.restype = i
    lib.p3d_line_fft.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.p3d_line_fft.restype = i
    lib.p3d_box_group_update.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.p3d_box_group_update.restype = i
    lib.p3d_subband_keys.argtypes = [p] * 7 + [i] * 2 + [p] * 4 + [i] * 4 + [p]
    lib.p3d_subband_keys.restype = i
    lib.p3d_subband_shrink.argtypes = [p] * 6 + [i] * 2 + [p] * 4 + [i] * 6 + [p]
    lib.p3d_subband_shrink.restype = i
    lib.p3d_box_keys.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.p3d_box_keys.restype = i
    lib.p3d_box_shrink.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.p3d_box_shrink.restype = i
    return lib


def subband_update_plain(x_spec: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                         thresh_op: str = "hard") -> Cplx:
    """Σ_l fft2(shrink(ifft2(X·ψ_l), tau[:, l]))·ψ_l with ``torch.fft``,
    one band at a time, summed in band order as the kernel sums."""
    op = "garrote" if thresh_op == "garotte" else thresh_op
    x = torch.complex(x_spec.re, x_spec.im)
    acc = torch.zeros_like(x)
    for k in range(psi.shape[0]):
        p = psi[k]
        c = torch.fft.ifft2(x * p)
        c = c * _shrink(c.real * c.real + c.imag * c.imag,
                        tau[:, k, None, None], op)
        acc = acc + torch.fft.fft2(c) * p
    return Cplx(acc.real.contiguous(), acc.imag.contiguous())


def _check_bands(x: Cplx, psi: torch.Tensor, tau: torch.Tensor | None,
                 name: str) -> torch.device:
    """The checks of the subband entry points (``tau`` None: one that takes
    no thresholds); returns the tensors' device."""
    device = _device(x.re)
    if x.re.dim() != 3 or x.im.shape != x.re.shape:
        raise ValueError(f"{name} must be a (B, H, W) pair, got "
                         f"{tuple(x.re.shape)} / {tuple(x.im.shape)}")
    b, h, w = x.re.shape
    if psi.dim() != 3 or tuple(psi.shape[1:]) != (h, w):
        raise ValueError(f"psi must be (L, {h}, {w}), got "
                         f"{tuple(psi.shape)}")
    nbands = psi.shape[0]
    named = {f"{name}.re": x.re, f"{name}.im": x.im, "psi": psi}
    if tau is not None:
        if tuple(tau.shape) != (b, nbands):
            raise ValueError(f"tau must be ({b}, {nbands}), got "
                             f"{tuple(tau.shape)}")
        named["tau"] = tau
    _check(named, device)
    return device


def _check_support(psi: torch.Tensor, support: RowSupport) -> None:
    """Raise unless ``support`` describes ``psi``'s bands on its device."""
    nbands, h = psi.shape[:2]
    offsets, table = support.offsets, support.table
    if (offsets.dtype != np.int32 or offsets.shape != (nbands + 1,)
            or table.dtype != torch.int32 or table.device != psi.device
            or tuple(table.shape) != (2 * int(offsets[-1]) + nbands * h,)):
        raise ValueError(f"support does not describe {nbands} bands of "
                         f"{h} rows on {psi.device}")


def _band_call(x: Cplx, support: RowSupport, spatial: bool) -> tuple:
    """What the two subband entry points share: (the band chunks, the
    compact scratch, with ``spatial`` the spectrum scratch else None, the
    int arguments (B, H, W, L, chunk count))."""
    b, h, w = x.re.shape
    nbands = len(support.offsets) - 1
    chunks, rows = support.chunks(b, h, w)
    work = torch.empty(max(1, b * rows * w * 2), dtype=torch.float32,
                       device=x.re.device)
    spec = (torch.empty(b * h * w * 2, dtype=torch.float32,
                        device=x.re.device) if spatial else None)
    return chunks, work, spec, (b, h, w, nbands, len(chunks) - 1)


def subband_update(x_spec: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                   thresh_op: str = "hard", precision: str = "highest", *,
                   support: RowSupport) -> Cplx:
    """The full-size bands' subband update of a batch of spectra.

    ``x_spec``: (B, H, W) float32 pair, the natural-order ``fft2`` of the
    slices, any H and W up to 4096; ``psi``: (L, H, W) real windows;
    ``tau``: (B, L) thresholds; ``precision``: 'high', 'highest' or 'default',
    all full fp32; ``support``: ``psi``'s :class:`RowSupport` on its device,
    built once per window stack (:func:`row_support_on`). Returns the
    (B, H, W) spectral accumulator, which inverts with ``ifft2``. CUDA
    tensors run the kernel, CPU tensors :func:`subband_update_plain`."""
    op = _op(thresh_op, precision)
    device = _check_bands(x_spec, psi, tau, "x_spec")
    _check_support(psi, support)
    if device.type == "cpu":
        return subband_update_plain(x_spec, psi, tau, op)
    acc_re = torch.empty_like(x_spec.re)
    acc_im = torch.empty_like(x_spec.im)
    if x_spec.re.shape[0] == 0 or psi.shape[0] == 0:
        return Cplx(acc_re.zero_(), acc_im.zero_())
    chunks, work, _, ints = _band_call(x_spec, support, False)
    h, w = ints[1:3]
    tw_h = twiddles_on(h, str(device))
    tw_w = twiddles_on(w, str(device))
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_update(
            x_spec.re.data_ptr(), x_spec.im.data_ptr(), psi.data_ptr(),
            tau.data_ptr(), tw_h.data_ptr(), tw_w.data_ptr(),
            support.table.data_ptr(), support.offsets.ctypes.data,
            chunks.ctypes.data, acc_re.data_ptr(), acc_im.data_ptr(),
            work.data_ptr(), *ints, THRESH_OPS[op],
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "subband_update", tuple(x_spec.re.shape))
    subband_update.launches += 1
    return Cplx(acc_re, acc_im)


subband_update.launches = 0


def subband_update_spatial_plain(x: Cplx, psi: torch.Tensor,
                                 tau: torch.Tensor, thresh_op: str = "hard"
                                 ) -> Cplx:
    """``ifft2`` of :func:`subband_update_plain` of ``fft2(x)``: the bands
    one at a time, summed in band order."""
    xf = torch.fft.fft2(torch.complex(x.re, x.im))
    acc = subband_update_plain(
        Cplx(xf.real.contiguous(), xf.imag.contiguous()), psi, tau,
        thresh_op)
    out = torch.fft.ifft2(torch.complex(acc.re, acc.im))
    return Cplx(out.real.contiguous(), out.imag.contiguous())


def subband_update_spatial(x: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                           thresh_op: str = "hard",
                           precision: str = "highest", *,
                           support: RowSupport) -> Cplx:
    """The full-size bands' subband update of a batch of slices, spatial in
    and out: ``ifft2(Σ_l fft2(shrink(ifft2(fft2(x)·ψ_l)))·ψ_l)``.

    ``x``: (B, H, W) float32 pair of spatial slices, any H and W up to
    4096; ``psi``, ``tau``, ``precision`` and ``support`` as
    :func:`subband_update`. Returns the (B, H, W) spatial update. CUDA
    tensors run the kernel, whose forward and inverse transforms are its
    own passes; CPU tensors :func:`subband_update_spatial_plain`."""
    op = _op(thresh_op, precision)
    device = _check_bands(x, psi, tau, "x")
    _check_support(psi, support)
    if x.re.shape[0] == 0 or psi.shape[0] == 0:
        return Cplx(torch.zeros_like(x.re), torch.zeros_like(x.im))
    if device.type == "cpu":
        return subband_update_spatial_plain(x, psi, tau, op)
    out_re = torch.empty_like(x.re)
    out_im = torch.empty_like(x.im)
    chunks, work, spec, ints = _band_call(x, support, True)
    h, w = ints[1:3]
    tw_h = twiddles_on(h, str(device))
    tw_w = twiddles_on(w, str(device))
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_update_spatial(
            x.re.data_ptr(), x.im.data_ptr(), psi.data_ptr(), tau.data_ptr(),
            tw_h.data_ptr(), tw_w.data_ptr(), support.table.data_ptr(),
            support.offsets.ctypes.data, chunks.ctypes.data,
            out_re.data_ptr(), out_im.data_ptr(), spec.data_ptr(),
            work.data_ptr(), *ints, THRESH_OPS[op],
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "subband_update_spatial", tuple(x.re.shape))
    subband_update_spatial.launches += 1
    return Cplx(out_re, out_im)


subband_update_spatial.launches = 0


def line_fft_plain(x: Cplx, inverse: bool = False) -> Cplx:
    """The DFT along the last axis with ``torch.fft`` (``inverse``: the
    unscaled inverse, n·ifft)."""
    c = torch.complex(x.re, x.im)
    n = c.shape[-1]
    out = torch.fft.ifft(c) * n if inverse else torch.fft.fft(c)
    return Cplx(out.real.contiguous(), out.imag.contiguous())


def line_fft(x: Cplx, inverse: bool = False) -> Cplx:
    """The subband kernels' line engine (``csrc/fft_lines.cuh``) alone:
    the DFT along the last axis of a (..., n) float32 pair, n up to 4096
    (``inverse``: unscaled). Not on a solver path: it lets the engine be
    held against ``torch.fft`` at every line length. CUDA tensors run the
    kernel, CPU tensors :func:`line_fft_plain`."""
    device = _device(x.re)
    if x.im.shape != x.re.shape or x.re.dim() < 1:
        raise ValueError(f"x must be a (..., n) pair, got "
                         f"{tuple(x.re.shape)} / {tuple(x.im.shape)}")
    _check({"x.re": x.re, "x.im": x.im}, device)
    if device.type == "cpu":
        return line_fft_plain(x, inverse)
    n = x.re.shape[-1]
    nlines = x.re.numel() // max(1, n)
    re, im = x.re.clone(), x.im.clone()
    if nlines == 0:
        return Cplx(re, im)
    tw = twiddles_on(n, str(device))
    with torch.cuda.device(device):
        rc = _lib().p3d_line_fft(
            re.data_ptr(), im.data_ptr(), tw.data_ptr(), nlines, n,
            int(inverse), torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "line_fft", tuple(x.re.shape))
    return Cplx(re, im)


def _check_box(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor | None,
               mats, n_h: int, n_w: int, index) -> torch.device:
    """The checks of the box entry points (``tau`` None: one that takes no
    thresholds); returns the tensors' device. CPU tensors need ``mats``,
    CUDA tensors ``index``."""
    device = _device(xbox.re)
    if xbox.re.dim() != 3 or xbox.im.shape != xbox.re.shape:
        raise ValueError(f"xbox must be a (B, sr, sc) pair, got "
                         f"{tuple(xbox.re.shape)} / {tuple(xbox.im.shape)}")
    b, sr, sc = xbox.re.shape
    if psi.dim() != 3 or tuple(psi.shape[1:]) != (sr, sc):
        raise ValueError(f"psi must be (lg, {sr}, {sc}), got "
                         f"{tuple(psi.shape)}")
    lg = psi.shape[0]
    named = {"xbox.re": xbox.re, "xbox.im": xbox.im, "psi": psi}
    if tau is not None:
        if tuple(tau.shape) != (b, lg):
            raise ValueError(f"tau must be ({b}, {lg}), got "
                             f"{tuple(tau.shape)}")
        named["tau"] = tau
    _check(named, device)
    if device.type == "cpu":
        ahr, ahi, awr, awi = mats
        for name, t, shape in (("ahr", ahr, (sr, n_h)), ("ahi", ahi, (sr, n_h)),
                               ("awr", awr, (sc, n_w)), ("awi", awi, (sc, n_w))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(t.shape)}")
        _check({"ahr": ahr, "ahi": ahi, "awr": awr, "awi": awi}, device)
        return device
    if index is None:
        raise ValueError("a box kernel on a CUDA tensor needs index, the "
                         "box's (idx_h, idx_w) as int32 on its device")
    for name, t, n in (("idx_h", index[0], sr), ("idx_w", index[1], sc)):
        if (t.dtype != torch.int32 or t.device != device
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be ({n},) int32 on {device}")
    return device


def box_group_update_plain(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                           mats, n_h: int, n_w: int,
                           thresh_op: str = "hard") -> Cplx:
    """Σ_l ψ_l·(A_h shrink(A_hᴴ(xb·ψ_l)A_w*/(N_h·N_w)) A_wᵀ) with complex
    ``torch.matmul``, one band at a time, summed in band order."""
    op = "garrote" if thresh_op == "garotte" else thresh_op
    ahr, ahi, awr, awi = mats
    ah = torch.complex(ahr, ahi)  # (sr, N_h)
    aw = torch.complex(awr, awi)  # (sc, N_w)
    xb = torch.complex(xbox.re, xbox.im)
    m = torch.zeros_like(xb)
    for k in range(psi.shape[0]):
        p = psi[k]
        c = (ah.conj().T @ (xb * p) @ aw.conj()) / (n_h * n_w)
        c = c * _shrink(c.real * c.real + c.imag * c.imag,
                        tau[:, k, None, None], op)
        m = m + (ah @ c @ aw.T) * p
    return Cplx(m.real.contiguous(), m.imag.contiguous())


def box_group_update(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor, mats,
                     n_h: int, n_w: int, thresh_op: str = "hard",
                     precision: str = "highest", *, index=None) -> Cplx:
    """One support-cropped group's update of a batch of box spectra.

    ``xbox``: (B, sr, sc) float32 pair, the group's frequency box of the
    slices' spectra on the N_h × N_w grid; ``psi``: (lg, sr, sc) windows;
    ``tau``: (B, lg); ``mats``: (ahr, ahi, awr, awi), the partial DFT rows
    A_h = F_{N_h}[idx_h] (sr, N_h) and A_w = F_{N_w}[idx_w] (sc, N_w) as
    float32, which the plain version multiplies by (CUDA tensors may pass
    None); ``index``: (idx_h, idx_w), the box's distinct fft-layout indices
    as int32 on the tensors' device (``_ScaleGroup.box_index_on``), which
    the kernel scatters and gathers at (CPU tensors may pass None). Returns
    the window-weighted summed box (B, sr, sc), to be added into the
    slices' spectra at the box. CUDA tensors run the kernel, CPU tensors
    :func:`box_group_update_plain`."""
    op = _op(thresh_op, precision)
    device = _check_box(xbox, psi, tau, mats, n_h, n_w, index)
    if device.type == "cpu":
        return box_group_update_plain(xbox, psi, tau, mats, n_h, n_w, op)
    b, sr, sc = xbox.re.shape
    lg = psi.shape[0]
    idx_h, idx_w = index
    m_re = torch.empty_like(xbox.re)
    m_im = torch.empty_like(xbox.im)
    if b == 0 or lg == 0:
        return Cplx(m_re.zero_(), m_im.zero_())
    work = torch.empty(box_work_floats(b, lg, sc, n_h), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        rc = _lib().p3d_box_group_update(
            xbox.re.data_ptr(), xbox.im.data_ptr(), psi.data_ptr(),
            tau.data_ptr(), idx_h.data_ptr(), idx_w.data_ptr(),
            twiddles_on(n_h, str(device)).data_ptr(),
            twiddles_on(n_w, str(device)).data_ptr(), m_re.data_ptr(),
            m_im.data_ptr(), work.data_ptr(), b, lg, sr, sc, n_h, n_w,
            THRESH_OPS[op], torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "box_group_update", (b, sr, sc, n_h, n_w))
    box_group_update.launches += 1
    return Cplx(m_re, m_im)


box_group_update.launches = 0


# --- the percentile route: each kernel split at the threshold -------------
#
# A percentile threshold needs all of c_l before any of it is shrunk, so
# the route runs each kernel in two passes with the selection between:
# pass 1 (``subband_keys``, ``box_keys``) the passes up to c_l, writing
# |c_l| of every pixel (the keys) and counting their first digit
# (``percentile.key_histogram_plain``'s histogram); ``percentile.
# band_percentile`` one threshold per (slice, band); pass 2
# (``subband_shrink``, ``box_shrink``) c_l shrunk and the rest of the
# kernel, on c_l as pass 1 kept it (kernel A) or computed again from pass
# 1's scratch (kernel B). Each wrapper counts its launches; on CPU tensors
# it runs its plain version.


def subband_keys_plain(x_spec: Cplx, psi: torch.Tensor) -> torch.Tensor:
    """|ifft2(X·ψ_l)| of each band, (B, L, H, W), rounded as
    ``Cplx.abs`` rounds it."""
    x = torch.complex(x_spec.re, x_spec.im)
    keys = torch.empty((x.shape[0], psi.shape[0]) + tuple(x.shape[1:]),
                       dtype=torch.float32, device=x.device)
    for k in range(psi.shape[0]):
        c = torch.fft.ifft2(x * psi[k])
        keys[:, k] = torch.sqrt(c.real * c.real + c.imag * c.imag)
    return keys


def _new_hist(lead: tuple, device) -> torch.Tensor:
    """Pass 1's histogram on the card, (lead + (HIST_COLS,)) int32, zeroed
    on the current stream for the kernel to add to."""
    from .percentile import HIST_COLS

    return torch.zeros(tuple(lead) + (HIST_COLS,), dtype=torch.int32,
                       device=device)


def subband_keys(x_spec: Cplx, psi: torch.Tensor, support: RowSupport,
                 l0: int, l1: int, work=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the percentile route on the band chunk [l0, l1) of
    ``psi``: (the keys |c_l| (B, l1 − l0, H, W) of c_l = ifft2(X·ψ_l),
    their first-digit histogram (B, l1 − l0, HIST_COLS) int32, as
    ``percentile.key_histogram_plain`` counts it). On the card the
    kernel's passes (a) and (b) up to the scale, (a) into ``work``'s
    scratch and c_l into its kept buffer (:func:`percentile_work`), which
    pass 2 reads; the keys are written column by column and returned as a
    transposed view, each segment one contiguous block. CPU tensors run
    :func:`subband_keys_plain` and the plain histogram."""
    from .percentile import key_histogram_plain

    device = _check_bands(x_spec, psi, None, "x_spec")
    _check_support(psi, support)
    if device.type == "cpu":
        keys = subband_keys_plain(x_spec, psi[l0:l1])
        return keys, key_histogram_plain(keys)
    b, h, w = x_spec.re.shape
    scratch, cl = work
    keys = torch.empty((b, l1 - l0, w, h), dtype=torch.float32,
                       device=device)
    hist = _new_hist((b, l1 - l0), device)
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_keys(
            x_spec.re.data_ptr(), x_spec.im.data_ptr(), psi.data_ptr(),
            twiddles_on(h, str(device)).data_ptr(),
            twiddles_on(w, str(device)).data_ptr(), support.table.data_ptr(),
            support.offsets.ctypes.data, l0, l1, keys.data_ptr(),
            hist.data_ptr(), scratch.data_ptr(), cl.data_ptr(), b, h, w,
            psi.shape[0], torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "subband_keys", tuple(x_spec.re.shape))
    subband_keys.launches += 1
    return keys.transpose(-1, -2), hist


subband_keys.launches = 0


def subband_shrink_plain(x_spec: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                         thresh_op: str, acc: Cplx | None = None) -> Cplx:
    """``acc`` (zero when None) + Σ_l fft2(shrink(ifft2(X·ψ_l), tau[:, l]))·ψ_l
    over the bands of ``psi``, summed in band order onto ``acc`` as the
    kernel sums."""
    x = torch.complex(x_spec.re, x_spec.im)
    total = (torch.zeros_like(x) if acc is None
             else torch.complex(acc.re, acc.im))
    for k in range(psi.shape[0]):
        p = psi[k]
        c = torch.fft.ifft2(x * p)
        c = c * _shrink(c.real * c.real + c.imag * c.imag,
                        tau[:, k, None, None], thresh_op)
        total = total + torch.fft.fft2(c) * p
    return Cplx(total.real.contiguous(), total.imag.contiguous())


def subband_shrink(x_spec: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                   support: RowSupport, l0: int, l1: int, acc: Cplx | None,
                   thresh_op: str, work=None) -> Cplx:
    """Pass 2 of the percentile route on the band chunk [l0, l1): c_l as
    pass 1 kept it in ``work`` (:func:`percentile_work`), shrunk by ``tau``
    (B, l1 − l0) (the thresholds :func:`percentile.band_percentile`
    selected) with |c|² rounded as the keys were, forward-transformed,
    weighted by ψ_l and summed in band order onto ``acc`` (None for the
    first chunk). Returns the accumulator, on the card ``acc``'s planes
    written in place; CPU tensors run :func:`subband_shrink_plain`."""
    op = _split_op(thresh_op, "highest")
    device = _check_bands(x_spec, psi, None, "x_spec")
    _check_support(psi, support)
    b, h, w = x_spec.re.shape
    if tuple(tau.shape) != (b, l1 - l0):
        raise ValueError(f"tau must be ({b}, {l1 - l0}), got "
                         f"{tuple(tau.shape)}")
    _check({"tau": tau}, device)
    if device.type == "cpu":
        return subband_shrink_plain(x_spec, psi[l0:l1], tau, op, acc)
    first = acc is None
    if first:
        acc = Cplx(torch.empty_like(x_spec.re), torch.empty_like(x_spec.im))
    scratch, cl = work
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_shrink(
            psi.data_ptr(), tau.data_ptr(),
            twiddles_on(h, str(device)).data_ptr(),
            twiddles_on(w, str(device)).data_ptr(), support.table.data_ptr(),
            support.offsets.ctypes.data, l0, l1, acc.re.data_ptr(),
            acc.im.data_ptr(), scratch.data_ptr(), cl.data_ptr(), b, h, w,
            psi.shape[0], THRESH_OPS[op], int(first),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "subband_shrink", tuple(x_spec.re.shape))
    subband_shrink.launches += 1
    return acc


subband_shrink.launches = 0


def percentile_work(x: Cplx, support: RowSupport) -> tuple | None:
    """The buffers pass 1 of :func:`subband_keys` writes and pass 2 reads
    for every band chunk of a (B, H, W) call: (the scratch of the most
    support rows of one chunk, the kept c_l of the most bands of one chunk
    (B, bands, W, H) complex); None on the host, where the plain versions
    need none."""
    if x.re.device.type == "cpu":
        return None
    b, h, w = x.re.shape
    scratch = _band_call(x, support, False)[1]
    chunks = support.chunks(b, h, w)[0]
    bands = int(np.max(np.diff(chunks)))
    return scratch, torch.empty(b * bands * h * w * 2, dtype=torch.float32,
                                device=x.re.device)


def percentile_key_bytes(batch: int, h: int, w: int, nbands: int) -> int:
    """What pass 1 and the selection hold for ``nbands`` bands of a
    (B, H, W) call: the float32 keys (B, nbands, H, W), their histogram
    and the selection's candidates and state; a chunk of
    :func:`subband_update_percentile` holds at most every band's."""
    from .percentile import HIST_COLS, select_bytes

    segments = batch * nbands
    return (4 * segments * (h * w + HIST_COLS)
            + select_bytes(segments, h * w))


def kept_cl_bytes(batch: int, h: int, w: int, nbands: int) -> int:
    """The c_l pass 1 keeps for pass 2, for ``nbands`` full-size bands of
    a (B, H, W) call (a chunk holds at most every band's): complex64
    (B, nbands, W, H). Keeping it beats computing it again in pass 2 by
    1.8 ms a 32×512² SHEARLET call on an H100 (PERF.md §6)."""
    return 8 * batch * nbands * h * w


def subband_update_percentile_plain(x_spec: Cplx, psi: torch.Tensor,
                                    q: torch.Tensor,
                                    thresh_op: str = "hard-percentile"
                                    ) -> Cplx:
    """The split route's plain versions over every band at once: keys,
    percentiles, shrink and sum in band order."""
    from .percentile import band_percentile_plain

    op = _split_op(thresh_op, "highest")
    tau = band_percentile_plain(subband_keys_plain(x_spec, psi), q)
    return subband_shrink_plain(x_spec, psi, tau, op)


def subband_update_percentile(x_spec: Cplx, psi: torch.Tensor,
                              q: torch.Tensor,
                              thresh_op: str = "hard-percentile",
                              precision: str = "highest", *,
                              support: RowSupport) -> Cplx:
    """The full-size bands' subband update with percentile thresholds:
    Σ_l fft2(shrink(c_l, t[b, l]))·ψ_l, c_l = ifft2(X_b·ψ_l), where
    t[b, l] is the percentile ``q[b, l]`` of |c_l| over H×W (JAX
    ``threshold_pair`` with a ``*-percentile`` kind on its streamed
    apply). ``q``: (B, L) float32; ``thresh_op``: 'hard-percentile',
    'soft-percentile' or 'garrote-percentile' (or their bases); the rest
    as :func:`subband_update`. Per band chunk of the scratch:
    :func:`subband_keys`, :func:`percentile.band_percentile`,
    :func:`subband_shrink`, the chunks' sums in band order."""
    from .percentile import band_percentile

    op = _split_op(thresh_op, precision)
    device = _check_bands(x_spec, psi, q, "x_spec")
    _check_support(psi, support)
    b, h, w = x_spec.re.shape
    if b == 0 or psi.shape[0] == 0:
        return Cplx(torch.zeros_like(x_spec.re), torch.zeros_like(x_spec.im))
    chunks = support.chunks(b, h, w)[0]
    work = percentile_work(x_spec, support)
    acc = None
    for l0, l1 in zip(chunks[:-1].tolist(), chunks[1:].tolist()):
        keys, hist = subband_keys(x_spec, psi, support, l0, l1, work)
        tau = band_percentile(keys, q[:, l0:l1].contiguous(), hist)
        del keys, hist
        acc = subband_shrink(x_spec, psi, tau, support, l0, l1, acc, op, work)
    return acc


def box_keys_plain(xbox: Cplx, psi: torch.Tensor, mats, n_h: int,
                   n_w: int) -> torch.Tensor:
    """|A_hᴴ(xb·ψ_l)A_w*/(N_h·N_w)| of each band: the full N_h × N_w field,
    (B, lg, N_h, N_w), rounded as ``Cplx.abs`` rounds it."""
    ahr, ahi, awr, awi = mats
    ah = torch.complex(ahr, ahi)
    aw = torch.complex(awr, awi)
    xb = torch.complex(xbox.re, xbox.im)
    keys = torch.empty((xb.shape[0], psi.shape[0], n_h, n_w),
                       dtype=torch.float32, device=xb.device)
    for k in range(psi.shape[0]):
        c = (ah.conj().T @ (xb * psi[k]) @ aw.conj()) / (n_h * n_w)
        keys[:, k] = torch.sqrt(c.real * c.real + c.imag * c.imag)
    return keys


def box_keys(xbox: Cplx, psi: torch.Tensor, mats, n_h: int, n_w: int, *,
             index=None, work: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the percentile route for one box group: (the keys |c| of
    each band's full N_h × N_w field, (B, lg, N_h, N_w), their first-digit
    histogram (B, lg, HIST_COLS) int32). On the card the box kernel's pass
    (1) into ``work`` (``box_work_floats`` floats, which pass 2 reads) and
    its row pass up to the scale, pruned where ``index``'s W indices allow
    (:func:`box_line_plan`); CPU tensors run :func:`box_keys_plain` and the
    plain histogram. Arguments as :func:`box_group_update`."""
    from .percentile import key_histogram_plain

    b, sr, sc = xbox.re.shape
    lg = psi.shape[0]
    device = _check_box(xbox, psi, None, mats, n_h, n_w, index)
    if device.type == "cpu":
        keys = box_keys_plain(xbox, psi, mats, n_h, n_w)
        return keys, key_histogram_plain(keys)
    keys = torch.empty((b, lg, n_h, n_w), dtype=torch.float32, device=device)
    hist = _new_hist((b, lg), device)
    with torch.cuda.device(device):
        rc = _lib().p3d_box_keys(
            xbox.re.data_ptr(), xbox.im.data_ptr(), psi.data_ptr(),
            index[0].data_ptr(), index[1].data_ptr(),
            twiddles_on(n_h, str(device)).data_ptr(),
            twiddles_on(n_w, str(device)).data_ptr(), keys.data_ptr(),
            hist.data_ptr(), work.data_ptr(), b, lg, sr, sc, n_h, n_w,
            _box_line(index),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "box_keys", (b, sr, sc, n_h, n_w))
    box_keys.launches += 1
    return keys, hist


box_keys.launches = 0


def box_shrink(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor, mats,
               n_h: int, n_w: int, thresh_op: str, *, index=None,
               work: torch.Tensor | None = None) -> Cplx:
    """Pass 2 of the percentile route for one box group: each band's field
    once more from pass 1's ``work`` (in pass 1's form, so that |c|² is
    its key squared bit for bit), shrunk by ``tau`` (B, lg), back to the
    box, weighted and summed in band order: the window-weighted summed box
    (B, sr, sc). CPU tensors run :func:`box_group_update_plain`."""
    op = _split_op(thresh_op, "highest")
    device = _check_box(xbox, psi, tau, mats, n_h, n_w, index)
    if device.type == "cpu":
        return box_group_update_plain(xbox, psi, tau, mats, n_h, n_w, op)
    b, sr, sc = xbox.re.shape
    m_re = torch.empty_like(xbox.re)
    m_im = torch.empty_like(xbox.im)
    with torch.cuda.device(device):
        rc = _lib().p3d_box_shrink(
            psi.data_ptr(), tau.data_ptr(), index[0].data_ptr(),
            index[1].data_ptr(), twiddles_on(n_h, str(device)).data_ptr(),
            twiddles_on(n_w, str(device)).data_ptr(), m_re.data_ptr(),
            m_im.data_ptr(), work.data_ptr(), b, psi.shape[0], sr, sc, n_h,
            n_w, THRESH_OPS[op], _box_line(index),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "box_shrink", (b, sr, sc, n_h, n_w))
    box_shrink.launches += 1
    return Cplx(m_re, m_im)


box_shrink.launches = 0


def box_group_update_percentile_plain(xbox: Cplx, psi: torch.Tensor,
                                      q: torch.Tensor, mats, n_h: int,
                                      n_w: int,
                                      thresh_op: str = "hard-percentile"
                                      ) -> Cplx:
    """The box group's split route in its plain versions: keys of the full
    fields, percentiles, :func:`box_group_update_plain`."""
    from .percentile import band_percentile_plain

    op = _split_op(thresh_op, "highest")
    tau = band_percentile_plain(box_keys_plain(xbox, psi, mats, n_h, n_w), q)
    return box_group_update_plain(xbox, psi, tau, mats, n_h, n_w, op)


def box_group_update_percentile(xbox: Cplx, psi: torch.Tensor,
                                q: torch.Tensor, mats, n_h: int, n_w: int,
                                thresh_op: str = "hard-percentile",
                                precision: str = "highest", *,
                                index=None) -> Cplx:
    """One box group's update with percentile thresholds: each band's
    threshold is the percentile ``q[b, l]`` of |c| over the full
    N_h × N_w field (JAX ``_box_group_spatial`` with a ``*-percentile``
    kind), not over the box. :func:`box_keys`,
    :func:`percentile.band_percentile`, :func:`box_shrink`; arguments as
    :func:`box_group_update`, ``q`` (B, lg) in place of ``tau``."""
    from .percentile import band_percentile

    op = _split_op(thresh_op, precision)
    b, sr, sc = xbox.re.shape
    device = _check_box(xbox, psi, q, mats, n_h, n_w, index)
    if b == 0 or psi.shape[0] == 0:
        return Cplx(torch.zeros_like(xbox.re), torch.zeros_like(xbox.im))
    work = (None if device.type == "cpu" else torch.empty(
        box_work_floats(b, psi.shape[0], sc, n_h), dtype=torch.float32,
        device=device))
    keys, hist = box_keys(xbox, psi, mats, n_h, n_w, index=index, work=work)
    tau = band_percentile(keys, q, hist)
    del keys, hist
    return box_shrink(xbox, psi, tau, mats, n_h, n_w, op, index=index,
                      work=work)
