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
cropped group's ``Σ_l ψ_l·A_h·shrink(A_hᴴ(xb·ψ_l)A_w*/(N_h·N_w))·A_wᵀ``.
``csrc/subband.cu`` has the three kernels, with their design and what
bounds them.

Each wrapper launches its kernel for CUDA tensors, counts the launch
(``.launches``) and takes its plain version only for CPU tensors; a failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..cplx import Cplx
from . import _build
from .pocs_solve import PRECISIONS, THRESH_OPS, _shrink

# at most this much device scratch for kernel A's bands in flight: a
# (B, chunk, H, W) complex stack
SCRATCH_BYTES = 1 << 30
# the box kernel splits a subband's field rows over blocks until the grid
# has this many blocks per SM
BOX_BLOCKS_PER_SM = 4
# a box-kernel block forms 16 field rows at a time (csrc/subband.cu RB)
_BOX_ROWS = 16
_ERR_SMEM = -2


def band_chunk(batch: int, h: int, w: int, nbands: int) -> int:
    """Bands of kernel A's scratch in flight at a time."""
    return max(1, min(nbands, SCRATCH_BYTES // max(1, batch * h * w * 8)))


def scratch_bytes(batch: int, h: int, w: int, nbands: int,
                  spatial: bool = False) -> int:
    """Device scratch of one :func:`subband_update` call, or with
    ``spatial`` of one :func:`subband_update_spatial` call (one (B, H, W)
    spectrum more)."""
    return (band_chunk(batch, h, w, nbands) + int(spatial)) * batch * h * w * 8


def _op(thresh_op: str, precision: str) -> str:
    op = "garrote" if thresh_op == "garotte" else thresh_op
    if op not in THRESH_OPS:
        raise ValueError(f"the subband kernels support {sorted(THRESH_OPS)} "
                         f"thresholds, not {thresh_op!r}")
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r}: the subband kernels compute 'high' "
            "and 'highest' in full fp32; a Hopper mapping of the other "
            "modes is an open ROADMAP item")
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
    lib.p3d_subband_update.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.p3d_subband_update.restype = i
    lib.p3d_subband_update_spatial.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.p3d_subband_update_spatial.restype = i
    lib.p3d_box_group_update.argtypes = [p] * 11 + [i] * 8 + [p]
    lib.p3d_box_group_update.restype = i
    return lib


def _raise_on(rc: int, what: str, shape) -> None:
    if rc == _ERR_SMEM:
        raise ValueError(f"{what}: shape {shape} needs more shared memory "
                         "than a block has")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} while launching")


@functools.lru_cache(maxsize=16)
def twiddles(n: int) -> np.ndarray:
    """(n, 2) float32 table of exp(-2πi m/n), built in float64."""
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _twiddles_on(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(twiddles(n)).to(device)


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


def _check_bands(x: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                 name: str) -> torch.device:
    """The checks of :func:`subband_update` and
    :func:`subband_update_spatial`; returns the tensors' device."""
    device = _device(x.re)
    if x.re.dim() != 3 or x.im.shape != x.re.shape:
        raise ValueError(f"{name} must be a (B, H, W) pair, got "
                         f"{tuple(x.re.shape)} / {tuple(x.im.shape)}")
    b, h, w = x.re.shape
    if psi.dim() != 3 or tuple(psi.shape[1:]) != (h, w):
        raise ValueError(f"psi must be (L, {h}, {w}), got "
                         f"{tuple(psi.shape)}")
    nbands = psi.shape[0]
    if tuple(tau.shape) != (b, nbands):
        raise ValueError(f"tau must be ({b}, {nbands}), got "
                         f"{tuple(tau.shape)}")
    _check({f"{name}.re": x.re, f"{name}.im": x.im, "psi": psi, "tau": tau},
           device)
    return device


def subband_update(x_spec: Cplx, psi: torch.Tensor, tau: torch.Tensor,
                   thresh_op: str = "hard", precision: str = "highest"
                   ) -> Cplx:
    """The full-size bands' subband update of a batch of spectra.

    ``x_spec``: (B, H, W) float32 pair, the natural-order ``fft2`` of the
    slices, any H and W; ``psi``: (L, H, W) real windows; ``tau``: (B, L)
    thresholds; ``precision``: 'high' or 'highest', both full fp32. Returns
    the (B, H, W) spectral accumulator, which inverts with ``ifft2``. CUDA
    tensors run the kernel, CPU tensors :func:`subband_update_plain`."""
    op = _op(thresh_op, precision)
    device = _check_bands(x_spec, psi, tau, "x_spec")
    if device.type == "cpu":
        return subband_update_plain(x_spec, psi, tau, op)
    b, h, w = x_spec.re.shape
    nbands = psi.shape[0]
    acc_re = torch.empty_like(x_spec.re)
    acc_im = torch.empty_like(x_spec.im)
    if b == 0 or nbands == 0:
        return Cplx(acc_re.zero_(), acc_im.zero_())
    lc = band_chunk(b, h, w, nbands)
    work = torch.empty(b * lc * h * w * 2, dtype=torch.float32, device=device)
    tw_h = _twiddles_on(h, str(device))
    tw_w = _twiddles_on(w, str(device))
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_update(
            x_spec.re.data_ptr(), x_spec.im.data_ptr(), psi.data_ptr(),
            tau.data_ptr(), tw_h.data_ptr(), tw_w.data_ptr(),
            acc_re.data_ptr(), acc_im.data_ptr(), work.data_ptr(),
            b, h, w, nbands, lc, THRESH_OPS[op],
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "subband_update", (b, h, w))
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
                           precision: str = "highest") -> Cplx:
    """The full-size bands' subband update of a batch of slices, spatial in
    and out: ``ifft2(Σ_l fft2(shrink(ifft2(fft2(x)·ψ_l)))·ψ_l)``.

    ``x``: (B, H, W) float32 pair of spatial slices, any H and W; ``psi``,
    ``tau`` and ``precision`` as :func:`subband_update`. Returns the
    (B, H, W) spatial update. CUDA tensors run the kernel, whose forward
    and inverse transforms are its own passes; CPU tensors
    :func:`subband_update_spatial_plain`."""
    op = _op(thresh_op, precision)
    device = _check_bands(x, psi, tau, "x")
    b, h, w = x.re.shape
    nbands = psi.shape[0]
    if b == 0 or nbands == 0:
        return Cplx(torch.zeros_like(x.re), torch.zeros_like(x.im))
    if device.type == "cpu":
        return subband_update_spatial_plain(x, psi, tau, op)
    out_re = torch.empty_like(x.re)
    out_im = torch.empty_like(x.im)
    lc = band_chunk(b, h, w, nbands)
    work = torch.empty(b * lc * h * w * 2, dtype=torch.float32, device=device)
    spec = torch.empty(b * h * w * 2, dtype=torch.float32, device=device)
    tw_h = _twiddles_on(h, str(device))
    tw_w = _twiddles_on(w, str(device))
    with torch.cuda.device(device):
        rc = _lib().p3d_subband_update_spatial(
            x.re.data_ptr(), x.im.data_ptr(), psi.data_ptr(), tau.data_ptr(),
            tw_h.data_ptr(), tw_w.data_ptr(), out_re.data_ptr(),
            out_im.data_ptr(), spec.data_ptr(), work.data_ptr(), b, h, w,
            nbands, lc, THRESH_OPS[op],
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "subband_update_spatial", (b, h, w))
    subband_update_spatial.launches += 1
    return Cplx(out_re, out_im)


subband_update_spatial.launches = 0


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


def _box_splits(device, batch: int, lg: int, n_h: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-BOX_BLOCKS_PER_SM * sms // max(1, batch * lg))
    return max(1, min(want, -(-n_h // _BOX_ROWS)))


def box_group_update(xbox: Cplx, psi: torch.Tensor, tau: torch.Tensor, mats,
                     n_h: int, n_w: int, thresh_op: str = "hard",
                     precision: str = "highest") -> Cplx:
    """One support-cropped group's update of a batch of box spectra.

    ``xbox``: (B, sr, sc) float32 pair, the group's frequency box of the
    slices' spectra; ``psi``: (lg, sr, sc) windows; ``tau``: (B, lg);
    ``mats``: (ahr, ahi, awr, awi), the partial DFT rows A_h = F_{N_h}[idx_h]
    (sr, N_h) and A_w = F_{N_w}[idx_w] (sc, N_w) as float32. Returns the
    window-weighted summed box (B, sr, sc), to be added into the slices'
    spectra at the box. CUDA tensors run the kernel, CPU tensors
    :func:`box_group_update_plain`."""
    op = _op(thresh_op, precision)
    device = _device(xbox.re)
    if xbox.re.dim() != 3 or xbox.im.shape != xbox.re.shape:
        raise ValueError(f"xbox must be a (B, sr, sc) pair, got "
                         f"{tuple(xbox.re.shape)} / {tuple(xbox.im.shape)}")
    b, sr, sc = xbox.re.shape
    if psi.dim() != 3 or tuple(psi.shape[1:]) != (sr, sc):
        raise ValueError(f"psi must be (lg, {sr}, {sc}), got "
                         f"{tuple(psi.shape)}")
    lg = psi.shape[0]
    if tuple(tau.shape) != (b, lg):
        raise ValueError(f"tau must be ({b}, {lg}), got {tuple(tau.shape)}")
    ahr, ahi, awr, awi = mats
    for name, t, shape in (("ahr", ahr, (sr, n_h)), ("ahi", ahi, (sr, n_h)),
                           ("awr", awr, (sc, n_w)), ("awi", awi, (sc, n_w))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _check({"xbox.re": xbox.re, "xbox.im": xbox.im, "psi": psi, "tau": tau,
            "ahr": ahr, "ahi": ahi, "awr": awr, "awi": awi}, device)
    if device.type == "cpu":
        return box_group_update_plain(xbox, psi, tau, mats, n_h, n_w, op)
    m_re = torch.empty_like(xbox.re)
    m_im = torch.empty_like(xbox.im)
    if b == 0 or lg == 0:
        return Cplx(m_re.zero_(), m_im.zero_())
    nsplit = _box_splits(device, b, lg, n_h)
    work = torch.empty(b * lg * nsplit * sr * sc * 2, dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        rc = _lib().p3d_box_group_update(
            xbox.re.data_ptr(), xbox.im.data_ptr(), psi.data_ptr(),
            tau.data_ptr(), ahr.data_ptr(), ahi.data_ptr(), awr.data_ptr(),
            awi.data_ptr(), m_re.data_ptr(), m_im.data_ptr(),
            work.data_ptr(), b, lg, sr, sc, n_h, n_w, nsplit, THRESH_OPS[op],
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "box_group_update", (b, sr, sc, n_h, n_w))
    box_group_update.launches += 1
    return Cplx(m_re, m_im)


box_group_update.launches = 0
